"""Run one cell of ``BENCHMARK.json`` once on the card.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the card's name, count and power limit first, then, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; its last key, ``checks``, gives each compared number
beside its limit, as do the last lines of standard error.  Exits 1 with
no result when there is no card or too few, when a run fails, or when
JAX or the JAX package is loaded in this process.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "apex_tpu")


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    port builds its own kernels into its package's ``_build`` folders."""
    from portbench.spec import ROOT
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_lines(torch) -> dict:
    n = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "nvidia-smi unavailable"
    print(f"card: {name}; devices {n}; {limit}", flush=True)
    return {"kind": name, "count": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    import torch

    from portbench import check, harness
    from portbench.spec import cell as load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; this benchmark runs on the card "
              "only", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    device = card_lines(torch)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", process_start=PROCESS_START)
    numbers = out["numbers"]["program"]
    correct, shown = check.verdict(numbers, cell.limits)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: loaded in this process: {bad}", file=sys.stderr)
        return 1
    device["platform"] = "gpu"
    device["count"] = cell.chips
    device["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = {"correct": correct, "attempted": len(shown),
              "failed": sum(1 for v in shown.values()
                            if not v["value"] <= v["limit"]),
              "metrics": out["metrics"], "device": device}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
        result["breakdown"] = out["breakdown"]
    print(f"window: {out['window_s']:.3f} s, {out['steps_in_window']} "
          f"learner steps; steps/s by 5 s: {out['window_rates']}",
          flush=True)
    result["checks"] = shown
    for name, v in shown.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
