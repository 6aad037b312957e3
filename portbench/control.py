"""Readings that set the limits of ``correct``, on the card.

    python -m portbench.control --workload <name> --seeds 1,2,... \\
        [--planted 7,8,9]

For each seed the cell's trainer is built and driven through its first
learner steps exactly as a benchmark run does (no measured window), and
the program's numbers are read against the reference.  For each
``--planted`` seed the same, and also the control (the reference in
float8 e4m3 where the configuration computes in bfloat16, put in the
program's place) and the half-batch fault, each read against the float32
reference.  One JSON line per seed; the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--planted", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench.spec import cell as load_cell

    cell = load_cell(args.workload)
    seeds = [(int(s), ("program",)) for s in args.seeds.split(",") if s]
    seeds += [(int(s), ("program", "control", "half_batch"))
              for s in args.planted.split(",") if s]
    for seed, variants in seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, 0.0, False, device=args.device,
                               variants=variants, measure=False)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "peak": out["memory_peak_bytes"],
                          **out["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
