"""Merge per-role trace dumps into ONE perfetto-loadable fleet timeline.

Counterpart of :mod:`apex_tpu.obs.merge` (stdlib only).

    python -m apex_tpu_torch.obs.merge TRACE_DIR [-o merged_trace.json]
                                 [--fleet-summary fleet_summary.json]

Each role process dumps ``trace-<label>-<pid>.json`` (Chrome trace-event
JSON, timestamps already in its own wall-clock microseconds —
:mod:`apex_tpu_torch.obs.trace`).  Merging is then two corrections plus a
concatenation:

* **Clock alignment.**  Wall clocks agree on one host but skew across
  hosts.  The learner's registry already measures each peer's offset
  from the heartbeat timestamps flowing through
  :mod:`apex_tpu_torch.fleet.heartbeat` (each beat samples
  learner-wall-at-receive - peer-wall-at-send = skew + transit;
  ``clock_offset_s`` is the min-transit median over the recent sample
  window — transit only ever ADDS, so the smallest samples are the
  closest to pure skew, and the median over that low half rides out
  one anomalous beat) and persists it in ``fleet_summary.json``
  together with ``clock_offset_n`` (samples behind the estimate); when
  a summary is given (or found next to the traces), each file whose
  label matches a peer identity is shifted onto the learner's
  timeline.  Files without a matching peer (the learner itself,
  same-host workers) shift by zero.
* **Pid remapping.**  Every file becomes one perfetto process group
  (sequential pids, ``process_name`` = the role label), so two roles
  that happened to share an OS pid across hosts cannot collide.

Finally the whole timeline is re-zeroed at the earliest event, so the
merged view opens at t=0 instead of at the unix epoch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def load_offsets(summary: dict) -> dict[str, float]:
    """identity -> clock_offset_s from a ``fleet_summary.json`` snapshot
    (peers without a measured offset map to 0).  The registry's offset is
    already the min-transit median over its sample window (module
    docstring); single-sample peers (``clock_offset_n`` <= 1) still align
    — their estimate just carries that one beat's transit."""
    out: dict[str, float] = {}
    for peer in summary.get("peers", []):
        off = peer.get("clock_offset_s")
        if off is not None:
            out[peer["identity"]] = float(off)
    return out


def offset_quality(summary: dict) -> dict[str, int]:
    """identity -> sample count behind each offset estimate — surfaced in
    the merged trace metadata so a timeline with suspicious alignment can
    be triaged without re-running the fleet (n=1 means one transit of
    noise; n near the window size means the estimator had data)."""
    return {peer["identity"]: int(peer.get("clock_offset_n", 0))
            for peer in summary.get("peers", [])
            if peer.get("clock_offset_s") is not None}


def merge_traces(traces: list[dict],
                 offsets: dict[str, float] | None = None) -> dict:
    """Merge loaded per-process trace dicts into one Chrome trace.

    ``offsets``: seconds to ADD to a file's timestamps, keyed by its
    metadata label (peer wall + offset = learner wall).  Pure function —
    the unit tests drive it with fake skewed clocks.
    """
    offsets = offsets or {}
    merged: list[dict] = []
    labels: list[str] = []
    for i, trace in enumerate(traces):
        meta = trace.get("metadata", {})
        label = meta.get("label", f"proc{i}")
        labels.append(label)
        shift_us = offsets.get(label, 0.0) * 1e6
        pid = i + 1
        for ev in trace.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            merged.append(ev)
        # ensure a process_name row even for files dumped without one
        if not any(ev.get("ph") == "M" and ev.get("name") == "process_name"
                   and ev.get("pid") == pid for ev in merged):
            merged.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": label}})
    timed = [ev["ts"] for ev in merged if "ts" in ev]
    t0 = min(timed) if timed else 0.0
    for ev in merged:
        if "ts" in ev:
            ev["ts"] = round(ev["ts"] - t0, 1)
    merged.sort(key=lambda ev: (ev.get("ts", -1.0), ev.get("pid", 0)))
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {"merged_from": labels,
                     "t0_wall_us": round(t0, 1),
                     "offsets_applied": {k: v for k, v in offsets.items()
                                         if k in labels}},
    }


def merge_dir(trace_dir: str, out_path: str,
              fleet_summary: str | None = None) -> dict:
    """Load every ``trace-*.json`` under ``trace_dir``, align, merge,
    write ``out_path``.  Returns the merged trace dict."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "trace-*.json")))
    if not paths:
        raise FileNotFoundError(f"no trace-*.json files in {trace_dir!r} "
                                f"(set APEX_TRACE_DIR for the run)")
    traces = []
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as fh:
                traces.append(json.load(fh))
        except (OSError, json.JSONDecodeError) as e:
            print(f"obs.merge: skipping {p}: {e}")
    offsets: dict[str, float] = {}
    quality: dict[str, int] = {}
    if fleet_summary is None:
        candidate = os.path.join(trace_dir, "fleet_summary.json")
        fleet_summary = candidate if os.path.exists(candidate) else None
    if fleet_summary:
        with open(fleet_summary, "r", encoding="utf-8") as fh:
            summary = json.load(fh)
        offsets = load_offsets(summary)
        quality = offset_quality(summary)
    merged = merge_traces(traces, offsets)
    if quality:
        merged["metadata"]["offset_samples"] = {
            k: v for k, v in quality.items()
            if k in merged["metadata"]["merged_from"]}
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(merged, fh)
    os.replace(tmp, out_path)
    return merged


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.obs.merge",
        description="merge per-role trace dumps into one perfetto timeline")
    p.add_argument("trace_dir", help="directory holding trace-*.json dumps")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default TRACE_DIR/merged_trace.json)")
    p.add_argument("--fleet-summary", default=None,
                   help="fleet_summary.json with per-peer clock_offset_s "
                        "(default: TRACE_DIR/fleet_summary.json if present)")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.trace_dir, "merged_trace.json")
    try:
        merged = merge_dir(args.trace_dir, out, args.fleet_summary)
    except FileNotFoundError as e:
        print(f"obs.merge: {e}")
        return 1
    n = sum(1 for ev in merged["traceEvents"] if ev.get("ph") != "M")
    print(f"obs.merge: {len(merged['metadata']['merged_from'])} processes, "
          f"{n} events -> {out} (load in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    # whole lines on an output shared with the fleet's other processes
    # (apex_tpu_torch/runtime/__main__.py)
    sys.stdout.reconfigure(line_buffering=True, write_through=False)
    raise SystemExit(main())
