"""What the readers of the program's own spans share.

The learner thread's ``apex.learner.*`` spans are ranges of the device
trace (``DeviceTrace.ranges``); every thread's spans are also kept by the
program on the profiler's clock (``apex_tpu_torch.obs.trace.
profiled_spans``, absent from a program that has no spans).  Readers
count only what lies between the traced window's open and close, and
return None where the window holds none of the spans they read.
"""

from __future__ import annotations

import bisect

DISPATCH = "apex.learner.dispatch"


def bounds(trace) -> tuple[int, int]:
    """The traced window's open and close, in trace ns."""
    return trace.open_ns, trace.open_ns + int(round(trace.window_s * 1e9))


def union(intervals) -> list:
    out: list = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def overlap(a: list, b: list) -> int:
    """Length shared by two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def inside(merged: list, t: int) -> bool:
    """``t`` within one of the sorted, disjoint ``merged`` intervals."""
    i = bisect.bisect_right([s for s, _ in merged], t) - 1
    return i >= 0 and t <= merged[i][1]


def clipped(trace, names) -> dict:
    """``{thread: merged intervals}`` of the ranges named one of
    ``names``, clipped to the traced window."""
    lo, hi = bounds(trace)
    by_thread: dict = {}
    for name, thread, s, t in trace.ranges:
        if name in names and t > lo and s < hi:
            by_thread.setdefault(thread, []).append((max(s, lo), min(t, hi)))
    return {th: union(iv) for th, iv in by_thread.items()}


def phase_launches_per_step(run, names) -> float | None:
    """Device operations launched inside the learner's ``names`` ranges,
    on the learner's own streams (those of its dispatches), per learner
    step of the traced window."""
    trace = run.trace
    if trace is None or run.steps <= 0:
        return None
    phases = clipped(trace, names)
    if not phases:
        return None
    lo, hi = bounds(trace)
    n = 0
    for op in trace.launched_in(DISPATCH):
        thread, at = trace.launches[op[3]]
        if lo <= at <= hi and thread in phases and inside(phases[thread],
                                                          at):
            n += 1
    return n / run.steps


def program_spans(name: str, trace) -> list | None:
    """``(start_ns, end_ns)`` of the program's in-memory ``name`` spans
    that lie whole inside the traced window; None from a program that
    keeps no spans."""
    from apex_tpu_torch.obs import trace as obs_trace
    get = getattr(obs_trace, "profiled_spans", None)
    if get is None:
        return None
    lo, hi = bounds(trace)
    return [(s, t) for n, _, s, t in get() if n == name and lo <= s
            and t <= hi]
