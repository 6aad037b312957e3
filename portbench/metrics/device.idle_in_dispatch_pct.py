"""Of the device's idle time in the traced window, the share that falls
inside the program's ``apex.learner.dispatch`` spans, in percent: high
when the learner's launches cannot keep the card fed, low when the loop
between dispatches starves it."""

from portbench.spans import DISPATCH, bounds, clipped, overlap, union


def read(run):
    trace = run.trace
    if trace is None:
        return None
    spans = clipped(trace, (DISPATCH,))
    if not spans:
        return None
    lo, hi = bounds(trace)
    busy = union((max(s, lo), min(t, hi)) for s, t, _, _ in trace.ops
                 if t > lo and s < hi)
    edges = [lo] + [x for s, t in busy for x in (s, t)] + [hi]
    idle = [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle_ns = sum(b - a for a, b in idle)
    if idle_ns <= 0:
        return None
    dispatch = union(iv for merged in spans.values() for iv in merged)
    return 100.0 * overlap(idle, dispatch) / idle_ns
