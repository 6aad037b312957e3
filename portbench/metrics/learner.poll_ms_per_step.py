"""Host milliseconds per learner step inside the program's
``apex.learner.poll`` spans (the hot loop waiting on the ingest
pipeline, the pool or the replay service) in the traced window."""

from portbench.spans import clipped


def read(run):
    if run.trace is None or run.steps <= 0:
        return None
    spans = clipped(run.trace, ("apex.learner.poll",))
    if not spans:
        return None
    ns = sum(t - s for merged in spans.values() for s, t in merged)
    return ns * 1e-6 / run.steps
