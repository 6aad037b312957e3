"""Host milliseconds per learner step inside the program's
``apex.learner.update`` spans (``LearnerCore.update_from_batch``, eager
or a graph replay: the batch copied in, the update, the counts and the
target sync) in the traced window."""

from portbench.spans import clipped


def read(run):
    if run.trace is None or run.steps <= 0:
        return None
    spans = clipped(run.trace, ("apex.learner.update",))
    if not spans:
        return None
    ns = sum(t - s for merged in spans.values() for s, t in merged)
    return ns * 1e-6 / run.steps
