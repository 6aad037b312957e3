"""Device milliseconds per learner step: the operations launched inside
the harness's range around each learner dispatch, on the range's own
streams, over the steps of the traced window."""


def read(run):
    if run.trace is None or run.steps <= 0:
        return None
    ops = run.trace.launched_in("portbench.learner")
    if not ops:
        return None
    return sum(t - s for s, t, _, _ in ops) * 1e-6 / run.steps
