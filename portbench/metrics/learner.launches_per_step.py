"""Device operations launched per learner step inside the harness's
range around each learner dispatch, on its own streams."""


def read(run):
    if run.trace is None or run.steps <= 0:
        return None
    ops = run.trace.launched_in("portbench.learner")
    return len(ops) / run.steps if ops else None
