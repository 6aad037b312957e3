"""Device milliseconds per learner step of the operations launched on the
learner's own streams inside the program's ``apex.learner.burn_in``
spans (both nets' no-gradient unroll of each sequence's burn-in from its
stored state, in ``r2d2_loss``)."""

from portbench.spans import DISPATCH, bounds, clipped, inside


def read(run):
    trace = run.trace
    if trace is None or run.steps <= 0:
        return None
    phases = clipped(trace, ("apex.learner.burn_in",))
    if not phases:
        return None
    lo, hi = bounds(trace)
    ns = 0
    for op in trace.launched_in(DISPATCH):
        thread, at = trace.launches[op[3]]
        if lo <= at <= hi and thread in phases and inside(phases[thread],
                                                          at):
            ns += op[1] - op[0]
    return ns * 1e-6 / run.steps
