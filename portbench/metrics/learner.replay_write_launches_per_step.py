"""Device operations launched per learner step inside the program's
``apex.learner.ingest`` and ``apex.learner.priorities`` spans (frame
writes, the new rows' and the sampled rows' tree updates), on the
learner's own streams."""

from portbench.spans import phase_launches_per_step


def read(run):
    return phase_launches_per_step(
        run, ("apex.learner.ingest", "apex.learner.priorities"))
