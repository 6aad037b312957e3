"""Device operations launched per learner step inside the program's
``apex.learner.sample`` spans (stratified descent, IS weights, the
frame-ring gather), on the learner's own streams."""

from portbench.spans import phase_launches_per_step


def read(run):
    return phase_launches_per_step(run, ("apex.learner.sample",))
