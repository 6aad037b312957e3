"""Device operations launched per learner step inside the program's
``apex.learner.loss`` and ``apex.learner.optimizer`` spans (forwards,
loss, backward, clip, RMSprop, target copy), on the learner's own
streams."""

from portbench.spans import phase_launches_per_step


def read(run):
    return phase_launches_per_step(
        run, ("apex.learner.loss", "apex.learner.optimizer"))
