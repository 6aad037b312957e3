"""The actor processes' mean share of wall time spent in their batched
CPU policy call (``trainer.actor_plane()["policy_wait_frac"]``)."""


def read(run):
    plane = run.trainer.actor_plane()
    if not plane:
        return None
    return plane["policy_wait_frac"]
