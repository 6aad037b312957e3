"""Mean milliseconds of one rollout-engine dispatch (``rollout_len``
steps of every lane), synchronised, in the traced window."""


def read(run):
    samples = run.timers.get("anakin.rollout") or []
    if not samples:
        return None
    return 1e3 * sum(samples) / len(samples)
