"""Share of the traced window in which the device ran no operation, in
percent."""


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
