"""Mean wall milliseconds the ingest pipeline's staging thread took to
build one slot (poll, merge, copy to the device) in the traced window."""


def read(run):
    samples = run.timers.get("ingest.stage") or []
    if not samples:
        return None
    return 1e3 * sum(samples) / len(samples)
