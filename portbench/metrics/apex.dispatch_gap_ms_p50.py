"""Median host gap between one learner dispatch returning and the next
being issued, over the trainer's last 512 gaps
(``latency_summary()["dispatch_gap_ms"]``)."""


def read(run):
    summary = run.trainer.latency_summary()
    gaps = summary and summary["dispatch_gap_ms"]
    if not gaps or not gaps["dispatches"]:
        return None
    return gaps["dispatch_gap_ms_p50"]
