"""Median milliseconds from an actor's put of a chunk to the staging
thread's poll of it (the ``send→recv`` hop of the chunks' lineage spans,
``latency_summary()["hops_s"]``), over the chunks the learner consumed
inside the traced window: the chunk's wait in the shm ring."""

from portbench.spans import bounds


def read(run):
    if run.trace is None:
        return None
    if "hops_s" not in (run.trainer.latency_summary() or {}):
        return None              # a program without the hop histograms
    lo, hi = bounds(run.trace)   # the profiler's clock, Unix ns
    summary = run.trainer.latency_summary(between=(lo * 1e-9, hi * 1e-9))
    hop = summary["hops_s"].get("send→recv")
    if not hop or not hop["count"]:
        return None
    return 1e3 * hop["p50_s"]
