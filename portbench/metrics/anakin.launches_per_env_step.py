"""Device operations the rollout engine launches per env step: those
launched off the learner's streams while an engine dispatch ran (the
engine runs on the staging thread's stream), over the traced dispatches'
env steps."""


def read(run):
    spans = run.intervals.get("anakin.rollout") or []
    engine = getattr(run.trainer.pool, "engine", None)
    if run.trace is None or not spans or engine is None:
        return None
    ns = [(run.to_trace_ns(a), run.to_trace_ns(b)) for a, b in spans]
    learner = run.trace.home_streams("portbench.learner")
    ops = run.trace.launched_during(ns, exclude_streams=learner)
    return len(ops) / (len(spans) * engine.T) if ops else None
