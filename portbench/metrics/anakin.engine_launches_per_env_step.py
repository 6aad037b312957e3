"""Device operations the rollout engine launches per env step: those
launched off the learner's streams during the program's own
``apex.anakin.rollout`` spans, on the profiler's clock (no pairing of
clocks), over those dispatches' env steps."""

from portbench.spans import DISPATCH, program_spans


def read(run):
    engine = getattr(run.trainer.pool, "engine", None)
    if run.trace is None or engine is None:
        return None
    spans = program_spans("apex.anakin.rollout", run.trace)
    if not spans:
        return None
    learner = run.trace.home_streams(DISPATCH)
    ops = run.trace.launched_during(spans, exclude_streams=learner)
    return len(ops) / (len(spans) * engine.T)
