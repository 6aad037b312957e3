"""The readers of the program's spans on a synthetic trace.

One learner thread (1) and one staging thread (2) over a window of
[10 000, 30 000) ns.  Two learner dispatches lie in the window, one
before it; the staging thread's engine launches run on a stream of their
own.  Every reader is checked against counts made by hand, and on windows
that hold none of its spans (the reader returns None), as a program
without spans leaves them.
"""

from types import SimpleNamespace

import pytest

from portbench.devtrace import DeviceTrace
from portbench.spec import metric_reader

LEARNER, STAGING = 1, 2
LSTREAM, ESTREAM = 7, 9
OPEN, CLOSE = 10_000, 30_000


def _dispatch(t0: int) -> list:
    """One fused dispatch's ranges from ``t0``: 6000 ns, the five phases
    in step order."""
    return [("apex.learner.dispatch", LEARNER, t0, t0 + 6000),
            ("portbench.learner", LEARNER, t0 + 50, t0 + 5950),
            ("apex.learner.ingest", LEARNER, t0 + 100, t0 + 1000),
            ("apex.learner.sample", LEARNER, t0 + 1000, t0 + 2000),
            ("apex.learner.loss", LEARNER, t0 + 2000, t0 + 4000),
            ("apex.learner.optimizer", LEARNER, t0 + 4000, t0 + 5000),
            ("apex.learner.priorities", LEARNER, t0 + 5000, t0 + 5900)]


# launches a dispatch makes, by offset from its start: 2 ingest, 3
# sample, 4 loss, 2 optimizer, 1 priorities, and 1 outside the phases
PHASE_LAUNCHES = (150, 900, 1100, 1500, 1900, 2100, 2500, 3000, 3900,
                  4100, 4900, 5100, 5920)


def _trace(dispatch_starts=(2_000, 12_000, 20_000), poll=True,
           with_program=True) -> DeviceTrace:
    ranges, ops, launches, streams = [], [], {}, {}
    corr = 0

    def op(thread, at, start, end, stream):
        nonlocal corr
        corr += 1
        launches[corr] = (thread, at)
        ops.append((start, end, f"k{corr}", corr))
        streams[corr] = stream

    for t0 in dispatch_starts:
        if with_program:
            ranges += _dispatch(t0)
        else:
            ranges.append(("portbench.learner", LEARNER, t0 + 50,
                           t0 + 5950))
        for dt in PHASE_LAUNCHES:
            op(LEARNER, t0 + dt, t0 + dt + 10, t0 + dt + 60, LSTREAM)
    if poll and with_program:
        ranges += [("apex.learner.poll", LEARNER, 18_000, 19_500),
                   ("apex.learner.poll", LEARNER, 26_000, 26_500),
                   ("apex.learner.poll", LEARNER, 9_000, 10_200)]
    # the engine: 6 launches on the staging thread's stream, 4 of them
    # inside its span [21 000, 25 000], and one learner launch there
    for at in (21_100, 22_000, 23_000, 24_900, 25_500, 29_000):
        op(STAGING, at, at + 20, at + 80, ESTREAM)
    trace = DeviceTrace(
        [(max(s, OPEN), min(t, CLOSE), n, c) for s, t, n, c in ops
         if t >= OPEN and s <= CLOSE],
        launches,
        [r for r in ranges if r[3] >= OPEN and r[2] <= CLOSE],
        [], (CLOSE - OPEN) * 1e-9)
    trace.open_ns = OPEN
    trace.streams = streams
    return trace


def _run(trace, steps=2, summary=None, engine_t=4):
    trainer = SimpleNamespace(
        latency_summary=lambda between=None: summary,
        pool=SimpleNamespace(engine=SimpleNamespace(T=engine_t)))
    return SimpleNamespace(trace=trace, steps=steps, trainer=trainer)


@pytest.mark.parametrize("metric,per_dispatch", [
    ("learner.sample_launches_per_step", 3),
    ("learner.update_launches_per_step", 6),
    ("learner.replay_write_launches_per_step", 3)])
def test_phase_launches_count_the_window_s_dispatches(metric, per_dispatch):
    """Two dispatches inside the window, two steps: the phase's launches
    of those two, none of the dispatch before the open."""
    read = metric_reader(metric).read
    assert read(_run(_trace())) == pytest.approx(per_dispatch)
    phases = sum(metric_reader(m).read(_run(_trace())) for m in (
        "learner.sample_launches_per_step",
        "learner.update_launches_per_step",
        "learner.replay_write_launches_per_step"))
    assert phases == len(PHASE_LAUNCHES) - 1     # one launch lies outside


@pytest.mark.parametrize("metric", [
    "learner.sample_launches_per_step", "learner.update_launches_per_step",
    "learner.replay_write_launches_per_step", "device.idle_in_dispatch_pct",
    "learner.poll_ms_per_step"])
def test_trace_readers_read_nothing_without_the_program_s_spans(metric):
    read = metric_reader(metric).read
    assert read(_run(_trace(with_program=False))) is None
    assert read(_run(_trace(dispatch_starts=(2_000,), poll=False))) is None
    assert read(_run(None)) is None


def test_idle_in_dispatch_is_the_share_of_idle_time_inside_dispatches():
    trace = _trace()
    lo, hi = OPEN, CLOSE
    busy = sorted((s, t) for s, t, _, _ in trace.ops)
    idle, at = [], lo
    for s, t in busy:
        if s > at:
            idle.append((at, s))
        at = max(at, t)
    idle.append((at, hi))
    disp = [(12_000, 18_000), (20_000, 26_000)]
    inside = sum(max(0, min(b, d1) - max(a, d0))
                 for a, b in idle for d0, d1 in disp)
    want = 100.0 * inside / sum(b - a for a, b in idle)
    got = metric_reader("device.idle_in_dispatch_pct").read(_run(trace))
    assert got == pytest.approx(want)
    assert 0.0 < got < 100.0


def test_poll_ms_per_step_clips_the_polls_to_the_window():
    got = metric_reader("learner.poll_ms_per_step").read(_run(_trace()))
    assert got == pytest.approx((1_500 + 500 + 200) * 1e-6 / 2)


def test_engine_launches_read_the_program_s_in_memory_spans(monkeypatch):
    """The engine's spans as the program keeps them, on the trace's
    clock: launches off the learner's stream inside the spans that lie
    whole in the window, over their env steps."""
    from apex_tpu_torch.obs import trace as obs_trace

    read = metric_reader("anakin.engine_launches_per_env_step").read
    spans = [("apex.anakin.rollout", "apex-ingest-staging", 21_000, 25_000),
             ("apex.anakin.rollout", "apex-ingest-staging", 28_000, 31_000),
             ("apex.ingest.stage", "apex-ingest-staging", 20_000, 29_500)]
    monkeypatch.setattr(obs_trace, "profiled_spans", lambda: spans)
    assert read(_run(_trace(), engine_t=4)) == pytest.approx(4 / (1 * 4))
    monkeypatch.setattr(obs_trace, "profiled_spans", lambda: spans[1:])
    assert read(_run(_trace())) is None
    monkeypatch.delattr(obs_trace, "profiled_spans")
    assert read(_run(_trace())) is None


def test_counter_readers_read_the_trainer_s_summary():
    ring = metric_reader("ingest.ring_wait_ms_p50").read
    setup = metric_reader("setup.train_to_first_step_s").read
    hop = {"count": 5, "p50_s": 0.012}
    full = {"hops_s": {"send→recv": hop},
            "setup_s": {"train_to_pool_started": 1.5,
                        "train_to_first_step": 9.25}}
    assert ring(_run(_trace(), summary=full)) == pytest.approx(12.0)
    assert ring(_run(None, summary=full)) is None       # no traced window
    assert setup(_run(None, summary=full)) == 9.25
    bare = {"frame_age_at_train_s": {}, "dispatch_gap_ms": {}}
    for summary in (None, bare, {"hops_s": {"send→recv": dict(hop, count=0)},
                                 "setup_s": {}}):
        assert ring(_run(_trace(), summary=summary)) is None
        assert setup(_run(None, summary=summary)) is None


def test_ring_wait_keeps_to_the_chunks_consumed_in_the_window():
    """The trainer's hop histograms hold chunks consumed before, inside
    and after the traced window (wall seconds on the trace's Unix ns):
    the reader's median is that of the chunks inside it."""
    from apex_tpu_torch.obs.spans import LearnerObs

    wall = [0.0]
    obs = LearnerObs(wall=lambda: wall[0])
    lo_s, hi_s = OPEN * 1e-9, CLOSE * 1e-9
    for at, wait in ((lo_s - 2.0, 9.5), (lo_s - 1.0, 9.0), (lo_s, 0.010), (lo_s + 1e-6, 0.030),
                     (hi_s, 0.020), (hi_s + 1.0, 7.0), (hi_s + 2.0, 8.0)):
        wall[0] = at
        obs.post_consume([{"pv": 0, "hops": {"send": (0.0, 0.0),
                                             "recv": (0.0, wait)}}])
    trainer = SimpleNamespace(
        latency_summary=lambda between=None: obs.summary(between))
    run = SimpleNamespace(trace=_trace(), steps=2, trainer=trainer)
    got = metric_reader("ingest.ring_wait_ms_p50").read(run)
    assert got == pytest.approx(20.0)
    assert obs.summary()["hops_s"]["send→recv"]["p50_s"] == 7.0
