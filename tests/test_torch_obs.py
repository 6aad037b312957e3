"""The port's obs plane (``apex_tpu_torch.obs``) against ``apex_tpu.obs``.

Every test feeds both packages the same inputs, made from a seed, under
the same injected clocks, and compares what comes out:

* span stamping (``new_span``, ``stamp``, ``mark_send``, ``merge_spans``,
  first-wins, ``APEX_OBS_SPANS=0``) on the same message dicts, and the
  builder drains (frame chunks, R2D2 sequence groups) stamping ``sealed``;
* ``LatencyHistogram`` snapshots and ``LearnerObs`` summaries, scalars and
  lineage trace events over the same span stream;
* ``TraceRing.to_chrome`` of the same events, sampling and the disabled
  stub; the process ring's dump file;
* ``merge_traces`` / ``merge_dir`` / ``main`` of the same per-process
  traces and fleet summary;
* ``metrics.render`` / ``render_fleet`` / ``scalar_tails``, byte for byte;
* the port's ``PhaseTimer`` / ``DispatchGapTimer`` ring hooks, and
  ``utils.profiling.trace`` writing a Chrome trace on the CPU;
* the port's ingest pipeline stamping ``recv``, ``merge`` and ``stage``,
  with merged payloads unchanged by the spans.
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import pytest

from apex_tpu.obs import merge as jax_merge
from apex_tpu.obs import metrics as jax_metrics
from apex_tpu.obs import spans as jax_spans
from apex_tpu.obs import trace as jax_trace
from apex_tpu_torch.obs import merge as port_merge
from apex_tpu_torch.obs import metrics as port_metrics
from apex_tpu_torch.obs import spans as port_spans
from apex_tpu_torch.obs import trace as port_trace


class Ticks:
    """A clock pair that advances by a seeded step on every read."""

    def __init__(self, seed: int, mono0: float = 100.0,
                 wall0: float = 1.7e9):
        self._rng = np.random.default_rng(seed)
        self.mono, self.wall = mono0, wall0

    def __call__(self) -> tuple[float, float]:
        step = float(self._rng.uniform(1e-4, 5e-2))
        self.mono += step
        self.wall += step
        return (self.mono, self.wall)


@pytest.fixture
def same_clocks(monkeypatch):
    """Both span modules stamp from their own copy of one seeded clock."""
    monkeypatch.setattr(jax_spans, "_now", Ticks(7))
    monkeypatch.setattr(port_spans, "_now", Ticks(7))


def _bare_messages(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"payload": {"action": rng.integers(0, 4, 8).astype(np.int32)},
             "priorities": rng.random(8).astype(np.float32),
             "n_trans": 8} for _ in range(n)]


def _lifecycle(spans_mod, msgs: list[dict]) -> list[dict]:
    """One pass of every stamping call over ``msgs`` (in place)."""
    for i, msg in enumerate(msgs):
        if i % 2 == 0:
            msg[spans_mod.SPAN_KEY] = [spans_mod.new_span(hop="sealed")]
        spans_mod.mark_send(msg, param_version=10 + i)
        spans_mod.stamp(msg, "recv")
        spans_mod.stamp(msg, "recv")            # first wins
    merged = spans_mod.merge_spans(msgs[:3])
    spans_mod.stamp_spans(merged, "stage")
    spans_mod.stamp_spans(spans_mod.spans_of(msgs[3]), "stage")
    spans_mod.stamp({"no": "spans"}, "consume")  # unstamped: a no-op
    spans_mod.stamp("not a dict", "consume")
    return [m.get(spans_mod.SPAN_KEY) for m in msgs] + [merged]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_stamping_equals_jax(same_clocks, seed):
    port = _lifecycle(port_spans, _bare_messages(seed, 5))
    ref = _lifecycle(jax_spans, _bare_messages(seed, 5))
    assert port == ref
    assert port_spans.HOPS == jax_spans.HOPS
    assert port_spans.SPAN_KEY == jax_spans.SPAN_KEY == "obs_spans"
    merged = port[-1]
    assert len(merged) == 3 and all("merge" in s["hops"] for s in merged)
    assert [s["pv"] for s in merged] == [10, 11, 12]


@pytest.mark.parametrize("value", ["0", "false", "no", "1", ""])
def test_spans_disabled_by_env_as_in_jax(monkeypatch, value):
    monkeypatch.setenv("APEX_OBS_SPANS", value)
    assert port_spans.enabled() == jax_spans.enabled()
    msg, jmsg = _bare_messages(3, 1)[0], _bare_messages(3, 1)[0]
    port_spans.mark_send(msg, 4)
    jax_spans.mark_send(jmsg, 4)
    assert (port_spans.SPAN_KEY in msg) == (jax_spans.SPAN_KEY in jmsg)
    assert (port_spans.SPAN_KEY in msg) == (value not in ("0", "false",
                                                          "no"))


def _chunk_messages(drain, seed: int):
    """Frame-chunk messages of one seeded episode stream, drained by
    ``drain`` (the port's or the JAX package's)."""
    from apex_tpu_torch.replay.frame_chunks import FrameChunkBuilder

    rng = np.random.default_rng(seed)
    b = FrameChunkBuilder(3, 0.99, 4, (6, 6, 1), chunk_transitions=8)
    out = []
    b.begin_episode(rng.integers(0, 255, (6, 6, 1)).astype(np.uint8))
    for t in range(50):
        b.add_step(int(rng.integers(3)), float(rng.random()),
                   rng.normal(size=3).astype(np.float32),
                   rng.integers(0, 255, (6, 6, 1)).astype(np.uint8),
                   t == 49, False)
        out.extend(drain(b))
    return out


def test_builder_drains_stamp_sealed_as_jax(same_clocks):
    from apex_tpu.actors.pool import drain_builder_chunks as jax_drain
    from apex_tpu_torch.replay.frame_chunks import drain_builder_chunks

    port = _chunk_messages(drain_builder_chunks, 5)
    ref = _chunk_messages(jax_drain, 5)
    assert len(port) == len(ref) >= 5
    for m, r in zip(port, ref):
        assert m["obs_spans"] == r["obs_spans"]
        assert list(m["obs_spans"][0]["hops"]) == ["sealed"]
        assert "obs_spans" not in m["payload"]
        for key, value in r["payload"].items():
            assert np.array_equal(m["payload"][key], value), key


def test_r2d2_groups_stamp_sealed_as_jax(same_clocks):
    from apex_tpu.actors.r2d2 import drain_grouped as jax_grouped
    from apex_tpu_torch.actors.r2d2 import drain_grouped

    def make(x):
        return {"payload": {"x": np.asarray([s["x"] for s in x])}}

    ready = [{"x": i} for i in range(7)]
    jready = copy.deepcopy(ready)
    port = drain_grouped(ready, 3, make)
    ref = jax_grouped(jready, 3, make)
    assert len(port) == len(ref) == 2 and len(ready) == len(jready) == 1
    assert [m["obs_spans"] for m in port] == [m["obs_spans"] for m in ref]


# -- histograms and the learner join -------------------------------------------

@pytest.mark.parametrize("seed,window", [(0, 16), (1, 4096), (2, 3)])
def test_latency_histogram_equals_jax(seed, window):
    vals = np.random.default_rng(seed).exponential(0.05, 257)
    port, ref = (port_spans.LatencyHistogram(window),
                 jax_spans.LatencyHistogram(window))
    for v in vals:
        port.record(v)
        ref.record(v)
    assert port.snapshot() == ref.snapshot()
    assert port_spans.LatencyHistogram().snapshot() == \
        jax_spans.LatencyHistogram().snapshot()


def _span_stream(seed: int, n: int) -> list[list[dict]]:
    """Groups of spans as a learner consumes them: versions, hops in
    order, some without ``sealed``, some of an unpublished version."""
    rng = np.random.default_rng(seed)
    groups = []
    wall = 1.7e9 - 100.0        # sealed before the learner's clock
    for _ in range(n):
        group = []
        for _ in range(int(rng.integers(1, 4))):
            wall += float(rng.uniform(0.0, 0.2))
            hops = {}
            t = wall
            for hop in ("sealed", "send", "recv", "stage"):
                if hop == "sealed" and rng.random() < 0.2:
                    continue
                t += float(rng.uniform(0.0, 0.05))
                hops[hop] = (t - 1.6e9, t)
            group.append({"pv": int(rng.integers(0, 12)), "hops": hops})
        groups.append(group)
    return groups


def _run_learner_obs(mod, ring_mod, seed: int):
    clock = Ticks(seed + 100, mono0=5.0, wall0=1.7e9 + 5.0)
    ring = ring_mod.TraceRing("learner", enabled=True)
    ring._anchor_wall, ring._anchor_perf = 1.7e9, 50.0
    obs = mod.LearnerObs(ring=ring, max_versions=6,
                         clock=lambda: clock.mono, wall=lambda: clock.wall)
    for version, group in enumerate(_span_stream(seed, 40)):
        clock()
        obs.note_publish(version // 3)
        obs.pre_consume(group)
        clock()
        obs.post_consume(group)
    obs.post_consume([])
    return obs, ring


def _events(ring) -> list[dict]:
    return [{k: v for k, v in ev.items() if k != "pid"}
            for ev in ring.to_chrome()["traceEvents"]]


@pytest.mark.parametrize("seed", [0, 1])
def test_learner_obs_equals_jax(monkeypatch, seed):
    monkeypatch.setattr(jax_spans, "_now", Ticks(seed))
    monkeypatch.setattr(port_spans, "_now", Ticks(seed))
    port, pring = _run_learner_obs(port_spans, port_trace, seed)
    ref, jring = _run_learner_obs(jax_spans, jax_trace, seed)
    got = port.summary()
    hops = got.pop("hops_s")        # the port's own: one per hop pair
    assert got == ref.summary()
    assert set(hops) == {"sealed→send", "send→recv", "recv→stage",
                         "stage→consume", "consume→prio_wb"}
    lineage = [ev["name"] for ev in _events(pring) if ev.get("ph") == "X"]
    assert {pair: h["count"] for pair, h in hops.items()} == {
        pair: lineage.count(pair) for pair in hops}
    assert port.scalars() == ref.scalars()
    assert port.frame_age.count > 10 and port.param_lag.count > 10
    assert _events(pring) == _events(jring)
    names = {ev["name"] for ev in _events(pring) if ev.get("ph") == "X"}
    assert {"sealed→send", "stage→consume", "consume→prio_wb"} <= names


# -- the trace ring ------------------------------------------------------------

def _fill_ring(ring_mod, enabled=True, sample=1):
    ring = ring_mod.TraceRing("actor-3", enabled=enabled, capacity=32,
                              sample=sample)
    ring._anchor_wall, ring._anchor_perf = 1.7e9, 10.0
    rng = np.random.default_rng(11)
    for i in range(50):
        t = 10.0 + i * 0.01
        ring.complete(f"phase{i % 3}", t, float(rng.random()) * 1e-3,
                      track=("policy", "env", None)[i % 3],
                      args={"i": i} if i % 5 == 0 else None)
        ring.complete_wall("sealed→send", 1.7e9 + i, 0.002,
                           track="chunk-lineage", args={"pv": i})
    return ring


@pytest.mark.parametrize("enabled,sample", [(True, 1), (True, 3),
                                            (False, 1)])
def test_trace_ring_to_chrome_equals_jax(enabled, sample):
    port, ref = (_fill_ring(port_trace, enabled, sample),
                 _fill_ring(jax_trace, enabled, sample))
    got, want = port.to_chrome(), ref.to_chrome()
    assert got == want
    n = sum(1 for ev in got["traceEvents"] if ev["ph"] == "X")
    assert n == (min(32, 100 // sample) if enabled else 0)
    assert got["metadata"]["label"] == "actor-3"


def test_process_ring_dumps_to_the_trace_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("APEX_TRACE_DIR", raising=False)
    port_trace.reset_for_tests()
    try:
        stub = port_trace.get_ring()
        assert not stub.enabled and port_trace.dump_ring() is None
        port_trace.reset_for_tests()
        monkeypatch.setenv("APEX_TRACE_DIR", str(tmp_path))
        monkeypatch.setenv("APEX_TRACE_FLUSH_S", "0")
        port_trace.set_process_label("learner/x")
        ring = port_trace.get_ring()
        assert ring.enabled and ring.label == "learner/x"
        ring.instant("param_refresh", track="eval", args={"version": 3})
        path = port_trace.dump_ring()
        assert os.path.basename(path) == \
            f"trace-learner_x-{os.getpid()}.json"
        with open(path, encoding="utf-8") as fh:
            dumped = json.load(fh)
        assert [ev["name"] for ev in dumped["traceEvents"]
                if ev["ph"] == "i"] == ["param_refresh"]
    finally:
        port_trace.reset_for_tests()


# -- the merge tool ------------------------------------------------------------

def _fake_traces(seed: int) -> tuple[list[dict], dict]:
    rng = np.random.default_rng(seed)
    traces = []
    for i, label in enumerate(("learner", "actor-0", "actor-1",
                               "replay-0")):
        events = [{"ph": "M", "pid": 40 + i, "tid": 0,
                   "name": "process_name", "args": {"name": label}}]
        if i == 3:
            events = []                 # a file dumped without the row
        for j in range(6):
            events.append({"name": f"e{j}", "ph": "X", "pid": 40 + i,
                           "tid": 1000,
                           "ts": round(1.7e15 + float(rng.uniform(0, 1e7)),
                                       1),
                           "dur": round(float(rng.uniform(0, 1e4)), 1)})
        traces.append({"traceEvents": events,
                       "metadata": {"label": label}})
    summary = {"peers": [
        {"identity": "actor-0", "clock_offset_s": 0.25,
         "clock_offset_n": 9},
        {"identity": "actor-1", "clock_offset_s": -1.5,
         "clock_offset_n": 1},
        {"identity": "infer-0", "clock_offset_s": None}]}
    return traces, summary


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_traces_equals_jax(seed):
    traces, summary = _fake_traces(seed)
    assert port_merge.load_offsets(summary) == \
        jax_merge.load_offsets(summary)
    assert port_merge.offset_quality(summary) == \
        jax_merge.offset_quality(summary)
    offsets = port_merge.load_offsets(summary)
    got = port_merge.merge_traces(copy.deepcopy(traces), offsets)
    want = jax_merge.merge_traces(copy.deepcopy(traces), offsets)
    assert got == want
    assert got["metadata"]["merged_from"] == ["learner", "actor-0",
                                              "actor-1", "replay-0"]
    assert min(ev["ts"] for ev in got["traceEvents"] if "ts" in ev) == 0.0


def test_merge_dir_and_main_equal_jax(tmp_path, capsys):
    traces, summary = _fake_traces(2)
    for i, trace in enumerate(traces):
        (tmp_path / f"trace-p{i}.json").write_text(json.dumps(trace))
    (tmp_path / "fleet_summary.json").write_text(json.dumps(summary))
    got = port_merge.merge_dir(str(tmp_path), str(tmp_path / "a.json"))
    want = jax_merge.merge_dir(str(tmp_path), str(tmp_path / "b.json"))
    assert got == want
    assert got["metadata"]["offset_samples"] == {"actor-0": 9,
                                                 "actor-1": 1}
    assert port_merge.main([str(tmp_path)]) == 0
    assert "4 processes" in capsys.readouterr().out
    assert port_merge.main([str(tmp_path / "missing")]) == 1


# -- Prometheus text -----------------------------------------------------------

def _metric_sections(seed: int):
    rng = np.random.default_rng(seed)
    gauges = {"learner/loss": float(rng.random()), "1bad-name": 3,
              "nan": float("nan"), "none": None, "text": "x"}
    counters = {"learner_steps_total": int(rng.integers(1000)),
                "param_version": 7}
    hist = jax_spans.LatencyHistogram()
    for v in rng.exponential(0.1, 64):
        hist.record(v)
    histograms = {"frame_age_at_train_seconds": hist.snapshot(),
                  "param_propagation_lag_seconds": {"count": 0}}
    labeled = {"fleet_peer_up": [({"identity": 'ac"tor-0', "role": "actor"},
                                  1.0)],
               "empty": []}
    return gauges, counters, histograms, labeled


@pytest.mark.parametrize("seed", [0, 1])
def test_render_equals_jax_byte_for_byte(seed):
    g, c, h, lab = _metric_sections(seed)
    got = port_metrics.render(gauges=g, counters=c, histograms=h,
                              labeled=lab)
    want = jax_metrics.render(gauges=g, counters=c, histograms=h,
                              labeled=lab)
    assert got == want
    assert "apex_learner_loss" in got and "apex__1bad_name" in got
    assert port_metrics.render() == jax_metrics.render() == "\n"
    for name in ("learner/loss", "9x", "a.b-c"):
        assert port_metrics.sanitize(name) == jax_metrics.sanitize(name)


def test_render_fleet_and_scalar_tails_equal_jax():
    from collections import deque
    snapshot = {"metrics": {"alive": 2, "dead": 1, "hb_gap_p50_s": None},
                "peers": [
                    {"identity": "actor-0", "role": "actor",
                     "tenant": "", "state": "ALIVE", "fps": 12.5,
                     "chunks_sent": 4, "gauges": {"codec_ratio": 2.0,
                                                  "wire_bytes_out": 10}},
                    {"identity": "infer-0", "role": "infer",
                     "state": "DEAD", "gauges": None}]}
    got = port_metrics.render_fleet(snapshot)
    assert got == jax_metrics.render_fleet(snapshot)
    assert port_metrics.render(*got[:1], labeled=got[1]) == \
        jax_metrics.render(*got[:1], labeled=got[1])
    history = {"learner/loss": deque([(1, 0.5), (2, 0.25)]),
               "learner/empty": deque()}
    assert port_metrics.scalar_tails(history) == \
        jax_metrics.scalar_tails(history) == {"learner/loss": 0.25}


# -- profiling hooks -----------------------------------------------------------

def test_timers_record_into_a_ring():
    from apex_tpu_torch.utils.profiling import DispatchGapTimer, PhaseTimer

    ring = port_trace.TraceRing("actor-0", enabled=True)
    phase = PhaseTimer(ring=ring, track="actor-phases")
    with phase.phase("env_step"):
        time.sleep(0.001)
    gap = DispatchGapTimer(ring=ring, track="learner-hot-loop")
    gap.about_to_dispatch()             # no return yet: not a gap
    gap.dispatch_returned()
    gap.about_to_dispatch()
    events = [ev for ev in ring.to_chrome()["traceEvents"]
              if ev["ph"] == "X"]
    assert [ev["name"] for ev in events] == ["env_step", "host_gap"]
    assert events[0]["dur"] >= 1000.0
    assert gap.snapshot()["dispatches"] == 1
    assert phase.window()["fracs"]["env_step"] > 0


def test_profiler_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    from apex_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert files == [f"trace-{os.getpid()}.json"]
    with open(tmp_path / "prof" / files[0], encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(ev.get("name", "")) for ev in events)


# -- the ingest pipeline's hops ------------------------------------------------

class _ListPool:
    def __init__(self, msgs):
        self.msgs = list(msgs)

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self.msgs = self.msgs[:max_chunks], self.msgs[max_chunks:]
        return out


@pytest.mark.parametrize("merge", [False, True])
def test_pipeline_stamps_recv_merge_and_stage(monkeypatch, merge):
    from apex_tpu_torch.replay.frame_chunks import drain_builder_chunks
    from apex_tpu_torch.training.ingest_pipeline import (
        IngestPipeline, PipelineState, merge_chunk_messages)

    ring = port_trace.TraceRing("learner", enabled=True)
    monkeypatch.setattr(port_trace, "_RING", ring)
    msgs = _chunk_messages(drain_builder_chunks, 9)[:4]
    for i, msg in enumerate(msgs):
        port_spans.mark_send(msg, i)
    bare = copy.deepcopy(msgs)
    for msg in bare:
        del msg["obs_spans"]
    pipe = IngestPipeline(
        _ListPool(msgs), device="cpu", depth=8, merge_max=4,
        state_fn=lambda: PipelineState(train_eligible=not merge))
    pipe.start()
    try:
        slots, deadline = [], time.monotonic() + 10
        while sum(s.chunks for s in slots) < 4 \
                and time.monotonic() < deadline:
            slot = pipe.poll_slot(timeout=0.1)
            if slot is not None:
                slots.append(slot)
    finally:
        pipe.stop()
    spans = [s for slot in slots for s in slot.spans]
    assert [s["pv"] for s in spans] == [0, 1, 2, 3]
    want = {"sealed", "send", "recv", "stage"} | ({"merge"} if merge
                                                  else set())
    assert all(set(s["hops"]) == want for s in spans)
    if merge:
        assert [s.kind for s in slots] == ["merged"]
        ref = merge_chunk_messages(bare)
        for key, value in ref["payload"].items():
            assert np.array_equal(np.asarray(slots[0].payload[key]),
                                  np.asarray(value)), key
    # the staging thread's spans, in the process ring on its own track
    chrome = ring.to_chrome()["traceEvents"]
    track = {ev["tid"] for ev in chrome if ev["ph"] == "M"
             and ev["args"].get("name") == port_trace.STAGING_TRACK}
    staged = [ev["name"] for ev in chrome
              if ev["ph"] == "X" and ev["tid"] in track]
    assert staged.count("apex.ingest.stage") == len(slots)


# -- program spans -------------------------------------------------------------

@pytest.fixture
def fresh_spans(monkeypatch):
    """A disabled process ring and an empty profiled-span record."""
    from collections import deque

    ring = port_trace.TraceRing("learner", enabled=False)
    monkeypatch.setattr(port_trace, "_RING", ring)
    monkeypatch.setattr(port_trace, "_PROFILED", deque(maxlen=64))
    return ring


def _x_events(ring) -> list[tuple]:
    chrome = ring.to_chrome()["traceEvents"]
    tracks = {ev["tid"]: ev["args"]["name"] for ev in chrome
              if ev["ph"] == "M" and ev["name"] == "thread_name"}
    return [(ev["name"], tracks.get(ev["tid"])) for ev in chrome
            if ev["ph"] == "X"]


def test_span_with_no_profiler_and_no_ring_is_a_no_op(monkeypatch,
                                                      fresh_spans):
    import torch

    def entered(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    made = port_trace.span("apex.learner.sample", port_trace.LEARNER_TRACK)
    assert made is port_trace._NO_SPAN
    with made:
        torch.ones(3).add_(1)
    assert port_trace.profiled_spans() == []
    assert _x_events(fresh_spans) == []


def test_span_records_its_name_and_track_in_an_enabled_ring(monkeypatch,
                                                            fresh_spans):
    ring = port_trace.TraceRing("learner", enabled=True)
    monkeypatch.setattr(port_trace, "_RING", ring)
    with port_trace.span("apex.ingest.stage", port_trace.STAGING_TRACK):
        with port_trace.span("apex.anakin.rollout",
                             port_trace.STAGING_TRACK):
            time.sleep(0.001)
    with port_trace.span("apex.learner.poll", port_trace.LEARNER_TRACK):
        pass
    assert _x_events(ring) == [
        ("apex.anakin.rollout", "ingest-staging"),
        ("apex.ingest.stage", "ingest-staging"),
        ("apex.learner.poll", "learner-hot-loop")]
    assert port_trace.profiled_spans() == []      # no profiler ran


def test_span_under_the_profiler_is_a_range_and_a_profiled_span(
        fresh_spans):
    """A CPU profiler started with ``.start()``: the span is a user
    range of the trace, and the in-memory record starts within 5 ms of
    it on the same clock."""
    import threading

    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        for _ in range(3):
            with port_trace.span("apex.learner.loss",
                                 port_trace.LEARNER_TRACK):
                torch.ones(8).sum()
    finally:
        prof.stop()
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results
                    .events() if e.name() == "apex.learner.loss"
                    and e.is_user_annotation())
    spans = port_trace.profiled_spans()
    assert len(ranges) == len(spans) == 3
    me = threading.current_thread().name
    for (name, thread, s, t), r in zip(spans, ranges):
        assert (name, thread) == ("apex.learner.loss", me)
        assert s <= t and abs(s - r) < 5_000_000
    assert _x_events(fresh_spans) == []           # the ring is off


def test_a_profiler_stopped_inside_open_spans_raises_nothing(fresh_spans):
    """The benchmark stops its profiler inside a learner dispatch: the
    spans still open exit cleanly, and the next span is off."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with port_trace.span("apex.learner.dispatch", port_trace.LEARNER_TRACK):
        with port_trace.span("apex.learner.sample",
                             port_trace.LEARNER_TRACK):
            prof.stop()
            torch.ones(2).sum()
    assert [s[0] for s in port_trace.profiled_spans()] == [
        "apex.learner.sample", "apex.learner.dispatch"]
    assert port_trace.span("apex.learner.loss") is port_trace._NO_SPAN


def test_the_trace_module_spans_without_torch():
    """A fresh interpreter: ``obs.trace`` imports, and its spans run,
    without loading torch."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from apex_tpu_torch.obs import trace\n"
            "with trace.span('apex.learner.poll', trace.LEARNER_TRACK):\n"
            "    pass\n"
            "print(trace.profiled_spans(), 'torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items()
           if k != port_trace.TRACE_DIR_ENV}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] False"


def test_learner_obs_hop_histograms_read_the_p50_of_given_clocks():
    """Spans with every hop given: each consecutive pair's histogram holds
    its wall-clock differences, the ``send→recv`` p50 the nearest-rank
    median of the ring waits."""
    waits = [0.010, 0.030, 0.020, 0.050, 0.040]
    obs = port_spans.LearnerObs(clock=lambda: 5.0, wall=lambda: 2000.0)
    for i, wait in enumerate(waits):
        t = {"sealed": 1000.0 + i}
        t["send"] = t["sealed"] + 0.001
        t["recv"] = t["send"] + wait
        t["stage"] = t["recv"] + 0.002
        t["consume"] = t["stage"] + 0.004
        t["prio_wb"] = t["consume"] + 0.008
        obs.post_consume([{"pv": 0, "hops": {h: (0.0, v)
                                             for h, v in t.items()}}])
    hops = obs.summary()["hops_s"]
    assert list(hops) == ["sealed→send", "send→recv", "recv→stage",
                          "stage→consume", "consume→prio_wb"]
    assert all(h["count"] == len(waits) for h in hops.values())
    assert hops["send→recv"]["p50_s"] == pytest.approx(0.030, abs=1e-6)
    assert hops["send→recv"]["max_s"] == pytest.approx(0.050, abs=1e-6)
    for pair, gap in (("sealed→send", 0.001), ("recv→stage", 0.002),
                      ("stage→consume", 0.004), ("consume→prio_wb", 0.008)):
        assert hops[pair]["p50_s"] == pytest.approx(gap, abs=1e-6), pair


def test_learner_obs_hops_between_keep_to_the_chunks_consumed_within():
    """``summary(between=(lo, hi))``: each hop pair's snapshot over the
    chunks consumed at wall times in ``[lo, hi]`` alone; without it, over
    every chunk; the headline histograms stay whole either way."""
    wall = [0.0]
    obs = port_spans.LearnerObs(clock=lambda: 5.0, wall=lambda: wall[0])
    for at, wait in ((99.0, 4.0), (100.0, 0.010), (100.5, 0.030),
                     (101.0, 0.020), (102.0, 6.0)):
        wall[0] = at
        obs.post_consume([{"pv": 0, "hops": {"sealed": (0.0, at - 9.0),
                                             "send": (0.0, 50.0),
                                             "recv": (0.0, 50.0 + wait)}}])
    inside = obs.summary(between=(100.0, 101.0))
    hop = inside["hops_s"]["send→recv"]
    assert hop["count"] == 3 and hop["max_s"] == pytest.approx(0.030)
    assert hop["p50_s"] == pytest.approx(0.020)
    assert obs.summary()["hops_s"]["send→recv"]["count"] == 5
    assert obs.summary(between=(0.0, 1.0))["hops_s"]["send→recv"] == \
        port_spans.LatencyHistogram().snapshot()
    assert inside["frame_age_at_train_s"] == \
        obs.summary()["frame_age_at_train_s"]
