"""The port's ingest pipeline against ``apex_tpu``'s, and against its own
serial drain.

* ``merge_chunk_messages``: the port's merge equals the JAX one on the
  same messages, with and without per-transition sidecars (``extras``,
  the AQL family's candidate sets), and a merged add equals sequential
  adds in the port's frame pool, across ring wraparound.
* Pipeline mechanics on a scripted pool: backpressure while behind and the
  ring bound of ``(depth + 1) * merge_max`` chunks, publishes through the
  staging thread (the values from before a later in-place update), the
  staging thread's death surfacing in the trainer, host-int scalars,
  sidecars staged as tensors; the constructor's ``"cuda"`` default
  refusing a missing card.
* The trainer: pipelined and serial runs of one chunk stream end with
  bit-identical params and replay (``scan_steps`` 1 and 4); the port's
  pipelined counters equal the JAX pipelined trainer's; the gate.
"""

import collections
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from apex_tpu.actors.pool import drain_builder_chunks as jax_drain
from apex_tpu.config import ActorConfig as JaxActorConfig
from apex_tpu.config import ApexConfig as JaxApexConfig
from apex_tpu.config import EnvConfig as JaxEnvConfig
from apex_tpu.config import LearnerConfig as JaxLearnerConfig
from apex_tpu.config import ReplayConfig as JaxReplayConfig
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu.training import apex as jax_apex
from apex_tpu.training.ingest_pipeline import \
    merge_chunk_messages as jax_merge
from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig,
                                   small_test_config)
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training import apex as port_apex
from apex_tpu_torch.training.apex import ApexTrainer
from apex_tpu_torch.training.ingest_pipeline import (IngestPipeline,
                                                     PipelineState,
                                                     is_frame_chunk,
                                                     merge_chunk_messages)

FRAME_SHAPE = (3,)
STACK = 2
K = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


EXTRA = (5, 2)                   # one a_mu sidecar row: T=5 candidates of A=2


def _chunk_messages(seed, n_chunks, builder_cls=FrameChunkBuilder,
                    drain=drain_builder_chunks, k=K, extras=False):
    """Random episodes through a real chunk builder until it has emitted
    ``n_chunks`` messages; with ``extras``, each transition carries an
    ``a_mu`` sidecar of shape :data:`EXTRA`."""
    rng = np.random.default_rng(seed)
    builder = builder_cls(2, 0.9, STACK, FRAME_SHAPE, chunk_transitions=k,
                          frame_margin=4, frame_dtype=np.uint8,
                          extra_shapes={"a_mu": EXTRA} if extras else None)
    msgs = []
    while len(msgs) < n_chunks:
        builder.begin_episode(rng.integers(0, 255, FRAME_SHAPE))
        ep_len = int(rng.integers(1, 3 * k))
        for t in range(ep_len):
            builder.add_step(int(rng.integers(0, 4)), float(rng.normal()),
                             rng.normal(size=4).astype(np.float32),
                             rng.integers(0, 255, FRAME_SHAPE),
                             terminated=t == ep_len - 1, truncated=False,
                             extras=({"a_mu": rng.normal(size=EXTRA).astype(
                                 np.float32)} if extras else None))
        msgs.extend(drain(builder))
    return msgs[:n_chunks]


def _pool_spec(extras=False):
    return FramePoolReplay(capacity=64, frame_shape=FRAME_SHAPE,
                           frame_stack=STACK, frame_capacity=128,
                           frame_dtype="uint8",
                           extra_spec=(("a_mu", EXTRA),) if extras else ())


def _assert_pool_states_equal(a, b):
    for name in ("frames", "action", "reward", "discount", "obs_ids",
                 "next_ids", "frame_epoch", "sum_tree", "min_tree",
                 "max_priority"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.pos, a.f_epoch, a.size) == (b.pos, b.f_epoch, b.size)
    assert a.extras.keys() == b.extras.keys()
    for name in a.extras:
        assert torch.equal(a.extras[name], b.extras[name]), name


# -- merging -----------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 3, 8])
def test_merge_equals_jax(monkeypatch, m):
    monkeypatch.setenv("APEX_OBS_SPANS", "0")      # the port ships no spans
    msgs = _chunk_messages(m, m, JaxBuilder, jax_drain)
    want = jax_merge(copy.deepcopy(msgs))
    got = merge_chunk_messages(copy.deepcopy(msgs))
    assert got.keys() == want.keys() == {"payload", "priorities", "n_trans"}
    assert got["n_trans"] == want["n_trans"] == sum(x["n_trans"] for x in msgs)
    np.testing.assert_array_equal(got["priorities"], want["priorities"])
    assert got["payload"].keys() == want["payload"].keys()
    for name, value in want["payload"].items():
        assert got["payload"][name].dtype == value.dtype, name
        np.testing.assert_array_equal(got["payload"][name], value, name)


@pytest.mark.parametrize("m", [2, 5])
def test_merge_with_sidecars_equals_jax(monkeypatch, m):
    """Frame chunks with an ``a_mu`` sidecar (the pixel AQL family's): the
    sidecar rows merge bit-equal to JAX's, real rows compacted and the
    tail padded with the last real row."""
    monkeypatch.setenv("APEX_OBS_SPANS", "0")
    msgs = _chunk_messages(10 + m, m, JaxBuilder, jax_drain, extras=True)
    want = jax_merge(copy.deepcopy(msgs))["payload"]
    got = merge_chunk_messages(copy.deepcopy(msgs))["payload"]
    assert got.keys() == want.keys() and "extras" in got
    assert got["extras"].keys() == want["extras"].keys() == {"a_mu"}
    assert got["extras"]["a_mu"].shape == (m * K,) + EXTRA
    assert got["extras"]["a_mu"].dtype == np.float32
    np.testing.assert_array_equal(got["extras"]["a_mu"],
                                  want["extras"]["a_mu"])
    for name, value in want.items():
        if name != "extras":
            np.testing.assert_array_equal(got[name], value, name)


def _merged_vs_sequential_adds(extras: bool) -> None:
    """add(merge(c1..cm)) equals add(c1); ...; add(cm) on every field,
    over a stream long enough to wrap both rings."""
    msgs = _chunk_messages(7, 30, extras=extras)
    pool = _pool_spec(extras)
    seq, one = pool.init("cpu"), pool.init("cpu")
    widths, i, w = [3, 1, 4, 2, 5], 0, 0
    while i < len(msgs):
        take = msgs[i:i + widths[w % len(widths)]]
        w += 1
        i += len(take)
        for msg in take:
            pool.add(seq, msg["payload"], msg["priorities"])
        merged = merge_chunk_messages(copy.deepcopy(take))
        pool.add(one, merged["payload"], merged["priorities"])
        _assert_pool_states_equal(seq, one)
    assert seq.f_epoch > pool.f_capacity and seq.size == pool.capacity


def test_merged_add_equals_sequential_adds_across_wraparound():
    _merged_vs_sequential_adds(extras=False)


def test_merged_add_with_sidecars_equals_sequential_adds():
    """The same with an ``a_mu`` sidecar on every transition: the merged
    sidecar rows land in the cells the sequential adds write."""
    _merged_vs_sequential_adds(extras=True)


def test_merge_is_schema_gated():
    assert is_frame_chunk(_chunk_messages(1, 1)[0]["payload"])
    assert not is_frame_chunk({"obs": 1, "action": 2})
    assert not is_frame_chunk([1, 2])
    with pytest.raises(ValueError, match="uniform"):
        merge_chunk_messages([_chunk_messages(1, 1)[0],
                              _chunk_messages(2, 1, k=4)[0]])


# -- pipeline mechanics --------------------------------------------------------

class ScriptedPool:
    """A deterministic in-process chunk source with the pool interface
    the trainers drive; counts what it hands out.  An empty poll waits out
    its timeout, as a real queue's does (a staging thread spinning on an
    empty pool would starve the trainer's thread of the GIL)."""

    def __init__(self, msgs):
        self._msgs = list(msgs)
        self.procs = []
        self.polled = 0
        self.published = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        self.published.append((version, params))

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        self.polled += len(out)
        if not out and timeout:
            time.sleep(timeout)
        return out


def test_backpressure_while_behind_and_the_ring_bound():
    """The replay-ratio floor pauses draining; without it the bounded ring
    caps what the pipeline buffers ahead; draining the ring then delivers
    every transition in order."""
    msgs = _chunk_messages(3, 64)
    pool = ScriptedPool(msgs)
    state = {"behind": True}
    pipe = IngestPipeline(
        pool, device="cpu", depth=2, merge_max=4,
        state_fn=lambda: PipelineState(behind=state["behind"],
                                       train_eligible=False),
        capacity=1 << 20, frame_capacity=1 << 20)
    pipe.start()
    try:
        time.sleep(0.3)
        assert pool.polled == 0
        state["behind"] = False
        time.sleep(0.5)
        bound = (2 + 1) * 4      # depth slots of merge_max + one in flight
        assert 0 < pool.polled <= bound < len(msgs)
        seen = []
        while (slot := pipe.poll_slot(timeout=0.2)) is not None:
            seen.append(slot)
        assert {s.kind for s in seen} == {"merged"}
        assert sum(s.n_trans for s in seen) == sum(m["n_trans"] for m in msgs)
        assert pipe.polled_total() == sum(m["n_trans"] for m in msgs)
    finally:
        pipe.stop()


def test_publish_rides_the_staging_thread_with_the_values_it_was_given():
    pool = ScriptedPool([])
    pipe = IngestPipeline(pool, device="cpu")
    pipe.start()
    try:
        weights = torch.arange(4, dtype=torch.float32)
        pipe.publish(3, {"w": weights.clone()})
        weights.add_(100.0)                  # a later in-place update
        deadline = time.monotonic() + 5.0
        while not pool.published and time.monotonic() < deadline:
            time.sleep(0.01)
        (version, params), = pool.published
        assert version == 3 and pipe.stats["publishes"] == 1
        assert isinstance(params["w"], np.ndarray)
        np.testing.assert_array_equal(params["w"], [0.0, 1.0, 2.0, 3.0])
    finally:
        pipe.stop()


def test_staging_thread_death_surfaces_to_the_trainer():
    class ExplodingPool(ScriptedPool):
        def poll_chunks(self, max_chunks, timeout=0.0):
            raise RuntimeError("decode blew up")

    pipe = IngestPipeline(ExplodingPool([]), device="cpu")
    pipe.start()
    try:
        with pytest.raises(RuntimeError, match="staging thread died") as err:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                pipe.poll_slot(timeout=0.05)
        assert "decode blew up" in str(err.value.__cause__)
    finally:
        pipe.stop()

    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    trainer = ApexTrainer(cfg, pool=ExplodingPool([]), device="cpu",
                          respawn_workers=False)
    with pytest.raises(RuntimeError, match="staging thread died"):
        trainer.train(total_steps=5, max_seconds=30)


@pytest.mark.parametrize("train_eligible,scan_steps,kind", [
    (True, 1, "single"), (True, 4, "scan"), (False, 1, "merged")])
def test_staged_chunk_scalars_stay_host_ints(train_eligible, scan_steps,
                                             kind):
    """``n_frames``/``n_trans`` stay Python ints (the replay reads them
    on the host); every array is a tensor."""
    msgs = _chunk_messages(5, 8)
    pipe = IngestPipeline(ScriptedPool(msgs), device="cpu",
                          scan_steps=scan_steps,
                          state_fn=lambda: PipelineState(
                              train_eligible=train_eligible))
    pipe.start()
    try:
        slot = pipe.poll_slot(timeout=5.0)
    finally:
        pipe.stop()
    assert slot.kind == kind and slot.chunks > 1 - (kind == "single")
    payloads = slot.payload if kind == "scan" else [slot.payload]
    prios = slot.prios if kind == "scan" else [slot.prios]
    for payload, p in zip(payloads, prios):
        assert type(payload["n_frames"]) is int
        assert type(payload["n_trans"]) is int
        assert all(isinstance(v, torch.Tensor) for name, v in payload.items()
                   if name not in ("n_frames", "n_trans"))
        assert p.dtype == torch.float32
    assert slot.ready is None and slot.tensors == ()    # nothing to wait on


@pytest.mark.parametrize("train_eligible,scan_steps,kind", [
    (True, 1, "single"), (True, 2, "scan"), (False, 1, "merged")])
def test_staged_sidecars_are_tensors(train_eligible, scan_steps, kind):
    """A chunk's nested ``extras`` dict is staged as a dict of tensors
    (each slot kind), rows intact, so the frame pool's add takes it."""
    msgs = _chunk_messages(6, 8, extras=True)
    pipe = IngestPipeline(ScriptedPool(copy.deepcopy(msgs)), device="cpu",
                          scan_steps=scan_steps,
                          state_fn=lambda: PipelineState(
                              train_eligible=train_eligible))
    pipe.start()
    try:
        slot = pipe.poll_slot(timeout=5.0)
    finally:
        pipe.stop()
    assert slot.kind == kind
    payloads = slot.payload if kind == "scan" else [slot.payload]
    for payload in payloads:
        a_mu = payload["extras"]["a_mu"]
        assert isinstance(a_mu, torch.Tensor) and a_mu.dtype == torch.float32
        assert a_mu.shape[1:] == EXTRA
    if kind != "merged":
        np.testing.assert_array_equal(payloads[0]["extras"]["a_mu"].numpy(),
                                      msgs[0]["payload"]["extras"]["a_mu"])
    pool = _pool_spec(extras=True)
    state = pool.init("cpu")
    pool.add(state, payloads[0], slot.prios[0] if kind == "scan"
             else slot.prios)
    assert bool(state.extras["a_mu"][:state.size].abs().sum() > 0)


def test_bare_construction_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the pipeline defaults to
    ``"cuda"`` and refuses a missing card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IngestPipeline(ScriptedPool([]))
    assert IngestPipeline(ScriptedPool([]),
                          device="cpu").device == torch.device("cpu")


# -- the trainer ----------------------------------------------------------------

def _cartpole_messages(n_chunks):
    """Chunks of small_test_config's ApexCartPole spec: (4,) f32 frames,
    stack 1."""
    rng = np.random.default_rng(0)
    builder = FrameChunkBuilder(3, 0.99, 1, (4,), chunk_transitions=16,
                                frame_dtype=np.float32)
    msgs = []
    while len(msgs) < n_chunks:
        builder.begin_episode(rng.normal(size=4).astype(np.float32))
        ep_len = int(rng.integers(4, 40))
        for t in range(ep_len):
            builder.add_step(int(rng.integers(0, 2)), float(rng.normal()),
                             rng.normal(size=2).astype(np.float32),
                             rng.normal(size=4).astype(np.float32),
                             terminated=t == ep_len - 1, truncated=False)
        msgs.extend(drain_builder_chunks(builder))
    return msgs[:n_chunks]


def _run_port(pipeline_on, msgs, total_steps, scan_steps):
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, warmup=64),
        learner=dataclasses.replace(cfg.learner, ingest_pipeline=pipeline_on,
                                    target_update_interval=20,
                                    scan_steps=scan_steps))
    trainer = ApexTrainer(cfg, pool=ScriptedPool(copy.deepcopy(msgs)),
                          device="cpu", publish_min_seconds=10.0,
                          respawn_workers=False)
    trainer.train(total_steps=total_steps, max_seconds=120,
                  log_every=10 ** 9)
    return trainer


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_pipelined_loop_is_bit_identical_to_the_serial_drain(scan_steps):
    """One chunk stream, across the warm-up (merged ingest), staged fused
    singles or scan stacks, and train-only steps after the stream ends:
    the same params, optimizer state and replay, bit for bit."""
    msgs = _cartpole_messages(24)                  # 384 transitions
    serial = _run_port(False, msgs, 40, scan_steps)
    piped = _run_port(True, msgs, 40, scan_steps)
    assert serial.steps == piped.steps == 40
    assert serial.ingested == piped.ingested == 384
    assert serial._pipeline_last_stats is None
    stats = piped._pipeline_last_stats
    assert stats["merged_chunks"] >= 2 and stats["publishes"] >= 1
    if scan_steps > 1:
        assert stats["scan_slots"] > 0 and piped.dispatches["scan"] > 0
    assert piped.dispatches["ingest"] < serial.dispatches["ingest"]
    for a, b in ((serial.train_state.params, piped.train_state.params),
                 (serial.train_state.target_params,
                  piped.train_state.target_params)):
        for (name, x), y in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(x, y), name
    for x, y in zip(serial.train_state.opt_state.nu,
                    piped.train_state.opt_state.nu):
        assert torch.equal(x, y)
    _assert_pool_states_equal(serial.replay_state, piped.replay_state)
    assert torch.equal(serial.generator.get_state(),
                       piped.generator.get_state())


class FakeClock:
    """``time.monotonic``/``time.sleep`` of the trainers' loops: moves only
    when a loop sleeps, so the publish cadence follows the steps."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


ENV, B, KC = "ApexCatchSmall-v0", 16, 16


def _catch_messages(n):
    rng = np.random.default_rng(0)
    b = FrameChunkBuilder(3, 0.99, 4, (42, 42, 1), chunk_transitions=KC)
    msgs = []
    while len(msgs) < n:
        b.begin_episode(rng.integers(0, 255, (42, 42, 1)).astype(np.uint8))
        length = int(rng.integers(5, 40))
        for t in range(length):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, (42, 42, 1)).astype(np.uint8),
                       t == length - 1, False)
        msgs.extend(drain_builder_chunks(b))
    return msgs[:n]


def _counted(counts, name, fn):
    def call(*args, **kwargs):
        counts[name] += 1
        return fn(*args, **kwargs)
    return call


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX pipelined trainer for both cases (its jitted steps compile
    once); the case resets what it reads."""
    cfg = JaxApexConfig(
        env=JaxEnvConfig(env_id=ENV, seed=5),
        replay=JaxReplayConfig(capacity=512, warmup=64),
        learner=JaxLearnerConfig(batch_size=B, compute_dtype="float32",
                                 target_update_interval=7,
                                 publish_interval=5, scan_steps=4,
                                 ingest_pipeline=True),
        actor=JaxActorConfig(send_interval=KC))
    trainer = jax_apex.ApexTrainer(cfg, pool=ScriptedPool([]),
                                   publish_min_seconds=0.0,
                                   respawn_workers=False)
    trainer.counts = collections.Counter()
    for attr, name in (("_fused", "fused"), ("_train", "train"),
                       ("_ingest", "ingest"), ("_multi", "scan")):
        setattr(trainer, attr,
                _counted(trainer.counts, name, getattr(trainer, attr)))
    return trainer


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_pipelined_counters_equal_the_jax_pipelined_trainer(
        monkeypatch, jax_trainer, scan_steps):
    """Every chunk ready in the pool from the start: both pipelines stage
    the same slots, so both trainers take the same steps, ingest the same
    transitions, publish as often and make the same dispatches."""
    from apex_tpu.utils.metrics import RateCounter

    monkeypatch.setenv("APEX_OBS_SPANS", "0")
    clock = FakeClock()
    monkeypatch.setattr(jax_apex, "time", clock)
    monkeypatch.setattr(port_apex, "time", clock)
    msgs = _catch_messages(24)
    jt = jax_trainer
    jt.pool = ScriptedPool(copy.deepcopy(msgs))
    jt.scan_steps = scan_steps
    jt.replay_state = jt.replay.init()
    jt.steps_rate, jt.frames_rate = RateCounter(), RateCounter()
    jt.ingested = jt.param_version = jt._last_log = 0
    jt.counts.clear()
    jt.train(total_steps=30, max_seconds=1.0, log_every=10 ** 9)

    clock.now = 0.0
    cfg = ApexConfig(
        env=EnvConfig(env_id=ENV, seed=5),
        replay=ReplayConfig(capacity=512, warmup=64),
        learner=LearnerConfig(batch_size=B, compute_dtype="float32",
                              target_update_interval=7, publish_interval=5,
                              scan_steps=scan_steps),
        actor=ActorConfig(send_interval=KC))
    pt = ApexTrainer(cfg, pool=ScriptedPool(copy.deepcopy(msgs)),
                     device="cpu", publish_min_seconds=0.0,
                     respawn_workers=False)
    pt.train(total_steps=30, max_seconds=1.0, log_every=10 ** 9)

    assert pt.steps == jt.steps_rate.total == 30
    assert pt.ingested == jt.ingested == sum(m["n_trans"] for m in msgs)
    assert pt.param_version == jt.param_version > 1
    assert pt.dispatches == {name: jt.counts.get(name, 0) for name in
                             ("fused", "train", "ingest", "scan")}
    for key in ("slots", "scan_slots", "merged_slots", "merged_chunks"):
        assert pt._pipeline_last_stats[key] == jt._pipeline_last_stats[key]
    assert pt._pipeline_last_stats["merged_chunks"] >= 2


def test_trainer_pipeline_gate():
    """On by default; ``ingest_pipeline=False`` keeps the serial drain,
    which stages nothing and publishes on the learner thread."""
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    assert cfg.learner.ingest_pipeline and LearnerConfig().ingest_pipeline
    msgs = _cartpole_messages(6)
    off = _run_port(False, msgs, 2, 1)
    on = _run_port(True, msgs, 2, 1)
    assert off._pipeline_last_stats is None and off._pipeline is None
    assert on._pipeline_last_stats["slots"] > 0 and on._pipeline is None
    assert off.pool.published[0][0] == on.pool.published[0][0] == 1
