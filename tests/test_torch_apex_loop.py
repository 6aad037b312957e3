"""The port's concurrent Ape-X trainer against ``apex_tpu``'s.

* The serial drain: one fixed list of chunk messages goes, through an
  in-process stub pool, into the JAX trainer and into the port's, both
  with ``ingest_pipeline=False``.  Both loops see the same clock, a fake one that
  moves only when a loop sleeps, so the publish cadence is a function of
  the step count alone.  They must take the same learner steps, ingest
  the same transitions, publish the same number of times and make the
  same fused, train-only, ingest-only and scan dispatches, across the
  replay-ratio cap and floor and ``scan_steps`` 1 and 4.
* A real run: ``ApexTrainer(device="cpu")`` with its default ingest
  pipeline and 2 spawned actor processes of 2 envs each on
  ``ApexCatchSmall-v0`` takes 20 steps over the shared-memory ring,
  publishes params the actors act on, and leaves no process and no
  segment behind, also when ``train()`` raises.
"""

import collections
import copy
import os

import numpy as np
import pytest
import torch

from apex_tpu.config import ActorConfig as JaxActorConfig
from apex_tpu.config import ApexConfig as JaxApexConfig
from apex_tpu.config import EnvConfig as JaxEnvConfig
from apex_tpu.config import LearnerConfig as JaxLearnerConfig
from apex_tpu.config import ReplayConfig as JaxReplayConfig
from apex_tpu.training import apex as jax_apex
from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig)
from apex_tpu_torch.native.ring import SEGMENT_PREFIX
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.training import apex as port_apex
from apex_tpu_torch.training.apex import ApexTrainer

ENV = "ApexCatchSmall-v0"
B, K = 16, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores: this
    file's torch ops take one thread each (single-threaded ops compute
    the same values)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class FakeClock:
    """``time.monotonic``/``time.sleep`` for both trainers' modules: the
    clock moves only when a loop sleeps (the replay-ratio cap), so
    ``max_seconds`` bounds the idle iterations."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


class StubPool:
    """A deterministic in-process chunk source with the pool interface
    the trainers drive."""

    def __init__(self, msgs):
        self._msgs = list(msgs)
        self.procs = []
        self.published = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        self.published.append(version)

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        return out


def _messages(n, seed=0):
    rng = np.random.default_rng(seed)
    b = FrameChunkBuilder(3, 0.99, 4, (42, 42, 1), chunk_transitions=K)
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
    """One JAX trainer for every case (its jitted steps compile once);
    :func:`_run_jax` resets what a case reads."""
    cfg = JaxApexConfig(
        env=JaxEnvConfig(env_id=ENV, seed=5),
        replay=JaxReplayConfig(capacity=512, warmup=64),
        learner=JaxLearnerConfig(batch_size=B, compute_dtype="float32",
                                 target_update_interval=7,
                                 publish_interval=5, scan_steps=4,
                                 ingest_pipeline=False),
        actor=JaxActorConfig(send_interval=K))
    trainer = jax_apex.ApexTrainer(cfg, pool=StubPool([]),
                                   publish_min_seconds=0.0,
                                   respawn_workers=False)
    trainer.counts = collections.Counter()
    for attr, name in (("_fused", "fused"), ("_train", "train"),
                       ("_ingest", "ingest"), ("_multi", "scan")):
        setattr(trainer, attr,
                _counted(trainer.counts, name, getattr(trainer, attr)))
    return trainer


def _run_jax(trainer, msgs, scan_steps, knobs, total_steps):
    from apex_tpu.utils.metrics import RateCounter

    trainer.pool = pool = StubPool(copy.deepcopy(msgs))
    trainer.scan_steps = scan_steps        # 1: every poll asks for 1 chunk
    trainer.train_ratio = knobs.get("train_ratio")
    trainer.min_train_ratio = knobs.get("min_train_ratio")
    trainer.replay_state = trainer.replay.init()
    trainer.steps_rate, trainer.frames_rate = RateCounter(), RateCounter()
    trainer.ingested = trainer.param_version = trainer._last_log = 0
    trainer.counts.clear()
    trainer.train(total_steps=total_steps, max_seconds=1.0,
                  log_every=10 ** 9)
    return pool, dict(trainer.counts)


def _run_port(msgs, scan_steps, knobs, total_steps):
    cfg = ApexConfig(
        env=EnvConfig(env_id=ENV, seed=5),
        replay=ReplayConfig(capacity=512, warmup=64),
        learner=LearnerConfig(batch_size=B, compute_dtype="float32",
                              target_update_interval=7, publish_interval=5,
                              scan_steps=scan_steps, ingest_pipeline=False),
        actor=ActorConfig(send_interval=K))
    pool = StubPool(copy.deepcopy(msgs))
    trainer = ApexTrainer(cfg, pool=pool, device="cpu",
                          publish_min_seconds=0.0, respawn_workers=False,
                          **knobs)
    trainer.train(total_steps=total_steps, max_seconds=1.0,
                  log_every=10 ** 9)
    return trainer, pool


@pytest.mark.parametrize("scan_steps", [1, 4])
@pytest.mark.parametrize("knobs", [
    {},                                           # uncapped
    {"train_ratio": 0.5},                         # the cap binds
    {"train_ratio": 2.0, "min_train_ratio": 1.0},   # the floor binds
], ids=["open", "cap", "band"])
def test_serial_drain_counts_equal_jax(monkeypatch, jax_trainer, scan_steps,
                                      knobs):
    clock = FakeClock()
    monkeypatch.setattr(jax_apex, "time", clock)
    monkeypatch.setattr(port_apex, "time", clock)
    msgs = _messages(24)
    jt = jax_trainer
    jpool, counts = _run_jax(jt, msgs, scan_steps, knobs, total_steps=30)
    clock.now = 0.0
    pt, pool = _run_port(msgs, scan_steps, knobs, total_steps=30)

    assert pt.steps == jt.steps_rate.total > 0
    assert pt.ingested == jt.ingested == sum(m["n_trans"] for m in msgs)
    assert pt.param_version == jt.param_version > 1
    assert pool.published == jpool.published
    assert pt.dispatches == {name: counts.get(name, 0) for name in
                             ("fused", "train", "ingest", "scan")}
    assert pt.train_state.step == pt.steps
    if scan_steps > 1 and "train_ratio" not in knobs:
        assert pt.dispatches["scan"] > 0
    if knobs.get("train_ratio") == 0.5:
        assert pt.steps == pt.ingested * 0.5 // B < 30


def _segments():
    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-"))


def test_apex_trainer_trains_with_actor_processes_over_the_ring():
    cfg = ApexConfig(
        env=EnvConfig(env_id=ENV, seed=5),
        replay=ReplayConfig(capacity=1024, warmup=64),
        learner=LearnerConfig(batch_size=B, compute_dtype="float32",
                              publish_interval=5),
        actor=ActorConfig(n_actors=2, n_envs_per_actor=2, send_interval=K,
                          update_interval=8, timing_interval=8))
    trainer = ApexTrainer(cfg, device="cpu", publish_min_seconds=0.05)
    assert _segments() == []                   # nothing made before train()
    trainer.train(total_steps=20, max_seconds=60)
    pool = trainer.pool
    assert trainer.steps == trainer.train_state.step == 20
    assert trainer.ingested >= cfg.replay.warmup
    assert pool.chunk_plane == "shm"
    assert trainer.param_version >= 2
    versions = [v for _, v in
                trainer.log.history["learner/episode_param_version"]]
    assert versions and min(versions) >= 1
    assert sum(trainer.dispatches.values()) > 0
    # the whole warm-up went in ingest-only dispatches, a merged slot's
    # chunks counted one by one
    stats = trainer._pipeline_last_stats
    assert stats["slots"] > 0 and stats["publishes"] >= 1
    ingest_chunks = (trainer.dispatches["ingest"] - stats["merged_slots"]
                     + stats["merged_chunks"])
    assert ingest_chunks * K >= cfg.replay.warmup
    assert not any(p.is_alive() for p in pool.procs)
    assert _segments() == []
    score = trainer.evaluate(episodes=2)
    assert -3.0 <= score <= 3.0

    # a learner fault mid-run still stops every worker and frees the ring
    def boom(*args, **kwargs):
        raise RuntimeError("learner fault")

    trainer.core = type(trainer.core)(
        replay=trainer.replay, optimizer=trainer.core.optimizer,
        batch_size=B, target_update_interval=7)
    object.__setattr__(trainer.core, "ingest", boom)
    object.__setattr__(trainer.core, "fused_step", boom)
    object.__setattr__(trainer.core, "train_step", boom)
    with pytest.raises(RuntimeError, match="learner fault"):
        trainer.train(total_steps=5, max_seconds=60)
    assert not any(p.is_alive() for p in pool.procs)
    assert _segments() == []
