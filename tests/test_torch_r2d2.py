"""The port's R2D2 drivers against ``apex_tpu``'s.

* Specs and geometry: model spec, storage layout and frame-ring size
  equal the JAX driver's.
* Fused steps: the port's ``R2D2Core`` and JAX's, from the same weights,
  messages and sample uniforms, over the pooled pixel layout and the
  stacked vector one: losses and gradient norms within rtol 1e-4, trees
  within rtol 1e-5, the weights after three updates within atol 1e-6.
* Worker families at epsilon 0 (greedy, so no random draw matters): the
  sequences the port's scalar and vector families ship equal JAX's;
  carries and Q-derived priorities to f32 round-off (rtol 1e-5).
* Drivers on the CPU: ``R2D2Trainer`` on the partially observable
  CartPole and on pooled pixels (one ``gather_rows`` per learner step),
  a checkpoint round trip that stays bit-equal over the following
  learner steps, ``evaluate_checkpoint`` on a recurrent spec, the ingest
  pipeline staging pooled messages as the serial drain ingests them, and
  ``R2D2ApexTrainer.train`` with one real actor process over the shm
  ring.
"""

import copy
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.config import R2D2Config as JaxR2D2Config
from apex_tpu.config import small_test_config as jax_small_config
from apex_tpu.models.recurrent import RecurrentDuelingDQN as FlaxR2D2
from apex_tpu.ops.losses import make_optimizer as jax_make_optimizer
from apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from apex_tpu.replay.seq_pool import SequenceFramePoolReplay as JaxSeqPool
from apex_tpu.training import r2d2 as jax_r2d2
from apex_tpu.training.state import TrainState as JaxTrainState
from apex_tpu_torch.actors import r2d2 as port_actors
from apex_tpu_torch.config import R2D2Config, small_test_config
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.models.recurrent import RecurrentDuelingDQN
from apex_tpu_torch.native.ring import SEGMENT_PREFIX
from apex_tpu_torch.ops.losses import make_optimizer
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay import seq_pool as seq_pool_module
from apex_tpu_torch.replay.device import DeviceReplay
from apex_tpu_torch.training import r2d2 as port_r2d2
from apex_tpu_torch.training.checkpoint import evaluate_checkpoint
from apex_tpu_torch.training.ingest_pipeline import (IngestPipeline,
                                                     PipelineState)
from apex_tpu_torch.training.state import create_train_state

BURN, UNROLL, NSTEP, H = 2, 4, 1, 8
T_TOTAL = BURN + UNROLL + NSTEP


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on a few cores: this
    file's torch ops take one thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(env_id="ApexCartPolePO-v0", frame_pool=False, capacity=256,
         batch_size=8, **learner):
    """The port's and JAX's small config with the test's sequence
    geometry."""
    out = []
    for small, r2d2_cls in ((small_test_config, R2D2Config),
                            (jax_small_config, JaxR2D2Config)):
        cfg = small(capacity=capacity, batch_size=batch_size, n_actors=1,
                    env_id=env_id)
        out.append(cfg.replace(
            replay=dataclasses.replace(cfg.replay, frame_pool=frame_pool),
            learner=dataclasses.replace(cfg.learner, n_steps=NSTEP,
                                        **learner),
            r2d2=r2d2_cls(burn_in=BURN, unroll=UNROLL, lstm_features=H)))
    return out


@pytest.mark.parametrize("env_id,frame_pool", [
    ("ApexCartPolePO-v0", False), ("ApexCatchSmall-v0", False),
    ("ApexCatchSmall-v0", True), ("ApexCatch-v0", True)])
def test_specs_layout_and_ring_size_match_jax(env_id, frame_pool):
    cfg, jcfg = _cfg(env_id, frame_pool)
    spec, shape, dtype = port_r2d2.r2d2_env_specs(cfg)
    jspec, jshape, jdtype = jax_r2d2.r2d2_env_specs(jcfg)
    assert (shape, np.dtype(dtype)) == (jshape, np.dtype(jdtype))
    for key in ("num_actions", "obs_is_image", "scale_uint8",
                "lstm_features"):
        assert spec[key] == jspec[key], key
    assert spec["compute_dtype"] == torch.float32
    assert spec["obs_shape"] == shape
    assert (port_r2d2.r2d2_uses_frame_pool(cfg, shape)
            == jax_r2d2.r2d2_uses_frame_pool(jcfg, jshape))
    for group, stride in ((4, None), (2, 3), (1, 7)):
        c = cfg.replace(r2d2=dataclasses.replace(
            cfg.r2d2, sequence_group=group, stride=stride))
        jc = jcfg.replace(r2d2=dataclasses.replace(
            jcfg.r2d2, sequence_group=group, stride=stride))
        assert (port_r2d2.r2d2_frame_capacity(c)
                == jax_r2d2.r2d2_frame_capacity(jc))


def test_full_width_geometry_and_the_budget():
    """The chip run's geometry: capacity 2^16 sequences at T = 27 holds a
    1 277 952-row ring within the 12 GB budget; the default 2^19 is
    refused before anything is allocated."""
    cfg = small_test_config(env_id="ApexCatch-v0", capacity=2 ** 16)
    cfg = cfg.replace(replay=dataclasses.replace(cfg.replay,
                                                 frame_pool=True))
    assert port_r2d2.r2d2_frame_capacity(cfg) == 1_277_952
    big = cfg.replace(replay=dataclasses.replace(cfg.replay,
                                                 capacity=2 ** 19))
    with pytest.raises(ValueError, match="budget"):
        port_r2d2.build_r2d2(big, torch.device("cpu"))


def _messages(cfg, n, seed=0, shape=None, pooled=False):
    """Grouped sequence messages of a synthetic episode stream."""
    shape = shape or (2,)
    rng = np.random.default_rng(seed)
    b = port_r2d2.SequenceBuilder(BURN, UNROLL, NSTEP, 0.99, pooled=pooled)
    fn = (port_actors.pooled_sequence_message if pooled
          else port_actors.sequence_message)
    ready, msgs = [], []
    while len(msgs) < n:
        length = int(rng.integers(3, 25))
        for t in range(length):
            obs = (rng.integers(0, 255, shape).astype(np.uint8)
                   if len(shape) == 3 else
                   rng.normal(size=shape).astype(np.float32))
            need = b.needs_carry
            b.add_step(obs, int(rng.integers(0, 3)), float(rng.normal()),
                       terminated=t == length - 1,
                       carry_c=(rng.normal(size=H).astype(np.float32) * 0.3
                                if need else None),
                       carry_h=(rng.normal(size=H).astype(np.float32) * 0.3
                                if need else None),
                       q_values=rng.normal(size=3).astype(np.float32))
        b.end_episode()
        ready.extend(b.drain())
        msgs.extend(port_actors.drain_grouped(ready, cfg.r2d2.sequence_group,
                                              fn))
    return msgs[:n]


@pytest.mark.parametrize("pooled", [True, False],
                         ids=["pooled-pixels", "stacked-vector"])
def test_fused_steps_match_the_jax_core(pooled):
    shape = (42, 42, 1) if pooled else (2,)
    b = 4
    opt_kw = dict(lr=1e-3, lr_decay_steps=2, lr_decay_rate=0.5)
    flax_model = FlaxR2D2(num_actions=3, obs_is_image=pooled,
                          compute_dtype=jnp.float32, scale_uint8=pooled,
                          lstm_features=H)
    params = flax_model.init(
        jax.random.key(0),
        jnp.zeros((1, T_TOTAL) + shape, jnp.uint8 if pooled else jnp.float32),
        flax_model.initial_state(1))
    jopt = jax_make_optimizer(**opt_kw)
    jts = JaxTrainState(params=params,
                        target_params=jax.tree.map(jnp.copy, params),
                        opt_state=jopt.init(params), step=jnp.int32(0))
    if pooled:
        kw = dict(capacity=32, t_total=T_TOTAL, lstm_features=H,
                  frame_shape=shape, frame_capacity=256)
        jreplay = JaxSeqPool(**kw)
        jrs = jreplay.init()
        replay = seq_pool_module.SequenceFramePoolReplay(**kw)
        rs = replay.init("cpu")
    else:
        jreplay = JaxDeviceReplay(capacity=32)
        example = dict(obs=jnp.zeros((T_TOTAL,) + shape, jnp.float32),
                       action=jnp.zeros(T_TOTAL, jnp.int32),
                       **{k: jnp.zeros(T_TOTAL, jnp.float32)
                          for k in ("reward", "discount", "mask")},
                       state_c=jnp.zeros(H, jnp.float32),
                       state_h=jnp.zeros(H, jnp.float32))
        jrs = jreplay.init(example)
        replay = DeviceReplay(capacity=32)
        rs = replay.init(jax.tree.map(np.asarray, example), "cpu")
    jcore = jax_r2d2.R2D2Core(model=flax_model, replay=jreplay,
                              optimizer=jopt, batch_size=b,
                              target_update_interval=2, burn_in=BURN,
                              n_steps=NSTEP)
    model = RecurrentDuelingDQN(
        3, shape, obs_is_image=pooled, compute_dtype=torch.float32,
        scale_uint8=pooled, lstm_features=H,
        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    core = port_r2d2.R2D2Core(replay=replay, optimizer=make_optimizer(**opt_kw),
                              batch_size=b, target_update_interval=2,
                              burn_in=BURN, n_steps=NSTEP)
    ts = create_train_state(model, core.optimizer)

    cfg, _ = _cfg()
    msgs = _messages(cfg, 5, shape=shape, pooled=pooled)
    ingest = jcore.jit_ingest()
    for msg in msgs[:2]:
        jrs = ingest(jrs, msg["payload"], jnp.asarray(msg["priorities"]))
        core.ingest(rs, msg["payload"], msg["priorities"])
    fused = jcore.jit_fused_step()
    keys = jax.random.split(jax.random.key(11), 3)
    for i, msg in enumerate(msgs[2:]):
        offsets = np.array(jax.random.uniform(keys[i], (b,), jnp.float32))
        jts, jrs, jm = fused(jts, jrs, msg["payload"],
                             jnp.asarray(msg["priorities"]), keys[i],
                             jnp.float32(0.4))
        ts, rs, m = core.fused_step(ts, rs, msg["payload"], msg["priorities"],
                                    torch.from_numpy(offsets), 0.4)
        assert ts.step == int(jts.step) == i + 1
        for name in ("loss", "q_mean", "td_mean", "grad_norm"):
            np.testing.assert_allclose(m[name].item(), float(jm[name]),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(rs.sum_tree.numpy(),
                                   np.asarray(jrs.sum_tree), rtol=1e-5)
        assert (rs.pos, rs.size) == (int(jrs.pos), int(jrs.size))
    jparams, jtarget = jax.device_get((jts.params, jts.target_params))
    for mod, tree in ((ts.params, jparams), (ts.target_params, jtarget)):
        want = params_from_flax(tree)
        for name, p in mod.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_worker_families_ship_jax_sequences_at_epsilon_zero(vector):
    """Greedy acting from the same weights: the same actions, episodes,
    windows and stored carries as JAX's families, message by message."""
    from apex_tpu.actors import r2d2 as jax_actors

    cfg, jcfg = _cfg(env_id="ApexCartPolePO-v0")
    cfg = cfg.replace(r2d2=dataclasses.replace(cfg.r2d2, sequence_group=2))
    jcfg = jcfg.replace(r2d2=dataclasses.replace(jcfg.r2d2,
                                                 sequence_group=2))
    jspec = jax_r2d2.r2d2_env_specs(jcfg)[0]
    spec = port_r2d2.r2d2_env_specs(cfg)[0]
    jmodel = FlaxR2D2(**jspec)
    params = jmodel.init(jax.random.key(3), jnp.zeros((1, 1, 2)),
                         jmodel.initial_state(1))
    host = params_from_flax(jax.device_get(params))
    seeds, slots = [7, 8, 9], [0, 1, 2]
    if vector:
        jfam = jax_actors.VectorR2D2WorkerFamily(jcfg, jspec, seeds, slots,
                                                 [0.0] * 3, group=2)
        fam = port_actors.VectorR2D2WorkerFamily(cfg, spec, seeds, slots,
                                                 [0.0] * 3, group=2)
        assert fam.double_buffer is False and fam.n_envs == 3
        fam.load_params(host)
        jfam.reset_all()
        fam.reset_all()
        for step in range(60):
            jfam.step_all(params, jax.random.key(step))
            fam.step_all(step)
    else:
        jfam = jax_actors.R2D2WorkerFamily(jcfg, jspec, seed=7, group=2)
        fam = port_actors.R2D2WorkerFamily(cfg, spec, seed=7, group=2)
        fam.load_params(host)
        jobs = jfam.env.reset(seed=7)[0]
        jfam.begin_episode(jobs)
        fam.begin_episode(fam.env.reset(seed=7)[0])
        gen = torch.Generator().manual_seed(0)
        for step in range(80):
            jobs, _, term, trunc = jfam.step(params, jobs, 0.0,
                                             jax.random.key(step))
            fam.step(0.0, gen)
            if term or trunc:
                jobs = jfam.env.reset()[0]
                jfam.begin_episode(jobs)
                fam.begin_episode(fam.env.reset()[0])
    jmsgs, msgs = jfam.poll_msgs(), fam.poll_msgs()
    assert len(jmsgs) == len(msgs) >= 2
    for jm, m in zip(jmsgs, msgs):
        assert jm["n_trans"] == m["n_trans"]
        np.testing.assert_allclose(m["priorities"], jm["priorities"],
                                   rtol=1e-5, atol=1e-6)
        for k, v in m["payload"].items():
            if k in ("state_c", "state_h"):
                np.testing.assert_allclose(v, jm["payload"][k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(v, jm["payload"][k], err_msg=k)


def _learner_steps(trainer, k):
    """``k`` learner steps from the trainer's replay and generator."""
    for _ in range(k):
        trainer.train_state, trainer.replay_state, _ = \
            trainer.core.train_step(
                trainer.train_state, trainer.replay_state,
                stratified_offsets(trainer.core.batch_size,
                                   trainer.generator, trainer.device), 0.5)


def _assert_learners_equal(a, b):
    for mod_a, mod_b in ((a.train_state.params, b.train_state.params),
                         (a.train_state.target_params,
                          b.train_state.target_params)):
        for (name, x), y in zip(mod_a.state_dict().items(),
                                mod_b.state_dict().values()):
            assert torch.equal(x, y), name
    assert a.train_state.step == b.train_state.step
    oa, ob = a.train_state.opt_state, b.train_state.opt_state
    assert oa.count == ob.count
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(x, y)
    for f in dataclasses.fields(a.replay_state):
        x, y = getattr(a.replay_state, f.name), getattr(b.replay_state,
                                                        f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_r2d2_trainer_mechanics_on_the_partially_observable_env():
    cfg, _ = _cfg(capacity=512, batch_size=16)
    t = port_r2d2.R2D2Trainer(cfg, device="cpu")
    assert t.env.observation_space.shape == (2,)        # velocities hidden
    assert not t.pooled
    t.train(total_frames=600, log_every=10 ** 9, warmup_sequences=16)
    assert t.frames_rate.total == 600
    assert t.steps_rate.total == t.train_state.step > 0
    assert t.sequences >= 16 and t.replay_state.size == t.sequences
    assert t.transitions <= 600
    assert np.isfinite(t.evaluate(episodes=1, max_steps=100))


def test_r2d2_trainer_on_pooled_pixels_gathers_once_per_step(monkeypatch):
    calls = []
    real = seq_pool_module.gather_rows
    monkeypatch.setattr(seq_pool_module, "gather_rows",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    cfg, _ = _cfg("ApexCatchSmall-v0", frame_pool=True)
    t = port_r2d2.R2D2Trainer(cfg, device="cpu")
    assert t.pooled
    assert t.replay_state.frames.shape == (t.replay.f_capacity, 42 * 42)
    t.train(total_frames=300, log_every=10 ** 9, warmup_sequences=8)
    assert t.steps_rate.total > 0
    assert calls == [(8 * T_TOTAL,)] * t.steps_rate.total
    assert np.isfinite(t.evaluate(episodes=1, max_steps=30))


def test_checkpoint_round_trip_is_bit_equal_over_the_following_steps(
        tmp_path):
    cfg, _ = _cfg("ApexCatchSmall-v0", frame_pool=True)
    t1 = port_r2d2.R2D2Trainer(cfg, device="cpu",
                               checkpoint_dir=str(tmp_path))
    t1.train(total_frames=250, log_every=10 ** 9, warmup_sequences=8)
    assert t1.steps_rate.total > 0
    path = t1.save_checkpoint()
    t2 = port_r2d2.R2D2Trainer(cfg, device="cpu")
    t2.restore(path)
    assert (t2.steps_rate.total, t2.sequences, t2.transitions,
            t2.frames_rate.total) == (t1.steps_rate.total, t1.sequences,
                                      t1.transitions, t1.frames_rate.total)
    _assert_learners_equal(t1, t2)
    for t in (t1, t2):
        _learner_steps(t, 3)
    _assert_learners_equal(t1, t2)
    # the trainer-free eval rebuilds the recurrent model from the spec
    score = evaluate_checkpoint(path, episodes=2, max_steps=60, device="cpu")
    assert -3.0 <= score <= 3.0


class ListPool:
    """Messages ready from the start, with the pool interface the
    trainers drive; an empty poll waits out its timeout."""

    def __init__(self, msgs):
        self._msgs = list(msgs)
        self.procs = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        pass

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        if not out and timeout:
            time.sleep(timeout)
        return out


def test_pipeline_stages_pooled_messages_as_the_serial_drain_ingests():
    """Pooled sequence messages through ``train()``: the staging thread
    keeps ``n_frames``/``n_seqs`` host ints, merges nothing (sequence
    messages are not frame chunks), and the pipelined learner ends
    bit-equal to the serial drain's."""
    cfg, _ = _cfg("ApexCatchSmall-v0", frame_pool=True)
    cfg = cfg.replace(replay=dataclasses.replace(cfg.replay, warmup=40))
    msgs = _messages(cfg, 10, shape=(42, 42, 1), pooled=True)

    pipe = IngestPipeline(ListPool(copy.deepcopy(msgs[:1])), device="cpu",
                          state_fn=lambda: PipelineState(
                              train_eligible=False))
    pipe.start()
    try:
        slot = pipe.poll_slot(timeout=5.0)
    finally:
        pipe.stop()
    assert slot.kind == "single"
    assert type(slot.payload["n_frames"]) is int
    assert type(slot.payload["n_seqs"]) is int
    assert all(isinstance(v, torch.Tensor) for k, v in slot.payload.items()
               if k not in ("n_frames", "n_seqs"))

    runs = []
    for pipelined in (False, True):
        c = cfg.replace(learner=dataclasses.replace(
            cfg.learner, ingest_pipeline=pipelined))
        t = port_r2d2.R2D2ApexTrainer(c, pool=ListPool(copy.deepcopy(msgs)),
                                      device="cpu", publish_min_seconds=10.0,
                                      respawn_workers=False)
        t.train(total_steps=12, max_seconds=60, log_every=10 ** 9)
        assert t.steps == 12
        assert t.ingested == sum(m["n_trans"] for m in msgs)
        runs.append(t)
    serial, piped = runs
    assert serial.dispatches == piped.dispatches
    assert piped._pipeline_last_stats["merged_slots"] == 0
    _assert_learners_equal(serial, piped)


def _segments():
    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-"))


def test_r2d2_apex_trainer_trains_with_an_actor_process():
    """One spawned vector worker (2 envs) acting statefully ships grouped
    sequence messages over the shm ring; the pipelined learner trains on
    them, publishes params the worker acts on, and leaves no process and
    no segment behind."""
    cfg, _ = _cfg(capacity=1024, batch_size=16)
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, warmup=64),
        learner=dataclasses.replace(cfg.learner, publish_interval=3),
        actor=dataclasses.replace(cfg.actor, n_envs_per_actor=2,
                                  update_interval=8, timing_interval=16))
    t = port_r2d2.R2D2ApexTrainer(cfg, device="cpu",
                                  publish_min_seconds=0.05)
    assert t.pool._worker_fn is port_actors.vector_r2d2_worker_main
    t.train(total_steps=10, max_seconds=120)
    assert t.steps == t.train_state.step == 10
    assert t.ingested >= cfg.replay.warmup
    assert t.pool.chunk_plane == "shm"
    assert t.param_version >= 2
    assert t.log.history.get("learner/episode_reward")
    assert not any(p.is_alive() for p in t.pool.procs)
    assert _segments() == []
    assert np.isfinite(t.evaluate(episodes=1, max_steps=100))


def test_r2d2_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (port_r2d2.R2D2Trainer, port_r2d2.R2D2ApexTrainer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(small_test_config(env_id="ApexCartPolePO-v0"))
