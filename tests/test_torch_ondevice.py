"""The port's on-device replay plane (``apex_tpu_torch/ondevice``) against
``apex_tpu.ondevice``.

* :class:`DeviceFramePool` against JAX's given the same uniforms: sampled
  indices and stacks exact, IS weights and trees within rtol 1e-6 (the
  trees hold ``priority ** alpha``, which the port takes in f64 and XLA in
  f32, a few ulps apart); the snapshot round trip exact; a snapshot of
  another spec refused, naming the field.
* ``acting_priorities`` within 1 ulp of JAX's in-program ones (XLA
  contracts ``reward + discount * max`` into one FMA) and bit-equal to the
  host builder's numpy epilogue.
* :class:`FusedStep` against JAX's over three dispatches with the port's
  draws and uniforms replaying JAX's key chains, eps 1 on every lane:
  the ingested chunks (frame ring, transition tables, epochs, cursors)
  exact, which also holds the sampled indices equal through the
  write-back (a leaf written at another index would be off by far more
  than the tolerance); losses within rtol 1e-5 and the weights within atol
  1e-5; the trees within rtol 1e-3 and atol 1e-5, because the priorities
  are ``|target - q|`` of the flax and the torch network, a difference
  that magnifies their f32 round-off; the counters, the budget and the
  episode stats equal, with and without ``train_ratio``.
* The port's fused == serial bit for bit, the refusals, and a
  ``FusedApexTrainer`` checkpoint round trip.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig)
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.ondevice.fused import (FusedApexTrainer, FusedStep,
                                           acting_priorities)
from apex_tpu_torch.ondevice.replay import DeviceFramePool
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from tests.test_torch_anakin import ExactQ, JaxKeyDraws, _exact_q_jax

REPLAY_FIELDS = ("frames", "action", "reward", "discount", "obs_ids",
                 "next_ids", "frame_epoch", "pos", "f_epoch", "size")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_replay_equal(port, jax_state, rtol=1e-5, atol=0.0, where=""):
    """Exact on the ring, tables and cursors; ``rtol``/``atol`` on the
    trees and the running max priority."""
    for f in REPLAY_FIELDS:
        got, want = _np(getattr(port, f)), np.asarray(getattr(jax_state, f))
        if f == "frames":       # the JAX ring pads rows to (8, 128) tiles
            want = want.reshape(want.shape[0], -1)[:, :got.shape[1]]
        np.testing.assert_array_equal(got, want, err_msg=f"{where} {f}")
    for f in ("sum_tree", "min_tree", "max_priority"):
        np.testing.assert_allclose(_np(getattr(port, f)),
                                   np.asarray(getattr(jax_state, f)),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{where} {f}")


def _spec(capacity=64, frame_capacity=128):
    return FramePoolReplay(capacity=capacity, frame_shape=(5,),
                           frame_stack=2, frame_capacity=frame_capacity)


def _chunk(rng, kf=10, k=8):
    nf = int(rng.integers(2, kf + 1))
    nt = int(rng.integers(1, k + 1))
    return dict(
        frames=rng.integers(0, 255, (kf, 5), dtype=np.uint8),
        n_frames=np.int32(nf), n_trans=np.int32(nt),
        action=rng.integers(0, 3, (k,)).astype(np.int32),
        reward=rng.normal(size=k).astype(np.float32),
        discount=rng.random(k).astype(np.float32),
        obs_ref=rng.integers(0, nf, (k, 2)).astype(np.int32),
        next_ref=rng.integers(0, nf, (k, 2)).astype(np.int32))


# -- DeviceFramePool ---------------------------------------------------------

def test_device_pool_matches_jax_device_pool_given_its_uniforms():
    from apex_tpu.ondevice.replay import DeviceFramePool as JaxPool
    from apex_tpu.replay.frame_pool import FramePoolReplay as JaxSpec

    rng = np.random.default_rng(7)
    jpool = JaxPool(JaxSpec(capacity=64, frame_shape=(5,), frame_stack=2,
                            frame_capacity=128), seed=11)
    pool = DeviceFramePool(_spec(), device="cpu")
    for round_i in range(3):
        for _ in range(4):
            ch, pr = _chunk(rng), rng.random(8).astype(np.float32)
            jpool.add({k: jnp.asarray(v) for k, v in ch.items()},
                      jnp.asarray(pr))
            pool.add(ch, pr)
        # the uniforms JAX's sample will draw from its next key
        _, k = jax.random.split(jpool.key)
        offsets = torch.from_numpy(np.array(jax.random.uniform(k, (16,))))
        jb, jw, ji = jpool.sample(16, 0.5)
        batch, weights, idx = pool.sample(16, 0.5, offsets=offsets)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        for key in ("obs", "next_obs", "action", "reward", "discount"):
            np.testing.assert_array_equal(batch[key].numpy(),
                                          np.asarray(jb[key]), err_msg=key)
        np.testing.assert_allclose(weights.numpy(), np.asarray(jw),
                                   rtol=1e-6)
        new_pr = rng.random(16).astype(np.float32)
        jpool.update_priorities(ji, new_pr)
        pool.update_priorities(idx, new_pr)
        _assert_replay_equal(pool.state, jpool.state, rtol=1e-6,
                             where=f"round {round_i}")
    assert (pool.adds, pool.samples, pool.updates, pool.ingested) == (
        jpool.adds, jpool.samples, jpool.updates, jpool.ingested)


def test_device_pool_snapshot_roundtrip_and_spec_pin(tmp_path):
    rng = np.random.default_rng(5)
    pool = DeviceFramePool(_spec(), seed=2, device="cpu")
    for _ in range(3):
        pool.add(_chunk(rng), rng.random(8).astype(np.float32))
    pool.sample(8, 0.4)
    path = pool.snapshot(os.path.join(tmp_path, "pool.pt"))

    other = DeviceFramePool(_spec(), seed=99, device="cpu")
    other.restore(path)
    for f in dataclasses.fields(pool.state):
        a, b = getattr(pool.state, f.name), getattr(other.state, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name
    assert other.counters() == pool.counters()
    # the restored generator continues identically
    _, _, i1 = pool.sample(8, 0.4)
    _, _, i2 = other.sample(8, 0.4)
    assert torch.equal(i1, i2)

    small = DeviceFramePool(_spec(capacity=32, frame_capacity=64),
                            device="cpu")
    before = small.state.frames.clone()
    with pytest.raises(ValueError, match="capacity=64 != 32"):
        small.restore(path)
    assert torch.equal(small.state.frames, before)    # nothing overwritten


# -- acting priorities -------------------------------------------------------

def test_acting_priorities_within_one_ulp_of_jax_and_equal_to_numpy():
    from apex_tpu.envs.registry import make_jax_env
    from apex_tpu.ondevice.fused import acting_priorities as jax_prios
    from apex_tpu.training.anakin import AnakinRollout as JaxRollout
    from apex_tpu_torch.envs.device_envs import make_device_env
    from apex_tpu_torch.training.anakin import AnakinRollout

    eps = np.asarray([0.5, 0.1, 0.02], np.float32)

    def policy(params, obs, epsilon, key):
        q = _exact_q_jax(obs, 3)
        ek, ak = jax.random.split(key)
        rand = jax.random.randint(ak, (obs.shape[0],), 0, 3)
        explore = jax.random.uniform(ek, (obs.shape[0],)) < epsilon
        return jnp.where(explore, rand, q.argmax(axis=1)), q

    jeng = JaxRollout(make_jax_env("ApexRallySmall-v0"), policy, n_envs=3,
                      epsilons=eps, frame_stack=2, chunk_transitions=16,
                      rollout_len=48, seed=4)
    jeng.key, k = jax.random.split(jeng.key)
    _, _, jout = jeng._jit(None, jeng.epsilons, jeng.carry,
                           jeng.carry_frames, k)
    want = np.asarray(jax.jit(jax_prios)(jout))
    eng = AnakinRollout(make_device_env("ApexRallySmall-v0", device="cpu"),
                        ExactQ(3), n_envs=3, epsilons=eps, frame_stack=2,
                        chunk_transitions=16, rollout_len=48,
                        draws=JaxKeyDraws(4, 3))
    out = eng.dispatch()
    sealed = out["sealed"].numpy()
    np.testing.assert_array_equal(sealed, np.asarray(jout["sealed"]))
    got = acting_priorities(out).numpy()
    real = np.arange(eng.M)[None, :] < sealed[:, None]
    assert real.sum() >= 3
    np.testing.assert_array_max_ulp(got[real], want[real], maxulp=1)
    g = jax.device_get(jout)
    q_taken = np.take_along_axis(g["q0"], g["action"][..., None],
                                 -1)[..., 0]
    target = g["reward"] + g["discount"] * g["qn"].max(-1)
    host = np.abs(target - q_taken).astype(np.float32) + np.float32(1e-6)
    np.testing.assert_array_equal(got[real], host[real])


# -- FusedStep against JAX's --------------------------------------------------

B, T, K, S, BATCH = 2, 8, 8, 2, 16


class JaxSampleUniforms:
    """The per-slot uniforms of JAX's fused dispatch: one split of the
    sample key per train slot, ``uniform(k, (batch,))``
    (``apex_tpu/ondevice/fused.py:397-401``, ``ops/tree.py:131``)."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)

    def __call__(self, n):
        rows = []
        for _ in range(n):
            self.key, k = jax.random.split(self.key)
            rows.append(np.array(jax.random.uniform(k, (BATCH,))))
        return torch.from_numpy(np.stack(rows))


def _fused_pair(train_ratio):
    from apex_tpu.envs.registry import make_jax_env
    from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
    from apex_tpu.models.dueling import make_policy_fn
    from apex_tpu.ondevice.fused import FusedStep as JaxFused
    from apex_tpu.ops.losses import make_optimizer as jax_optimizer
    from apex_tpu.replay.frame_pool import FramePoolReplay as JaxSpec
    from apex_tpu.training.anakin import AnakinRollout as JaxRollout
    from apex_tpu.training.learner import LearnerCore as JaxCore
    from apex_tpu.training.state import create_train_state as jax_state
    from apex_tpu_torch.convert import params_from_flax
    from apex_tpu_torch.envs.device_envs import make_device_env
    from apex_tpu_torch.models.dueling import DuelingDQN
    from apex_tpu_torch.ops.losses import make_optimizer
    from apex_tpu_torch.training.anakin import AnakinRollout
    from apex_tpu_torch.training.learner import LearnerCore
    from apex_tpu_torch.training.state import create_train_state

    knobs = dict(warmup=32, beta=0.4, beta_anneal=200, steps_per_dispatch=2,
                 train_per_step=2, train_ratio=train_ratio)
    flax_model = FlaxDQN(num_actions=3, compute_dtype=jnp.float32)
    jspec = JaxSpec(capacity=256, frame_shape=(42, 42, 1), frame_stack=S)
    jopt = jax_optimizer(lr=1e-3)
    jts = jax_state(flax_model, jopt, jax.random.key(0),
                    jnp.zeros((1, 42, 42, S), jnp.uint8))
    jcore = JaxCore(apply_fn=flax_model.apply, replay=jspec, optimizer=jopt,
                    batch_size=BATCH, target_update_interval=4)
    jeng = JaxRollout(make_jax_env("ApexCatchSmall-v0"),
                      make_policy_fn(flax_model), n_envs=B,
                      epsilons=[1.0] * B, frame_stack=S,
                      chunk_transitions=K, rollout_len=T, seed=5)
    jfused = JaxFused(jcore, jspec, jeng, **knobs)

    model = DuelingDQN(3, (42, 42, S), compute_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(jax.device_get(jts.params)))
    spec = FramePoolReplay(capacity=256, frame_shape=(42, 42, 1),
                           frame_stack=S)
    core = LearnerCore(replay=spec, optimizer=make_optimizer(lr=1e-3),
                       batch_size=BATCH, target_update_interval=4)
    eng = AnakinRollout(make_device_env("ApexCatchSmall-v0", device="cpu"),
                        model, n_envs=B, epsilons=[1.0] * B, frame_stack=S,
                        chunk_transitions=K, rollout_len=T,
                        draws=JaxKeyDraws(5, 3))
    fused = FusedStep(core, spec, eng, **knobs)
    return (jfused, jts, jspec.init()), (fused, create_train_state(
        model, core.optimizer), spec.init("cpu"))


@pytest.mark.parametrize("train_ratio", [None, 1.0],
                         ids=["structural", "train_ratio"])
def test_fused_step_matches_jax_fused_step(train_ratio):
    from apex_tpu_torch.convert import params_from_flax

    (jfused, jts, jrs), (fused, ts, rs) = _fused_pair(train_ratio)
    skey = jax.random.key(9)
    uniforms = JaxSampleUniforms(9)
    trained = 0
    for d in range(3):
        # apexlint: disable=J004 -- dispatch splits the chain and returns the advanced key
        jts, jrs, skey, jinfo = jfused.dispatch(jts, jrs, skey)
        ts, rs, info = fused.dispatch(ts, rs, uniforms)
        where = f"dispatch {d}"
        assert info["transitions"] == jinfo["transitions"], where
        assert info["train_steps"] == jinfo["train_steps"], where
        assert fused.ingested == int(jfused.ingested_dev), where
        assert fused.budget == np.float32(jfused.budget_dev), where
        _assert_replay_equal(rs, jrs, rtol=1e-3, atol=1e-5, where=where)
        if jinfo["metrics"] is not None:
            for k in ("loss", "q_mean", "td_mean"):
                np.testing.assert_allclose(info["metrics"][k],
                                           jinfo["metrics"][k], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{where} {k}")
        trained += info["train_steps"]
        assert [(s.actor_id, s.reward, s.length) for s in info["stats"]] \
            == [(s.actor_id, s.reward, s.length) for s in jinfo["stats"]]
    assert trained >= 2 and ts.step == int(jts.step) == trained
    if train_ratio is not None:
        assert trained < 2 * 2 * 3       # the budget held slots back
    assert fused.counters()["prio_writebacks"] == jfused.prio_writebacks
    want = params_from_flax(jax.device_get(jts.params))
    for name, p in ts.params.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


# -- the port's own contracts --------------------------------------------------

def _cfg(warmup=32, capacity=512, n_envs=2, send=8, ratio_env="ApexCatchSmall-v0"):
    return ApexConfig(
        env=EnvConfig(env_id=ratio_env, frame_stack=2, seed=3),
        replay=ReplayConfig(capacity=capacity, warmup=warmup,
                            beta_anneal=2000),
        learner=LearnerConfig(batch_size=16, compute_dtype="float32",
                              target_update_interval=50,
                              publish_interval=5, save_interval=10 ** 9),
        actor=ActorConfig(n_actors=1, n_envs_per_actor=n_envs,
                          send_interval=send))


def _run_fused(steps_per_dispatch, dispatches, **kw):
    t = FusedApexTrainer(_cfg(), device="cpu",
                         steps_per_dispatch=steps_per_dispatch,
                         rollout_len=8, **kw)
    for _ in range(dispatches):
        t.train_state, t.replay_state, _ = t.fused.dispatch(
            t.train_state, t.replay_state, t._offsets)
    return t


def _assert_trainers_equal(a, b):
    for x, y in zip(list(a.train_state.params.parameters())
                    + list(a.train_state.target_params.parameters())
                    + a.train_state.opt_state.mu + a.train_state.opt_state.nu,
                    list(b.train_state.params.parameters())
                    + list(b.train_state.target_params.parameters())
                    + b.train_state.opt_state.mu
                    + b.train_state.opt_state.nu):
        assert torch.equal(x, y)
    assert a.train_state.step == b.train_state.step
    for f in dataclasses.fields(a.replay_state):
        x, y = getattr(a.replay_state, f.name), getattr(b.replay_state,
                                                        f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("train_ratio", [None, 0.5],
                         ids=["structural", "train_ratio"])
def test_fused_equals_serial_bit_for_bit(train_ratio):
    """steps_per_dispatch=3 x 2 dispatches == 1 x 6: weights, optimizer,
    replay, both generators and the engine carry, bit for bit."""
    a = _run_fused(3, 2, train_ratio=train_ratio)
    b = _run_fused(1, 6, train_ratio=train_ratio)
    _assert_trainers_equal(a, b)
    assert a.train_state.step > 0
    assert torch.equal(a.fused.engine.draws.generator.get_state(),
                       b.fused.engine.draws.generator.get_state())
    ca, cb = a.fused.engine.carry, b.fused.engine.carry
    for f in dataclasses.fields(ca):
        x, y = getattr(ca, f.name), getattr(cb, f.name)
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(u, v), f.name
    assert torch.equal(a.fused.engine.ring, b.fused.engine.ring)
    assert (a.fused.ingested, a.fused.budget, a.fused.train_steps,
            a.fused.transitions) == (b.fused.ingested, b.fused.budget,
                                     b.fused.train_steps,
                                     b.fused.transitions)


def test_refusals_name_their_knobs():
    cfg = _cfg()
    for knob in ("steps_per_dispatch", "train_per_step"):
        with pytest.raises(ValueError, match=knob):
            FusedApexTrainer(cfg, device="cpu", **{knob: 0})
    with pytest.raises(ValueError, match="ApexCartPole-v0"):
        FusedApexTrainer(_cfg(ratio_env="ApexCartPole-v0"), device="cpu")
    # an outbox too small for the segment: the overflowing seals stay on
    # the dump slot and the dispatch raises
    t = FusedApexTrainer(cfg, device="cpu", rollout_len=24)
    t.fused.engine.M = 1
    t.fused.engine.carry = t.fused.engine._init_carry()
    with pytest.raises(RuntimeError, match="fused outbox overflow"):
        t.fused.dispatch(t.train_state, t.replay_state, t._offsets)


def test_fused_trainer_trains_then_checkpoint_roundtrips(tmp_path):
    """train() takes its steps and logs each ended episode with the param
    version it acted under; a checkpoint restores the learner bit for
    bit and re-seeds the warm/anneal counter, and the restored trainer
    keeps dispatching."""
    t = FusedApexTrainer(_cfg(), device="cpu", steps_per_dispatch=2,
                         rollout_len=8, checkpoint_dir=str(tmp_path))
    t.train(total_steps=4, max_seconds=120.0, log_every=1)
    assert t.steps >= 4 and t.fused.prio_writebacks == t.steps
    assert t.ingested == t.fused.transitions > 0
    assert t.param_version >= 1
    losses = [v for _, v in t.log.history.get("learner/loss", [])]
    assert losses and all(np.isfinite(losses))
    history = t.log.history
    versions = [v for _, v in history.get("learner/episode_param_version",
                                          [])]
    assert versions and len(versions) == len(
        history["learner/episode_reward"])
    assert all(v in range(1, t.param_version + 1) for v in versions)
    path = t.save_checkpoint()
    assert os.path.exists(path)

    t2 = FusedApexTrainer(_cfg(), device="cpu", steps_per_dispatch=2,
                          rollout_len=8, checkpoint_dir=str(tmp_path))
    t2.restore()
    _assert_trainers_equal(t, t2)
    assert t2.fused.ingested == min(t.ingested, t.fused._ing_cap)
    assert t2.ingested == t.ingested and t2.steps == t.steps
    t2.train_state, t2.replay_state, info = t2.fused.dispatch(
        t2.train_state, t2.replay_state, t2._offsets)
    assert info["transitions"] > 0 and info["train_steps"] == 2


def test_fused_train_with_a_logdir_writes_its_fleet_summary(tmp_path):
    """A fused ``train()`` with a logdir ends by writing
    ``fleet_summary.json``; its latency section carries the lineage
    histograms and the set-up durations between the call's milestones,
    which the one concurrent loop stamps for the fused body too."""
    import json

    t = FusedApexTrainer(_cfg(), device="cpu", steps_per_dispatch=2,
                         rollout_len=8, logdir=str(tmp_path))
    t.train(total_steps=2, max_seconds=120.0, log_every=10 ** 9)
    latency = t.fleet_summary()["latency"]
    assert "hops_s" in latency and "setup_s" in latency
    marks = obs_spans.SetupClock.MILESTONES
    assert set(latency["setup_s"]) == {
        f"{a}_to_{b}" for a, b in zip(marks, marks[1:])} | {
        "train_to_first_step"}
    assert all(v >= 0 for v in latency["setup_s"].values())
    with open(tmp_path / "fleet_summary.json", encoding="utf-8") as fh:
        written = json.load(fh)
    assert set(written["latency"]) == set(latency)
    assert written["steps"] >= 2


def test_entry_points_default_to_the_card(monkeypatch):
    """The on-device entry points run on the card unless the CPU is asked
    for: without one they raise instead of falling back."""
    from apex_tpu_torch.training.anakin import AnakinPool, make_anakin_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    for build in (lambda: FusedApexTrainer(cfg),
                  lambda: make_anakin_engine(cfg), lambda: AnakinPool(cfg),
                  lambda: DeviceFramePool(_spec())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
