"""The port's on-device rollout engine (``apex_tpu_torch/training/anakin.py``).

Three pins, all exact (no tolerance):

* against the port's own host builder: the engine's sealed chunks and
  priorities equal what :class:`FrameChunkBuilder` makes of the same
  trajectory (the device env stepped with the draws the engine used, the
  same model and epsilon-greedy), as ``tests/test_anakin.py:112`` pins
  the JAX engine;
* against JAX's :class:`apex_tpu.training.anakin.AnakinRollout`, with the
  port's draws replaying JAX's key chains and a Q-function both sides
  compute exactly: chunks byte-equal, priorities bit-equal, episode
  stats equal, across dispatch boundaries, on Catch and Rally;
* ``AnakinPool`` feeding ``ApexTrainer.train`` on the CPU, pipelined and
  serial, with the publishes reaching the engine as tensors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu.training import anakin as jax_anakin
from apex_tpu.envs.registry import make_jax_env
from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig)
from apex_tpu_torch.envs.device_envs import DrawSource, make_device_env
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.training.anakin import (AnakinPool, AnakinRollout,
                                            make_anakin_engine)
from tests.test_torch_device_envs import keyed_draws, lane_keys

CHUNK_KEYS = ("frames", "n_frames", "n_trans", "action", "reward",
              "discount", "obs_ref", "next_ref")


def _cfg(env_id="ApexCatchSmall-v0", n_envs=3, send=16, warmup=128,
         pipeline=True):
    return ApexConfig(
        env=EnvConfig(env_id=env_id, frame_stack=2, seed=7),
        replay=ReplayConfig(capacity=1024, warmup=warmup),
        learner=LearnerConfig(batch_size=16, compute_dtype="float32",
                              target_update_interval=100,
                              publish_interval=2,
                              ingest_pipeline=pipeline),
        actor=ActorConfig(n_actors=1, n_envs_per_actor=n_envs,
                          send_interval=send))


class JaxKeyDraws(DrawSource):
    """The draws of JAX's engine, from its key chains: ``key(seed)``
    splits into the dispatch chain and the reset key (each lane resets
    with ``fold_in(reset_key, lane)``); each dispatch splits the chain and
    then its key into ``T`` step keys; a step's policy key is
    ``fold_in(step_key, T_POLICY)``, split into the explore and action
    keys, and lane ``b``'s env key ``fold_in(fold_in(step_key, T_ENV),
    b)`` (``apex_tpu/training/anakin.py:155-160, 334-345, 469-478``)."""

    def __init__(self, seed: int, num_actions: int):
        self.chain, self.init_key = jax.random.split(jax.random.key(seed))
        self.num_actions = num_actions

    def reset(self, sites, n):
        return keyed_draws(lane_keys(self.init_key, n), sites)

    def dispatch(self, sites, steps, n):
        self.chain, key = jax.random.split(self.chain)
        env_sites = {k: v for k, v in sites.items()
                     if k not in ("explore", "action")}
        rows = []
        for sk in jax.random.split(key, steps):
            ek, ak = jax.random.split(
                jax.random.fold_in(sk, jax_anakin.T_POLICY))
            row = keyed_draws(lane_keys(
                jax.random.fold_in(sk, jax_anakin.T_ENV), n), env_sites)
            row["explore"] = torch.from_numpy(np.array(
                jax.random.uniform(ek, (n,))))
            row["action"] = torch.from_numpy(np.array(
                jax.random.randint(ak, (n,), 0, self.num_actions)))
            rows.append(row)
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class RecordingDraws(DrawSource):
    """A generator's draws, kept for the host replay."""

    def __init__(self, seed: int):
        super().__init__(torch.Generator().manual_seed(seed))
        self.resets, self.blocks = [], []

    def reset(self, sites, n):
        self.resets.append(super().reset(sites, n))
        return self.resets[-1]

    def dispatch(self, sites, steps, n):
        self.blocks.append(super().dispatch(sites, steps, n))
        return self.blocks[-1]


def _exact_q_jax(obs, num_actions):
    tot = obs.astype(jnp.int32).sum(axis=(1, 2, 3))
    a = jnp.arange(num_actions, dtype=jnp.int32)
    v = (tot[:, None] * (a + 1) + 7 * a) % 101
    return v.astype(jnp.float32) * 0.0625 - 2.0


class ExactQ(nn.Module):
    """A Q-function both frameworks compute exactly: integer pixel sums
    mapped to multiples of 1/16."""

    def __init__(self, num_actions):
        super().__init__()
        self.num_actions = num_actions

    def forward(self, obs):
        tot = obs.long().sum(dim=(1, 2, 3))
        a = torch.arange(self.num_actions)
        v = (tot[:, None] * (a + 1) + 7 * a) % 101
        return v.float() * 0.0625 - 2.0


def _assert_messages_equal(want, got, where=""):
    assert len(want) == len(got), where
    for i, (w, g) in enumerate(zip(want, got)):
        assert w["n_trans"] == g["n_trans"], (where, i)
        np.testing.assert_array_equal(np.asarray(w["priorities"]),
                                      g["priorities"], err_msg=f"{where} {i}")
        for k in CHUNK_KEYS:
            np.testing.assert_array_equal(
                np.asarray(w["payload"][k]), g["payload"][k],
                err_msg=f"{where} chunk {i} {k}")


@pytest.mark.parametrize("env_id", ["ApexCatchSmall-v0",
                                    "ApexRallySmall-v0"])
def test_engine_matches_jax_engine_bit_for_bit(env_id):
    """Three dispatches of 40 steps over 3 lanes with the Ape-X ladder
    (explore and greedy steps both): every message and episode stat of
    the port equals JAX's."""
    B, T, A, seed = 3, 40, 3, 11
    eps = np.asarray([0.4, 0.2, 0.05], np.float32)

    def policy(params, obs, epsilon, key):
        q = _exact_q_jax(obs, A)
        explore_key, action_key = jax.random.split(key)
        greedy = q.argmax(axis=1)
        rand = jax.random.randint(action_key, greedy.shape, 0, A)
        explore = jax.random.uniform(explore_key, greedy.shape) < epsilon
        return jnp.where(explore, rand, greedy), q

    jeng = jax_anakin.AnakinRollout(
        make_jax_env(env_id), policy, n_envs=B, epsilons=eps,
        frame_stack=2, chunk_transitions=16, rollout_len=T, seed=seed)
    eng = AnakinRollout(make_device_env(env_id, device="cpu"), ExactQ(A),
                        n_envs=B, epsilons=eps,
                        frame_stack=2, chunk_transitions=16, rollout_len=T,
                        draws=JaxKeyDraws(seed, A))
    n_msgs = n_stats = 0
    for d in range(3):
        want, want_stats = jeng.rollout(None)
        got, got_stats = eng.rollout()
        _assert_messages_equal(want, got, f"dispatch {d}")
        assert [(s.actor_id, s.reward, s.length) for s in want_stats] == \
            [(s.actor_id, s.reward, s.length) for s in got_stats]
        n_msgs += len(got)
        n_stats += len(got_stats)
    assert n_msgs >= 6 and n_stats >= (3 if "Catch" in env_id else 0)
    assert eng.transitions == jeng.transitions and eng.chunks == jeng.chunks


def _host_replay(engine: AnakinRollout, draws: RecordingDraws, model):
    """Replay the engine's recorded draws through the device env stepped
    one step at a time and per-lane FrameChunkBuilders: the ground truth
    the engine's state machine must match."""
    env, B = engine.env, engine.B
    builders = [FrameChunkBuilder(engine.n, 0.99, engine.S,
                                  env.frame_shape,
                                  chunk_transitions=engine.K)
                for _ in range(B)]
    states, obs = env.reset(draws.resets[0])
    for b in range(B):
        builders[b].begin_episode(obs[b].numpy())
    per_dispatch, stats = [], []
    for block in draws.blocks:
        for t in range(engine.T):
            step = {k: v[t] for k, v in block.items()}
            stack = torch.from_numpy(np.stack(
                [bl.current_stack() for bl in builders]))
            with torch.no_grad():
                q = model(stack).float()
            actions = torch.where(step["explore"] < engine.epsilons,
                                  step["action"].long(), q.argmax(1))
            states, obs, rew, done, ff = env.step(states, actions, step)
            for b in range(B):
                builders[b].add_step(int(actions[b]), float(rew[b]),
                                     q[b].numpy(), ff[b].numpy(),
                                     bool(done[b]), False)
                if done[b]:
                    stats.append(b)
                    builders[b].begin_episode(obs[b].numpy())
        host = []
        for b in range(B):
            host.extend(drain_builder_chunks(builders[b]))
        per_dispatch.append(host)
    return per_dispatch, stats


@pytest.mark.parametrize("env_id", ["ApexCatchSmall-v0",
                                    "ApexRallySmall-v0"])
def test_engine_chunks_equal_the_host_builder(env_id):
    """The port's DuelingDQN (f32) acting: three dispatches' chunks,
    priorities included, byte-equal to the host builder's of the same
    trajectory; carries survive dispatch boundaries.  The builder emits
    chunks in lane order as they seal, the engine lane by lane: compared
    lane-major on both sides."""
    cfg = _cfg(env_id)
    draws = RecordingDraws(3)
    base = make_anakin_engine(cfg, device="cpu")
    eng = AnakinRollout(base.env, base.model, n_envs=3,
                        epsilons=[0.5, 0.3, 0.1], frame_stack=2,
                        chunk_transitions=16, rollout_len=40, draws=draws)
    got = [eng.rollout() for _ in range(3)]
    host, host_stats = _host_replay(eng, draws, base.model)
    compared = 0
    for d, ((msgs, stats), want) in enumerate(zip(got, host)):
        _assert_messages_equal(want, msgs, f"dispatch {d}")
        compared += len(msgs)
    assert compared >= 8
    assert [s.actor_id for _, st in got for s in st] == host_stats


def test_masked_overflow_stays_in_bounds_and_raises():
    """An outbox too small for the dispatch: the overflowing seals land
    on the dump slot (no out-of-range index) and the epilogue raises."""
    eng = make_anakin_engine(_cfg(), rollout_len=40, device="cpu")
    eng.M = 1
    eng.carry = eng._init_carry()
    with pytest.raises(RuntimeError, match="outbox overflow"):
        eng.rollout()


def test_make_anakin_engine_matches_jax_wiring_and_guard():
    """Lanes, slot ids, epsilons and the outbox geometry equal the JAX
    engine's; ids without a device env refuse, naming the id."""
    from apex_tpu.config import ActorConfig as JActor
    from apex_tpu.config import ApexConfig as JApex
    from apex_tpu.config import EnvConfig as JEnv
    from apex_tpu.training.anakin import make_anakin_engine as jax_engine

    jcfg = JApex(env=JEnv(env_id="ApexRallySmall-v0", frame_stack=2),
                 actor=JActor(n_actors=3, n_envs_per_actor=4,
                              send_interval=16))
    cfg = ApexConfig(env=EnvConfig(env_id="ApexRallySmall-v0",
                                   frame_stack=2),
                     actor=ActorConfig(n_actors=3, n_envs_per_actor=4,
                                       send_interval=16))
    for rollout_len in (None, 40):
        want = jax_engine(jcfg, rollout_len=rollout_len)
        got = make_anakin_engine(cfg, rollout_len=rollout_len, device="cpu")
        assert got.slot_ids == want.slot_ids == list(range(12))
        np.testing.assert_array_equal(got.epsilons.numpy(), want.epsilons)
        assert (got.B, got.M, got.K, got.Kf, got.W, got.T, got.S) == (
            want.B, want.M, want.K, want.Kf, want.W, want.T, want.S)
    bad = ApexConfig(env=EnvConfig(env_id="ApexCartPole-v0", frame_stack=1))
    with pytest.raises(ValueError, match="ApexCartPole-v0"):
        make_anakin_engine(bad, device="cpu")


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "serial"])
def test_anakin_pool_trains_apex_trainer(pipeline):
    """AnakinPool as ApexTrainer.train's chunk source on the CPU: steps
    taken, warm-up ingested, the engine acting on published device
    tensors (never numpy), episode stats stamped with their version."""
    from apex_tpu_torch.training.apex import ApexTrainer

    cfg = _cfg(n_envs=4, send=32, warmup=128, pipeline=pipeline)
    pool = AnakinPool(cfg, device="cpu")
    seen = []
    publish = pool.publish_params

    def spy(version, params):
        seen.append((version, {type(v) for v in params.values()}))
        publish(version, params)

    pool.publish_params = spy
    trainer = ApexTrainer(cfg, pool=pool, device="cpu",
                          publish_min_seconds=0.0, train_ratio=0.5)
    trainer.train(total_steps=6, max_seconds=90, log_every=10 ** 9)
    assert trainer.steps >= 6 and trainer.ingested >= 128
    assert seen and all(types == {torch.Tensor} for _, types in seen)
    assert pool._acting_version >= 1
    counters = pool.ondevice_counters()
    assert counters["dispatches"] > 0 and counters["chunks"] > 0
    assert counters["transitions"] >= trainer.ingested
    # the engine's model is its own: loaded from, never aliasing, the
    # learner's weights
    learner = dict(trainer.train_state.params.named_parameters())
    for name, p in pool.engine.model.named_parameters():
        assert p.data_ptr() != learner[name].data_ptr()
    versions = [v for _, v in trainer.log.history.get(
        "learner/episode_param_version", [])]
    assert versions and min(versions) >= 1
    if pipeline:
        assert trainer._pipeline_last_stats["publishes"] >= 1
