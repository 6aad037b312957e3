"""The port's single-process DQN driver and its parts against ``apex_tpu``.

* ``NStepAccumulator``: the same episodes (the ``tests/test_nstep.py``
  cases: terminated, truncated, several episodes, pixel obs) give the same
  transitions and priorities, bit for bit (both are the same numpy code).
* ``DeviceReplay``: add, sample from the same uniforms and priority update
  against the JAX replay; trees and IS weights to a few ulps at alpha 0.6
  (XLA's f32 ``pow`` against the port's, rounded from f64), everything
  else exact.
* CartPole: the gymnasium-free env steps the JAX env's trajectories.
* ``DQNTrainer``: a short run trains with finite metrics; the learning
  test of ``tests/test_learner.py:137-156`` is marked slow as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.config import EnvConfig as JaxEnvConfig
from apex_tpu.envs.registry import make_env as jax_make_env
from apex_tpu.replay.device import DeviceReplay as JaxReplay
from apex_tpu.replay.nstep import NStepAccumulator as JaxAccumulator
from apex_tpu_torch.config import EnvConfig, small_test_config
from apex_tpu_torch.envs.registry import make_env, make_eval_env
from apex_tpu_torch.replay.device import DeviceReplay
from apex_tpu_torch.replay.nstep import NStepAccumulator
from apex_tpu_torch.training.dqn import DQNTrainer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _feed(acc, episodes, rng, obs_shape):
    for length, end in episodes:
        for t in range(length):
            last = t == length - 1
            acc.add(rng.integers(0, 255, obs_shape).astype(np.uint8)
                    if obs_shape else np.float32(t),
                    int(rng.integers(0, 2)), float(rng.normal()),
                    rng.normal(size=2).astype(np.float32),
                    terminated=last and end == "terminated",
                    truncated=last and end == "truncated",
                    final_obs=(np.float32(length) if not obs_shape
                               else np.zeros(obs_shape, np.uint8))
                    if last and end == "truncated" else None)


@pytest.mark.parametrize("n,episodes,obs_shape", [
    (3, [(6, "terminated")], ()),
    (3, [(5, "truncated")], ()),
    (2, [(3, "terminated")], ()),
    (3, [(2, "terminated"), (5, "terminated"), (4, "truncated")], ()),
    (2, [(4, "terminated")], (8, 8, 1)),
    (5, [(1, "truncated"), (9, "running")], ()),
])
def test_nstep_accumulator_equals_jax(n, episodes, obs_shape):
    got_acc, want_acc = NStepAccumulator(n, 0.9), JaxAccumulator(n, 0.9)
    _feed(got_acc, episodes, np.random.default_rng(n), obs_shape)
    _feed(want_acc, episodes, np.random.default_rng(n), obs_shape)
    assert len(got_acc) == len(want_acc) > 0
    got, got_p = got_acc.make_batch()
    want, want_p = want_acc.make_batch()
    np.testing.assert_array_equal(got_p, want_p)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], key)
    with pytest.raises(ValueError):
        got_acc.add(np.float32(0), 0, 1.0, np.zeros(2, np.float32),
                    terminated=False, truncated=True)


def _item():
    return dict(obs=np.zeros((6,), np.float32), action=np.int32(0),
                reward=np.float32(0), next_obs=np.zeros((6,), np.float32),
                discount=np.float32(0))


def _batch(rng, k):
    return dict(obs=rng.normal(size=(k, 6)).astype(np.float32),
                action=rng.integers(0, 3, k).astype(np.int32),
                reward=rng.normal(size=k).astype(np.float32),
                next_obs=rng.normal(size=(k, 6)).astype(np.float32),
                discount=np.full(k, 0.97, np.float32))


@pytest.mark.parametrize("alpha,rtol", [(1.0, 0.0), (0.6, 1e-6)])
def test_device_replay_add_sample_update_equal_jax(alpha, rtol):
    """Adds wrap the ring; after each, the states agree and samples from
    the same uniforms return the same rows."""
    jrep, trep = JaxReplay(64, alpha=alpha), DeviceReplay(64, alpha=alpha)
    js, ts = jrep.init(_item()), trep.init(_item(), "cpu")
    assert trep.hbm_bytes(_item()) == jrep.hbm_bytes(_item())
    rng = np.random.default_rng(0)
    for i in range(7):
        batch = _batch(rng, 24)
        prios = np.abs(rng.normal(size=24)).astype(np.float32) + 0.05
        js = jrep.add(js, batch, jnp.asarray(prios))
        trep.add(ts, batch, prios)
        assert (ts.pos, ts.size) == (int(js.pos), int(js.size))
        for name in batch:
            np.testing.assert_array_equal(ts.storage[name].numpy(),
                                          np.asarray(js.storage[name]), name)
        for name in ("sum_tree", "min_tree"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       rtol=rtol, err_msg=name)
        assert ts.max_priority.item() == float(js.max_priority)

        key = jax.random.key(i)
        offsets = np.array(jax.random.uniform(key, (16,), jnp.float32))
        # apexlint: disable=J004 -- parity test: JAX redraws the offsets above from the same key
        jb, jw, jidx = jrep.sample(js, key, 16, 0.4)
        tb, tw, tidx = trep.sample(ts, torch.from_numpy(offsets), 0.4)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        for name in jb:
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]), name)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                   rtol=max(rtol, 1e-6))
        new_p = (np.asarray(jidx) % 5 + 1).astype(np.float32) * 0.7
        js = jrep.update_priorities(js, jidx, jnp.asarray(new_p))
        trep.update_priorities(ts, tidx, torch.from_numpy(new_p))
        np.testing.assert_allclose(ts.sum_tree.numpy(),
                                   np.asarray(js.sum_tree), rtol=rtol)


def test_cartpole_trajectories_equal_jax():
    jenv = jax_make_env("ApexCartPole-v0", JaxEnvConfig(), seed=3)
    env = make_env("ApexCartPole-v0", EnvConfig(), seed=3)
    assert env.observation_space.shape == jenv.observation_space.shape
    assert env.action_space.n == jenv.action_space.n == 2
    assert make_eval_env("ApexCartPole-v0").observation_space.shape == (4,)
    actions = np.random.default_rng(0).integers(0, 2, 600)
    ends = set()
    for episode in range(4):
        want, _ = jenv.reset(seed=10 + episode)
        got, _ = env.reset(seed=10 + episode)
        np.testing.assert_array_equal(got, want)
        for a in actions:
            want_step = jenv.step(int(a))
            got_step = env.step(int(a))
            np.testing.assert_array_equal(got_step[0], want_step[0])
            assert got_step[1:4] == want_step[1:4]
            if got_step[2] or got_step[3]:
                ends.add("terminated" if got_step[2] else "truncated")
                break
    assert "terminated" in ends
    short = make_env("ApexCartPole-v0", EnvConfig(), seed=0,
                     max_episode_steps=3)
    assert [short.step(1)[3] for _ in range(3)] == [False, False, True]


def test_dqn_trainer_trains_with_finite_metrics():
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    trainer = DQNTrainer(cfg, device="cpu", train_every=2)
    trainer.train(total_frames=300, log_every=10)
    assert trainer.frames_rate.total == 300
    assert trainer.ingested >= cfg.replay.warmup
    assert trainer.steps_rate.total > 50
    assert trainer.train_state.step == trainer.steps_rate.total
    logged = trainer.log.history["learner/loss"]
    assert logged and all(np.isfinite(v) for _, v in logged)
    # the run wraps the ring
    assert trainer.ingested > cfg.replay.capacity == trainer.replay_state.size
    score = trainer.evaluate(episodes=2, max_steps=50)
    assert 0 < score <= 50


@pytest.mark.slow
def test_dqn_learns_cartpole():
    """End to end: reward must clearly beat random play (about 22 per
    episode), as ``tests/test_learner.py::test_dqn_learns_cartpole``."""
    cfg = small_test_config(capacity=4096, batch_size=64)
    trainer = DQNTrainer(cfg, train_every=2, device="cpu")
    trainer.epsilon.decay = 4000.0
    trainer.train(total_frames=14_000)
    eps = [v for _, v in trainer.log.history["learner/episode_reward"]]
    first, last = float(np.mean(eps[:20])), float(np.mean(eps[-20:]))
    score = trainer.evaluate(episodes=5, epsilon=0.0, max_steps=500)
    assert last > 1.5 * first, f"no training-curve improvement: {first}->{last}"
    assert score > 40.0, f"eval reward {score} <= 40: not learning"
