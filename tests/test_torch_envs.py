"""Port of the Catch env and its registry against ``apex_tpu.envs``.

The port's env is gymnasium-free; seeded the same way, it must render the
same frames and hand out the same rewards and episode ends.
"""

import numpy as np
import pytest

from apex_tpu.config import EnvConfig as JaxEnvConfig
from apex_tpu.envs.registry import make_env as jax_make_env
from apex_tpu.envs.registry import unstacked_env_spec as jax_spec
from apex_tpu_torch.config import EnvConfig
from apex_tpu_torch.envs.registry import (make_env, num_actions,
                                          unstacked_env_spec)


@pytest.mark.parametrize("env_id", ["ApexCatch-v0", "ApexCatchSmall-v0",
                                    "ApexCatchMedium-v0"])
def test_catch_trajectories_match(env_id):
    jenv = jax_make_env(env_id, JaxEnvConfig(env_id=env_id), seed=3,
                        stack_frames=False)
    env = make_env(env_id, EnvConfig(env_id=env_id), seed=3)
    assert unstacked_env_spec(env, EnvConfig()) == jax_spec(jenv,
                                                            JaxEnvConfig())
    assert num_actions(env) == jenv.action_space.n == 3
    actions = np.random.default_rng(0).integers(0, 3, 400)
    for episode in range(3):
        want, _ = jenv.reset(seed=10 + episode)
        got, _ = env.reset(seed=10 + episode)
        np.testing.assert_array_equal(got, want)
        for a in actions:
            want_step = jenv.step(int(a))
            got_step = env.step(int(a))
            np.testing.assert_array_equal(got_step[0], want_step[0])
            assert got_step[1:4] == want_step[1:4]
            if got_step[2]:
                break
        else:
            pytest.fail("episode did not end")


def test_partially_observable_cartpole_matches():
    """``ApexCartPolePO-v0``: CartPole with the velocities masked, the
    recurrent family's env; same observations, rewards and ends."""
    env_id = "ApexCartPolePO-v0"
    jenv = jax_make_env(env_id, JaxEnvConfig(env_id=env_id), seed=3,
                        max_episode_steps=60)
    env = make_env(env_id, EnvConfig(env_id=env_id), seed=3,
                   max_episode_steps=60)
    assert env.observation_space.shape == jenv.observation_space.shape == (2,)
    assert num_actions(env) == 2
    actions = np.random.default_rng(1).integers(0, 2, 200)
    for episode in range(3):
        want, _ = jenv.reset(seed=20 + episode)
        got, _ = env.reset(seed=20 + episode)
        np.testing.assert_array_equal(got, want)
        for a in actions:
            want_step = jenv.step(int(a))
            got_step = env.step(int(a))
            np.testing.assert_array_equal(got_step[0], want_step[0])
            assert got_step[1:4] == want_step[1:4]
            if got_step[2] or got_step[3]:
                break


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_rally_trajectories_match(small, dtype):
    """The host Rally env against ``apex_tpu.envs.toy.RallyEnv`` from the
    same seeds and actions, in both compute dtypes: the same frames,
    rewards and episode ends, bit for bit."""
    from apex_tpu.envs.toy import RallyEnv as JaxRally
    from apex_tpu_torch.envs.toy import RallyEnv

    kw = (dict(grid=14, pixels=42, points=2, agent_half=2, opp_speed=0.45)
          if small else {})
    jenv, env = JaxRally(dtype=dtype, **kw), RallyEnv(dtype=dtype, **kw)
    actions = np.random.default_rng(4).integers(0, 3, 600)
    ends = 0
    for episode in range(3):
        want, _ = jenv.reset(seed=30 + episode)
        got, _ = env.reset(seed=30 + episode)
        np.testing.assert_array_equal(got, want)
        for a in actions:
            want_step = jenv.step(int(a))
            got_step = env.step(int(a))
            np.testing.assert_array_equal(got_step[0], want_step[0])
            assert got_step[1:4] == want_step[1:4]
            if got_step[2]:
                ends += 1
                break
    assert ends >= 2


@pytest.mark.parametrize("env_id", ["ApexRally-v0", "ApexRallySmall-v0"])
def test_rally_registry_geometry_matches(env_id):
    jenv = jax_make_env(env_id, JaxEnvConfig(env_id=env_id), seed=2,
                        stack_frames=False)
    env = make_env(env_id, EnvConfig(env_id=env_id), seed=2)
    assert unstacked_env_spec(env, EnvConfig()) == jax_spec(jenv,
                                                            JaxEnvConfig())
    j, p = jenv.unwrapped, env
    assert (p.grid, p.pixels, p.points, p.half, p.agent_half,
            p.opp_speed) == (j.grid, j.pixels, j.points, j.half,
                             j.agent_half, j.opp_speed)
    np.testing.assert_array_equal(env.reset(seed=5)[0],
                                  jenv.reset(seed=5)[0])


def test_registry_refuses_what_is_not_ported():
    for env_id in ("ApexContinuousNav-v0", "SeaquestNoFrameskip-v4"):
        with pytest.raises(ValueError, match="not ported"):
            make_env(env_id)
    stacked = make_env("ApexCatchSmall-v0", stack_frames=True, seed=0)
    assert stacked.observation_space.shape == (42, 42, 4)
    assert stacked.reset(seed=1)[0].shape == (42, 42, 4)
