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


def test_registry_refuses_what_is_not_ported():
    for env_id in ("ApexCartPolePO-v0", "ApexRally-v0",
                   "SeaquestNoFrameskip-v4"):
        with pytest.raises(ValueError, match="not ported"):
            make_env(env_id)
    stacked = make_env("ApexCatchSmall-v0", stack_frames=True, seed=0)
    assert stacked.observation_space.shape == (42, 42, 4)
    assert stacked.reset(seed=1)[0].shape == (42, 42, 4)
