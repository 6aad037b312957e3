"""The batched device envs (``apex_tpu_torch/envs/device_envs.py``) against
``apex_tpu.envs.jax_envs``.

The port's envs take their randomness as explicit per-lane draws; here
those draws replay the JAX ports' keyed draws (``fold_in(key, tag)`` at
each site, the ``KeyedNpRandom`` approach of ``tests/test_jax_envs.py``),
so under the same actions the two trajectories must agree bit for bit:
observations, terminal frames, rewards and episode ends, auto-resets
included.  Tolerance: none (exact), for Catch's integer dynamics and for
Rally's f32 ones alike.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from apex_tpu.envs import jax_envs
from apex_tpu.envs.registry import make_jax_env
from apex_tpu_torch.envs.device_envs import (COIN, DrawSource,
                                             has_device_env,
                                             make_device_env)

#: the JAX port's fold-in tag of each of the port's draw sites
TAGS = {"coin": jax_envs._T_COIN, "int": jax_envs._T_INT,
        "choice": jax_envs._T_CHOICE, "reset_coin": jax_envs._T_RESET_COIN,
        "reset_int": jax_envs._T_RESET_INT,
        "reset_choice": jax_envs._T_RESET_CHOICE}


def keyed_draws(keys, sites: dict) -> dict:
    """The port's draw tensors for a batch of per-lane JAX keys: each site
    drawn as the JAX port draws it (``jax_envs.py:54-68``)."""
    out = {}
    for name, spec in sites.items():
        # apexlint: disable=J004 -- each site folds its own distinct tag onto the lane keys, as the JAX ports draw
        sub = jax.vmap(jax.random.fold_in, (0, None))(keys, TAGS[name])
        if spec is COIN:
            vals = jax.vmap(jax.random.uniform)(sub) < 0.5
        else:
            low, high = spec
            vals = jax.vmap(lambda k, lo=low, hi=high: jax.random.randint(
                k, (), lo, hi))(sub)
        out[name] = torch.from_numpy(np.array(vals))
    return out


def lane_keys(key, n):
    return jax.vmap(jax.random.fold_in, (None, 0))(
        key, np.arange(n, dtype=np.uint32))


def _check_trajectory(env_id: str, lanes: int, steps: int, seed: int):
    jenv = make_jax_env(env_id)
    env = make_device_env(env_id, device="cpu")
    assert env.frame_shape == jenv.frame_shape
    assert env.num_actions == jenv.num_actions
    key = jax.random.key(seed)
    key, kr = jax.random.split(key)
    keys = lane_keys(kr, lanes)
    jst, jobs = jax.vmap(jenv.reset)(keys)
    st, obs = env.reset(keyed_draws(keys, env.reset_sites))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(seed)
    dones = 0
    for t in range(steps):
        a = rng.integers(0, 3, lanes).astype(np.int32)
        key, kt = jax.random.split(key)
        keys = lane_keys(kt, lanes)
        jst, jobs, jr, jd, jff = jstep(jst, a, keys)
        st, obs, r, d, ff = env.step(st, torch.from_numpy(a),
                                     keyed_draws(keys, env.step_sites))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd),
                                      err_msg=f"done, step {t}")
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr),
                                      err_msg=f"reward, step {t}")
        np.testing.assert_array_equal(ff.numpy(), np.asarray(jff),
                                      err_msg=f"final frame, step {t}")
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs),
                                      err_msg=f"obs, step {t}")
        for name, x in zip(st._fields, st):
            np.testing.assert_array_equal(
                x.numpy(), np.asarray(getattr(jst, name)),
                err_msg=f"state {name}, step {t}")
        dones += int(d.sum())
    return dones


@pytest.mark.parametrize("env_id,steps,min_dones", [
    ("ApexCatch-v0", 120, 4), ("ApexCatchSmall-v0", 80, 12),
    ("ApexRally-v0", 300, 1), ("ApexRallySmall-v0", 300, 2)])
def test_device_env_matches_jax_port_bit_for_bit(env_id, steps, min_dones):
    assert _check_trajectory(env_id, lanes=4, steps=steps,
                             seed=3) >= min_dones


def test_state_dtypes_and_frame_layout():
    env = make_device_env("ApexRallySmall-v0", device="cpu")
    draws = DrawSource(torch.Generator().manual_seed(0))
    st, obs = env.reset(draws.reset(env.reset_sites, 5))
    assert obs.shape == (5, 42, 42, 1) and obs.dtype == torch.uint8
    assert [x.dtype for x in st] == [torch.float32] * 4 + [
        torch.int32, torch.float32, torch.int32]
    step = draws.dispatch(env.step_sites, 1, 5)
    st, obs, r, d, ff = env.step(st, torch.zeros(5, dtype=torch.int64),
                                 {k: v[0] for k, v in step.items()})
    assert r.dtype == torch.float32 and d.dtype == torch.bool
    assert ff.shape == obs.shape
    # serve rows drawn in the JAX site's range, [2, grid - 2)
    rows = draws.dispatch(env.step_sites, 200, 5)["int"]
    assert rows.dtype == torch.int32
    assert int(rows.min()) == 2 and int(rows.max()) == 14 - 3


def test_registry_guard_names_the_id():
    for env_id in ("ApexCatch-v0", "ApexCatchMedium-v0", "ApexRally-v0",
                   "ApexRallySmall-v0"):
        assert has_device_env(env_id)
    for env_id in ("ApexCartPole-v0", "ApexContinuousNav-v0",
                   "PongNoFrameskip-v4"):
        assert not has_device_env(env_id)
        with pytest.raises(ValueError, match=env_id):
            make_device_env(env_id, device="cpu")
    medium = make_device_env("ApexCatchMedium-v0", device="cpu")
    assert (medium.grid, medium.pixels, medium.balls) == (11, 44, 4)
