"""Port of the dueling network: flax weights carried into the torch module.

At f32 both sides compute the same network, so outputs agree to f32
round-off of differently ordered conv/matmul sums (rtol 1e-5, atol 1e-6).
At bf16 the two frameworks round at different places (flax casts each
layer's inputs and kernel, autocast rounds each op's inputs), so the
check is loose: atol 2e-2 on Q-values of order 0.1-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.models.dueling import DuelingDQN, make_policy_fn

# 44x44 leaves a 2x2x64 trunk output, so the NHWC flatten order matters
OBS = (44, 44, 4)


def _pair(compute, obs_shape=OBS, image=True, seed=0):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[compute]
    flax_model = FlaxDQN(num_actions=3, obs_is_image=image, compute_dtype=jdt)
    example = (jnp.zeros((1,) + obs_shape, jnp.uint8) if image
               else jnp.zeros((1,) + obs_shape, jnp.float32))
    params = flax_model.init(jax.random.key(seed), example)
    model = DuelingDQN(3, obs_shape, obs_is_image=image, compute_dtype=tdt,
                       generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(params_from_flax(jax.device_get(params)),
                          strict=True)
    return flax_model, params, model


@pytest.mark.parametrize("compute,rtol,atol", [("float32", 1e-5, 1e-6),
                                               ("bfloat16", 0.0, 2e-2)])
def test_pixel_forward_matches_flax(compute, rtol, atol):
    flax_model, params, model = _pair(compute)
    obs = np.random.default_rng(0).integers(0, 256, (8,) + OBS).astype(np.uint8)
    want = np.asarray(flax_model.apply(params, jnp.asarray(obs)))
    got = model(torch.from_numpy(obs))
    assert got.dtype == torch.float32 and got.shape == (8, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol)


def test_mlp_trunk_matches_flax():
    flax_model, params, model = _pair("float32", obs_shape=(6,), image=False)
    obs = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)
    want = np.asarray(flax_model.apply(params, jnp.asarray(obs)))
    got = model(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_state_dict_names_follow_flax():
    _, params, model = _pair("float32")
    flax_names = set(params["params"])
    assert {k.rsplit(".", 1)[0] for k in model.state_dict()} == flax_names
    assert flax_names == {"Conv_0", "Conv_1", "Conv_2", "advantage_hidden",
                          "advantage_out", "value_hidden", "value_out"}


def test_greedy_policy_matches_flax_argmax():
    flax_model, params, model = _pair("float32", seed=3)
    obs = np.random.default_rng(2).integers(0, 256, (16,) + OBS).astype(np.uint8)
    want_q = np.asarray(flax_model.apply(params, jnp.asarray(obs)))
    policy = make_policy_fn(model)
    actions, q = policy(torch.from_numpy(obs), 0.0,
                        torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(actions.numpy(), want_q.argmax(1))
    np.testing.assert_allclose(q.numpy(), want_q, rtol=1e-5, atol=1e-6)
    # epsilon 1 explores everywhere: actions drawn from the generator
    explore, _ = policy(torch.from_numpy(obs), 1.0,
                        torch.Generator().manual_seed(0))
    assert explore.min().item() >= 0 and explore.max().item() < 3


def test_orthogonal_init_is_seeded():
    a = DuelingDQN(3, OBS, generator=torch.Generator().manual_seed(7))
    b = DuelingDQN(3, OBS, generator=torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.advantage_hidden.weight                    # (128, 256): rows orthogonal
    gram = w @ w.T / 2.0                             # gain sqrt(2) squared
    torch.testing.assert_close(gram, torch.eye(128), atol=1e-5, rtol=0)
    assert not bool(a.Conv_0.bias.any())
