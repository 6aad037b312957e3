"""Port of the DQN loss and the clip+RMSprop+StepLR chain against optax.

Tolerances: the loss runs the f32 network on both sides, so values agree
to f32 round-off of reordered sums (rtol 1e-5).  TD errors are
differences of Q-values of order 1, so their error is absolute (atol
1e-5).  Gradients sum over the batch once more (rtol 1e-4, atol 1e-7).  The optimizer does the
same f32 arithmetic as optax in the same order except for the learning
rate (Python float here, f32 ``pow`` in optax), so parameters agree to
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
from apex_tpu.ops import losses as jl
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.models.dueling import DuelingDQN
from apex_tpu_torch.ops import losses as tl

OBS = (44, 44, 4)


def test_huber_and_mixed_max_priorities():
    x = np.concatenate([np.linspace(-3, 3, 61), [-1.0, 1.0, 0.999999]])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(tl.huber(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.huber(jnp.asarray(x))))
    td = np.abs(np.random.default_rng(0).normal(size=32)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.mixed_max_priorities(torch.from_numpy(td)).numpy(),
        np.asarray(jl.mixed_max_priorities(jnp.asarray(td))))
    assert tl.PRIORITY_ETA == jl.PRIORITY_ETA


def _batch(rng, b=16):
    return dict(
        obs=rng.integers(0, 256, (b,) + OBS).astype(np.uint8),
        next_obs=rng.integers(0, 256, (b,) + OBS).astype(np.uint8),
        action=rng.integers(0, 3, b).astype(np.int32),
        reward=rng.normal(size=b).astype(np.float32),
        discount=np.where(rng.random(b) < 0.2, 0.0,
                          0.99 ** 3).astype(np.float32))


def test_double_dqn_loss_priorities_and_grads_match():
    flax_model = FlaxDQN(num_actions=3, compute_dtype=jnp.float32)
    example = jnp.zeros((1,) + OBS, jnp.uint8)
    params = flax_model.init(jax.random.key(0), example)
    target = flax_model.init(jax.random.key(1), example)
    gen = torch.Generator().manual_seed(0)
    online_t = DuelingDQN(3, OBS, compute_dtype=torch.float32, generator=gen)
    target_t = DuelingDQN(3, OBS, compute_dtype=torch.float32, generator=gen)
    online_t.load_state_dict(params_from_flax(jax.device_get(params)))
    target_t.load_state_dict(params_from_flax(jax.device_get(target)))

    rng = np.random.default_rng(0)
    batch = _batch(rng)
    weights = rng.uniform(0.2, 1.0, 16).astype(np.float32)

    def jloss(p):
        return jl.double_dqn_loss(flax_model.apply, p, target,
                                  {k: jnp.asarray(v) for k, v in batch.items()},
                                  jnp.asarray(weights))

    (jval, jaux), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    loss, aux = tl.double_dqn_loss(
        online_t, target_t, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(weights))
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    for name in ("td_abs", "priorities", "q_taken"):
        np.testing.assert_allclose(getattr(aux, name).numpy(),
                                   np.asarray(getattr(jaux, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    want_grads = params_from_flax(jax.device_get(jgrads))
    for name, p in online_t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    assert all(p.grad is None for p in target_t.parameters())


@pytest.mark.parametrize("centered", [True, False])
def test_clip_rmsprop_steplr_matches_optax(centered):
    """Five updates from given gradients: norms above and below max_norm,
    and the staircase lr stepping every two updates."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, decay=0.95, eps=1.5e-7, centered=centered,
              max_grad_norm=2.0, lr_decay_steps=2, lr_decay_rate=0.5)
    jopt = jl.make_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    topt = tl.make_optimizer(**kw)
    tparams = [torch.tensor(init[k]) for k in shapes]
    tstate = topt.init(tparams)
    for step, scale in enumerate((0.1, 3.0, 0.5, 10.0, 0.02)):
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v)
                                       for k, v in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = topt.step(tparams, [torch.tensor(grads[k]) for k in shapes],
                         tstate)
        np.testing.assert_allclose(
            norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        assert tstate.count == step + 1
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def test_staircase_learning_rate():
    opt = tl.make_optimizer(lr=1.0, lr_decay_steps=1000, lr_decay_rate=0.99)
    assert opt.learning_rate(0) == opt.learning_rate(999) == 1.0
    assert opt.learning_rate(1000) == 0.99
    assert tl.make_optimizer(lr=0.5, lr_decay_steps=0).learning_rate(5000) == 0.5
