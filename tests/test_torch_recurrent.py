"""Port of the recurrent model, the R2D2 loss and its optimizer step
against ``apex_tpu``.

Weights cross from flax through ``convert.params_from_flax``; inputs come
from a numpy seed; the JAX model runs f32.  Tolerances: Q-values and both
carries rtol/atol 1e-5 (f32 round-off of conv, GEMM and LSTM sums in
another order); loss, priorities, ``td_abs`` and ``q_taken`` rtol 1e-5;
parameter gradients rtol 1e-4 (atol 1e-6 for the near-zero ones); one
clip + RMSprop step rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from apex_tpu.models.recurrent import RecurrentDuelingDQN as FlaxR2D2
from apex_tpu.ops.losses import make_optimizer as jax_make_optimizer
from apex_tpu.ops.losses import r2d2_loss as jax_r2d2_loss
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.models.recurrent import (RecurrentDuelingDQN,
                                             episodic_policy,
                                             make_recurrent_policy_fn)
from apex_tpu_torch.ops.losses import huber, make_optimizer, r2d2_loss
from apex_tpu_torch.training.state import create_train_state

H = 16                                    # LSTM width
BURN, UNROLL = 2, 4


def _models(image: bool, seed: int = 0):
    """A flax model with its params and the port's model loaded from
    them, f32 on both sides."""
    shape = (42, 42, 1) if image else (2,)
    flax_model = FlaxR2D2(num_actions=3, obs_is_image=image,
                          compute_dtype=jnp.float32, scale_uint8=image,
                          lstm_features=H)
    params = flax_model.init(jax.random.key(seed),
                             jnp.zeros((1, 2) + shape,
                                       jnp.uint8 if image else jnp.float32),
                             flax_model.initial_state(1))
    model = RecurrentDuelingDQN(3, shape, obs_is_image=image,
                                compute_dtype=torch.float32,
                                scale_uint8=image, lstm_features=H,
                                generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return flax_model, params, model, shape


def _obs(rng, shape, *lead):
    if len(shape) == 3:
        return rng.integers(0, 255, lead + shape).astype(np.uint8)
    return rng.normal(size=lead + shape).astype(np.float32)


@pytest.mark.parametrize("image", [False, True], ids=["vector", "pixel"])
def test_model_matches_flax_and_steps_equal_the_unroll(image):
    flax_model, params, model, shape = _models(image)
    rng = np.random.default_rng(1)
    x = _obs(rng, shape, 3, 5)
    c0, h0 = (rng.normal(size=(3, H)).astype(np.float32) for _ in range(2))
    q, (c, h) = jax.jit(flax_model.apply)(params, x, (c0, h0))
    tq, (tc, th) = model(torch.from_numpy(x),
                         (torch.from_numpy(c0), torch.from_numpy(h0)))
    assert tq.shape == (3, 5, 3) and tq.dtype == torch.float32
    for got, want in ((tq, q), (tc, c), (th, h)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # one frame at a time through the carry reproduces the unroll: the
    # actors step, the loss unrolls
    carry = (torch.from_numpy(c0), torch.from_numpy(h0))
    steps = []
    with torch.no_grad():
        for t in range(5):
            q1, carry = model(torch.from_numpy(x[:, t:t + 1]), carry)
            steps.append(q1[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               tq.detach().numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(carry[0].numpy(), tc.detach().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_trainable_set_is_flax_and_the_input_bias_stays_zero():
    """flax's OptimizedLSTMCell has hidden-side biases only: the port
    trains exactly its leaves (bias_ih is a zero buffer, outside the
    optimizer and the clip's norm)."""
    _, params, model, _ = _models(False)
    n_flax = sum(x.size for x in jax.tree.leaves(params))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_flax
    names = [n for n, _ in model.named_parameters()]
    assert "lstm.bias_ih" not in names
    assert names[-3:] == ["lstm.weight_ih", "lstm.weight_hh", "lstm.bias_hh"]
    assert not model.lstm.bias_ih.any()
    assert "lstm.bias_ih" in model.state_dict()


def test_bf16_model_keeps_f32_carry_and_heads_and_a_greedy_policy():
    model = RecurrentDuelingDQN(4, (84, 84, 1), lstm_features=32,
                                generator=torch.Generator().manual_seed(0))
    carry = model.initial_state(2)
    x = torch.randint(0, 255, (2, 3, 84, 84, 1), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    q, (c, h) = model(x, carry)
    assert q.shape == (2, 3, 4) and q.dtype == torch.float32
    assert c.dtype == h.dtype == torch.float32 and c.shape == (2, 32)
    policy = make_recurrent_policy_fn(model)
    a, qv, (c2, _) = policy(x[:, 0], carry, 0.0,
                            torch.Generator().manual_seed(5))
    assert a.shape == (2,) and qv.shape == (2, 4) and c2.shape == (2, 32)
    assert torch.equal(a, qv.argmax(dim=1))           # greedy at epsilon 0
    # the episode loop's policy threads its own carry and resets it
    step, reset = episodic_policy(model)
    gen = torch.Generator().manual_seed(0)
    first = step(x[:1, 0], 0.0, gen)[1]
    assert not torch.equal(step(x[:1, 0], 0.0, gen)[1], first)
    reset()
    assert torch.equal(step(x[:1, 0], 0.0, gen)[1], first)


def _sequence_batch(rng, shape, b, n_steps):
    t = BURN + UNROLL + n_steps
    discount = np.full((b, t), 0.9, np.float32)
    discount[0, 4] = 0.0                          # a terminal mid-sequence
    mask = np.ones((b, t), np.float32)
    mask[-1, -3:] = 0.0                           # a padded tail
    discount[-1, -3:] = 0.0
    reward = rng.normal(size=(b, t)).astype(np.float32)
    reward[-1, -3:] = 0.0
    obs = _obs(rng, shape, b, t)
    obs[-1, -3:] = 0
    return dict(obs=obs, action=rng.integers(0, 3, (b, t)).astype(np.int32),
                reward=reward, discount=discount, mask=mask,
                state_c=rng.normal(size=(b, H)).astype(np.float32),
                state_h=rng.normal(size=(b, H)).astype(np.float32))


@pytest.mark.parametrize("image,n_steps", [(False, 1), (False, 3),
                                           (True, 1)],
                         ids=["vector-n1", "vector-n3", "pixel-n1"])
def test_loss_priorities_and_gradients_match_jax(image, n_steps):
    flax_model, params, online, shape = _models(image, seed=0)
    _, target_params, target, _ = _models(image, seed=1)
    target.requires_grad_(False)
    rng = np.random.default_rng(2)
    b = 4
    batch = _sequence_batch(rng, shape, b, n_steps)
    weights = rng.uniform(0.5, 1.5, b).astype(np.float32)

    def jloss(p):
        return jax_r2d2_loss(flax_model.apply, p, target_params,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.asarray(weights), burn_in=BURN,
                             n_steps=n_steps)

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    loss, out = r2d2_loss(online, target,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.from_numpy(weights), burn_in=BURN,
                          n_steps=n_steps)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for name in ("priorities", "td_abs", "q_taken"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    names = [n for n, _ in online.named_parameters()]
    grads = torch.autograd.grad(loss, list(online.parameters()))
    want = params_from_flax(jax.device_get(jgrads))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


class _Accumulator(nn.Module):
    """A carry-accumulating fake net: ``c += p * o_t``, ``q = [c, -c]``."""

    def __init__(self, p):
        super().__init__()
        self.p = nn.Parameter(torch.tensor(p))

    def forward(self, obs_seq, carry):
        c, h = carry
        outs = []
        for t in range(obs_seq.shape[1]):
            c = c + self.p * obs_seq[:, t, :1]
            outs.append(torch.cat([c, -c], dim=1))
        return torch.stack(outs, 1), (c, h)


def test_burn_in_carries_no_gradient():
    """Mirror of ``tests/test_r2d2.py:137``: with burn 1 / unroll 1 / n 1
    the loss's gradient equals a closed form whose prefix carry is a
    detached ``p * o0``; a leaky burn-in would add the prefix term."""
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.normal(size=3).astype(np.float32))
    r1, d1, pt = 0.4, 0.9, 0.7
    online = _Accumulator(1.3)
    target = _Accumulator(pt).requires_grad_(False)
    batch = dict(obs=o.reshape(1, 3, 1),
                 action=torch.zeros((1, 3), dtype=torch.int32),
                 reward=torch.tensor([[0.0, r1, 0.0]]),
                 discount=torch.full((1, 3), d1),
                 mask=torch.ones((1, 3)),
                 state_c=torch.zeros((1, 1)), state_h=torch.zeros((1, 1)))
    loss, _ = r2d2_loss(online, target, batch, torch.ones(1), burn_in=1,
                        n_steps=1)
    (grad,) = torch.autograd.grad(loss, [online.p])

    p = torch.tensor(1.3, requires_grad=True)
    c0 = p.detach() * o[0]                       # detached prefix carry
    c1 = c0 + p * o[1]                           # q at the loss position
    c2 = c1 + p * o[2]                           # q at the bootstrap
    ct2 = pt * (o[0] + o[1] + o[2])
    q2, qt2 = torch.stack([c2, -c2]), torch.stack([ct2, -ct2])
    target_q = r1 + d1 * qt2[torch.argmax(q2.detach())]
    manual = huber(target_q.detach() - c1)
    (want,) = torch.autograd.grad(manual, [p])
    np.testing.assert_allclose(loss.item(), manual.item(), rtol=1e-5)
    np.testing.assert_allclose(grad.item(), want.item(), rtol=1e-5)
    assert abs(o[0].item()) > 1e-3               # the prefix term is real


def test_one_clip_rmsprop_step_matches_optax():
    """One clip + centered RMSprop update of the recurrent model from the
    same gradients: the clip's norm and the new weights equal optax's."""
    flax_model, params, model, shape = _models(False)
    rng = np.random.default_rng(3)
    jgrads = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                              * 30.0), params)
    opt_kw = dict(lr=1e-3, max_grad_norm=40.0)
    jopt = jax_make_optimizer(**opt_kw)

    @jax.jit
    def jstep(grads, params):
        updates, _ = jopt.update(grads, jopt.init(params), params)
        return optax.apply_updates(params, updates), optax.global_norm(grads)

    jnew, jnorm = jstep(jgrads, params)

    opt = make_optimizer(**opt_kw)
    ts = create_train_state(model, opt)
    grads = params_from_flax(jax.device_get(jgrads))
    names = [n for n, _ in model.named_parameters()]
    norm = opt.step(list(model.parameters()), [grads[n] for n in names],
                    ts.opt_state)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-5)
    assert norm.item() > 40.0                     # the clip is active
    want = params_from_flax(jax.device_get(jnew))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_train_state_from_flax_packs_the_lstm_moments():
    """A JAX train state two RMSprop updates in, as a checkpoint bundle
    holds it, crosses with ``train_state_from_flax``: the gate kernels'
    ``mu``/``nu`` pack as the weights do, so the next update from the same
    gradients equals optax's (rtol 1e-5)."""
    from flax import serialization

    from apex_tpu.training.state import TrainState as JaxTrainState
    from apex_tpu_torch.convert import train_state_from_flax

    flax_model, params, model, _ = _models(False)
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32)), params)
        for _ in range(3)]
    opt_kw = dict(lr=1e-3, lr_decay_steps=2, lr_decay_rate=0.5)
    jopt = jax_make_optimizer(**opt_kw)

    @jax.jit
    def jstep(grads, params, opt_state):
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    jparams, jstate = params, jopt.init(params)
    for g in grads[:2]:
        jparams, jstate = jstep(g, jparams, jstate)
    raw = serialization.to_state_dict(jax.device_get(JaxTrainState(
        params=jparams, target_params=params, opt_state=jstate,
        step=jnp.int32(2))))
    opt = make_optimizer(**opt_kw)
    ts = train_state_from_flax(raw, model, opt)
    assert ts.step == ts.opt_state.count == 2
    assert all(m.abs().max() > 0 for m in ts.opt_state.mu + ts.opt_state.nu)
    names = [n for n, _ in model.named_parameters()]
    want_target = params_from_flax(jax.device_get(params))
    for name, p in ts.target_params.state_dict().items():
        assert torch.equal(p, want_target[name]), name

    jparams, _ = jstep(grads[2], jparams, jstate)
    g = params_from_flax(jax.device_get(grads[2]))
    opt.step(list(model.parameters()), [g[n] for n in names], ts.opt_state)
    want = params_from_flax(jax.device_get(jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_fresh_lstm_input_kernels_are_bounded_as_flax_draws_them():
    """A fresh port init of the full-width model (trunk 3136 features into
    an LSTM of 128) draws its input kernels as flax's lecun_normal does:
    a normal truncated at 2 std, so max |w| * sqrt(fan_in) stays under
    2 / 0.87962566 = 2.2737 (checked <= 2.2742), and the std within 2% of
    a fresh flax init's."""
    flax_model = FlaxR2D2(num_actions=3, compute_dtype=jnp.float32)
    params = flax_model.init(jax.random.key(0),
                             jnp.zeros((1, 1, 84, 84, 1), jnp.uint8),
                             flax_model.initial_state(1))
    want = params_from_flax(jax.device_get(params))["lstm.weight_ih"]
    fan_in = want.shape[1]
    assert fan_in == 3136
    model = RecurrentDuelingDQN(3, (84, 84, 1),
                                generator=torch.Generator().manual_seed(0))
    got = model.lstm.weight_ih.detach()
    assert got.shape == want.shape
    bound = 2.2742
    assert want.abs().max().item() * fan_in ** 0.5 <= bound
    assert got.abs().max().item() * fan_in ** 0.5 <= bound
    np.testing.assert_allclose(got.std().item(), want.std().item(),
                               rtol=0.02)
