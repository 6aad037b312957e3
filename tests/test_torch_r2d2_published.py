"""The R2D2 family at its published settings against the plain float32
reference (``tests/plain_r2d2.py``), at a small size on the CPU.

LSTM 16, heads 8, burn-in 2, unroll 4, n 2, batch 4, 42x42 frames,
seeded weights; the LSTM fed the previous action and reward, value
rescaling at eps 1e-3, clip + Adam (eps 1e-3).  The port runs
``torch.lstm`` and the reference an explicit per-step loop, both in
float32: their sums differ in order only, so the tolerances below are
float32 round-off over a few dozen accumulations.  The JAX parity files
(``test_torch_r2d2.py``, ``test_torch_recurrent.py``) hold the family at
its defaults.
"""

import dataclasses

import numpy as np
import pytest
import torch

import plain_r2d2 as ref
from apex_tpu_torch.actors.r2d2 import pooled_sequence_message
from apex_tpu_torch.config import (ApexConfig, EnvConfig, LearnerConfig,
                                   R2D2Config, ReplayConfig)
from apex_tpu_torch.models.recurrent import (RecurrentDuelingDQN,
                                             episodic_policy)
from apex_tpu_torch.ops.losses import (ClipAdam, inverse_value_rescale,
                                       r2d2_loss, value_rescale)
from apex_tpu_torch.replay.base import check_hbm_budget
from apex_tpu_torch.replay.seq_pool import SequenceFramePoolReplay
from apex_tpu_torch.training import r2d2 as port_r2d2

A, H_LSTM, HEAD = 3, 16, 8
BURN, UNROLL, NSTEP, B = 2, 4, 2, 4
T = BURN + UNROLL + NSTEP
SHAPE = (42, 42, 1)
EPS = 1e-3
# float32 sums in another order: a few ulps over ~100 terms
RTOL, ATOL = 2e-5, 2e-6


def _model(seed=0):
    return RecurrentDuelingDQN(
        A, SHAPE, compute_dtype=torch.float32, lstm_features=H_LSTM,
        head_width=HEAD, prev_action_reward=True,
        generator=torch.Generator().manual_seed(seed))


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randint(0, 256, (B, T) + SHAPE, generator=g,
                        dtype=torch.uint8)
    reward = torch.randint(-1, 2, (B, T), generator=g).float()
    discount = torch.full((B, T), 0.997)
    mask = torch.ones(B, T)
    discount[1, 5:] = 0.0                 # a terminal, then padding
    mask[1, 6:] = 0.0
    reward[1, 6:] = 0.0
    return dict(
        obs=obs, action=torch.randint(0, A, (B, T), generator=g,
                                      dtype=torch.int32),
        reward=reward, discount=discount, mask=mask,
        state_c=0.5 * torch.randn(B, H_LSTM, generator=g),
        state_h=0.5 * torch.randn(B, H_LSTM, generator=g),
        prev_action=torch.randint(0, A, (B,), generator=g,
                                  dtype=torch.int32),
        prev_reward=torch.randint(-1, 2, (B,), generator=g).float())


def test_q_values_and_both_carries_match_the_reference():
    model, batch = _model(), _batch()
    prev = ref.previous(batch)
    carry = (batch["state_c"], batch["state_h"])
    with torch.no_grad():
        q, (c, h) = model(batch["obs"], carry, prev)
    q_ref, (c_ref, h_ref) = ref.q_values(_params(model), batch["obs"],
                                         carry, prev)
    np.testing.assert_allclose(q, q_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c, c_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h, h_ref, rtol=RTOL, atol=ATOL)
    # the previous action and reward do reach the LSTM
    other = (prev[0].roll(1, 1), -prev[1])
    with torch.no_grad():
        q_other, _ = model(batch["obs"], carry, other)
    assert float((q_other - q).abs().max()) > 1e-3


def _both_losses(model, target, batch, weights):
    loss, out = r2d2_loss(model, target, batch, weights, burn_in=BURN,
                          n_steps=NSTEP, rescale_eps=EPS)
    p = {n: v.requires_grad_(True) for n, v in _params(model).items()}
    tp = _params(target)
    loss_ref, prios_ref, td_ref = ref.sequence_loss(p, tp, batch, weights,
                                                    BURN, NSTEP, EPS)
    return loss, out, p, loss_ref, prios_ref, td_ref


def test_rescaled_loss_priorities_and_td_match_the_reference():
    model, target = _model(0), _model(7).requires_grad_(False)
    batch, weights = _batch(), torch.tensor([1.0, 0.5, 0.8, 0.3])
    loss, out, _, loss_ref, prios_ref, td_ref = _both_losses(
        model, target, batch, weights)
    m = batch["mask"][:, BURN:BURN + UNROLL]
    td_mean_ref = td_ref.abs().sum(1) / m.sum(1)
    np.testing.assert_allclose(loss.item(), loss_ref.item(), rtol=RTOL)
    np.testing.assert_allclose(out.priorities, prios_ref, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.td_abs, td_mean_ref, rtol=RTOL,
                               atol=ATOL)
    # without the rescaling the same batch gives other targets
    plain, _ = r2d2_loss(model, target, batch, weights, burn_in=BURN,
                         n_steps=NSTEP)
    assert abs(plain.item() - loss.item()) > 1e-4 * abs(loss.item())


def test_gradients_match_the_reference():
    model, target = _model(0), _model(7).requires_grad_(False)
    batch, weights = _batch(2), torch.tensor([1.0, 0.5, 0.8, 0.3])
    loss, _, p, loss_ref, _, _ = _both_losses(model, target, batch, weights)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    grads_ref = torch.autograd.grad(loss_ref, [p[n] for n in names])
    for n, g, g_ref in zip(names, grads, grads_ref):
        scale = float(g_ref.abs().max())
        np.testing.assert_allclose(g, g_ref, rtol=1e-4,
                                   atol=1e-5 * max(scale, 1e-3), err_msg=n)


@pytest.mark.parametrize("max_norm", [40.0, 1e-3])
def test_one_adam_step_matches_the_reference(max_norm):
    """One clip + Adam update (lr 1e-4, eps 1e-3), unclipped and
    clipped; the first moment after it is ``(1 - b1)`` times the clipped
    gradient, which the benchmark's probe reads back."""
    g = torch.Generator().manual_seed(3)
    params = [torch.randn(5, 4, generator=g), torch.randn(7, generator=g)]
    grads = [torch.randn_like(p) * 0.1 for p in params]
    opt = ClipAdam(lr=1e-4, eps=1e-3, max_grad_norm=max_norm)
    mine = [p.clone() for p in params]
    state = opt.init(mine)
    opt.step(mine, grads, state)
    theirs = [p.clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    clipped = ref.adam(theirs, grads, mu, nu, 0, 1e-4, 1e-3, max_norm)
    for a, b, m, c in zip(mine, theirs, state.mu, clipped):
        # two float32 ulps of the weight: the port rounds the bias
        # corrections to float32 (optax's order), the reference does not
        np.testing.assert_allclose(a, b, rtol=2.5e-7, atol=1e-9)
        np.testing.assert_allclose(m / (1 - opt.b1), c, rtol=1e-6,
                                   atol=1e-9)


def test_rescaling_inverts_across_magnitudes():
    mags = np.concatenate([[0.0], np.logspace(-6, 6, 49)])
    x = torch.from_numpy(np.concatenate([-mags[::-1], mags]))
    for f, g in ((value_rescale, inverse_value_rescale),
                 (inverse_value_rescale, value_rescale)):
        np.testing.assert_allclose(f(g(x, EPS), EPS), x, rtol=1e-9,
                                   atol=1e-12)
    # the port's and the reference's agree in float32
    y = x.float().clamp(-1e4, 1e4)
    np.testing.assert_allclose(value_rescale(y, EPS),
                               ref.value_rescale(y, EPS), rtol=1e-6)
    np.testing.assert_allclose(inverse_value_rescale(y, EPS),
                               ref.inverse_value_rescale(y, EPS), rtol=1e-6)


def _episode(builder, n, rng, with_q=True):
    """One terminated episode of ``n`` steps; returns its actions,
    rewards and Q vectors."""
    acts, rews, qs = [], [], []
    for t in range(n):
        need = builder.needs_carry
        a, r = int(rng.integers(0, A)), float(rng.integers(-1, 2))
        q = rng.normal(size=A).astype(np.float32) * 3.0
        builder.add_step(rng.integers(0, 255, SHAPE).astype(np.uint8), a, r,
                         terminated=t == n - 1,
                         carry_c=np.full(H_LSTM, t, np.float32) if need
                         else None,
                         carry_h=np.full(H_LSTM, -t, np.float32) if need
                         else None,
                         q_values=q if with_q else None)
        acts.append(a)
        rews.append(r)
        qs.append(q)
    builder.end_episode()
    return acts, rews, qs


def test_the_builder_records_the_previous_action_and_reward():
    b = port_r2d2.SequenceBuilder(BURN, UNROLL, NSTEP, 0.997, stride=3,
                                  prev_inputs=True)
    acts, rews, _ = _episode(b, 20, np.random.default_rng(4))
    seqs = b.drain()
    assert len(seqs) > 3
    for k, s in enumerate(seqs):
        start = 3 * k
        assert s["state_c"][0] == start              # its own start
        want_a = acts[start - 1] if start else 0
        want_r = rews[start - 1] if start else 0.0
        assert s["prev_action"].dtype == np.int32
        assert (int(s["prev_action"]), float(s["prev_reward"])) == (
            want_a, want_r), k
    # off, the sequences carry neither
    plain = port_r2d2.SequenceBuilder(BURN, UNROLL, NSTEP, 0.997, stride=3)
    _episode(plain, 20, np.random.default_rng(4))
    assert "prev_action" not in plain.drain()[0]


def test_acting_priorities_are_taken_in_the_rescaled_space():
    b = port_r2d2.SequenceBuilder(BURN, UNROLL, NSTEP, 0.997, stride=3,
                                  prev_inputs=True, rescale_eps=EPS)
    acts, rews, qs = _episode(b, 17, np.random.default_rng(5))
    n = len(acts)
    maxq = torch.tensor([float(q.max()) for q in qs[1:]] + [0.0])
    disc = torch.tensor([0.997] * (n - 1) + [0.0])
    target = ref.value_rescale(
        torch.tensor(rews) + disc * ref.inverse_value_rescale(maxq, EPS), EPS)
    td = (target - torch.tensor([q[a] for q, a in zip(qs, acts)])).abs()
    for k, s in enumerate(b.drain()):
        lo = 3 * k + BURN
        part = td[lo:min(lo + UNROLL, n)]
        want = 0.9 * part.max() + 0.1 * part.sum() / len(part) + 1e-6
        np.testing.assert_allclose(s["priority"], want, rtol=1e-6)


def test_pooled_messages_carry_the_new_fields_through_the_replay():
    b = port_r2d2.SequenceBuilder(BURN, UNROLL, NSTEP, 0.997, stride=3,
                                  pooled=True, prev_inputs=True,
                                  rescale_eps=EPS)
    rng = np.random.default_rng(6)
    for n in (14, 9, 11):
        _episode(b, n, rng)
    seqs = b.drain()[:4]
    want = [(int(s["prev_action"]), float(s["prev_reward"]),
             s["ep_frames"][s["start"]:s["end"]].copy()) for s in seqs]
    msg = pooled_sequence_message(seqs)
    assert msg["payload"]["prev_action"].shape == (4,)
    pool = SequenceFramePoolReplay(capacity=8, t_total=T,
                                   lstm_features=H_LSTM, frame_shape=SHAPE,
                                   frame_capacity=128, prev_inputs=True)
    state = pool.init("cpu")
    state = pool.add(state, msg["payload"], msg["priorities"])
    # one stratum per sequence, each uniform at the middle of its own
    # stratum: the four equal leaves come back in order
    pool.update_priorities(state, torch.arange(4), torch.ones(4))
    batch, _, idx = pool.sample(state, torch.full((4,), 0.5), 0.6)
    assert idx.tolist() == [0, 1, 2, 3]
    for i, (a, r, frames) in enumerate(want):
        assert int(batch["prev_action"][i]) == a
        assert float(batch["prev_reward"][i]) == r
        got = batch["obs"][i, :len(frames)].numpy()
        np.testing.assert_array_equal(got, frames)
    plain = dataclasses.replace(pool, prev_inputs=False)
    assert pool.hbm_bytes() - plain.hbm_bytes() == 8 * 8
    assert "prev_action" not in plain.sample(
        plain.init("cpu"), torch.full((4,), 0.5), 0.6)[0]


def _published(capacity=256, **r2d2):
    """The published recipe at this file's small widths, on 42x42 Catch."""
    return ApexConfig(
        env=EnvConfig(env_id="ApexCatchSmall-v0", frame_stack=1, seed=3),
        replay=ReplayConfig(capacity=capacity, alpha=0.9, beta=0.6,
                            warmup=64, frame_pool=True),
        learner=LearnerConfig(batch_size=B, lr=1e-4, lr_decay_steps=0,
                              gamma=0.997, n_steps=NSTEP,
                              optimizer="adam", adam_eps=EPS,
                              target_update_interval=2500,
                              compute_dtype="float32"),
        r2d2=R2D2Config(burn_in=BURN, unroll=UNROLL, stride=3,
                        lstm_features=H_LSTM, head_width=HEAD,
                        prev_action_reward=True, value_rescale_eps=EPS,
                        **r2d2))


def test_the_family_builds_the_published_recipe_from_the_config():
    cfg = _published()
    (spec, _, _, model, replay, _, train_state,
     core) = port_r2d2.build_r2d2(cfg, torch.device("cpu"))
    assert spec["head_width"] == HEAD and spec["prev_action_reward"]
    assert model.value_hidden.out_features == HEAD
    assert model.lstm.weight_ih.shape[1] == 64 + A + 1
    assert isinstance(core.optimizer, ClipAdam)
    assert (core.optimizer.lr, core.optimizer.eps) == (1e-4, EPS)
    assert core.rescale_eps == EPS and replay.prev_inputs
    assert len(train_state.opt_state.mu) == len(list(model.parameters()))
    # at the defaults the family's model is the JAX family's
    spec0 = port_r2d2.r2d2_env_specs(dataclasses.replace(
        cfg, r2d2=R2D2Config()))[0]
    assert (spec0["head_width"], spec0["prev_action_reward"]) == (128, False)
    with pytest.raises(ValueError, match="optimizer"):
        port_r2d2.make_r2d2_optimizer(dataclasses.replace(
            cfg.learner, optimizer="sgd"))


def test_the_budget_counts_the_new_leaves():
    pool = SequenceFramePoolReplay(capacity=2 ** 12, t_total=125,
                                   lstm_features=512, frame_capacity=380_928,
                                   frame_shape=(84, 84, 1), prev_inputs=True)
    nbytes = pool.hbm_bytes()
    assert nbytes - dataclasses.replace(
        pool, prev_inputs=False).hbm_bytes() == 8 * 2 ** 12
    # a budget that the ring without them would meet refuses the ring
    # with them
    tight = (nbytes - 4 * 2 ** 12) / 2 ** 30
    check_hbm_budget(nbytes - 8 * 2 ** 12, tight, "r2d2", 2 ** 12,
                     torch.device("cpu"))
    with pytest.raises(ValueError, match="budget"):
        check_hbm_budget(nbytes, tight, "r2d2", 2 ** 12, torch.device("cpu"))


def test_the_single_process_driver_learns_and_evaluates_with_prev_inputs():
    """``R2D2Trainer`` acts, ingests and trains on the published recipe,
    and greedy evaluation threads the previous action and reward."""
    trainer = port_r2d2.R2D2Trainer(_published(), device="cpu",
                                    train_every=8)
    trainer.train(total_frames=400, warmup_sequences=B)
    assert trainer.steps_rate.total > 0
    assert trainer.replay_state.extras["prev_reward"].abs().sum() > 0
    seen = []
    policy, reset = episodic_policy(trainer.model)
    forward = trainer.model.forward

    def spy(x, carry, prev=None):
        seen.append(None if prev is None else (int(prev[0][0, 0]),
                                               float(prev[1][0, 0])))
        return forward(x, carry, prev)

    trainer.model.forward = spy
    try:
        score = trainer.evaluate(episodes=1, max_steps=30)
    finally:
        trainer.model.forward = forward
    assert np.isfinite(score)
    assert seen[0] == (0, 0.0)
    assert any(r != 0.0 for _, r in seen)
