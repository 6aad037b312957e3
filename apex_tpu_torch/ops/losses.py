"""Loss and update rules of the DQN, R2D2 and AQL families.

Counterpart of :mod:`apex_tpu.ops.losses` (reference
``utils.compute_loss``/``update_parameters``, ``utils.py:64-97``): the
n-step double-DQN Huber loss with IS weights, the mixed-max priority
heuristic, the recurrent sequence loss with burn-in, global-norm clipping
+ centered RMSprop + StepLR, and the AQL half (``losses.py:225-330``):
the candidate-set Q loss, the proposal loss, the two parameter groups and
their per-group clip + Adam with an optional cosine schedule.

The optimizers are written out by hand to match optax, because stock
torch differs.  RMSprop, in three places:

* ``optax.clip_by_global_norm`` scales only when ``norm >= max_norm``,
  by exactly ``max_norm / norm`` (``clip_grad_norm_`` adds 1e-6);
* ``optax.rmsprop(centered=True)`` computes ``g * rsqrt(nu - mu^2 + eps)``
  with eps inside the root and nu = mu = 0 initially
  (``torch.optim.RMSprop`` puts eps outside);
* the learning rate is the staircase ``lr * rate^(count // steps)`` with
  ``count`` starting at 0.

Adam (``optax.adam``): ``torch.optim.Adam`` folds the bias corrections
into the step size and ``eps`` (``lr / bc1 * m / (sqrt(v) / sqrt(bc2) +
eps)``), where optax divides each moment by its correction first
(``mu_hat / (sqrt(nu_hat) + eps)``), and its schedule count is its own.

Parameters are updated in place, where optax returns new ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class TDOutput(NamedTuple):
    loss: torch.Tensor          # scalar
    td_abs: torch.Tensor        # (B,) |TD error|
    priorities: torch.Tensor    # (B,) mixed-max heuristic priorities
    q_taken: torch.Tensor       # (B,) Q(s0, a0)


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber in the reference's branchless form (``utils.py:79``)."""
    absx = x.abs()
    return torch.where(absx < delta, 0.5 * x * x, delta * (absx - 0.5 * delta))


# max/per-item priority mix weight (``utils.py:77``)
PRIORITY_ETA = 0.9


def mixed_max_priorities(td_abs: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return (PRIORITY_ETA * td_abs.max()
            + (1.0 - PRIORITY_ETA) * td_abs + eps)


def obs_pair(batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """obs‖next_obs: ``batch['obs_pair']`` where the batch carries it (the
    one tensor :meth:`~apex_tpu_torch.replay.frame_pool.FramePoolReplay.
    sample` gathers, whose halves are obs and next_obs), else
    ``torch.cat([obs, next_obs])``."""
    pair = batch.get("obs_pair")
    if pair is None:
        pair = torch.cat([batch["obs"], batch["next_obs"]])
    return pair


def double_dqn_loss(online: nn.Module, target: nn.Module,
                    batch: dict[str, torch.Tensor],
                    weights: torch.Tensor) -> tuple[torch.Tensor, TDOutput]:
    """IS-weighted n-step double-DQN Huber loss.  One online pass over
    obs‖next_obs (the reference runs two, ``utils.py:67-69``) and one
    target pass over next_obs.  ``batch['reward']`` is the n-step return
    and ``batch['discount']`` the bootstrap coefficient (``gamma**n``,
    ``gamma**k`` for truncated tails, 0 at terminals)."""
    q_values, next_q_values = online(obs_pair(batch)).chunk(2)
    with torch.no_grad():
        tgt_next_q_values = target(batch["next_obs"])

    actions = batch["action"].long()
    q_taken = q_values.gather(1, actions[:, None])[:, 0]
    next_actions = next_q_values.detach().argmax(dim=1)
    next_q_taken = tgt_next_q_values.gather(1, next_actions[:, None])[:, 0]

    target_q = batch["reward"] + batch["discount"] * next_q_taken
    td = target_q - q_taken
    td_abs = td.detach().abs()

    loss = (huber(td) * weights).mean()
    return loss, TDOutput(loss=loss.detach(), td_abs=td_abs,
                          priorities=mixed_max_priorities(td_abs),
                          q_taken=q_taken.detach())


def r2d2_loss(online: nn.Module, target: nn.Module,
              batch: dict[str, torch.Tensor], weights: torch.Tensor, *,
              burn_in: int, n_steps: int, eta: float = PRIORITY_ETA,
              eps: float = 1e-6) -> tuple[torch.Tensor, TDOutput]:
    """Sequence double-DQN loss of the recurrent family
    (``apex_tpu/ops/losses.py:105-193``).

    ``online``/``target`` map ``(obs_seq [B, L, *obs], (c, h)) -> (q [B, L,
    A], (c, h))``.  ``batch``: ``obs [B, T, *obs]``, ``action``/``reward``/
    ``discount``/``mask`` ``[B, T]`` (``discount`` = gamma per step, 0 at
    terminals and on padding; ``mask`` 1 on real loss steps) and
    ``state_c``/``state_h`` ``[B, H]``, the stored state at sequence start.
    ``T = burn_in + unroll + n_steps``; the loss covers the ``unroll``
    positions after the burn-in.

    Both nets unroll the burn-in from the stored state with no gradient;
    then n-step double-DQN over the unroll, bootstrapping from the target
    net at the online argmax, a masked Huber mean per sequence weighted by
    the IS weights, and per-sequence priorities ``eta * max + (1 - eta) *
    mean + eps`` of the masked |TD|.  ``td_abs`` and ``q_taken`` in the
    output are per-sequence means over the mask.
    """
    obs = batch["obs"]
    t_total = obs.shape[1]
    unroll = t_total - burn_in - n_steps
    if unroll < 1:
        raise ValueError(
            f"sequence length {t_total} too short for burn_in={burn_in} "
            f"+ n_steps={n_steps} + at least one unroll step")

    carry_on = carry_tg = (batch["state_c"], batch["state_h"])
    with torch.no_grad():
        if burn_in:
            _, carry_on = online(obs[:, :burn_in], carry_on)
            _, carry_tg = target(obs[:, :burn_in], carry_tg)
        body = obs[:, burn_in:]                    # [B, unroll + n, *obs]
        qt_seq, _ = target(body, carry_tg)
    q_seq, _ = online(body, carry_on)

    r = batch["reward"][:, burn_in:]
    d = batch["discount"][:, burn_in:]
    m = batch["mask"][:, burn_in:]
    # n-step returns per unroll position; discount 0 at terminals and on
    # padding truncates every product past the episode's end
    returns = torch.zeros_like(r[:, :unroll])
    disc_prod = torch.ones_like(returns)
    for i in range(n_steps):
        returns = returns + disc_prod * r[:, i:i + unroll]
        disc_prod = disc_prod * d[:, i:i + unroll]

    next_online = q_seq.detach()[:, n_steps:n_steps + unroll]
    next_target = qt_seq[:, n_steps:n_steps + unroll]
    a_star = next_online.argmax(dim=-1, keepdim=True)
    bootstrap = next_target.gather(-1, a_star)[..., 0]
    target_q = returns + disc_prod * bootstrap

    actions = batch["action"][:, burn_in:burn_in + unroll].long()
    q_taken = q_seq[:, :unroll].gather(-1, actions[..., None])[..., 0]
    td = target_q - q_taken
    lmask = m[:, :unroll]
    n_valid = lmask.sum(dim=1).clamp_min(1.0)

    loss = ((huber(td) * lmask).sum(dim=1) / n_valid * weights).mean()

    td_abs = td.detach().abs() * lmask
    seq_mean = td_abs.sum(dim=1) / n_valid
    priorities = eta * td_abs.max(dim=1).values + (1.0 - eta) * seq_mean + eps
    q_mean = (q_taken.detach() * lmask).sum(dim=1) / n_valid
    return loss, TDOutput(loss=loss.detach(), td_abs=seq_mean,
                          priorities=priorities, q_taken=q_mean)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@dataclass
class RMSpropState:
    count: int = 0                                      # updates taken
    mu: list = field(default_factory=list)              # first moments
    nu: list = field(default_factory=list)              # second moments


@dataclass(frozen=True)
class ClipRMSprop:
    """Clip-by-global-norm then (centered) RMSprop with a staircase lr,
    matching ``apex_tpu.ops.losses.make_optimizer``'s optax chain."""

    lr: float = 6.25e-5
    decay: float = 0.95
    eps: float = 1.5e-7
    centered: bool = True
    max_grad_norm: float = 40.0
    lr_decay_steps: int | None = 1000
    lr_decay_rate: float = 0.99

    def init(self, params: list[torch.Tensor]) -> RMSpropState:
        return RMSpropState(count=0,
                            mu=[torch.zeros_like(p) for p in params],
                            nu=[torch.zeros_like(p) for p in params])

    def learning_rate(self, count: int) -> float:
        if not self.lr_decay_steps:
            return self.lr
        return self.lr * self.lr_decay_rate ** (count // self.lr_decay_steps)

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             state: RMSpropState) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place.  Returns the
        global norm of the unclipped ``grads``."""
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        lr = self.learning_rate(state.count)
        d = self.decay
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(keep, g, g / norm * self.max_grad_norm)
            nu.copy_((1 - d) * (g * g) + d * nu)
            if self.centered:
                mu.copy_((1 - d) * g + d * mu)
                scaling = torch.rsqrt(nu - mu * mu + self.eps)
            else:
                scaling = torch.rsqrt(nu + self.eps)
            p.add_(-lr * (scaling * g))
        state.count += 1
        return norm


def make_optimizer(lr: float = 6.25e-5, decay: float = 0.95,
                   eps: float = 1.5e-7, centered: bool = True,
                   max_grad_norm: float = 40.0,
                   lr_decay_steps: int | None = 1000,
                   lr_decay_rate: float = 0.99) -> ClipRMSprop:
    """Clip-then-RMSprop (``ApeX.py:37`` + ``utils.py:95``) with the
    drivers' ``StepLR(step_size=1000, gamma=0.99)`` as a staircase decay
    (``DQN.py:39,71``); ``lr_decay_steps=0``/``None`` = constant lr."""
    return ClipRMSprop(lr=lr, decay=decay, eps=eps, centered=centered,
                       max_grad_norm=max_grad_norm,
                       lr_decay_steps=lr_decay_steps,
                       lr_decay_rate=lr_decay_rate)


# -- AQL (proposal-action Q-learning) --------------------------------------

class AQLOutput(NamedTuple):
    loss: torch.Tensor          # scalar
    td_abs: torch.Tensor        # (B,) |TD error|
    priorities: torch.Tensor    # (B,) mixed-max heuristic priorities
    q_taken: torch.Tensor       # (B,) Q(s, a_mu[idx])
    best_idx: torch.Tensor      # (B,) argmax-Q candidate of s (no grad)


def aql_q_loss(online: nn.Module, target: nn.Module,
               batch: dict[str, torch.Tensor], weights: torch.Tensor,
               online_noise: dict, target_noise: dict
               ) -> tuple[torch.Tensor, AQLOutput]:
    """Double-DQN TD loss over the stored candidate set (reference
    ``compute_loss_AQL``, ``utils.py:44-61``).  ``batch['action']`` is
    the index into ``batch['a_mu'] [B, T, A]``; obs and next_obs are
    scored against the same stored set, in one online pass over
    obs‖next_obs.  ``online_noise``/``target_noise`` are one NoisyNet
    draw per network for the whole update (:meth:`~apex_tpu_torch.models.
    aql.AQLDraws.noise`).  ``best_idx`` is the online argmax over the
    obs half, under the same draw: data for the proposal loss."""
    a_mu = batch["a_mu"]
    q_both = online.score(obs_pair(batch), torch.cat([a_mu, a_mu]),
                          online_noise)
    q_values, next_q_values = q_both.chunk(2)
    with torch.no_grad():
        tgt_next_q_values = target.score(batch["next_obs"], a_mu,
                                         target_noise)

    idx = batch["action"].long()
    q_taken = q_values.gather(1, idx[:, None])[:, 0]
    next_idx = next_q_values.detach().argmax(dim=1)
    next_q_taken = tgt_next_q_values.gather(1, next_idx[:, None])[:, 0]

    target_q = batch["reward"] + batch["discount"] * next_q_taken
    td = target_q - q_taken
    td_abs = td.detach().abs()
    loss = (huber(td) * weights).mean()
    return loss, AQLOutput(loss=loss.detach(), td_abs=td_abs,
                           priorities=mixed_max_priorities(td_abs),
                           q_taken=q_taken.detach(),
                           best_idx=q_values.detach().argmax(dim=1))


def aql_proposal_loss(model: nn.Module, batch: dict[str, torch.Tensor],
                      best_idx: torch.Tensor,
                      entropy_coef: float) -> torch.Tensor:
    """Entropy-regularized NLL of the argmax-Q candidate (reference
    ``AQL_dis.py:79-86``): the proposal mean is pulled toward the
    candidate the Q head ranks best."""
    a_mu = batch["a_mu"]
    rows = torch.arange(a_mu.shape[0], device=a_mu.device)
    best_action = a_mu[rows, best_idx].detach()
    log_prob, entropy = model.proposal_log_prob(batch["obs"], best_action)
    return (-log_prob - entropy_coef * entropy).mean()


#: top-level parameter-name prefixes of the proposal optimizer group
PROPOSAL_PREFIXES = ("proposal", "embed")


def aql_param_labels(model: nn.Module) -> dict[str, str]:
    """``"proposal"`` / ``"q"`` per parameter name, in
    ``named_parameters`` order (``losses.py:283-302``).  The embedding
    trunk belongs to the proposal group: it feeds only the proposal mean
    (the Q head reads raw observations through ``q_feature``)."""
    return {name: "proposal" if name.startswith(PROPOSAL_PREFIXES) else "q"
            for name, _ in model.named_parameters()}


def aql_param_groups(model: nn.Module) -> dict[str, list[torch.Tensor]]:
    """The two groups' parameters, ``{"q": [...], "proposal": [...]}``,
    each in ``named_parameters`` order."""
    labels = aql_param_labels(model)
    groups: dict[str, list] = {"q": [], "proposal": []}
    for name, p in model.named_parameters():
        groups[labels[name]].append(p)
    return groups


def cosine_annealing(lr: float, t_max: int, eta_min: float):
    """torch ``CosineAnnealingLR``'s value curve, ``eta_min + (lr -
    eta_min) * (1 + cos(pi * t / t_max)) / 2``, held at ``eta_min`` past
    ``t_max`` (``losses.py:320-330``).  Evaluated in f32, with optax's
    operation order."""
    half = np.float32((lr - eta_min) * 0.5)

    def schedule(count: int) -> float:
        t = np.float32(min(count, t_max))
        cos = np.cos(np.float32(math.pi) * t / np.float32(t_max))
        return float(np.float32(eta_min) + half * (np.float32(1.0) + cos))

    return schedule


@dataclass
class AdamState:
    count: int = 0                                      # updates taken
    mu: list = field(default_factory=list)              # first moments
    nu: list = field(default_factory=list)              # second moments


@dataclass
class AQLOptState:
    """One :class:`AdamState` per parameter group."""

    q: AdamState
    proposal: AdamState


@dataclass(frozen=True)
class ClipAdam:
    """Clip-by-global-norm then Adam, matching ``optax.chain(
    optax.clip_by_global_norm(max_grad_norm), optax.adam(lr))`` with ``lr``
    constant or, with ``cosine_steps``, :func:`cosine_annealing` down to
    ``lr / 1000``."""

    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 40.0
    cosine_steps: int | None = None

    def init(self, params: list[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def learning_rate(self, count: int) -> float:
        if not self.cosine_steps:
            return self.lr
        return cosine_annealing(self.lr, self.cosine_steps,
                                self.lr / 1000.0)(count)

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             state: AdamState) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place; returns the
        global norm of the unclipped ``grads``."""
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        lr = self.learning_rate(state.count)
        count = state.count + 1
        # optax: 1 - decay**count in f32, each moment divided by its own
        one = np.float32(1.0)
        bc1 = one - np.float32(self.b1) ** np.float32(count)
        bc2 = one - np.float32(self.b2) ** np.float32(count)
        b1, b2 = self.b1, self.b2
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(keep, g, g / norm * self.max_grad_norm)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            update = (mu / float(bc1)) / ((nu / float(bc2)).sqrt()
                                          + self.eps)
            p.add_(update * -lr)
        state.count = count
        return norm


@dataclass(frozen=True)
class AQLOptimizer:
    """Per-group clip + Adam over :func:`aql_param_groups`
    (``make_aql_optimizer``, ``losses.py:305-317``; reference
    ``AQL.py:41-42``, ``AQL_dis.py:87-101``): each group clips by its own
    norm and steps its own Adam."""

    q: ClipAdam
    proposal: ClipAdam

    def init(self, model: nn.Module) -> AQLOptState:
        groups = aql_param_groups(model)
        return AQLOptState(q=self.q.init(groups["q"]),
                           proposal=self.proposal.init(groups["proposal"]))

    def step(self, model: nn.Module, grads: dict[str, list[torch.Tensor]],
             state: AQLOptState) -> None:
        """Update both groups of ``model`` in place from ``grads``, a list
        per group in :func:`aql_param_groups` order."""
        groups = aql_param_groups(model)
        self.q.step(groups["q"], grads["q"], state.q)
        self.proposal.step(groups["proposal"], grads["proposal"],
                           state.proposal)


def make_aql_optimizer(q_lr: float = 1e-4, proposal_lr: float = 1e-4,
                       max_grad_norm: float = 40.0,
                       cosine_steps: int | None = None) -> AQLOptimizer:
    """The two-group optimizer of ``losses.py:305-317``; ``cosine_steps``
    is ``CosineAnnealingLR(T_max, eta_min=lr/1000)`` on both groups
    (``AQL.py:48-49``), ``None``/0 a constant lr (``AQL_dis``)."""
    return AQLOptimizer(
        q=ClipAdam(lr=q_lr, max_grad_norm=max_grad_norm,
                   cosine_steps=cosine_steps),
        proposal=ClipAdam(lr=proposal_lr, max_grad_norm=max_grad_norm,
                          cosine_steps=cosine_steps))
