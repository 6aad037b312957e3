"""Loss and update rules of the DQN family.

Counterpart of the DQN part of :mod:`apex_tpu.ops.losses` (reference
``utils.compute_loss``/``update_parameters``, ``utils.py:64-97``): the
n-step double-DQN Huber loss with IS weights, the mixed-max priority
heuristic, and global-norm clipping + centered RMSprop + StepLR.

The optimizer is written out by hand to match optax, because stock torch
differs in three places:

* ``optax.clip_by_global_norm`` scales only when ``norm >= max_norm``,
  by exactly ``max_norm / norm`` (``clip_grad_norm_`` adds 1e-6);
* ``optax.rmsprop(centered=True)`` computes ``g * rsqrt(nu - mu^2 + eps)``
  with eps inside the root and nu = mu = 0 initially
  (``torch.optim.RMSprop`` puts eps outside);
* the learning rate is the staircase ``lr * rate^(count // steps)`` with
  ``count`` starting at 0.

Parameters are updated in place, where optax returns new ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

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


def double_dqn_loss(online: nn.Module, target: nn.Module,
                    batch: dict[str, torch.Tensor],
                    weights: torch.Tensor) -> tuple[torch.Tensor, TDOutput]:
    """IS-weighted n-step double-DQN Huber loss.  One online pass over
    obs‖next_obs (the reference runs two, ``utils.py:67-69``) and one
    target pass over next_obs.  ``batch['reward']`` is the n-step return
    and ``batch['discount']`` the bootstrap coefficient (``gamma**n``,
    ``gamma**k`` for truncated tails, 0 at terminals)."""
    obs, next_obs = batch["obs"], batch["next_obs"]
    q_values, next_q_values = online(torch.cat([obs, next_obs])).chunk(2)
    with torch.no_grad():
        tgt_next_q_values = target(next_obs)

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
