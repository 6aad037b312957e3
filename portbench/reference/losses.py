"""The losses and the update rule.

n-step double DQN: ``target = R + discount * Q_target(s', argmax_a
Q_online(s', a))`` with the stored n-step return ``R`` and bootstrap
coefficient ``discount``; the IS-weighted mean of the Huber loss (delta
1); new priorities ``0.9 * max|td| + 0.1 * |td| + 1e-6`` over the batch.

The update: clip the gradients to global norm ``max_norm`` (scaled only
when the norm is at least ``max_norm``), then centered RMSprop with eps
inside the root (``nu - mu**2 + eps``), moments starting at zero, and
the staircase rate ``lr * rate ** (count // steps)``.
"""

from __future__ import annotations

import torch

from portbench.reference.nets import dueling_q

ETA = 0.9


def huber(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.where(a < 1.0, 0.5 * x * x, a - 0.5)


def dqn_loss(p: dict, tp: dict, batch: dict, weights: torch.Tensor,
             quant=None, keep_rows=None):
    """(loss, priorities) of one batch.  ``keep_rows`` keeps only the
    first rows of the batch in the loss (a planted fault)."""
    obs, nxt = batch["obs"], batch["next_obs"]
    q = dueling_q(p, obs, quant)
    next_online = dueling_q(p, nxt, quant).detach()
    with torch.no_grad():
        next_target = dueling_q(tp, nxt, quant)
    a = batch["action"].long()
    q_taken = q.gather(1, a[:, None])[:, 0]
    a_star = next_online.argmax(dim=1)
    boot = next_target.gather(1, a_star[:, None])[:, 0]
    td = batch["reward"] + batch["discount"] * boot - q_taken
    terms = huber(td) * weights
    if keep_rows is not None:
        terms = terms[:keep_rows]
    loss = terms.mean()
    td_abs = td.detach().abs()
    prios = ETA * td_abs.max() + (1.0 - ETA) * td_abs + 1e-6
    return loss, prios


def clip_rmsprop(params: list, grads: list, mu: list, nu: list, count: int,
                 hp: dict) -> list:
    """One update in place; returns the clipped gradients."""
    with torch.no_grad():
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.where(norm < hp["max_grad_norm"], torch.ones_like(norm),
                            hp["max_grad_norm"] / norm)
        steps = hp["lr_decay_steps"]
        lr = hp["lr"] * (hp["lr_decay_rate"] ** (count // steps)
                         if steps else 1.0)
        d, eps = hp["rmsprop_decay"], hp["rmsprop_eps"]
        clipped = []
        for p, g, m, n in zip(params, grads, mu, nu):
            g = g * scale
            n.mul_(d).add_((1 - d) * g * g)
            m.mul_(d).add_((1 - d) * g)
            p.sub_(lr * g * torch.rsqrt(n - m * m + eps))
            clipped.append(g)
    return clipped
