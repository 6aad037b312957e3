"""R2D2 at its published architecture, written plainly in float32.

Kapturowski et al., "Recurrent Experience Replay in Distributed
Reinforcement Learning" (ICLR 2019): the Nature-DQN trunk, one LSTM fed
the trunk's features, the previous action one-hot and the previous reward
(the appendix; Acme's R2D2 Atari network embeds the same three), dueling
heads with a hidden layer each; stored recurrent state at each sequence
start, a burn-in prefix that only warms the state, n-step double
Q-learning on value-rescaled targets, priorities mixed from the max and
the mean |TD| of a sequence, and Adam.  Plain ``torch`` with TF32 off:
no kernel, fused RNN or mixed precision; the LSTM is an explicit loop
over steps.

Everything is a function of a parameter dict named as the measured
model's parameters: ``Conv_{0,1,2}.{weight,bias}`` (torch layout ``[out,
in, kh, kw]`` over NCHW), ``lstm.weight_ih [4H, F + A + 1]``,
``lstm.weight_hh [4H, H]``, ``lstm.bias_hh [4H]``, and
``{advantage,value}_{hidden,out}.{weight,bias}``.

Departures from the paper, each deliberate:

* Single 84x84x1 frames with no frame stack: the LSTM is the memory (the
  paper stacks four frames).
* The LSTM has one bias vector, on the hidden side (the measured model
  keeps flax's parameter set); gates in the order i, f, g, o.
* The previous reward enters raw (Acme squashes it with tanh); at an
  episode's first step the previous action is action 0 and the previous
  reward 0 (Acme's reset values).
* The per-step loss is the Huber loss with delta 1, as the measured
  family keeps it (the paper says squared TD); with rescaled targets
  the TDs stay well under 1, where the two agree (``0.5 td^2``).
* Adam clips the gradients to a global norm first (``max_norm``; the
  paper gives none), with betas 0.9 and 0.999 (the paper gives neither).

``quant`` rounds what each convolution and linear layer of the trunk and
heads reads (a lower precision standing in for what the configuration
computes in bfloat16); ``lstm_dtype`` runs the recurrence in another
dtype.  Both default to plain float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CONV = ((4, 0), (2, 1), (1, 2))      # (stride, layer) of the trunk
ETA = 0.9                            # priority mix of max and mean |TD|


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q(x, quant):
    return x if quant is None else quant(x)


def linear(p: dict, name: str, x: torch.Tensor, quant=None) -> torch.Tensor:
    return F.linear(_q(x, quant), _q(p[f"{name}.weight"], quant),
                    p[f"{name}.bias"])


def trunk(p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """``x`` u8 ``[N, H, W, C]`` -> features ``[N, h*w*c]``, flattened in
    (h, w, c) order after three ReLU convolutions."""
    x = x.float() / 255.0
    x = x.permute(0, 3, 1, 2)
    for stride, i in CONV:
        x = torch.relu(F.conv2d(_q(x, quant), _q(p[f"Conv_{i}.weight"], quant),
                                p[f"Conv_{i}.bias"], stride=stride))
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def heads(p: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    """Dueling heads: ``V + A - mean(A)``."""
    adv = linear(p, "advantage_out",
                 torch.relu(linear(p, "advantage_hidden", h, quant)), quant)
    val = linear(p, "value_out",
                 torch.relu(linear(p, "value_hidden", h, quant)), quant)
    return val + adv - adv.mean(dim=-1, keepdim=True)


def lstm(p: dict, x: torch.Tensor, carry, dtype=torch.float32):
    """The LSTM over ``x [B, L, F]`` one step at a time from ``carry =
    (c, h)``: ``i, f, g, o`` from ``x W_ih^T + h W_hh^T + b_hh``, ``c' =
    sigmoid(f) c + sigmoid(i) tanh(g)``, ``h' = sigmoid(o) tanh(c')``.
    Returns ``(h_seq [B, L, H] f32, (c, h))``; ``dtype`` is what every
    step computes and carries in."""
    w_ih = p["lstm.weight_ih"].to(dtype)
    w_hh = p["lstm.weight_hh"].to(dtype)
    b = p["lstm.bias_hh"].to(dtype)
    c, h = (t.to(dtype) for t in carry)
    out = []
    for t in range(x.shape[1]):
        gates = x[:, t].to(dtype) @ w_ih.T + h @ w_hh.T + b
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return (torch.stack(out, 1).float(), (c.float(), h.float()))


def q_values(p: dict, obs: torch.Tensor, carry, prev=None, quant=None,
             lstm_dtype=torch.float32):
    """Q-values ``[B, L, A]`` of frames ``obs`` u8 ``[B, L, H, W, C]`` from
    ``carry``, and the carry after them.  ``prev = (prev_action [B, L],
    prev_reward [B, L])`` feed the LSTM the action taken and the reward
    received before each step; None feeds the trunk's features alone."""
    b, length = obs.shape[:2]
    x = trunk(p, obs.reshape((b * length,) + tuple(obs.shape[2:])), quant)
    x = x.view(b, length, -1)
    if prev is not None:
        n_actions = p["advantage_out.weight"].shape[0]
        onehot = F.one_hot(prev[0].long(), n_actions).float()
        x = torch.cat([x, onehot, prev[1].float()[..., None]], -1)
    h_seq, carry = lstm(p, x, carry, lstm_dtype)
    return heads(p, h_seq, quant), carry


def value_rescale(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``h(x) = sign(x) (sqrt(|x| + 1) - 1) + eps x``."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def inverse_value_rescale(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The inverse of :func:`value_rescale` for ``eps > 0``."""
    root = (torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0 + eps)) - 1.0) / (
        2.0 * eps)
    return torch.sign(x) * (root * root - 1.0)


def huber(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.where(a < 1.0, 0.5 * x * x, a - 0.5)


def previous(batch: dict):
    """The previous action and reward of every stored step ``[B, T]``: the
    sequence's stored ``prev_action``/``prev_reward`` first, then its own
    actions and rewards one step late; None for a batch without them."""
    if "prev_action" not in batch:
        return None
    a, r = batch["action"].long(), batch["reward"].float()
    return (torch.cat([batch["prev_action"].long()[:, None], a[:, :-1]], 1),
            torch.cat([batch["prev_reward"].float()[:, None], r[:, :-1]], 1))


def sequence_loss(p: dict, tp: dict, batch: dict, weights: torch.Tensor,
                  burn_in: int, n_steps: int, rescale_eps: float | None,
                  quant=None, lstm_dtype=torch.float32):
    """``(loss, priorities [B], td [B, unroll])`` of a batch of stored
    sequences ``obs [B, T, H, W, C]``, ``action``/``reward``/``discount``/
    ``mask`` ``[B, T]`` (``discount`` gamma a step, 0 at terminals and on
    padding), ``state_c``/``state_h`` ``[B, H]`` and, where the model reads
    them, ``prev_action``/``prev_reward`` ``[B]``.

    Both nets unroll the ``burn_in`` steps from the stored state without a
    gradient; over the ``unroll = T - burn_in - n_steps`` steps after them
    the target is ``h(R + disc * h^-1(Q_target(s', argmax Q_online(s'))))``
    with the n-step return ``R`` and ``disc`` the product of the n
    discounts (no rescaling with ``rescale_eps`` None); the loss is the
    IS-weighted mean over sequences of the masked mean Huber of the TD,
    the priorities ``ETA max|td| + (1 - ETA) mean|td| + 1e-6`` over the
    mask."""
    obs = batch["obs"]
    t_total = obs.shape[1]
    unroll = t_total - burn_in - n_steps
    prev = previous(batch)

    def run(q, lo, hi, carry):
        part = None if prev is None else tuple(x[:, lo:hi] for x in prev)
        return q_values(q, obs[:, lo:hi], carry, part, quant, lstm_dtype)

    carry_on = carry_tg = (batch["state_c"].float(),
                           batch["state_h"].float())
    with torch.no_grad():
        if burn_in:
            _, carry_on = run(p, 0, burn_in, carry_on)
            _, carry_tg = run(tp, 0, burn_in, carry_tg)
        q_tg, _ = run(tp, burn_in, t_total, carry_tg)
    q_on, _ = run(p, burn_in, t_total, carry_on)

    r = batch["reward"].float()[:, burn_in:]
    d = batch["discount"].float()[:, burn_in:]
    m = batch["mask"].float()[:, burn_in:burn_in + unroll]
    ret = torch.zeros_like(r[:, :unroll])
    disc = torch.ones_like(ret)
    for i in range(n_steps):
        ret = ret + disc * r[:, i:i + unroll]
        disc = disc * d[:, i:i + unroll]
    a_star = q_on.detach()[:, n_steps:n_steps + unroll].argmax(-1)
    boot = q_tg[:, n_steps:n_steps + unroll].gather(-1, a_star[..., None])
    boot = boot[..., 0]
    if rescale_eps is None:
        target = ret + disc * boot
    else:
        target = value_rescale(
            ret + disc * inverse_value_rescale(boot, rescale_eps),
            rescale_eps)
    a = batch["action"].long()[:, burn_in:burn_in + unroll]
    q_taken = q_on[:, :unroll].gather(-1, a[..., None])[..., 0]
    td = target - q_taken
    n_valid = m.sum(1).clamp_min(1.0)
    loss = ((huber(td) * m).sum(1) / n_valid * weights).mean()
    td_abs = td.detach().abs() * m
    prios = (ETA * td_abs.max(1).values + (1.0 - ETA) * td_abs.sum(1)
             / n_valid + 1e-6)
    return loss, prios, td.detach() * m


def adam(params: list, grads: list, mu: list, nu: list, count: int,
         lr: float, eps: float, max_norm: float, b1: float = 0.9,
         b2: float = 0.999) -> list:
    """One update in place (``count`` updates taken before it): clip to
    global norm ``max_norm`` (scaled only when the norm reaches it), then
    Adam with bias-corrected moments, ``p -= lr * m_hat / (sqrt(v_hat) +
    eps)``.  Returns the clipped gradients."""
    with torch.no_grad():
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = 1.0 if float(norm) < max_norm else max_norm / norm
        k = count + 1
        clipped = []
        for p, g, m, v in zip(params, grads, mu, nu):
            g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** k)
            v_hat = v / (1 - b2 ** k)
            p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
            clipped.append(g)
    return clipped
