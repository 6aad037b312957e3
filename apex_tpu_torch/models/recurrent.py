"""Recurrent dueling DQN (R2D2-style) as a torch ``nn.Module``.

Counterpart of :class:`apex_tpu.models.recurrent.RecurrentDuelingDQN`
(``recurrent.py:38-131``): the trunk and dueling heads of
:class:`apex_tpu_torch.models.dueling.DuelingDQN` with an LSTM between
them.  Kept from the JAX model, so the two take the same inputs and
weights:

* NHWC uint8 in, ``/255`` inside, the trunk flattened in ``(h, w, c)``
  order; parameter names ``Conv_0..2``, ``Dense_0``, ``lstm``,
  ``{advantage,value}_{hidden,out}``.  Trunk and heads run batched over
  ``B*L`` frames under ``torch.autocast`` in the compute dtype; the heads'
  output is f32.
* The LSTM runs in f32 outside autocast (bf16 carries drift over long
  unrolls), over the whole ``[B, L]`` segment in one ``torch.lstm`` call,
  where JAX scans one cell with ``lax.scan``.  On the card that call is
  cuDNN's, which would take TF32 for its matmuls under torch's default
  ``cudnn.allow_tf32``; :class:`LSTM` turns that off around the call
  (:func:`f32_cudnn`), and the learner around its backward too, so the
  recurrence is f32 on the card as on the CPU.
* With ``prev_action_reward`` (R2D2's appendix; Acme's observation,
  action and reward embedding) the LSTM's input is the trunk's features,
  then the previous action one-hot (``num_actions`` wide) and then the
  previous reward (one column, raw), so ``weight_ih`` is ``[4H, F + A +
  1]``.  At an episode's first step both are zero, the previous action
  being action 0 (Acme's reset values).  Off (the default), the model
  is the JAX model.
* The carry is ``(c, h)``, each ``f32[B, lstm_features]``, flax's order
  (torch's own LSTM takes ``(h, c)``).
* flax's ``OptimizedLSTMCell`` has biases on the hidden side only
  (``hi/hf/hg/ho``).  The port's LSTM holds ``weight_ih [4H, F]``,
  ``weight_hh [4H, H]`` and ``bias_hh [4H]`` as parameters, gates in the
  order i, f, g, o on both sides, and ``bias_ih`` as a zero buffer: the
  trainable set, the optimizer's state and the gradient norm the clip
  reads are JAX's.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn

from apex_tpu_torch.models.dueling import _CONV_GEOMETRY, _RELU_GAIN


class LSTM(nn.Module):
    """One LSTM layer over ``[B, L, F]`` with flax's parameter set (module
    docstring); ``forward(x, (c, h)) -> (h_seq [B, L, H], (c, h))``."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        self.bias_hh = nn.Parameter(torch.zeros(4 * features))
        self.register_buffer("bias_ih", torch.zeros(4 * features))
        # the initializers of flax's OptimizedLSTMCell: lecun-normal input
        # kernels (variance_scaling(1, "fan_in", "truncated_normal"): a
        # normal truncated at +-2 std, its std raised by 1/0.87962566 so
        # the truncated draw keeps variance 1/fan_in), an orthogonal
        # recurrent kernel per gate, zero biases
        std = in_features ** -0.5 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight_ih, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            for gate in self.weight_hh.view(4, features, features):
                nn.init.orthogonal_(gate, generator=generator)

    def forward(self, x: torch.Tensor, carry):
        c, h = carry
        train = torch.is_grad_enabled() and self.weight_ih.requires_grad
        with f32_cudnn():
            h_seq, h_n, c_n = torch.lstm(
                x, (h[None].contiguous(), c[None].contiguous()),
                [self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh],
                True, 1, 0.0, train, False, True)
        return h_seq, (c_n[0], h_n[0])


@contextlib.contextmanager
def f32_cudnn():
    """cuDNN's RNN in f32 math: TF32 off inside, restored after.  The flag
    is read when cuDNN's descriptors are made, so a backward pass takes
    the value in force where ``autograd.grad`` is called."""
    flags = torch.backends.cudnn
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = saved


class RecurrentDuelingDQN(nn.Module):
    """Dueling Q-network with an LSTM between trunk and heads.

    ``forward(x_seq, carry, prev=None)`` takes ``x_seq [B, L,
    *obs_shape]`` and ``carry = (c, h)``, each ``f32[B, lstm_features]``;
    with ``prev_action_reward`` also ``prev = (prev_action [B, L],
    prev_reward [B, L])``, the action taken and the reward received before
    each step; returns ``(q_seq f32[B, L, A], new_carry)``.  ``obs_shape``
    is one observation, ``(H, W, C)`` for pixels or ``(D,)`` for vectors.
    ``generator`` draws the init (never the global RNG).
    """

    def __init__(self, num_actions: int, obs_shape: Sequence[int],
                 obs_is_image: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 scale_uint8: bool = True,
                 trunk_features: Sequence[int] = (32, 64, 64),
                 lstm_features: int = 128, head_width: int = 128,
                 prev_action_reward: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_actions = num_actions
        self.prev_action_reward = prev_action_reward
        self.obs_is_image = obs_is_image
        self.compute_dtype = compute_dtype
        self.scale_uint8 = scale_uint8
        self.lstm_features = lstm_features
        if obs_is_image:
            h, w, cin = obs_shape
            for i, (feats, (kernel, stride)) in enumerate(
                    zip(trunk_features, _CONV_GEOMETRY)):
                setattr(self, f"Conv_{i}",
                        nn.Conv2d(cin, feats, kernel, stride))
                h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
                cin = feats
            trunk_out = h * w * cin
        else:
            self.Dense_0 = nn.Linear(obs_shape[0], 128)
            trunk_out = 128
        for name, out_dim in (("advantage", num_actions), ("value", 1)):
            setattr(self, f"{name}_hidden",
                    nn.Linear(lstm_features, head_width))
            setattr(self, f"{name}_out", nn.Linear(head_width, out_dim))
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                nn.init.orthogonal_(module.weight, gain=_RELU_GAIN,
                                    generator=generator)
                nn.init.zeros_(module.bias)
        lstm_in = trunk_out + (num_actions + 1 if prev_action_reward else 0)
        self.lstm = LSTM(lstm_in, lstm_features, generator=generator)

    def initial_state(self, batch_size: int,
                      device: torch.device | str | None = None):
        """Zero carry ``(c, h)``, f32, on the model's device unless
        ``device`` is given."""
        if device is None:
            device = self.lstm.weight_ih.device
        z = torch.zeros((batch_size, self.lstm_features), device=device)
        return (z, z.clone())

    def forward(self, x_seq: torch.Tensor, carry, prev=None):
        dt = self.compute_dtype
        b, length = x_seq.shape[:2]
        x = x_seq.reshape((b * length,) + tuple(x_seq.shape[2:]))
        if x.dtype == torch.uint8 and self.scale_uint8:
            x = x.to(dt) / 255.0
        else:
            x = x.to(dt)
        mixed = dict(device_type=x.device.type, dtype=dt,
                     enabled=dt != torch.float32)
        with torch.autocast(**mixed):
            if self.obs_is_image:
                x = x.permute(0, 3, 1, 2)              # NHWC -> NCHW view
                for i in range(len(_CONV_GEOMETRY)):
                    x = torch.relu(getattr(self, f"Conv_{i}")(x))
                x = x.permute(0, 2, 3, 1).reshape(b * length, -1)
            else:
                x = torch.relu(self.Dense_0(x))
        with torch.autocast(x.device.type, enabled=False):
            x = x.float().view(b, length, -1)
            if self.prev_action_reward:
                if prev is None:
                    raise ValueError("this model reads the previous action "
                                     "and reward: pass prev")
                x = torch.cat([x, prev_inputs(prev, self.num_actions)], -1)
            h_seq, carry = self.lstm(x, carry)
        with torch.autocast(**mixed):
            h = h_seq.reshape(b * length, -1).to(dt)
            advantage = self.advantage_out(
                torch.relu(self.advantage_hidden(h))).float()
            value = self.value_out(torch.relu(self.value_hidden(h))).float()
        q = value + advantage - advantage.mean(dim=1, keepdim=True)
        return q.view(b, length, self.num_actions), carry


def prev_inputs(prev, num_actions: int) -> torch.Tensor:
    """``(prev_action [B, L], prev_reward [B, L])`` as the LSTM's extra
    input columns ``f32[B, L, A + 1]``: the action one-hot, then the
    reward."""
    action, reward = prev
    onehot = torch.nn.functional.one_hot(action.long(), num_actions)
    return torch.cat([onehot.float(), reward.float()[..., None]], -1)


def make_recurrent_policy_fn(model: RecurrentDuelingDQN):
    """Stateful epsilon-greedy step with the model's current weights:
    ``policy(obs [B, *obs], carry, epsilon, generator, prev=None) ->
    (actions [B], q [B, A], new_carry)``.  The caller owns the carry (one
    row per env slot) and resets it to :meth:`RecurrentDuelingDQN.
    initial_state` at episode boundaries; with ``prev_action_reward`` it
    also passes ``prev = (prev_action [B], prev_reward [B])``, zeros at an
    episode's first step.  The exploration draws come from ``generator``
    on the model's device."""

    @torch.no_grad()
    def policy(obs: torch.Tensor, carry, epsilon, generator: torch.Generator,
               prev=None):
        if prev is not None:
            prev = tuple(t[:, None] for t in prev)
        q_seq, carry = model(obs[:, None], carry, prev)
        q = q_seq[:, 0]
        greedy = q.argmax(dim=1)
        random_actions = torch.randint(0, model.num_actions, greedy.shape,
                                       generator=generator,
                                       device=greedy.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=greedy.device) < epsilon
        return torch.where(explore, random_actions, greedy), q, carry

    return policy


def initial_prev(model: RecurrentDuelingDQN, batch_size: int,
                 device: torch.device | str | None = None):
    """``(prev_action, prev_reward)`` of an episode's first step, zeros
    ``[B]``, for a model with ``prev_action_reward``; None otherwise."""
    if not model.prev_action_reward:
        return None
    if device is None:
        device = model.lstm.weight_ih.device
    return (torch.zeros(batch_size, dtype=torch.long, device=device),
            torch.zeros(batch_size, device=device))


def episodic_policy(model: RecurrentDuelingDQN):
    """``(policy, reset)`` for episode loops that act on a batch of one
    (:func:`apex_tpu_torch.training.checkpoint.run_policy_episodes`):
    ``policy(obs, epsilon, generator) -> (actions, q)`` threads a carry it
    holds itself, and ``reset()`` zeroes it at an episode's start.  Where
    the model reads the previous action and reward, the policy keeps its
    last action, ``policy.observe_reward(r)`` (the loop's ``reward_hook``)
    records the reward the env returned for it, and ``reset()`` zeroes
    both."""
    step = make_recurrent_policy_fn(model)
    box = [model.initial_state(1), initial_prev(model, 1)]

    def policy(obs, epsilon, generator):
        actions, q, box[0] = step(obs, box[0], epsilon, generator, box[1])
        if box[1] is not None:
            box[1] = (actions.long(), box[1][1])
        return actions, q

    def observe_reward(reward: float) -> None:
        if box[1] is not None:
            box[1] = (box[1][0], torch.full_like(box[1][1], float(reward)))

    def reset():
        box[0] = model.initial_state(1)
        box[1] = initial_prev(model, 1)

    policy.observe_reward = observe_reward
    return policy, reset
