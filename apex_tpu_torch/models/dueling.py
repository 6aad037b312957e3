"""Dueling DQN as a torch ``nn.Module``.

Counterpart of :class:`apex_tpu.models.dueling.DuelingDQN` (reference
``model.py:14-107``): Nature-DQN conv trunk (32x8s4 / 64x4s2 / 64x3s1) for
3-D observations or a 128-unit MLP trunk for 1-D, dueling value/advantage
heads of width 128, aggregation ``V + A - mean(A)``, orthogonal init with
ReLU gain and zero bias.

Kept from the JAX model, so the two take the same inputs and weights:

* NHWC uint8 in, ``/255`` inside.  ``x.permute(0, 3, 1, 2)`` hands
  ``nn.Conv2d`` a channels-last view without a copy.
* The trunk's output is flattened in NHWC ``(h, w, c)`` order, as flax
  flattens it (``dueling.py:74``), so both heads' hidden layers read the
  same feature order and :func:`apex_tpu_torch.convert.params_from_flax`
  only transposes their kernels.
* Parameter names follow flax: ``Conv_0..2``, ``Dense_0``,
  ``{advantage,value}_{hidden,out}``.
* bf16 compute through ``torch.autocast``; params and the head output
  stay f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

_RELU_GAIN = 2.0 ** 0.5

_CONV_GEOMETRY = ((8, 4), (4, 2), (3, 1))     # (kernel, stride) per layer


class DuelingDQN(nn.Module):
    """Q-network with dueling heads.

    ``obs_shape`` is one stacked observation, ``(H, W, C)`` for pixels or
    ``(D,)`` for vectors (torch layers need their input widths up front,
    where flax infers them).  ``compute_dtype`` is the conv/matmul dtype.
    ``generator`` draws the orthogonal init (never the global RNG).
    """

    def __init__(self, num_actions: int, obs_shape: Sequence[int],
                 obs_is_image: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 scale_uint8: bool = True,
                 trunk_features: Sequence[int] = (32, 64, 64),
                 head_width: int = 128, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_actions = num_actions
        self.obs_is_image = obs_is_image
        self.compute_dtype = compute_dtype
        self.scale_uint8 = scale_uint8
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
            setattr(self, f"{name}_hidden", nn.Linear(trunk_out, head_width))
            setattr(self, f"{name}_out", nn.Linear(head_width, out_dim))
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                nn.init.orthogonal_(module.weight, gain=_RELU_GAIN,
                                    generator=generator)
                nn.init.zeros_(module.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if x.dtype == torch.uint8 and self.scale_uint8:
            x = x.to(dt) / 255.0
        else:
            x = x.to(dt)
        with torch.autocast(x.device.type, dtype=dt,
                            enabled=dt != torch.float32):
            if self.obs_is_image:
                x = x.permute(0, 3, 1, 2)              # NHWC -> NCHW view
                for i in range(len(_CONV_GEOMETRY)):
                    x = torch.relu(getattr(self, f"Conv_{i}")(x))
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            else:
                x = torch.relu(self.Dense_0(x))
            advantage = self.advantage_out(
                torch.relu(self.advantage_hidden(x))).float()
            value = self.value_out(torch.relu(self.value_hidden(x))).float()
        return value + advantage - advantage.mean(dim=1, keepdim=True)


def make_policy_fn(model: DuelingDQN):
    """Epsilon-greedy policy over a batch of states (reference
    ``DuelingDQN.act``, ``model.py:74-86``): ``policy(obs, epsilon,
    generator) -> (actions, q_values)``, with the model's current weights.
    The exploration draws come from ``generator`` on the model's device."""

    @torch.no_grad()
    def policy(obs: torch.Tensor, epsilon: float,
               generator: torch.Generator):
        q_values = model(obs)
        greedy = q_values.argmax(dim=1)
        random_actions = torch.randint(0, model.num_actions, greedy.shape,
                                       generator=generator,
                                       device=greedy.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=greedy.device) < epsilon
        return torch.where(explore, random_actions, greedy), q_values

    return policy
