"""The Q-networks, as plain functions of a parameter dict.

The Nature-DQN trunk (32 8x8 stride 4, 64 4x4 stride 2, 64 3x3 stride 1,
ReLU) over NHWC uint8 frames scaled by 1/255 and flattened in (h, w, c)
order; dueling heads of ``head`` units, ``V + A - mean(A)``.  Parameter
names: ``Conv_{0,1,2}.{weight,bias}``,
``{advantage,value}_{hidden,out}.{weight,bias}``.

``quant`` rounds what a matmul or convolution reads (the control's lower
precision); ``None`` computes in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CONV = ((4, 0), (2, 1), (1, 2))      # (stride, layer) of the trunk


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to float8 e4m3 under one per-tensor scale (its largest
    magnitude at 448, e4m3's top), straight through for the gradient."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _q(x, quant):
    return x if quant is None else quant(x)


def linear(p: dict, name: str, x: torch.Tensor, quant=None) -> torch.Tensor:
    return F.linear(_q(x, quant), _q(p[f"{name}.weight"], quant),
                    p[f"{name}.bias"])


def trunk(p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """``x`` u8 ``[N, H, W, C]`` -> features ``[N, h*w*c]``."""
    x = x.float() / 255.0
    x = x.permute(0, 3, 1, 2)
    for stride, i in CONV:
        x = torch.relu(F.conv2d(_q(x, quant), _q(p[f"Conv_{i}.weight"], quant),
                                p[f"Conv_{i}.bias"], stride=stride))
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def heads(p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    adv = linear(p, "advantage_out",
                 torch.relu(linear(p, "advantage_hidden", x, quant)), quant)
    val = linear(p, "value_out",
                 torch.relu(linear(p, "value_hidden", x, quant)), quant)
    return val + adv - adv.mean(dim=1, keepdim=True)


def dueling_q(p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """Q-values ``[N, A]`` of frame stacks ``x`` u8 ``[N, H, W, S]``."""
    return heads(p, trunk(p, x, quant), quant)

