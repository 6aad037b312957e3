"""Factorized NoisyNet linear layer (Fortunato et al. 2017).

Counterpart of :class:`apex_tpu.models.noisy.NoisyDense` (``noisy.py:25-60``;
reference ``NoisyLinear``, ``model.py:112-164``): ``mu`` and ``sigma``
parameters with ``mu ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` and ``sigma =
std_init / sqrt(fan_in)``; factorized noise ``eps_out (x) eps_in`` scaled
by ``sign(x) * sqrt(|x|)``; a deterministic (mu-only) mode.

The flax layer draws its noise from the ``'noise'`` PRNG collection inside
its own scope, which no torch generator can reproduce.  Here the noise is
an explicit argument: the raw standard normals ``(z_in [in], z_out
[out])`` of one draw, which the layer scales itself, or ``None`` for the
mu-only mode.  :class:`~apex_tpu_torch.models.aql.AQLDraws` draws them
from a ``torch.Generator``; the parity tests feed the normals JAX drew.

The weights keep flax's ``[in, out]`` layout (``w_mu``, ``w_sigma``), so
:mod:`apex_tpu_torch.convert` copies them without a transpose.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def scale_noise(x: torch.Tensor) -> torch.Tensor:
    return x.sign() * x.abs().sqrt()


class NoisyDense(nn.Module):
    """``y = x @ (w_mu + w_sigma * outer(eps_in, eps_out)) + (b_mu +
    b_sigma * eps_out)`` in ``compute_dtype``, returned in f32.
    ``generator`` draws the ``mu`` init."""

    def __init__(self, in_features: int, features: int,
                 std_init: float = 0.4,
                 compute_dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.compute_dtype = compute_dtype
        mu_range = 1.0 / math.sqrt(in_features)
        sigma = std_init / math.sqrt(in_features)
        self.w_mu = nn.Parameter(torch.empty(in_features, features).uniform_(
            -mu_range, mu_range, generator=generator))
        self.w_sigma = nn.Parameter(torch.full((in_features, features),
                                               sigma))
        self.b_mu = nn.Parameter(torch.empty(features).uniform_(
            -mu_range, mu_range, generator=generator))
        self.b_sigma = nn.Parameter(torch.full((features,), sigma))

    def forward(self, x: torch.Tensor,
                noise: tuple[torch.Tensor, torch.Tensor] | None
                ) -> torch.Tensor:
        if noise is None:
            w, b = self.w_mu, self.b_mu
        else:
            z_in, z_out = noise
            eps_in, eps_out = scale_noise(z_in), scale_noise(z_out)
            w = self.w_mu + self.w_sigma * torch.outer(eps_in, eps_out)
            b = self.b_mu + self.b_sigma * eps_out
        dt = self.compute_dtype
        return (x.to(dt) @ w.to(dt) + b.to(dt)).float()
