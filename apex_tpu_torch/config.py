"""Configuration dataclasses read by the port.

A copy of the sections of :mod:`apex_tpu.config` the frame-pool learner
slice reads, with the same defaults (reference hyperparameters:
``origin_repo/arguments.py:9-74``).  Fields that only later slices read
(Atari wrappers, actor fleet, ingest pipeline, mesh, comms, AQL, R2D2)
are not copied yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ReplayConfig:
    """Prioritized replay hyperparameters (reference: arguments.py:41-50)."""

    capacity: int = 2 ** 19          # per-device transition capacity
    alpha: float = 0.6               # priority exponent
    beta: float = 0.4                # IS-weight exponent, annealed toward 1
    beta_anneal: int = 500_000       # transitions over which beta reaches 1
    warmup: int = 50_000             # learner gated until this many transitions
    eps: float = 1e-6                # clamp floor for priorities (pre-alpha)
    # Constructors refuse a replay whose estimated footprint exceeds this
    # (and, on a card, the card's own memory).
    hbm_budget_gb: float = 12.0

    def __post_init__(self) -> None:
        if self.capacity <= 0 or self.capacity & (self.capacity - 1):
            raise ValueError(f"capacity must be a power of 2, got {self.capacity}")


@dataclass(frozen=True)
class LearnerConfig:
    """Learner hyperparameters (reference: arguments.py:49-66, ApeX.py:37)."""

    batch_size: int = 512
    lr: float = 6.25e-5
    lr_decay_steps: int = 1000       # StepLR(step_size=1000, gamma=0.99); 0 = constant
    lr_decay_rate: float = 0.99
    rmsprop_decay: float = 0.95
    rmsprop_eps: float = 1.5e-7
    rmsprop_centered: bool = True
    gamma: float = 0.99
    n_steps: int = 3
    max_grad_norm: float = 40.0
    target_update_interval: int = 2500
    compute_dtype: str = "bfloat16"  # conv/matmul dtype; params stay f32


@dataclass(frozen=True)
class ActorConfig:
    """Actor hyperparameters (reference: arguments.py:9-40)."""

    send_interval: int = 50          # transitions per shipped chunk
    eps_base: float = 0.4            # ladder eps_base^(1 + i/(N-1)*eps_alpha)
    eps_alpha: float = 7.0


@dataclass(frozen=True)
class EnvConfig:
    env_id: str = "SeaquestNoFrameskip-v4"   # reference default (arguments.py:9-10)
    frame_stack: int = 4
    seed: int = 1122                 # reference default seed (arguments.py:14)


@dataclass(frozen=True)
class ApexConfig:
    """Top-level bundle of the sections this slice reads."""

    env: EnvConfig = field(default_factory=EnvConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    learner: LearnerConfig = field(default_factory=LearnerConfig)
    actor: ActorConfig = field(default_factory=ActorConfig)

    def replace(self, **sections: Any) -> "ApexConfig":
        return dataclasses.replace(self, **sections)
