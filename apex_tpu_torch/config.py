"""Configuration dataclasses read by the port.

A copy of the sections of :mod:`apex_tpu.config` the frame-pool learner
and the concurrent Ape-X trainer read, with the same defaults (reference
hyperparameters: ``origin_repo/arguments.py:9-74``).  Fields that only
later slices read (Atari wrappers, ingest pipeline, mesh, comms, remote
policy, AQL, R2D2) are not copied yet: the port's
:meth:`~apex_tpu_torch.training.apex.ConcurrentTrainer.train` is the JAX
trainer's serial drain (``ingest_pipeline=False``).
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
    publish_interval: int = 25       # param publish period, learner steps
    compute_dtype: str = "bfloat16"  # conv/matmul dtype; params stay f32
    # >1: when at least this many chunks are queued and the replay-ratio
    # budget allows, drain them into one fused_multi_step call of
    # scan_steps fused steps
    scan_steps: int = 1


@dataclass(frozen=True)
class ActorConfig:
    """Actor-fleet hyperparameters (reference: arguments.py:9-40,
    batchrecorder.py:121)."""

    n_actors: int = 8
    # env slots driven by each worker process through one batched policy
    # call per step; the exploration ladder spans all
    # n_actors * n_envs_per_actor slots
    n_envs_per_actor: int = 1
    send_interval: int = 50          # transitions per shipped chunk
    update_interval: int = 400       # env steps between param refresh polls
    eps_base: float = 0.4            # ladder eps_base^(1 + i/(N-1)*eps_alpha)
    eps_alpha: float = 7.0
    # anneal each slot's epsilon 1.0 -> its ladder value over this many of
    # its own env steps (exp decay); 0 = the fixed reference ladder
    eps_anneal_steps: int = 0
    max_episode_length: int | None = None   # None = the env's own limit
    # chunk transport: the native shared-memory ring when it builds, else
    # multiprocessing.Queue
    shm_data_plane: bool = True
    shm_slot_bytes: int = 0          # 0 = drivers size it from the frame spec
    # the JAX workers' overlap of one half-group's env steps with the
    # other's inference; the port's vector workers run the serial
    # interleave in both modes (actors/vector.py) and report the flag
    double_buffer: bool = True
    # vector steps between ActorTimingStat emissions; 0 = off
    timing_interval: int = 256


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
