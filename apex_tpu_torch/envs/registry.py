"""Env construction for the port.

Counterpart of :mod:`apex_tpu.envs.registry` for the envs this slice runs:
the ``ApexCatch*`` family, un-stacked (``stack_frames=False``), the form
the frame-pool actors consume.  Stacking happens on the device at sample
time and in :class:`~apex_tpu_torch.replay.frame_chunks.FrameChunkBuilder`
while acting, so the port has no FrameStack wrapper.
"""

from __future__ import annotations

from typing import Any

from apex_tpu_torch.config import EnvConfig
from apex_tpu_torch.envs.toy import CatchEnv


def make_env(env_id: str | None = None, cfg: EnvConfig | None = None,
             seed: int | None = None, stack_frames: bool = False) -> CatchEnv:
    """Catch variants with the geometry of ``apex_tpu.envs.registry``
    (``registry.py:95-101``): Small 7x7 at 42x42 with 3 balls, Medium
    11x11 at 44x44 with 4 balls, full 21x21 at 84x84 with 5 balls."""
    cfg = cfg or EnvConfig()
    env_id = env_id or cfg.env_id
    if stack_frames:
        raise ValueError("the port builds un-stacked envs only "
                         "(stack_frames=False): stacks are rebuilt by the "
                         "frame pool and the chunk builder")
    if not env_id.startswith("ApexCatch"):
        raise ValueError(f"env {env_id!r} is not ported yet; the port "
                         f"serves the ApexCatch* family")
    if "Small" in env_id:
        env = CatchEnv(grid=7, pixels=42, balls=3)
    elif "Medium" in env_id:
        env = CatchEnv(grid=11, pixels=44, balls=4)
    else:
        env = CatchEnv()
    if seed is not None:
        env.reset(seed=seed)
    return env


def unstacked_env_spec(env: CatchEnv,
                       cfg: EnvConfig) -> tuple[tuple[int, ...], Any, int]:
    """(frame_shape, frame_dtype, frame_stack) for an un-stacked env — the
    FrameChunkBuilder/FramePoolReplay spec.  1-D observations use
    frame_stack=1."""
    space = env.observation_space
    shape = tuple(space.shape)
    stack = cfg.frame_stack if len(shape) == 3 else 1
    return shape, space.dtype, stack


def num_actions(env: CatchEnv) -> int:
    return int(env.action_space.n)
