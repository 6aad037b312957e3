"""Env construction for the port.

Counterpart of :mod:`apex_tpu.envs.registry` for the envs the port runs:
``ApexCartPole-v0``, its velocity-masked ``ApexCartPolePO-v0``, the
Box-action ``ApexContinuousNav-v0``, the ``ApexCatch*`` family and
``ApexRally{,Small}-v0``.  :func:`make_env`
builds them un-stacked by default (``stack_frames=False``), the form the
frame-pool actors consume: stacks are rebuilt on the device at sample
time and in :class:`~apex_tpu_torch.replay.frame_chunks.FrameChunkBuilder`
while acting.  The evaluator and the DQN driver, whose replay stores whole
observations, step stacked pixel envs.  The wrappers are gymnasium-free
copies of ``apex_tpu.envs.wrappers``' ``TimeLimit`` and ``FrameStack``.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np

from apex_tpu_torch.config import EnvConfig
from apex_tpu_torch.envs.toy import (Box, CartPoleEnv, CatchEnv,
                                     ContinuousNavEnv, RallyEnv, VelocityMask)


class TimeLimit:
    """Truncate an episode after ``max_episode_steps`` steps (reference
    ``wrapper.py:282-298``)."""

    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._max = max_episode_steps
        self._elapsed = 0

    def reset(self, **kwargs):
        self._elapsed = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self._max:
            truncated = True
        return obs, reward, terminated, truncated, info

    def close(self) -> None:
        self.env.close()


class FrameStack:
    """The last ``k`` frames concatenated on the channel axis, oldest
    first; a reset fills all ``k`` with the reset frame (reference
    ``wrapper.py:160-205``)."""

    def __init__(self, env, k: int):
        self.env = env
        self.k = k
        self.action_space = env.action_space
        shape = env.observation_space.shape
        self.observation_space = Box(0, 255, shape[:-1] + (shape[-1] * k,),
                                     env.observation_space.dtype)
        self._frames: deque = deque(maxlen=k)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        for _ in range(self.k):
            self._frames.append(obs)
        return np.concatenate(self._frames, axis=-1), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._frames.append(obs)
        return (np.concatenate(self._frames, axis=-1), reward, terminated,
                truncated, info)

    def close(self) -> None:
        self.env.close()


def make_env(env_id: str | None = None, cfg: EnvConfig | None = None,
             seed: int | None = None,
             max_episode_steps: int | None = None,
             stack_frames: bool = False):
    """The envs of ``apex_tpu.envs.registry`` that the port serves
    (``registry.py:77-101``): ``ApexCartPole-v0``, whose own limit is 500
    steps unless ``max_episode_steps`` is given, ``ApexCartPolePO-v0``,
    the same with its velocities hidden, ``ApexContinuousNav-v0`` (a 2-D
    point driven to the origin, 30 steps unless ``max_episode_steps`` is
    given), the Catch variants (Small 7x7
    at 42x42 with 3 balls, Medium 11x11 at 44x44 with 4 balls, full 21x21
    at 84x84 with 5 balls) and the Rally variants (Small: a 14-cell court
    at 42x42, 2 points, the agent's paddle half-height 2 and a 0.45-speed
    opponent; full: 21 cells at 84x84, 3 points, the symmetric speed-1
    duel).  For the pixel envs ``max_episode_steps`` wraps the env in
    :class:`TimeLimit` and ``stack_frames`` stacks the last
    ``cfg.frame_stack`` frames."""
    cfg = cfg or EnvConfig()
    env_id = env_id or cfg.env_id
    if env_id in ("ApexCartPole-v0", "ApexCartPolePO-v0"):
        env = (CartPoleEnv(max_episode_steps=max_episode_steps)
               if max_episode_steps is not None else CartPoleEnv())
        if env_id == "ApexCartPolePO-v0":
            env = VelocityMask(env)
    elif env_id == "ApexContinuousNav-v0":
        env = (ContinuousNavEnv(max_episode_steps=max_episode_steps)
               if max_episode_steps is not None else ContinuousNavEnv())
    elif env_id.startswith(("ApexCatch", "ApexRally")):
        if env_id.startswith("ApexRally"):
            env = (RallyEnv(grid=14, pixels=42, points=2, agent_half=2,
                            opp_speed=0.45)
                   if "Small" in env_id else RallyEnv())
        elif "Small" in env_id:
            env = CatchEnv(grid=7, pixels=42, balls=3)
        elif "Medium" in env_id:
            env = CatchEnv(grid=11, pixels=44, balls=4)
        else:
            env = CatchEnv()
        if max_episode_steps is not None:
            env = TimeLimit(env, max_episode_steps)
        if stack_frames and cfg.frame_stack > 1:
            env = FrameStack(env, cfg.frame_stack)
    else:
        raise ValueError(f"env {env_id!r} is not ported yet; the port "
                         f"serves ApexCartPole-v0, ApexCartPolePO-v0, "
                         f"ApexContinuousNav-v0, the ApexCatch* family "
                         f"and ApexRally{{,Small}}-v0")
    if seed is not None:
        env.reset(seed=seed)
    return env


def make_eval_env(env_id: str | None = None, cfg: EnvConfig | None = None,
                  seed: int | None = None):
    """The evaluator's env: full episodes with frame stacks of
    ``cfg.frame_stack`` (the JAX evaluator's env also drops reward
    clipping and episodic life, which Catch does not have)."""
    return make_env(env_id, cfg, seed=seed, stack_frames=True)


def unstacked_env_spec(env,
                       cfg: EnvConfig) -> tuple[tuple[int, ...], Any, int]:
    """(frame_shape, frame_dtype, frame_stack) for an un-stacked env — the
    FrameChunkBuilder/FramePoolReplay spec.  1-D observations use
    frame_stack=1."""
    space = env.observation_space
    shape = tuple(space.shape)
    stack = cfg.frame_stack if len(shape) == 3 else 1
    return shape, space.dtype, stack


def num_actions(env) -> int:
    return int(env.action_space.n)
