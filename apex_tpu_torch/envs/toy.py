"""Numpy-native envs, free of gymnasium.

Counterparts of :class:`apex_tpu.envs.toy.CartPoleEnv` (``toy.py:23-77``)
and :class:`apex_tpu.envs.toy.CatchEnv` (``toy.py:272-324``) with the same
``reset``/``step`` semantics.  The port cannot import gymnasium (the GPU
host does not ship it), so the envs carry their own minimal space
stand-ins and their own ``numpy.random.Generator``, seeded in ``reset``
exactly as ``gymnasium.Env.reset(seed=...)`` seeds its ``np_random``
(``np.random.default_rng(seed)``: the same PCG64 stream).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Box:
    """Shape/dtype stand-in for ``gymnasium.spaces.Box``."""

    low: float
    high: float
    shape: tuple[int, ...]
    dtype: np.dtype


@dataclass(frozen=True)
class Discrete:
    """Stand-in for ``gymnasium.spaces.Discrete``."""

    n: int


class CartPoleEnv:
    """Pole balancing; physics constants from the classic task definition.
    Observations are ``(x, x_dot, theta, theta_dot)`` in f32; reward 1 per
    step; truncation after ``max_episode_steps``."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4

    def __init__(self, max_episode_steps: int = 500):
        self.observation_space = Box(-np.inf, np.inf, (4,),
                                     np.dtype(np.float32))
        self.action_space = Discrete(2)
        self._max_steps = max_episode_steps
        self._state = np.zeros(4, np.float64)
        self._steps = 0
        self.np_random: np.random.Generator | None = None

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        self._state = self.np_random.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN

        cos, sin = np.cos(theta), np.sin(theta)
        temp = (force + pole_ml * theta_dot ** 2 * sin) / total_mass
        theta_acc = (self.GRAVITY * sin - cos * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * cos ** 2 /
                                  total_mass))
        x_acc = temp - pole_ml * theta_acc * cos / total_mass

        self._state = np.array([
            x + self.TAU * x_dot,
            x_dot + self.TAU * x_acc,
            theta + self.TAU * theta_dot,
            theta_dot + self.TAU * theta_acc,
        ])
        self._steps += 1

        terminated = bool(abs(self._state[0]) > self.X_LIMIT
                          or abs(self._state[2]) > self.THETA_LIMIT)
        truncated = self._steps >= self._max_steps
        return (self._state.astype(np.float32), 1.0, terminated, truncated, {})

    def close(self) -> None:
        pass


class CatchEnv:
    """Catch a falling ball with a paddle; pixel observations.

    Internal grid is ``grid x grid``; observations are rendered to
    ``pixels x pixels x 1`` uint8 (default 84, matching WarpFrame geometry).
    Reward +1 for a catch, -1 for a miss; an episode is ``balls`` drops.
    Actions: 0=stay, 1=left, 2=right.
    """

    def __init__(self, grid: int = 21, pixels: int = 84, balls: int = 5):
        self.grid, self.pixels, self.balls = grid, pixels, balls
        self.observation_space = Box(0, 255, (pixels, pixels, 1),
                                     np.dtype(np.uint8))
        self.action_space = Discrete(3)
        self._scale = pixels // grid
        self.np_random: np.random.Generator | None = None

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        self._paddle = self.grid // 2
        self._drop()
        self._remaining = self.balls
        return self._render(), {}

    def _drop(self):
        self._ball_x = int(self.np_random.integers(0, self.grid))
        self._ball_y = 0

    def step(self, action):
        self._paddle = int(np.clip(self._paddle + (0, -1, 1)[int(action)],
                                   0, self.grid - 1))
        self._ball_y += 1
        reward, terminated = 0.0, False
        if self._ball_y == self.grid - 1:
            reward = 1.0 if abs(self._ball_x - self._paddle) <= 1 else -1.0
            self._remaining -= 1
            if self._remaining == 0:
                terminated = True
            else:
                self._drop()
        return self._render(), reward, terminated, False, {}

    def _render(self) -> np.ndarray:
        s = self._scale
        img = np.zeros((self.pixels, self.pixels, 1), np.uint8)
        by, bx = self._ball_y * s, self._ball_x * s
        img[by:by + s, bx:bx + s] = 255
        py = (self.grid - 1) * s
        p0 = max(self._paddle - 1, 0) * s
        p1 = (min(self._paddle + 1, self.grid - 1) + 1) * s
        img[py:py + s, p0:p1] = 128
        return img

    def close(self) -> None:
        pass
