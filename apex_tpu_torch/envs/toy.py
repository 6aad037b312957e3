"""Numpy-native pixel env, free of gymnasium.

Counterpart of :class:`apex_tpu.envs.toy.CatchEnv` (``toy.py:272-324``)
with the same ``reset``/``step``/``_render`` semantics.  The port cannot
import gymnasium (the GPU host does not ship it), so the env carries its
own minimal space stand-ins and its own ``numpy.random.Generator``, seeded
in ``reset`` exactly as ``gymnasium.Env.reset(seed=...)`` seeds its
``np_random`` (``np.random.default_rng(seed)``: the same PCG64 stream).
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
