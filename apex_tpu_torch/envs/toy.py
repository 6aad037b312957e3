"""Numpy-native envs, free of gymnasium.

Counterparts of :class:`apex_tpu.envs.toy.CartPoleEnv` (``toy.py:23-77``),
:class:`apex_tpu.envs.toy.VelocityMask` (``toy.py:78-93``),
:class:`apex_tpu.envs.toy.ContinuousNavEnv` (``toy.py:96-130``),
:class:`apex_tpu.envs.toy.RallyEnv` (``toy.py:133-270``) and
:class:`apex_tpu.envs.toy.CatchEnv` (``toy.py:272-324``) with the same
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


class VelocityMask:
    """CartPole with its velocities hidden: observations are ``(x,
    theta)`` only, so a policy has to infer velocities from history (the
    partially observable task the recurrent family is certified on)."""

    _KEEP = np.array([0, 2])

    def __init__(self, env):
        self.env = env
        self.action_space = env.action_space
        self.observation_space = Box(-np.inf, np.inf, (2,),
                                     np.dtype(np.float32))

    def _mask(self, obs) -> np.ndarray:
        return np.asarray(obs, np.float32)[self._KEEP]

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self._mask(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._mask(obs), reward, terminated, truncated, info

    def close(self) -> None:
        self.env.close()


class ContinuousNavEnv:
    """Continuous-action navigation: drive a point to the origin, the
    CI-scale Box-action task of the AQL family.  The observation is the
    position in ``[-2, 2]^dim`` (f64 inside, f32 out); the action a
    velocity in ``[-1, 1]^dim`` scaled by ``step_scale``; the reward
    ``-|position|_2``; truncation after ``max_episode_steps``."""

    def __init__(self, dim: int = 2, max_episode_steps: int = 30,
                 step_scale: float = 0.2):
        self.dim, self._max_steps, self._scale = dim, max_episode_steps, \
            step_scale
        self.observation_space = Box(-2.0, 2.0, (dim,), np.dtype(np.float32))
        self.action_space = Box(-1.0, 1.0, (dim,), np.dtype(np.float32))
        self._pos = np.zeros(dim, np.float64)
        self._steps = 0
        self.np_random: np.random.Generator | None = None

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        self._pos = self.np_random.uniform(-2.0, 2.0, size=self.dim)
        self._steps = 0
        return self._pos.astype(np.float32), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        self._pos = np.clip(self._pos + self._scale * a, -2.0, 2.0)
        self._steps += 1
        reward = -float(np.linalg.norm(self._pos))
        truncated = self._steps >= self._max_steps
        return self._pos.astype(np.float32), reward, False, truncated, {}

    def close(self) -> None:
        pass


class RallyEnv:
    """Two-paddle rally against a scripted opponent, the Pong-shaped pixel
    task (``apex_tpu/envs/toy.py:133-270``).

    Court: ``grid x grid`` cells rendered to ``pixels x pixels x 1`` u8.
    The opponent guards column 0, the agent column ``grid-1``; actions
    0=stay, 1=up, 2=down.  The ball advances one column per step; a paddle
    contact sets its vertical speed from the hit offset (centre shallow,
    edge steep, at least ``MIN_VY``) and the walls reflect it.  The
    opponent tracks the ball at ``opp_speed`` cells per step.  Reward +1
    when the opponent misses, -1 when the agent does; an episode is
    ``points`` points.  ``agent_half`` widens only the agent's paddle.

    ``dtype`` is the continuous state's compute dtype: float64 (the
    default) is the JAX package's python-float arithmetic, float32 makes
    every op the f32 op of the batched device env
    (:mod:`apex_tpu_torch.envs.device_envs`).
    """

    MAX_VY = 1.75          # edge-hit deflection; outruns the speed-1 opponent
    MIN_VY = 0.5           # centre hits stay live (no horizontal stalemates)

    def __init__(self, grid: int = 21, pixels: int = 84, points: int = 3,
                 paddle_half: int = 1, agent_half: int | None = None,
                 opp_speed: float = 1.0, dtype=np.float64):
        self.grid, self.pixels, self.points = grid, pixels, points
        self.half = paddle_half
        self.agent_half = self.half if agent_half is None else agent_half
        self.opp_speed = opp_speed
        self._scalar = np.dtype(dtype).type
        self.observation_space = Box(0, 255, (pixels, pixels, 1),
                                     np.dtype(np.uint8))
        self.action_space = Discrete(3)
        self._scale = pixels // grid
        self.np_random: np.random.Generator | None = None

    # -- mechanics ---------------------------------------------------------

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        self._agent_y = self._opp_y = self._scalar((self.grid - 1) / 2)
        self._played = 0
        self._serve(toward_agent=bool(self.np_random.random() < 0.5))
        return self._render(), {}

    def _serve(self, toward_agent: bool) -> None:
        self._bx = self._scalar((self.grid - 1) / 2)
        self._by = self._scalar(self.np_random.integers(2, self.grid - 2))
        self._vx = 1 if toward_agent else -1
        self._vy = self._scalar(self.np_random.choice([-1.0, -0.5, 0.5, 1.0]))

    def _deflect(self, offset: float) -> float:
        """Paddle-contact vertical speed from the normalized hit offset
        (centre 0 -> shallow, edge +-1 -> MAX_VY steep)."""
        vy = self.MAX_VY * offset
        if abs(vy) < self.MIN_VY:
            sign = 1.0 if self.np_random.random() < 0.5 else -1.0
            vy = self.MIN_VY * sign
        return self._scalar(np.clip(vy, -self.MAX_VY, self.MAX_VY))

    def step(self, action):
        g, half, ahalf = self.grid, self.half, self.agent_half
        self._agent_y = self._scalar(np.clip(
            self._agent_y + (0, -1, 1)[int(action)], ahalf, g - 1 - ahalf))
        # the scripted opponent tracks the ball at all times
        self._opp_y = self._scalar(np.clip(
            self._opp_y + np.clip(self._by - self._opp_y,
                                  -self.opp_speed, self.opp_speed),
            half, g - 1 - half))
        # ball advance + wall reflection
        self._bx += self._vx
        self._by += self._vy
        while self._by < 0 or self._by > g - 1:
            if self._by < 0:
                self._by = -self._by
            else:
                self._by = 2 * (g - 1) - self._by
            self._vy = -self._vy

        reward = 0.0
        if self._bx <= 0:                       # opponent's goal column
            if abs(self._by - self._opp_y) <= half + 0.5:
                self._bx, self._vx = self._scalar(0.0), 1
                self._vy = self._deflect(
                    (self._by - self._opp_y) / (half + 0.5))
            else:
                reward = 1.0
                self._played += 1
                self._serve(toward_agent=False)
        elif self._bx >= g - 1:                 # agent's goal column
            if abs(self._by - self._agent_y) <= ahalf + 0.5:
                self._bx, self._vx = self._scalar(g - 1), -1
                self._vy = self._deflect(
                    (self._by - self._agent_y) / (ahalf + 0.5))
            else:
                reward = -1.0
                self._played += 1
                self._serve(toward_agent=True)
        terminated = self._played >= self.points
        return self._render(), reward, terminated, False, {}

    # -- rendering ---------------------------------------------------------

    def _block(self, img, row: float, col: int, h: int, value: int) -> None:
        s = self._scale
        r0 = int(np.clip(round(row) - h, 0, self.grid - 1)) * s
        r1 = (int(np.clip(round(row) + h, 0, self.grid - 1)) + 1) * s
        img[r0:r1, col * s:(col + 1) * s] = value

    def _render(self) -> np.ndarray:
        img = np.zeros((self.pixels, self.pixels, 1), np.uint8)
        self._block(img, self._opp_y, 0, self.half, 128)
        self._block(img, self._agent_y, self.grid - 1, self.agent_half, 128)
        bx = int(np.clip(round(self._bx), 0, self.grid - 1))
        self._block(img, self._by, bx, 0, 255)
        return img

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
