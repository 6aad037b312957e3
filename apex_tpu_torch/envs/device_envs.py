"""Batched Catch and Rally on a device: the on-device rollout substrate.

Counterpart of :mod:`apex_tpu.envs.jax_envs`.  Each env steps ``B`` lanes
at once over state tensors of leading size ``[B]`` on one device:

    reset(draws)               -> (state, obs)
    step(state, action, draws) -> (state, obs, reward, done, final_frame)

with the auto-reset inside ``step`` as the JAX ports do it
(``jax_envs.py:27-32``): on ``done`` the returned ``obs`` is the next
episode's reset frame while ``final_frame`` is the terminal render; on
other steps the two are equal.  Frames are ``u8[B, P, P, 1]``, rendered
with broadcast comparisons and drawn in the host envs' order (Catch: ball,
then paddle; Rally: opponent, agent, then ball, later draws overwriting).

Randomness is kept apart from the dynamics.  The JAX ports draw with
``fold_in(key, tag)`` keys at fixed sites; here every site is an explicit
per-lane tensor that the caller hands in, already in the site's range:

    Catch: int (drop column, [0, grid)), reset_int (the same at reset)
    Rally: coin (deflection sign, bool), int (serve row, [2, grid-2)),
           choice (serve vy index, [0, 4)), reset_coin (serve direction),
           reset_int, reset_choice

``step`` takes every site on every step, used or not, and ``reset`` the
``reset_*`` sites, as the JAX ports draw every site on every step: the
two sides can never fall out of step.  :class:`DrawSource` turns an
explicit ``torch.Generator`` into those tensors on the device; the parity
tests replace it with one that replays JAX's keyed draws.

Catch is integer dynamics.  Rally computes in f32, every op a separate
elementwise op (``torch.round`` rounds half to even, as ``jnp.round``),
so card, CPU and JAX agree bit for bit.  One op is not the host env's:
the hit offset multiplies by the f32 reciprocal of the paddle's reach,
because XLA compiles the JAX port's division by that constant so
(``x / 1.5`` becomes ``x * 0.666666687``); numpy's true division differs
from it in the last bit for some offsets.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: a site spec: ``None`` is a fair coin (bool), ``"uniform"`` an f32 in
#: [0, 1), ``(low, high)`` an int32 in [low, high)
COIN = None
UNIFORM = "uniform"


class DrawSource:
    """Per-lane draws from an explicit generator on its device.

    ``draw(sites, shape)`` returns one tensor of ``shape`` per site.
    :meth:`reset` and :meth:`dispatch` are the two calls a rollout
    engine makes (its initial reset; one block of ``T`` steps), so a test
    can replay another framework's draws by overriding them."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def draw(self, sites: dict, shape: tuple[int, ...]) -> dict:
        g, dev = self.generator, self.device
        out = {}
        for name, spec in sites.items():
            if spec is COIN:
                out[name] = torch.rand(shape, generator=g, device=dev) < 0.5
            elif spec == UNIFORM:
                out[name] = torch.rand(shape, generator=g, device=dev)
            else:
                low, high = spec
                out[name] = torch.randint(low, high, shape, generator=g,
                                          device=dev, dtype=torch.int32)
        return out

    def reset(self, sites: dict, n: int) -> dict:
        return self.draw(sites, (n,))

    def dispatch(self, sites: dict, steps: int, n: int) -> dict:
        return self.draw(sites, (steps, n))


def _where(done: torch.Tensor, fresh: NamedTuple, mid: NamedTuple):
    return type(mid)(*[torch.where(done, a, b) for a, b in zip(fresh, mid)])


class _PixelEnv:
    """Shared geometry: the pixel grid and the u8 ink on ``device``."""

    num_actions = 3

    def __init__(self, grid: int, pixels: int, env_id: str,
                 device: torch.device | str):
        self.grid, self.pixels, self.env_id = grid, pixels, env_id
        self.scale = pixels // grid
        self.frame_shape = (pixels, pixels, 1)
        self.device = dev = torch.device(device)
        ar = torch.arange(pixels, dtype=torch.int32, device=dev)
        self._rows = ar.view(1, pixels, 1)
        self._cols = ar.view(1, 1, pixels)
        self._ink = {v: torch.tensor(v, dtype=torch.uint8, device=dev)
                     for v in (0, 128, 255)}

    def _span(self, axis: torch.Tensor, lo, hi) -> torch.Tensor:
        """``lo <= axis < hi`` with ``lo``/``hi`` ints or ``[B]`` tensors
        broadcast against the ``[1, P, 1]`` / ``[1, 1, P]`` axis."""
        if isinstance(lo, torch.Tensor):
            lo, hi = lo.view(-1, 1, 1), hi.view(-1, 1, 1)
        return (axis >= lo) & (axis < hi)

    def _paint(self, img, mask, value: int):
        return torch.where(mask, self._ink[value], img)


# -- Catch -------------------------------------------------------------------


class CatchState(NamedTuple):
    paddle: torch.Tensor       # i32[B]
    ball_x: torch.Tensor       # i32[B]
    ball_y: torch.Tensor       # i32[B]
    remaining: torch.Tensor    # i32[B]


class CatchEnv(_PixelEnv):
    """``B`` Catch lanes (``apex_tpu/envs/jax_envs.py:91-167``)."""

    def __init__(self, grid: int = 21, pixels: int = 84, balls: int = 5,
                 env_id: str = "ApexCatch-v0",
                 device: torch.device | str = "cuda"):
        super().__init__(grid, pixels, env_id, device)
        self.balls = balls
        self.reset_sites = {"reset_int": (0, grid)}
        self.step_sites = {"int": (0, grid), "reset_int": (0, grid)}
        self._move = torch.tensor([0, -1, 1], dtype=torch.int32,
                                  device=self.device)

    def _render(self, st: CatchState) -> torch.Tensor:
        s, g = self.scale, self.grid
        by, bx = st.ball_y * s, st.ball_x * s
        ball = (self._span(self._rows, by, by + s)
                & self._span(self._cols, bx, bx + s))
        py = (g - 1) * s
        p0 = st.paddle.sub(1).clamp_min(0) * s
        p1 = (st.paddle.add(1).clamp_max(g - 1) + 1) * s
        pad = (self._span(self._rows, py, py + s)
               & self._span(self._cols, p0, p1))
        img = torch.where(ball, self._ink[255], self._ink[0])
        return self._paint(img, pad, 128).unsqueeze(-1)

    def _fresh(self, column: torch.Tensor) -> CatchState:
        col = column.int()
        return CatchState(paddle=torch.full_like(col, self.grid // 2),
                          ball_x=col, ball_y=torch.zeros_like(col),
                          remaining=torch.full_like(col, self.balls))

    def reset(self, draws: dict):
        st = self._fresh(draws["reset_int"])
        return st, self._render(st)

    def step(self, st: CatchState, action: torch.Tensor, draws: dict):
        g = self.grid
        paddle = (st.paddle + self._move[action.long()]).clamp(0, g - 1)
        ball_y = st.ball_y + 1
        landed = ball_y == g - 1
        caught = (st.ball_x - paddle).abs() <= 1
        reward = torch.where(landed, torch.where(caught, 1.0, -1.0), 0.0)
        remaining = st.remaining - landed.int()
        done = landed & (remaining == 0)
        # a drop within the episode takes the in-step column; the
        # terminal render keeps the old ball
        drop = landed & ~done
        mid = CatchState(paddle=paddle,
                         ball_x=torch.where(drop, draws["int"].int(),
                                            st.ball_x),
                         ball_y=torch.where(drop, 0, ball_y),
                         remaining=remaining)
        final_frame = self._render(mid)
        fresh = self._fresh(draws["reset_int"])
        obs = torch.where(done.view(-1, 1, 1, 1), self._render(fresh),
                          final_frame)
        return _where(done, fresh, mid), obs, reward, done, final_frame


# -- Rally -------------------------------------------------------------------


class RallyState(NamedTuple):
    agent_y: torch.Tensor      # f32[B]
    opp_y: torch.Tensor        # f32[B]
    bx: torch.Tensor           # f32[B] (half-integer courts exist: grid 14)
    by: torch.Tensor           # f32[B]
    vx: torch.Tensor           # i32[B] (+1 toward the agent)
    vy: torch.Tensor           # f32[B]
    played: torch.Tensor       # i32[B]


_MAX_VY = 1.75
_MIN_VY = 0.5


class RallyEnv(_PixelEnv):
    """``B`` Rally lanes in f32 (``apex_tpu/envs/jax_envs.py:173-345``)."""

    def __init__(self, grid: int = 21, pixels: int = 84, points: int = 3,
                 paddle_half: int = 1, agent_half: int | None = None,
                 opp_speed: float = 1.0, env_id: str = "ApexRally-v0",
                 device: torch.device | str = "cuda"):
        super().__init__(grid, pixels, env_id, device)
        self.points = points
        self.half = paddle_half
        self.a_half = paddle_half if agent_half is None else agent_half
        self.opp_speed = float(opp_speed)
        serve = (2, grid - 2)
        self.reset_sites = {"reset_coin": COIN, "reset_int": serve,
                            "reset_choice": (0, 4)}
        self.step_sites = {"coin": COIN, "int": serve, "choice": (0, 4),
                           **self.reset_sites}
        dev = self.device

        def f32(*v):
            return torch.tensor(v if len(v) > 1 else v[0],
                                dtype=torch.float32, device=dev)

        self._move = f32(0.0, -1.0, 1.0)
        self._serve_vy = f32(-1.0, -0.5, 0.5, 1.0)
        # hit offsets scale by the f32 reciprocal of each paddle's reach,
        # the multiply XLA makes of the JAX port's division (module
        # docstring)
        self._opp_scale = float(np.float32(1) / np.float32(self.half + 0.5))
        self._agent_scale = float(np.float32(1)
                                  / np.float32(self.a_half + 0.5))
        s = self.scale
        self._opp_col = self._span(self._cols, 0, s)
        self._agent_col = self._span(self._cols, (grid - 1) * s, grid * s)

    def _serve(self, toward_agent, row, choice):
        """(bx, by, vx, vy) of a fresh serve (``toy.RallyEnv._serve``)."""
        by = row.float()
        bx = torch.full_like(by, (self.grid - 1) / 2)
        vx = torch.where(toward_agent, 1, -1).int()
        return bx, by, vx, self._serve_vy[choice.long()]

    def _fresh(self, draws: dict) -> RallyState:
        bx, by, vx, vy = self._serve(draws["reset_coin"],
                                     draws["reset_int"],
                                     draws["reset_choice"])
        mid = torch.full_like(bx, (self.grid - 1) / 2)
        return RallyState(agent_y=mid, opp_y=mid, bx=bx, by=by, vx=vx,
                          vy=vy, played=torch.zeros_like(vx))

    def _block(self, row: torch.Tensor, h: int) -> torch.Tensor:
        """Rows ``[B, P, 1]`` a block of half-height ``h`` centred on
        ``round(row)`` covers."""
        g, s = self.grid, self.scale
        r = torch.round(row).int()
        r0 = (r - h).clamp(0, g - 1) * s
        r1 = ((r + h).clamp(0, g - 1) + 1) * s
        return self._span(self._rows, r0, r1)

    def _render(self, st: RallyState) -> torch.Tensor:
        g, s = self.grid, self.scale
        img = torch.where(self._block(st.opp_y, self.half) & self._opp_col,
                          self._ink[128], self._ink[0])
        img = self._paint(img, self._block(st.agent_y, self.a_half)
                          & self._agent_col, 128)
        col = torch.round(st.bx).int().clamp(0, g - 1) * s
        ball = self._block(st.by, 0) & self._span(self._cols, col, col + s)
        return self._paint(img, ball, 255).unsqueeze(-1)

    def reset(self, draws: dict):
        st = self._fresh(draws)
        return st, self._render(st)

    def _deflect(self, coin, offset):
        """``toy.RallyEnv._deflect``: centre -> shallow, edge -> steep,
        with the coin-flipped minimum-speed floor."""
        vy = offset * _MAX_VY
        sign = torch.where(coin, 1.0, -1.0)
        vy = torch.where(vy.abs() < _MIN_VY, sign * _MIN_VY, vy)
        return vy.clamp(-_MAX_VY, _MAX_VY)

    def step(self, st: RallyState, action: torch.Tensor, draws: dict):
        g, half, ahalf, speed = (self.grid, self.half, self.a_half,
                                 self.opp_speed)
        agent_y = (st.agent_y + self._move[action.long()]).clamp(
            ahalf, g - 1 - ahalf)
        opp_y = (st.opp_y + (st.by - st.opp_y).clamp(-speed, speed)).clamp(
            half, g - 1 - half)
        bx = st.bx + st.vx.float()
        by = st.by + st.vy
        # wall reflection (|vy| <= 1.75 < g-1: at most one bounce)
        hit_low, hit_high = by < 0, by > g - 1
        by = torch.where(hit_low, -by,
                         torch.where(hit_high, 2 * (g - 1) - by, by))
        vy = torch.where(hit_low | hit_high, -st.vy, st.vy)

        at_opp, at_agent = bx <= 0, bx >= g - 1
        opp_saves = (by - opp_y).abs() <= half + 0.5
        agent_saves = (by - agent_y).abs() <= ahalf + 0.5
        opp_deflect = at_opp & opp_saves
        agent_deflect = at_agent & agent_saves
        agent_scores = at_opp & ~opp_saves
        opp_scores = at_agent & ~agent_saves
        scored = agent_scores | opp_scores
        reward = torch.where(agent_scores, 1.0,
                             torch.where(opp_scores, -1.0, 0.0))
        # a contact snaps the ball to the goal column; vy from the
        # normalised hit offset
        off = torch.where(opp_deflect, (by - opp_y) * self._opp_scale,
                          (by - agent_y) * self._agent_scale)
        dvy = self._deflect(draws["coin"], off)
        bx = torch.where(opp_deflect, 0.0,
                         torch.where(agent_deflect, float(g - 1), bx))
        vx = torch.where(opp_deflect, 1,
                         torch.where(agent_deflect, -1, st.vx))
        vy = torch.where(opp_deflect | agent_deflect, dvy, vy)
        # serve after a point, toward the side that conceded
        sbx, sby, svx, svy = self._serve(opp_scores, draws["int"],
                                         draws["choice"])
        mid = RallyState(agent_y=agent_y, opp_y=opp_y,
                         bx=torch.where(scored, sbx, bx),
                         by=torch.where(scored, sby, by),
                         vx=torch.where(scored, svx, vx),
                         vy=torch.where(scored, svy, vy),
                         played=st.played + scored.int())
        done = mid.played >= self.points
        final_frame = self._render(mid)
        fresh = self._fresh(draws)
        obs = torch.where(done.view(-1, 1, 1, 1), self._render(fresh),
                          final_frame)
        return _where(done, fresh, mid), obs, reward, done, final_frame


# -- registry ------------------------------------------------------------------


def has_device_env(env_id: str) -> bool:
    """True when :func:`make_device_env` serves ``env_id``: the Catch and
    Rally families (``apex_tpu/envs/registry.py:131-139``)."""
    return env_id.startswith(("ApexCatch", "ApexRally"))


def make_device_env(env_id: str | None = None, cfg=None,
                    device: torch.device | str = "cuda"):
    """The batched device twin of
    :func:`apex_tpu_torch.envs.registry.make_env`: the same id -> variant
    geometry table (``apex_tpu/envs/registry.py:142-170``).  Raises
    ``ValueError`` naming the id for any env without a device port."""
    env_id = env_id or cfg.env_id
    if not has_device_env(env_id):
        raise ValueError(
            f"env {env_id!r} has no device port; on-device rollouts serve "
            f"the ApexCatch*/ApexRally* families only, use the host actor "
            f"pipeline for this env")
    if env_id.startswith("ApexCatch"):
        if "Small" in env_id:
            return CatchEnv(grid=7, pixels=42, balls=3, env_id=env_id,
                            device=device)
        if "Medium" in env_id:
            return CatchEnv(grid=11, pixels=44, balls=4, env_id=env_id,
                            device=device)
        if env_id == "ApexCatchLong-v0":
            return CatchEnv(balls=50, env_id=env_id, device=device)
        return CatchEnv(env_id=env_id, device=device)
    if "Small" in env_id:
        return RallyEnv(grid=14, pixels=42, points=2, agent_half=2,
                        opp_speed=0.45, env_id=env_id, device=device)
    return RallyEnv(env_id=env_id, device=device)
