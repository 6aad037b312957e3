"""On-device Anakin rollouts: env, policy and chunk assembly on the card.

Counterpart of :mod:`apex_tpu.training.anakin`.  For the envs with a
device port (:func:`apex_tpu_torch.envs.device_envs.make_device_env`) the
host actor loop moves onto the card: one dispatch of ``T`` steps over
``B`` lanes runs, per step,

    acting-stack re-layout -> epsilon-greedy policy -> env step
    (auto-reset) -> n-step window -> chunk assembly

and emits sealed chunks that are byte-identical to what
:class:`~apex_tpu_torch.replay.frame_chunks.FrameChunkBuilder` makes of the
same trajectory: the same message dicts ``drain_builder_chunks`` ships, so
they enter the learner's replay path unchanged.

The builder port is the JAX engine's state machine (``anakin.py:216-467``):
per-episode frame registration with chunk-relative refs, the n-step
window with full-window ``gamma**n`` emission and terminal tails,
flush-on-K and flush-for-frames with the episode's frame carry, pad rows
repeating the last real row, and acting-time TD priorities.  n-step
returns fold ``float32(gamma**i)`` coefficients left to right, which
equals the host builder's float64 fold whenever a window holds at most
one nonzero reward, as Catch and Rally's scoring spacing guarantees.

Where JAX scans, the T-step loop here is a Python loop of masked tensor
ops over ``[B]``, with no host sync inside it: the host reads the
dispatch's results once, after the loop (:meth:`AnakinRollout.rollout`).
JAX's masked writes (``.at[...].set(mode="drop")``) have no torch twin:
an out-of-range index is an error on the CPU and a device-side assert on
the card.  So every per-lane outbox buffer has one dump slot past its
``M`` chunk slots: a masked write lands there, each lane in its own row
(no duplicate indices), and the output never reads it.  Indices stay
int32 in the carry, as the chunks ship them, and widen to int64 where
they index.

Randomness comes from a :class:`~apex_tpu_torch.envs.device_envs.
DrawSource`: one block of draws per dispatch (the policy's explore
uniform and random action, every env site), ``[T, B]`` each.

:class:`AnakinPool` is the ActorPool-shaped adapter that feeds the
ordinary ``ApexTrainer.train``; with an ``inner`` socket pool it also
serves host actors and evaluators (the learner role's ``--rollout
ondevice``).  :func:`make_anakin_engine` builds the engine of one ladder
band too, which ``--role loadgen`` runs as a standalone traffic source.
Each sealed chunk carries a lineage span (``sealed`` hop) in its message
metadata, as the host actors' chunks do.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from apex_tpu_torch import resolve_device
from apex_tpu_torch.actors.pool import EpisodeStat, actor_epsilons
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.device_envs import (UNIFORM, DrawSource,
                                             make_device_env)
from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.obs.trace import STAGING_TRACK, span
from apex_tpu_torch.replay.frame_chunks import FRAME_MARGIN


@dataclass
class RolloutCarry:
    """Builder and env state between steps (leading axis ``B``).

    Only bookkeeping: int32 row maps, the n-step window and the acting
    stack.  Frame bytes go to the dispatch ring (carry region ``[0, Kf)``,
    then the steps' frame pairs) and ``fmap`` maps each chunk row to its
    ring row; chunks take their frames once, after the loop.  Slot
    ``sealed[b]`` is the in-progress chunk, earlier slots were sealed in
    this dispatch, slot ``M`` is the dump slot (module docstring)."""

    env: tuple                  # the env's state tuple
    stack: torch.Tensor         # u8[B, S, D] acting stack, oldest first
    fmap: torch.Tensor          # i32[B, M+1, Kf] chunk row -> ring row
    action: torch.Tensor        # i32[B, M+1, K]
    rd: torch.Tensor            # f32[B, M+1, K, 2] (reward, discount)
    refs: torch.Tensor          # i32[B, M+1, K, 2, S] (obs_ref, next_ref)
    q: torch.Tensor             # f32[B, M+1, K, 2, A] (q0, qn)
    counts: torch.Tensor        # i32[B, M+1, 2] (n_frames, n_trans) at seal
    sealed: torch.Tensor        # i32[B] chunks sealed this dispatch
    cur_nf: torch.Tensor        # i32[B] in-progress frame count
    cur_nt: torch.Tensor        # i32[B] in-progress transition count
    ep_step: torch.Tensor       # i32[B] episode index of the newest frame
    rows: torch.Tensor          # i32[B, W] chunk rows of the last W frames
    w_obs: torch.Tensor         # i32[B, n+1]
    w_act: torch.Tensor         # i32[B, n+1]
    w_rew: torch.Tensor         # f32[B, n+1]
    w_q: torch.Tensor           # f32[B, n+1, A]
    w_len: torch.Tensor         # i32[B]
    ep_ret: torch.Tensor        # f32[B]
    ep_len: torch.Tensor        # i32[B]


def acting_priorities(out: dict) -> torch.Tensor:
    """``|reward + discount * max(qn) - q_taken| + 1e-6`` over the chunk
    grid, in the host builder's order of f32 ops
    (``FrameChunkBuilder._materialize``): the product and the sum are two
    ops, never one fused multiply-add, so the result equals the numpy
    epilogue bit for bit."""
    q_taken = torch.gather(out["q0"], -1,
                           out["action"].long().unsqueeze(-1)).squeeze(-1)
    bootstrap = torch.mul(out["discount"], out["qn"].amax(-1))
    target = torch.add(out["reward"], bootstrap)
    return (target - q_taken).abs() + 1e-6


def host_arrays(tensors: dict) -> dict:
    """Numpy copies of ``tensors`` after one wait: on the card the copies
    go out asynchronously on the current stream and the host waits once."""
    moved = {k: v.to("cpu", non_blocking=True) for k, v in tensors.items()}
    if any(v.is_cuda for v in tensors.values()):
        torch.cuda.current_stream().synchronize()
    return {k: v.numpy() for k, v in moved.items()}


class AnakinRollout:
    """The rollout engine for one device env.

    ``model`` is the Q-network it acts with (a
    :class:`~apex_tpu_torch.models.dueling.DuelingDQN` on the env's
    device).  :meth:`rollout` runs one dispatch of ``rollout_len`` steps
    over ``n_envs`` lanes and returns ``(messages, stats)``;
    :meth:`dispatch` is the same program leaving its chunks on the
    device, for :class:`~apex_tpu_torch.ondevice.fused.FusedStep`.
    Between dispatches the in-progress chunk's frames persist in the
    ring's carry region.
    """

    def __init__(self, env, model: nn.Module, *, n_envs: int, epsilons,
                 slot_ids=None, n_steps: int = 3, gamma: float = 0.99,
                 frame_stack: int = 4, chunk_transitions: int = 64,
                 rollout_len: int | None = None,
                 frame_margin: int = FRAME_MARGIN,
                 draws: DrawSource | None = None, seed: int = 0):
        self.env = env
        self.model = model
        self.device = dev = env.device
        self.B = int(n_envs)
        self.n = int(n_steps)
        self.S = int(frame_stack)
        self.K = int(chunk_transitions)
        self.Kf = self.K + int(frame_margin)
        self.W = self.S + self.n + 1
        self.T = int(rollout_len or chunk_transitions)
        # transitions emitted per dispatch <= leftover window + T + n, and
        # every seal takes at least one; +1 in-progress slot, +1 slack for
        # frame-overflow partial seals (an overflow raises in the epilogue)
        self.M = (self.T + self.n + self.K - 1) // self.K + 3
        self.A = int(env.num_actions)
        self.frame_shape = tuple(env.frame_shape)
        self.D = int(np.prod(self.frame_shape))
        self.slot_ids = list(slot_ids if slot_ids is not None
                             else range(self.B))
        eps = np.asarray(epsilons, np.float32)
        if len(eps) != self.B:
            raise ValueError(
                f"epsilons arity {len(eps)} != n_envs {self.B}")
        self.epsilons = torch.from_numpy(eps).to(dev)
        # the f32 coefficients the host builder's f64 math rounds to
        self.gpow = [float(np.float32(np.float64(gamma) ** i))
                     for i in range(self.n + 1)]
        self.draws = draws or DrawSource(
            torch.Generator(device=dev).manual_seed(seed))
        self._sites = {"explore": UNIFORM, "action": (0, self.A),
                       **env.step_sites}
        # index and constant tensors, made once: a Python scalar in
        # ``torch.where`` or an index converted per call costs a launch
        i32 = torch.int32
        self._ar = torch.arange(self.B, device=dev)
        self._ar_col = self._ar[:, None]
        self._arW = torch.arange(self.W, dtype=i32, device=dev)
        self._arW_l = self._arW.long()
        self._arN = torch.arange(self.n + 1, dtype=i32, device=dev)
        self._stack_offs = torch.arange(self.S - 1, -1, -1, dtype=i32,
                                        device=dev)
        self._always = torch.ones(self.B, dtype=torch.bool, device=dev)
        self._zero_i = torch.zeros((), dtype=i32, device=dev)
        self._neg1 = torch.tensor(-1, dtype=i32, device=dev)
        self._zero_f = torch.zeros((), device=dev)
        self._gpow = torch.tensor(self.gpow, device=dev)
        self._gpow_n = self._gpow[self.n].expand(self.B)
        # the dispatch ring: carry region [0, Kf), then (final, obs) frame
        # pairs of each step; kept across dispatches
        self.ring = torch.zeros((self.B, self.Kf + 2 * self.T, self.D),
                                dtype=torch.uint8, device=dev)
        # ring row numbers as device scalars: a Python int written through
        # an index would be a host-to-device copy, a sync, every step
        self._ring_rows = torch.arange(self.Kf + 2 * self.T,
                                       dtype=torch.int32, device=dev)
        self.carry = self._init_carry()
        # host counters
        self.dispatches = 0
        self.chunks = 0
        self.frames = 0
        self.transitions = 0

    # -- construction ------------------------------------------------------

    def _init_carry(self) -> RolloutCarry:
        B, M, K, Kf, S, A, n = (self.B, self.M, self.K, self.Kf, self.S,
                                self.A, self.n)
        dev = self.device
        states, obs = self.env.reset(self.draws.reset(self.env.reset_sites,
                                                      B))
        flat = obs.reshape(B, self.D)
        # begin_episode: the reset frame is episode frame 0 = chunk row 0;
        # the acting stack starts as S copies of it
        self.ring[:, 0] = flat

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        f32 = torch.float32
        self._dump = torch.tensor(M, dtype=torch.int32, device=dev)
        return RolloutCarry(
            env=states,
            stack=flat[:, None].expand(B, S, self.D).clone(),
            fmap=zeros(B, M + 1, Kf), action=zeros(B, M + 1, K),
            rd=zeros(B, M + 1, K, 2, dtype=f32),
            refs=zeros(B, M + 1, K, 2, S),
            q=zeros(B, M + 1, K, 2, A, dtype=f32),
            counts=zeros(B, M + 1, 2), sealed=zeros(B),
            cur_nf=torch.ones(B, dtype=torch.int32, device=dev),
            cur_nt=zeros(B), ep_step=zeros(B), rows=zeros(B, self.W),
            w_obs=zeros(B, n + 1), w_act=zeros(B, n + 1),
            w_rew=zeros(B, n + 1, dtype=f32),
            w_q=zeros(B, n + 1, A, dtype=f32), w_len=zeros(B),
            ep_ret=zeros(B, dtype=f32), ep_len=zeros(B))

    # -- builder-port primitives (batched over B, masked) ------------------

    def _slot(self, c: RolloutCarry, do: torch.Tensor) -> torch.Tensor:
        """The in-progress slot where ``do``, the dump slot elsewhere."""
        return torch.where(do, c.sealed, self._dump).long()

    def _rows_of(self, c: RolloutCarry, ep_idx: torch.Tensor):
        """Chunk rows of the episode frames ``ep_idx [B, J]`` (clamped to
        frame 0, the builder's episode-start repeat) from the recent-rows
        ring."""
        idx = (self.W - 1) - (c.ep_step[:, None] - ep_idx.clamp_min(0))
        return torch.gather(c.rows, 1, idx.clamp(0, self.W - 1).long())

    def _flush(self, c: RolloutCarry, do: torch.Tensor) -> None:
        """``FrameChunkBuilder._flush``: seal when transitions exist (else
        drop the frame-only chunk), then carry the episode frames that the
        live window and the acting stack still need into the fresh chunk:
        an int32 remap of ``fmap`` rows, no frame bytes move."""
        ar, W = self._ar, self.W
        has_trans = c.cur_nt >= 1
        seal = do & has_trans
        active = do & (has_trans | (c.cur_nf >= 1))
        c.counts[ar, self._slot(c, seal)] = torch.stack([c.cur_nf,
                                                         c.cur_nt], 1)
        # an overflowing seal stays on the dump slot (raised after the
        # dispatch)
        new_cur = (c.sealed + seal).clamp_max(self.M)
        # frame carry: episode frames oldest..ep_step -> rows 0..count-1;
        # gather the carried ring rows first, then one scatter
        has_ep = c.ep_step >= 0
        head = torch.where(c.w_len > 0, c.w_obs[:, 0], c.ep_step)
        oldest = (head - (self.S - 1)).clamp_min(0)
        keep = active & has_ep
        count = torch.where(keep, c.ep_step - oldest + 1, self._zero_i)
        src = self._rows_of(c, oldest[:, None] + self._arW).clamp(
            0, self.Kf - 1).long()
        carried = c.fmap[self._ar_col, c.sealed.long()[:, None], src]
        dst = torch.where(active[:, None] & (self._arW < count[:, None]),
                          new_cur[:, None], self._dump).long()
        c.fmap[self._ar_col, dst, self._arW_l] = carried
        # recent-rows remap: episode frame f's new chunk row is f - oldest
        ring_ep = self._arW + (c.ep_step - (W - 1))[:, None]
        c.rows = torch.where(keep[:, None], ring_ep - oldest[:, None],
                             c.rows)
        c.sealed = torch.where(seal, new_cur, c.sealed)
        c.cur_nf = torch.where(active, count, c.cur_nf)
        c.cur_nt = torch.where(seal, self._zero_i, c.cur_nt)

    def _register(self, c: RolloutCarry, ring_row: int,
                  do: torch.Tensor) -> None:
        """Append one frame (already at ``ring_row`` of the dispatch ring)
        to the in-progress chunk and shift the recent-rows ring."""
        row = c.cur_nf
        c.fmap[self._ar, self._slot(c, do),
               row.clamp_max(self.Kf - 1).long()] = self._ring_rows[ring_row]
        c.rows = torch.where(do[:, None],
                             torch.cat([c.rows[:, 1:], row[:, None]], 1),
                             c.rows)
        c.cur_nf = c.cur_nf + do

    def _push(self, c: RolloutCarry, ret, next_end, disc, qn_row,
              do: torch.Tensor) -> None:
        """Emit one transition from the window head, then flush at K.  Its
        refs are the rows of the S-stacks ending at the head's frame and
        at ``next_end``, oldest first (``FrameChunkBuilder._stack_refs``),
        in one gather."""
        ar = self._ar
        sl = self._slot(c, do)
        pos = c.cur_nt.clamp_max(self.K - 1).long()
        c.action[ar, sl, pos] = c.w_act[:, 0]
        c.rd[ar, sl, pos] = torch.stack([ret, disc], 1)
        ends = torch.stack([c.w_obs[:, 0], next_end], 1)
        c.refs[ar, sl, pos] = self._rows_of(
            c, (ends[:, :, None] - self._stack_offs).view(self.B, -1)).view(
            self.B, 2, self.S)
        c.q[ar, sl, pos] = torch.stack([c.w_q[:, 0], qn_row], 1)
        c.cur_nt = c.cur_nt + do
        self._flush(c, do & (c.cur_nt == self.K))

    def _popleft(self, c: RolloutCarry, do: torch.Tensor) -> None:
        m = do[:, None]
        c.w_obs = torch.where(m, c.w_obs.roll(-1, 1), c.w_obs)
        c.w_act = torch.where(m, c.w_act.roll(-1, 1), c.w_act)
        c.w_rew = torch.where(m, c.w_rew.roll(-1, 1), c.w_rew)
        c.w_q = torch.where(m[..., None], c.w_q.roll(-1, 1), c.w_q)
        c.w_len = torch.where(do, c.w_len - 1, c.w_len)

    def _nstep_return(self, c: RolloutCarry, k) -> torch.Tensor:
        """Left fold, from 0.0, of ``gpow[i] * w_rew[i]`` over ``i < k``:
        the host builder's ``sum(gamma**i * r_i)`` with its rounded
        coefficients.  A static ``k`` folds the first ``k`` terms (adding
        the masked terms' 0.0 to a sum from 0.0 changes nothing)."""
        terms = c.w_rew * self._gpow
        if not isinstance(k, int):
            terms = torch.where(self._arN < k[:, None], terms, self._zero_f)
            k = self.n + 1
        acc = self._zero_f + terms[:, 0]
        for i in range(1, k):
            acc = acc + terms[:, i]
        return acc

    # -- one step ----------------------------------------------------------

    def _policy_obs(self, c: RolloutCarry) -> torch.Tensor:
        """The acting stack as the policy's contiguous NHWC batch, the
        layout the host builder's stacks and the learner's batches have
        (for one channel a reshape alone would leave an NCHW view, and
        the convs round differently on it)."""
        shp = self.frame_shape
        stk = c.stack.view(self.B, self.S, *shp).movedim(1, -2)
        return stk.reshape(self.B, *shp[:-1],
                           self.S * shp[-1]).contiguous()

    def _step(self, model: nn.Module, c: RolloutCarry, t: int,
              draws: dict, log: dict) -> None:
        B, n, ar = self.B, self.n, self._ar
        q = model(self._policy_obs(c)).float()
        explore = draws["explore"] < self.epsilons
        actions = torch.where(explore, draws["action"].long(),
                              q.argmax(1))
        c.env, obs, reward, done, final_frame = self.env.step(
            c.env, actions, draws)
        final_flat = final_frame.reshape(B, self.D)
        obs_flat = obs.reshape(B, self.D)
        final_row = self.Kf + 2 * t
        obs_row = final_row + 1
        self.ring[:, final_row] = final_flat
        self.ring[:, obs_row] = obs_flat

        # add_step: flush-for-frames, register, window append
        self._flush(c, c.cur_nf + 1 > self.Kf)
        obs_idx = c.ep_step
        c.ep_step = c.ep_step + 1
        self._register(c, final_row, self._always)
        pos = c.w_len.clamp_max(n).long()
        c.w_obs[ar, pos] = obs_idx
        c.w_act[ar, pos] = actions.int()
        c.w_rew[ar, pos] = reward
        c.w_q[ar, pos] = q
        c.w_len = c.w_len + 1
        # full-window emission (gamma**n bootstrap)
        full = c.w_len == n + 1
        self._push(c, self._nstep_return(c, n), c.w_obs[:, 0] + n,
                   self._gpow_n, c.w_q[:, n], full)
        self._popleft(c, full)
        # terminal tails (discount 0, the next stack a masked obs stack)
        zero = self._zero_f.expand(B)
        for _ in range(n):
            m = done & (c.w_len > 0)
            k = c.w_len
            qn_row = c.w_q[ar, (k - 1).clamp(0, n).long()]
            self._push(c, self._nstep_return(c, k), c.w_obs[:, 0], zero,
                       qn_row, m)
            self._popleft(c, m)
        c.ep_step = torch.where(done, self._neg1, c.ep_step)
        # auto-reset: begin_episode(obs) on the done lanes
        self._flush(c, done & (c.cur_nf + 1 > self.Kf))
        c.ep_step = torch.where(done, self._zero_i, c.ep_step)
        c.w_len = torch.where(done, self._zero_i, c.w_len)
        self._register(c, obs_row, done)
        # acting stack: roll the new frame in; a reset refills all S
        stack = torch.cat([c.stack[:, 1:], final_flat[:, None]], 1)
        c.stack = torch.where(done[:, None, None], obs_flat[:, None],
                              stack)
        ep_ret = c.ep_ret + reward
        ep_len = c.ep_len + 1
        log["done"][t] = done
        log["ep_ret"][t] = ep_ret
        log["ep_len"][t] = ep_len
        c.ep_ret = torch.where(done, self._zero_f, ep_ret)
        c.ep_len = torch.where(done, self._zero_i, ep_len)

    # -- the dispatch ------------------------------------------------------

    def _rebase(self, c: RolloutCarry) -> None:
        """Dispatch prologue: the in-progress chunk moves to slot 0, its
        frames now at identity rows of the ring's carry region."""
        src = c.sealed.clamp_max(self.M - 1).long()
        for name in ("fmap", "action", "rd", "refs", "q"):
            buf = getattr(c, name)
            buf[:, 0] = buf[self._ar, src]
        c.fmap[:, 0] = torch.arange(self.Kf, dtype=torch.int32,
                                    device=self.device)
        c.rows = c.rows.clamp(0, self.Kf - 1)
        c.sealed = torch.zeros_like(c.sealed)

    def _pad(self, a: torch.Tensor, counts: torch.Tensor, length: int):
        """Rows ``>= counts`` of each chunk slot repeat its last real row
        (pad-rows-repeat-last) over ``a [B, M, length, ...]``."""
        B, M = self.B, self.M
        idx = torch.minimum(
            torch.arange(length, device=self.device),
            (counts.long() - 1).clamp_min(0)[..., None])
        base = torch.arange(B * M, device=self.device).view(B, M, 1)
        flat = (base * length + idx).view(-1)
        return a.reshape(B * M * length, -1).index_select(0, flat).view(
            a.shape)

    @torch.no_grad()
    def dispatch(self, model: nn.Module | None = None) -> dict:
        """One dispatch of ``T`` steps, acting with ``model`` (default the
        engine's own).  Returns the chunk grid on the device: ``frames``
        u8[B, M, Kf, D], ``action``/``reward``/``discount`` [B, M, K],
        ``obs_ref``/``next_ref`` i32[B, M, K, S], ``q0``/``qn``
        f32[B, M, K, A], ``nf``/``nt`` i32[B, M], ``sealed`` i32[B] and
        ``done``/``ep_ret``/``ep_len`` [T, B], the step-wise episode
        tallies before a reset.  Slots ``>= sealed[b]`` are not chunks."""
        model = self.model if model is None else model
        c = self.carry
        B, M, T = self.B, self.M, self.T
        self._rebase(c)
        draws = self.draws.dispatch(self._sites, T, B)
        dev = self.device
        log = dict(done=torch.zeros((T, B), dtype=torch.bool, device=dev),
                   ep_ret=torch.zeros((T, B), device=dev),
                   ep_len=torch.zeros((T, B), dtype=torch.int32,
                                      device=dev))
        for t in range(T):
            self._step(model, c, t, {k: v[t] for k, v in draws.items()},
                       log)
        # write the in-progress counts through, then pad and materialize
        sl = c.sealed.clamp_max(M - 1).long()
        counts = c.counts.clone()
        counts[self._ar, sl] = torch.stack([c.cur_nf, c.cur_nt], 1)
        nf, nt = counts[:, :M, 0], counts[:, :M, 1]
        fmap = self._pad(c.fmap[:, :M], nf, self.Kf)
        ring_rows = self.ring.shape[1]
        flat = (fmap.long() + (self._ar * ring_rows).view(B, 1, 1)).view(-1)
        frames = self.ring.view(-1, self.D).index_select(0, flat).view(
            B, M, self.Kf, self.D)
        # the in-progress chunk's frames: the next dispatch's carry region
        self.ring[:, :self.Kf] = frames[self._ar, sl]
        rd = self._pad(c.rd[:, :M], nt, self.K)
        refs = self._pad(c.refs[:, :M], nt, self.K)
        q = self._pad(c.q[:, :M], nt, self.K)
        self.dispatches += 1
        self.frames += T * B
        return dict(frames=frames,
                    action=self._pad(c.action[:, :M], nt, self.K),
                    reward=rd[..., 0], discount=rd[..., 1],
                    obs_ref=refs[..., 0, :], next_ref=refs[..., 1, :],
                    q0=q[..., 0, :], qn=q[..., 1, :], nf=nf, nt=nt,
                    sealed=c.sealed.clone(), **log)

    def rollout(self):
        """One dispatch with the engine's model; returns ``(messages,
        stats)``: chunk messages in the ``drain_builder_chunks`` schema
        (numpy payloads) and an :class:`EpisodeStat` per episode that
        ended in the dispatch, in step-then-lane order."""
        out = self.dispatch()
        out["priorities"] = acting_priorities(out)
        got = host_arrays({k: out[k] for k in (
            "frames", "action", "reward", "discount", "obs_ref", "next_ref",
            "nf", "nt", "sealed", "priorities", "done", "ep_ret",
            "ep_len")})
        sealed = got["sealed"]
        if sealed.max(initial=0) > self.M - 1:
            raise RuntimeError(
                f"anakin outbox overflow: {int(sealed.max())} seals > "
                f"{self.M - 1} sealed slots; raise rollout_len headroom")
        stamped = obs_spans.enabled()
        msgs = []
        for b in range(self.B):
            for j in range(int(sealed[b])):
                chunk = dict(
                    frames=got["frames"][b, j],
                    n_frames=np.int32(got["nf"][b, j]),
                    n_trans=np.int32(got["nt"][b, j]),
                    action=got["action"][b, j],
                    reward=got["reward"][b, j],
                    discount=got["discount"][b, j],
                    obs_ref=got["obs_ref"][b, j],
                    next_ref=got["next_ref"][b, j])
                msg = {"payload": chunk,
                       "priorities": got["priorities"][b, j],
                       "n_trans": int(got["nt"][b, j])}
                if stamped:
                    # lineage metadata, outside the payload
                    msg[obs_spans.SPAN_KEY] = [
                        obs_spans.new_span(hop="sealed")]
                msgs.append(msg)
        done, ep_ret, ep_len = got["done"], got["ep_ret"], got["ep_len"]
        stats = [EpisodeStat(self.slot_ids[b], float(ep_ret[t, b]),
                             int(ep_len[t, b]))
                 for t in range(self.T) for b in range(self.B)
                 if done[t, b]]
        self.chunks += len(msgs)
        self.transitions += sum(m["n_trans"] for m in msgs)
        return msgs, stats


def make_anakin_engine(cfg: ApexConfig, rollout_len: int | None = None,
                       device: torch.device | str = "cuda",
                       model: nn.Module | None = None,
                       n_envs: int | None = None, slot_band: int = 0,
                       total_slots: int | None = None) -> AnakinRollout:
    """Engine wired from the config (``apex_tpu/training/anakin.py:527-562``):
    the device env (:func:`make_device_env` raises ``ValueError`` naming
    an id without one), a DQN model of the trainer's spec (``model``, or a
    fresh one seeded from ``cfg.env.seed``) and the epsilon ladder.

    The defaults build the co-located engine that owns the whole fleet's
    lanes (``n_actors * n_envs_per_actor``, the ladder spanning them
    all).  Loadgen process ``i`` of ``N`` passes ``n_envs =
    n_envs_per_actor, slot_band = i, total_slots = N * n_envs_per_actor``:
    the ladder band a host vector worker with that actor id owns
    (:func:`~apex_tpu_torch.actors.vector.worker_slots`).  The draws come
    from a generator seeded ``cfg.env.seed + 1000 * (slot_band + 1)``,
    the JAX engine's seed, so bands explore apart."""
    from apex_tpu_torch.models.dueling import DuelingDQN
    from apex_tpu_torch.training.apex import dqn_env_specs

    dev = resolve_device(device)
    env = make_device_env(cfg.env.env_id, cfg.env, device=dev)
    model_spec, _shape, _dtype, frame_stack = dqn_env_specs(cfg)
    if model is None:
        model = DuelingDQN(**model_spec, generator=torch.Generator()
                           .manual_seed(cfg.env.seed)).to(dev)
    b = n_envs or max(cfg.actor.n_actors, 1) * max(
        1, cfg.actor.n_envs_per_actor)
    total = max(total_slots or 0, (slot_band + 1) * b)
    ladder = actor_epsilons(total, cfg.actor.eps_base, cfg.actor.eps_alpha)
    slot_ids = list(range(slot_band * b, (slot_band + 1) * b))
    return AnakinRollout(
        env, model, n_envs=b, epsilons=ladder[slot_ids], slot_ids=slot_ids,
        n_steps=cfg.learner.n_steps, gamma=cfg.learner.gamma,
        frame_stack=frame_stack, chunk_transitions=cfg.actor.send_interval,
        rollout_len=rollout_len, seed=cfg.env.seed + 1000 * (slot_band + 1))


class AnakinPool:
    """ActorPool-shaped adapter over :class:`AnakinRollout` for training
    with the rollouts on the card (``apex_tpu/training/anakin.py:565-684``).

    ``accepts_device_params``: the trainer hands over a device copy of its
    weights (and the ingest pipeline makes no host copy of it); the pool
    keeps that copy, and the engine loads it into its own model, which the
    learner's optimizer never touches, before its next dispatch.
    Dispatches run lazily inside :meth:`poll_chunks`, so the trainer's
    replay-ratio backpressure gates collection for free; with the ingest
    pipeline on, they run on its staging thread and side stream.  Episode
    stats surface through :meth:`poll_stats`, stamped with the param
    version the engine acted on.

    ``inner`` (a socket :class:`~apex_tpu_torch.runtime.transport.
    RemotePool`) keeps host actors and evaluators riding alongside: its
    chunks and stats merge in ahead of the engine's, publishes fan out to
    it as host params, and any other attribute (``wire_summary``,
    ``peer_seen``, ...) is its.  The pool beats as ``identity`` (role
    ``rollout``, the engine's counters as gauges) through
    :meth:`poll_stats`, so the learner's registry lists it."""

    accepts_device_params = True

    def __init__(self, cfg: ApexConfig, engine: AnakinRollout | None = None,
                 device: torch.device | str = "cuda", inner=None,
                 identity: str = "ondevice-0"):
        self.cfg = cfg
        self.engine = engine or make_anakin_engine(cfg, device=device)
        self.inner = inner
        self._params: dict | None = None
        self._version = 0
        self._acting_version = 0
        self._pending: deque = deque()
        self._stats: deque = deque()
        self._beat = HeartbeatEmitter(
            identity, role="rollout",
            interval_s=cfg.comms.heartbeat_interval_s,
            gauges_fn=self.ondevice_counters)
        self._t0 = time.monotonic()

    def __getattr__(self, name):
        # the rest of the surface is the inner pool's; a pure on-device
        # pool lacks it
        inner = self.__dict__.get("inner")
        if inner is not None:
            return getattr(inner, name)
        raise AttributeError(name)

    @property
    def needs_warmup_republish(self) -> bool:
        return bool(getattr(self.inner, "needs_warmup_republish", False))

    def start(self) -> None:
        if self.inner is not None:
            self.inner.start()

    def cleanup(self) -> None:
        if self.inner is not None:
            self.inner.cleanup()

    def set_learner_epoch(self, epoch: int) -> None:
        setter = getattr(self.inner, "set_learner_epoch", None)
        if setter is not None:
            setter(epoch)

    def peer_seen(self) -> dict:
        seen = getattr(self.inner, "peer_seen", None)
        return seen() if callable(seen) else {}

    def publish_params(self, version: int, params: dict) -> None:
        """Keep the device copy; the engine loads it before its next
        dispatch.  An inner socket pool gets the host copy, made on the
        caller's stream."""
        self._version, self._params = version, params
        if self.inner is not None:
            self.inner.publish_params(
                version, {name: t.detach().cpu().numpy()
                          for name, t in params.items()})

    def poll_chunks(self, max_chunks: int, timeout: float = 0.0) -> list:
        out = []
        if self.inner is not None:
            out = self.inner.poll_chunks(max_chunks, timeout=0)
        dry = 0
        while len(out) < max_chunks:
            if not self._pending:
                # a short dispatch can seal nothing (the n-step window
                # lags the first emissions); each dispatch advances the
                # stream, so a few retries always produce
                if self._params is None or dry >= 4:
                    break
                if self._acting_version != self._version:
                    # a copy into the engine's own model, on this thread's
                    # stream
                    self.engine.model.load_state_dict(self._params)
                    self._acting_version = self._version
                with span("apex.anakin.rollout", STAGING_TRACK):
                    msgs, stats = self.engine.rollout()
                for stat in stats:
                    stat.param_version = self._acting_version
                self._pending.extend(msgs)
                self._stats.extend(stats)
                dry = 0 if msgs else dry + 1
                continue
            out.append(self._pending.popleft())
        return out

    def poll_stats(self) -> list:
        out = list(self._stats)
        self._stats.clear()
        self._beat.tick(0)
        hb = self._beat.maybe_beat(self._version)
        if hb is not None:
            e = self.engine
            hb.fps = round(e.frames / max(time.monotonic() - self._t0,
                                          1e-9), 1)
            hb.chunks_sent = e.chunks
            out.append(hb)
        if self.inner is not None:
            out.extend(self.inner.poll_stats())
        return out

    def ondevice_counters(self) -> dict:
        e = self.engine
        return {"dispatches": e.dispatches, "chunks": e.chunks,
                "frames": e.frames, "transitions": e.transitions,
                "rollout_len": e.T, "n_envs": e.B}
