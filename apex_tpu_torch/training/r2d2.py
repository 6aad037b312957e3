"""Recurrent DQN (R2D2-style) drivers.

Counterpart of :mod:`apex_tpu.training.r2d2` (read its module docstring
for the recipe: stored recurrent state, burn-in, overlapping sequences as
replay items):

* :class:`SequenceBuilder` cuts episodes into overlapping fixed-length
  sequences on the host, recording the carry at each sequence start and
  acting-time insert priorities.
* :func:`build_r2d2` wires :class:`~apex_tpu_torch.models.recurrent.
  RecurrentDuelingDQN`, the replay (the frame-dedup
  :class:`~apex_tpu_torch.replay.seq_pool.SequenceFramePoolReplay` for
  pixels with ``replay.frame_pool``, else stacked sequences in a
  :class:`~apex_tpu_torch.replay.device.DeviceReplay`), the optimizer and
  :class:`R2D2Core`, the learner core with :func:`~apex_tpu_torch.ops.
  losses.r2d2_loss` in place of the DQN loss.
* :class:`R2D2Trainer` is the single-process driver,
  :class:`R2D2ApexTrainer` the concurrent one on
  :class:`~apex_tpu_torch.training.apex.ConcurrentTrainer` with worker
  processes of :mod:`apex_tpu_torch.actors.r2d2` over the shm ring.

As in the other drivers, PRNG keys become ``torch.Generator`` draws on the
learner's device, and entry points default to ``"cuda"``.  Not ported:
the sharded learner (``mesh_shape`` > 1), the socket roles and remote
policy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.actors.pool import ActorPool
from apex_tpu_torch.actors.r2d2 import (drain_grouped,
                                        pooled_sequence_message,
                                        r2d2_worker_main, sequence_message,
                                        vector_r2d2_worker_main)
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.registry import make_env, make_eval_env, num_actions
from apex_tpu_torch.models.recurrent import (RecurrentDuelingDQN,
                                             episodic_policy,
                                             make_recurrent_policy_fn)
from apex_tpu_torch.ops.losses import PRIORITY_ETA, make_optimizer, r2d2_loss
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.base import check_hbm_budget
from apex_tpu_torch.replay.device import DeviceReplay
from apex_tpu_torch.replay.seq_pool import SequenceFramePoolReplay
from apex_tpu_torch.training.apex import ConcurrentTrainer
from apex_tpu_torch.training.checkpoint import (CheckpointableTrainer,
                                                Checkpointer,
                                                run_policy_episodes)
from apex_tpu_torch.training.dqn import BetaSchedule, EpsilonSchedule
from apex_tpu_torch.training.learner import LearnerCore, td_update
from apex_tpu_torch.training.state import create_train_state
from apex_tpu_torch.utils.metrics import MetricLogger, RateCounter


class SequenceBuilder:
    """Host-side episode-to-sequence splitter (``r2d2.py:55-222``).

    Per step the caller gives the observation, action, reward, the
    termination flag and the carry BEFORE acting (the one that produced
    the action).  Episodes are cut into sequences of ``t_total = burn_in +
    unroll + n_steps`` steps starting every ``stride`` steps; short tails
    are zero-padded with ``mask=0`` (the padded ``discount=0`` truncates
    every n-step product across the end).  A sequence is emitted only if
    its loss region holds a real step.  ``pooled`` emits frame references
    (``ep_frames``, ``start``, ``end``) for
    :func:`~apex_tpu_torch.actors.r2d2.pooled_sequence_message` in place
    of each window's padded ``obs``.
    """

    def __init__(self, burn_in: int, unroll: int, n_steps: int,
                 gamma: float, stride: int | None = None,
                 pooled: bool = False):
        self.burn_in, self.unroll, self.n_steps = burn_in, unroll, n_steps
        self.t_total = burn_in + unroll + n_steps
        self.stride = stride or max(1, unroll // 2)
        if pooled and self.stride > self.t_total:
            # the pooled packer ships each episode's union coverage as one
            # block sized for overlapping windows
            raise ValueError(
                f"pooled sequence layout requires stride <= t_total "
                f"(burn_in + unroll + n_steps = {self.t_total}), got "
                f"stride={self.stride}")
        self.gamma = gamma
        self.pooled = pooled
        self._obs: list = []
        self._action: list = []
        self._reward: list = []
        self._discount: list = []
        self._carry: list = []
        self._q: list = []
        self._out: list[dict] = []

    @property
    def needs_carry(self) -> bool:
        """True when the next ``add_step`` starts a sequence window: only
        those carries are read back, so the caller copies the carry to
        the host only then."""
        return len(self._obs) % self.stride == 0

    def add_step(self, obs, action: int, reward: float, terminated: bool,
                 carry_c: np.ndarray | None, carry_h: np.ndarray | None,
                 q_values: np.ndarray | None = None) -> None:
        """``carry_c``/``carry_h`` may be None unless :attr:`needs_carry`
        was True before this call.  ``q_values``, the acting-time Q
        vector, feeds the insert priority; without them sequences insert
        at priority 1."""
        if len(self._obs) % self.stride == 0 and carry_c is None:
            raise ValueError("sequence-start step needs its carry "
                             "(check builder.needs_carry before acting)")
        self._obs.append(np.asarray(obs))
        self._action.append(int(action))
        self._reward.append(float(reward))
        self._discount.append(0.0 if terminated else self.gamma)
        self._carry.append(
            None if carry_c is None
            else (np.asarray(carry_c), np.asarray(carry_h)))
        self._q.append(None if q_values is None
                       else np.asarray(q_values, np.float32))

    def end_episode(self, truncated: bool = False) -> None:
        """Cut the finished episode into sequences and clear the step
        buffers.  After a truncation (time limit, not termination) the
        last ``n_steps`` loss positions get ``mask=0``: their n-step
        windows would bootstrap from padded zero observations."""
        n = len(self._obs)
        if n == 0:
            return
        mask_full = np.ones(n, np.float32)
        if truncated:
            mask_full[max(0, n - self.n_steps):] = 0.0
        td_full = self._acting_time_tds(n)
        obs = np.stack(self._obs)
        emitted: list[dict] = []
        starts: list[int] = []
        start = 0
        while start + self.burn_in < n:
            end = min(start + self.t_total, n)
            pad = self.t_total - (end - start)
            m = _pad(mask_full[start:end], pad)
            lm = m[self.burn_in:self.burn_in + self.unroll]
            if not lm.any():
                break            # loss region entirely padded or masked
            c, h = self._carry[start]
            seq = dict(
                action=_pad(np.asarray(self._action[start:end], np.int32),
                            pad),
                reward=_pad(np.asarray(self._reward[start:end], np.float32),
                            pad),
                discount=_pad(np.asarray(self._discount[start:end],
                                         np.float32), pad),
                mask=m,
                state_c=c.astype(np.float32),
                state_h=h.astype(np.float32),
            )
            if self.pooled:
                # one episode array shared by every window over it
                seq["ep_frames"], seq["start"], seq["end"] = obs, start, end
            else:
                seq["obs"] = _pad(obs[start:end], pad)
            if td_full is not None:
                td = _pad(td_full[start:end], pad)[
                    self.burn_in:self.burn_in + self.unroll] * lm
                nv = max(lm.sum(), 1.0)
                seq["priority"] = np.float32(
                    PRIORITY_ETA * td.max()
                    + (1.0 - PRIORITY_ETA) * td.sum() / nv + 1e-6)
            else:
                seq["priority"] = np.float32(1.0)
            emitted.append(seq)
            starts.append(start)
            start += self.stride
        # n_new: env steps new to each sequence against its overlapping
        # predecessors; every step counts once per episode
        for i, (seq, s) in enumerate(zip(emitted, starts)):
            nxt = starts[i + 1] if i + 1 < len(starts) else n
            seq["n_new"] = int(min(nxt, n) - s)
        self._out.extend(emitted)
        self._obs, self._action, self._reward = [], [], []
        self._discount, self._carry, self._q = [], [], []

    def _acting_time_tds(self, n: int) -> np.ndarray | None:
        """Per-step 1-step |TD| from the acting-time Q vectors, ``|r + disc
        * max q' - q[a]|`` with bootstrap 0 past the episode's end; None
        when a step lacked its Q vector."""
        if any(q is None for q in self._q):
            return None
        maxq = np.asarray([float(q.max()) for q in self._q] + [0.0],
                          np.float32)
        td = np.empty(n, np.float32)
        for t in range(n):
            td[t] = abs(self._reward[t]
                        + self._discount[t] * maxq[t + 1]
                        - float(self._q[t][self._action[t]]))
        return td

    def drain(self) -> list[dict]:
        out, self._out = self._out, []
        return out


def _pad(arr: np.ndarray, pad: int) -> np.ndarray:
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths)


@dataclass(frozen=True)
class R2D2Core(LearnerCore):
    """The learner core with the sequence loss (``r2d2.py:232-288``):
    ingest, train and fused steps of :class:`LearnerCore` over a
    sequence replay."""

    burn_in: int = 8
    n_steps: int = 3

    def update_from_batch(self, train_state, batch: dict,
                          weights: torch.Tensor):
        def loss_fn():
            return r2d2_loss(train_state.params, train_state.target_params,
                             batch, weights, burn_in=self.burn_in,
                             n_steps=self.n_steps)

        return td_update(self.optimizer, self.target_update_interval,
                         train_state, loss_fn)


def r2d2_env_specs(cfg: ApexConfig):
    """(model_spec, obs_shape, obs_dtype) of the recurrent family from a
    probe env: single frames (the LSTM is the memory).  The spec carries
    ``obs_shape``, which torch layers need up front."""
    probe = make_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed)
    obs_shape = tuple(probe.observation_space.shape)
    obs_dtype = probe.observation_space.dtype
    spec = dict(
        num_actions=num_actions(probe), obs_shape=obs_shape,
        obs_is_image=len(obs_shape) == 3,
        compute_dtype=getattr(torch, cfg.learner.compute_dtype),
        scale_uint8=np.dtype(obs_dtype) == np.uint8,
        lstm_features=cfg.r2d2.lstm_features)
    probe.close()
    return spec, obs_shape, obs_dtype


def r2d2_uses_frame_pool(cfg: ApexConfig, obs_shape) -> bool:
    """The one predicate choosing the family's storage layout, shared by
    :func:`build_r2d2` and the worker families: pooled frames for pixel
    observations under ``replay.frame_pool``, stacked sequences else."""
    return bool(cfg.replay.frame_pool) and len(obs_shape) == 3


def r2d2_frame_capacity(cfg: ApexConfig) -> int:
    """Frame-ring rows of the pooled layout: each live sequence holds about
    ``stride`` new frames plus its share of the windows reshipped across
    message boundaries (``(t_total - stride + 1) / group``), with 1.5x
    headroom so the staleness redirect stays rare."""
    rc, lc = cfg.r2d2, cfg.learner
    t_total = rc.burn_in + rc.unroll + lc.n_steps
    stride = rc.stride or max(1, rc.unroll // 2)
    per_seq = stride + -(-(t_total - stride + 1) // rc.sequence_group)
    return max(2 * t_total, int(1.5 * cfg.replay.capacity * per_seq))


def build_r2d2(cfg: ApexConfig, device: torch.device):
    """(model_spec, obs_shape, obs_dtype, model, replay, replay_state,
    train_state, core) on ``device``: the one definition of the family's
    replay schema and core wiring, shared by both drivers.  The weights
    are drawn from ``cfg.env.seed``."""
    rc, lc = cfg.r2d2, cfg.learner
    model_spec, obs_shape, obs_dtype = r2d2_env_specs(cfg)
    model = RecurrentDuelingDQN(
        **model_spec, generator=torch.Generator().manual_seed(cfg.env.seed)
    ).to(device)
    t_total = rc.burn_in + rc.unroll + lc.n_steps
    if r2d2_uses_frame_pool(cfg, obs_shape):
        replay = SequenceFramePoolReplay(
            capacity=cfg.replay.capacity, t_total=t_total,
            lstm_features=rc.lstm_features, frame_shape=obs_shape,
            frame_capacity=r2d2_frame_capacity(cfg),
            frame_dtype=np.dtype(obs_dtype).name,
            alpha=cfg.replay.alpha, eps=cfg.replay.eps)
        check_hbm_budget(replay.hbm_bytes(), cfg.replay.hbm_budget_gb,
                         "R2D2 replay (pooled sequence storage)",
                         cfg.replay.capacity, device)
        replay_state = replay.init(device)
    else:
        replay = DeviceReplay(capacity=cfg.replay.capacity,
                              alpha=cfg.replay.alpha, eps=cfg.replay.eps)
        example_item = dict(
            obs=np.zeros((t_total,) + obs_shape, obs_dtype),
            action=np.zeros(t_total, np.int32),
            reward=np.zeros(t_total, np.float32),
            discount=np.zeros(t_total, np.float32),
            mask=np.zeros(t_total, np.float32),
            state_c=np.zeros(rc.lstm_features, np.float32),
            state_h=np.zeros(rc.lstm_features, np.float32))
        check_hbm_budget(replay.hbm_bytes(example_item),
                         cfg.replay.hbm_budget_gb,
                         "R2D2 replay (sequence storage)",
                         cfg.replay.capacity, device)
        replay_state = replay.init(example_item, device)
    optimizer = make_optimizer(
        lr=lc.lr, decay=lc.rmsprop_decay, eps=lc.rmsprop_eps,
        centered=lc.rmsprop_centered, max_grad_norm=lc.max_grad_norm,
        lr_decay_steps=lc.lr_decay_steps, lr_decay_rate=lc.lr_decay_rate)
    train_state = create_train_state(model, optimizer)
    core = R2D2Core(replay=replay, optimizer=optimizer,
                    batch_size=lc.batch_size,
                    target_update_interval=lc.target_update_interval,
                    burn_in=rc.burn_in, n_steps=lc.n_steps)
    return (model_spec, obs_shape, obs_dtype, model, replay, replay_state,
            train_state, core)


def _single_frames(cfg: ApexConfig | None) -> ApexConfig:
    """The family's config: single frames, the LSTM being the memory (the
    replaced config is what checkpoints save)."""
    cfg = cfg or ApexConfig()
    return cfg.replace(env=dataclasses.replace(cfg.env, frame_stack=1))


def _r2d2_evaluate(self, episodes: int = 10, epsilon: float = 0.0,
                   max_steps: int = 10_000) -> float:
    """Greedy recurrent eval shared by both drivers: the carry threads
    within each episode and resets between them."""
    if not hasattr(self, "_eval_env"):
        self._eval_env = make_eval_env(self.cfg.env.env_id, self.cfg.env,
                                       seed=self.cfg.env.seed + 999)
    policy, reset = episodic_policy(self.model)
    rewards = run_policy_episodes(
        self._eval_env, policy, self.generator, episodes, epsilon,
        max_steps, seed_base=self.cfg.env.seed + 1000, reset_hook=reset)
    return float(np.mean(rewards))


class R2D2Trainer(CheckpointableTrainer):
    """Single-process recurrent driver (``r2d2.py:420-574``): the DQN
    driver's loop with a stateful policy on the learner's device.  The
    carry threads through the episode and resets at its end; each step
    feeds the :class:`SequenceBuilder` the carry that produced the
    action; full groups of ``sequence_group`` sequences are ingested as
    one message.  ``device`` defaults to the card and raises without one
    unless ``"cpu"`` is asked for."""

    def __init__(self, config: ApexConfig | None = None,
                 logdir: str | None = None, verbose: bool = False,
                 train_every: int = 4, checkpoint_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg = _single_frames(config)
        self.env = make_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed,
                            max_episode_steps=cfg.actor.max_episode_length)
        rc, lc = cfg.r2d2, cfg.learner
        (self.model_spec, _, _, self.model, self.replay, self.replay_state,
         self.train_state, self.core) = build_r2d2(cfg, self.device)
        self.policy = make_recurrent_policy_fn(self.model)
        # acting draws and the PER sample's uniforms
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.env.seed + 1)
        self.pooled = isinstance(self.replay, SequenceFramePoolReplay)
        self._message_fn = (pooled_sequence_message if self.pooled
                            else sequence_message)
        self.builder = SequenceBuilder(rc.burn_in, rc.unroll, lc.n_steps,
                                       lc.gamma, stride=rc.stride,
                                       pooled=self.pooled)
        self._pending: list[dict] = []
        self.transitions = 0
        self.ingest_group = rc.sequence_group
        self.train_every = train_every
        self.epsilon = EpsilonSchedule()
        self.beta = BetaSchedule(start=cfg.replay.beta)
        self.log = MetricLogger("learner", logdir, verbose=verbose)
        self.frames_rate = RateCounter()
        self.steps_rate = RateCounter()
        self.sequences = 0
        self.checkpointer = (Checkpointer(checkpoint_dir)
                             if checkpoint_dir else None)

    # -- checkpointing: format and IO in CheckpointableTrainer --------------

    def _counters(self) -> dict:
        return dict(sequences=self.sequences, frames=self.frames_rate.total,
                    steps=self.steps_rate.total, transitions=self.transitions)

    def _apply_counters(self, meta: dict) -> None:
        self.sequences = meta["sequences"]
        self.frames_rate.total = meta["frames"]
        self.steps_rate.total = meta["steps"]
        self.transitions = meta["transitions"]

    # -- main loop ---------------------------------------------------------

    def train(self, total_frames: int, log_every: int = 1000,
              warmup_sequences: int | None = None):
        """Run ``total_frames`` more env frames.  Training starts once
        ``warmup_sequences`` sequences are resident, by default a batch of
        them and ``replay.warmup`` unique transitions (the sum of the
        sequences' ``n_new``, which counts overlapping windows once)."""
        cfg = self.cfg
        warmup_seqs = (warmup_sequences if warmup_sequences is not None
                       else cfg.learner.batch_size)
        warmup_trans = (0 if warmup_sequences is not None
                        else cfg.replay.warmup)
        obs, _ = self.env.reset(seed=cfg.env.seed)
        carry = self.model.initial_state(1)
        episode_reward, episode_len, episode_idx = 0.0, 0, 0
        start = self.frames_rate.total

        for frame in range(start + 1, start + total_frames + 1):
            obs_np = np.asarray(obs)
            # the builder reads the pre-action carry only at sequence
            # starts; each read is a device-to-host copy
            cc = ch = None
            if self.builder.needs_carry:
                cc, ch = (t[0].cpu().numpy() for t in carry)
            actions, q, carry = self.policy(
                torch.as_tensor(obs_np[None]).to(self.device), carry,
                self.epsilon(frame), self.generator)
            action = int(actions[0])
            next_obs, reward, terminated, truncated, _ = self.env.step(action)
            self.builder.add_step(obs_np, action, float(reward),
                                  bool(terminated), cc, ch,
                                  q_values=q[0].cpu().numpy())
            obs = next_obs
            episode_reward += float(reward)
            episode_len += 1
            self.frames_rate.tick()

            if terminated or truncated:
                self.builder.end_episode(
                    truncated=bool(truncated and not terminated))
                # fixed-shape ingests of exactly ingest_group sequences;
                # a remainder waits for the next episode
                self._pending.extend(self.builder.drain())
                for msg in drain_grouped(self._pending, self.ingest_group,
                                         self._message_fn):
                    self.replay_state = self.core.ingest(
                        self.replay_state, msg["payload"], msg["priorities"])
                    self.sequences += self.ingest_group
                    self.transitions += int(msg["n_trans"])
                obs, _ = self.env.reset()
                carry = self.model.initial_state(1)
                self.log.scalars({"episode_reward": episode_reward,
                                  "episode_length": episode_len}, episode_idx)
                episode_reward, episode_len = 0.0, 0
                episode_idx += 1

            if (self.sequences >= warmup_seqs
                    and self.transitions >= warmup_trans
                    and frame % self.train_every == 0):
                self.train_state, self.replay_state, metrics = \
                    self.core.train_step(
                        self.train_state, self.replay_state,
                        stratified_offsets(self.core.batch_size,
                                           self.generator, self.device),
                        self.beta(frame))
                self.steps_rate.tick()
                if (self.checkpointer is not None and self.steps_rate.total
                        % cfg.learner.save_interval == 0):
                    self.save_checkpoint()
                if self.steps_rate.total % log_every == 0:
                    self.log.scalars(
                        {k: float(v) for k, v in metrics.items()}
                        | {"bps": self.steps_rate.rate,
                           "fps": self.frames_rate.rate,
                           "sequences": self.sequences},
                        self.steps_rate.total)
        return self

    evaluate = _r2d2_evaluate


class R2D2ApexTrainer(ConcurrentTrainer):
    """Concurrent R2D2 (``r2d2.py:577-663``): worker processes act
    statefully (:mod:`apex_tpu_torch.actors.r2d2`) and ship grouped
    sequence messages over the shm ring; :meth:`train` is the Ape-X loop
    of :class:`ConcurrentTrainer`, its ingest pipeline included, over the
    sequence replay.  The replay-ratio knobs compare learner SEQUENCES
    consumed (``batch_size`` counts sequences) with TRANSITIONS ingested.
    ``device`` defaults to the card and raises without one unless
    ``"cpu"`` is asked for; the actors act on the CPU."""

    def __init__(self, config: ApexConfig | None = None, pool=None,
                 train_ratio: float | None = None,
                 device: str | torch.device = "cuda",
                 logdir: str | None = None, verbose: bool = False,
                 publish_min_seconds: float = 0.2,
                 min_train_ratio: float | None = None,
                 respawn_workers: bool = True,
                 checkpoint_dir: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg = _single_frames(config)
        rc, lc = cfg.r2d2, cfg.learner
        (self.model_spec, obs_shape, obs_dtype, self.model, self.replay,
         self.replay_state, self.train_state, self.core) = build_r2d2(
            cfg, self.device)
        self.policy = make_recurrent_policy_fn(self.model)
        self.scan_steps = lc.scan_steps
        if pool is None:
            worker = (vector_r2d2_worker_main
                      if cfg.actor.n_envs_per_actor > 1 else r2d2_worker_main)
            group = rc.sequence_group
            t_total = rc.burn_in + rc.unroll + lc.n_steps
            obs_bytes = int(np.prod(obs_shape)) * np.dtype(obs_dtype).itemsize
            # both layouts: stacked ships G*T obs windows, pooled at most
            # G*T+1 frame rows and the i32 obs_ref table
            slot = ((group * t_total + 1) * obs_bytes
                    + group * t_total * 24
                    + group * 8 * rc.lstm_features + 65536)
            pool = ActorPool(cfg, self.model_spec, chunk_transitions=group,
                             worker_fn=worker, shm_slot_bytes=slot)
        self.pool = pool
        self._init_loop(train_ratio, min_train_ratio, publish_min_seconds,
                        respawn_workers, logdir, verbose, checkpoint_dir)

    evaluate = _r2d2_evaluate
