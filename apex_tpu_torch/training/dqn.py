"""Single-process DQN driver.

Counterpart of :mod:`apex_tpu.training.dqn` (``dqn.py:36-231``; reference
``DQN.py``): an inline act -> step -> add -> sample -> loss -> update loop
with exponential epsilon decay (``DQN.py:41``), linear beta anneal
(``DQN.py:40``), periodic target sync, checkpointing and evaluation.

The policy runs on the learner's device, one call per env frame;
transitions go through the n-step window (:mod:`apex_tpu_torch.replay.
nstep`) and are ingested into the stacked :class:`~apex_tpu_torch.replay.
device.DeviceReplay` in fixed ``ingest_chunk`` blocks.  Where the JAX
driver splits one PRNG key for acting and sampling, this one draws both
from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.registry import make_env, make_eval_env, num_actions
from apex_tpu_torch.models.dueling import DuelingDQN, make_policy_fn
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.nstep import NStepAccumulator
from apex_tpu_torch.training.checkpoint import (CheckpointableTrainer,
                                                Checkpointer,
                                                run_policy_episodes)
from apex_tpu_torch.training.learner import build_learner
from apex_tpu_torch.utils.metrics import MetricLogger, RateCounter


@dataclass
class EpsilonSchedule:
    """eps_final + (eps_start - eps_final) * exp(-frame / decay)  (DQN.py:41)."""

    start: float = 1.0
    final: float = 0.01
    decay: float = 30_000.0

    def __call__(self, frame: int) -> float:
        return self.final + (self.start - self.final) * math.exp(
            -frame / self.decay)


@dataclass
class BetaSchedule:
    """Linear anneal of the IS exponent toward 1 (DQN.py:40)."""

    start: float = 0.4
    frames: int = 100_000

    def __call__(self, frame: int) -> float:
        return min(1.0, self.start + (1.0 - self.start) * frame / self.frames)


class DQNTrainer(CheckpointableTrainer):
    """train_DQN equivalent (``DQN.py:15-75``).  ``device`` defaults to the
    card and raises without one unless ``"cpu"`` is asked for."""

    def __init__(self, config: ApexConfig | None = None,
                 logdir: str | None = None, verbose: bool = False,
                 train_every: int = 1, checkpoint_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg = config or ApexConfig()
        self.env = make_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed,
                            max_episode_steps=cfg.actor.max_episode_length,
                            stack_frames=True)
        space = self.env.observation_space
        obs_shape = tuple(space.shape)
        self.model_spec = dict(
            num_actions=num_actions(self.env), obs_shape=obs_shape,
            obs_is_image=len(obs_shape) == 3,
            compute_dtype=getattr(torch, cfg.learner.compute_dtype),
            scale_uint8=space.dtype == np.uint8)
        self.model = DuelingDQN(
            **self.model_spec,
            generator=torch.Generator().manual_seed(cfg.env.seed)
        ).to(self.device)
        lc = cfg.learner
        self.core, self.train_state, self.replay_state = build_learner(
            self.model, cfg.replay.capacity,
            np.zeros((1,) + obs_shape, space.dtype),
            alpha=cfg.replay.alpha, batch_size=lc.batch_size, lr=lc.lr,
            max_grad_norm=lc.max_grad_norm,
            lr_decay_steps=lc.lr_decay_steps, lr_decay_rate=lc.lr_decay_rate,
            rmsprop_decay=lc.rmsprop_decay, rmsprop_eps=lc.rmsprop_eps,
            rmsprop_centered=lc.rmsprop_centered, replay_eps=cfg.replay.eps,
            target_update_interval=lc.target_update_interval,
            hbm_budget_gb=cfg.replay.hbm_budget_gb)
        self.policy = make_policy_fn(self.model)
        # acting draws and the PER sample's uniforms
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.env.seed + 1)

        self.accumulator = NStepAccumulator(lc.n_steps, lc.gamma)
        self.ingest_chunk = lc.ingest_chunk
        self.train_every = train_every
        self.epsilon = EpsilonSchedule()
        self.beta = BetaSchedule(start=cfg.replay.beta)
        self.log = MetricLogger("learner", logdir, verbose=verbose)
        self.frames_rate = RateCounter()
        self.steps_rate = RateCounter()
        self.ingested = 0
        self._pending: list[tuple[dict, np.ndarray]] = []
        self._pending_count = 0
        self.checkpointer = (Checkpointer(checkpoint_dir)
                             if checkpoint_dir else None)

    # -- checkpointing: format and IO in CheckpointableTrainer --------------

    def _counters(self) -> dict:
        return dict(ingested=self.ingested, frames=self.frames_rate.total,
                    steps=self.steps_rate.total)

    def _apply_counters(self, meta: dict) -> None:
        self.ingested = meta["ingested"]
        self.frames_rate.total = meta["frames"]
        self.steps_rate.total = meta["steps"]

    # -- data plane --------------------------------------------------------

    def _flush_accumulator(self) -> None:
        if len(self.accumulator) == 0:
            return
        batch, prios = self.accumulator.make_batch()
        self._pending.append((batch, prios))
        self._pending_count += len(prios)
        while self._pending_count >= self.ingest_chunk:
            self._ingest_chunk()

    def _ingest_chunk(self) -> None:
        """Ingest exactly ``ingest_chunk`` transitions."""
        merged = {k: np.concatenate([b[k] for b, _ in self._pending])
                  for k in self._pending[0][0]}
        prios = np.concatenate([p for _, p in self._pending])
        take = self.ingest_chunk
        chunk = {k: v[:take] for k, v in merged.items()}
        rest = {k: v[take:] for k, v in merged.items()}
        self.replay_state = self.core.ingest(self.replay_state, chunk,
                                             prios[:take])
        self.ingested += take
        self._pending = ([(rest, prios[take:])]
                         if len(prios) > take else [])
        self._pending_count = len(prios) - take

    def train_step(self, beta: float):
        """One learner update from the replay; returns its metrics."""
        self.train_state, self.replay_state, metrics = self.core.train_step(
            self.train_state, self.replay_state,
            stratified_offsets(self.core.batch_size, self.generator,
                               self.device), beta)
        return metrics

    # -- main loop ---------------------------------------------------------

    def train(self, total_frames: int, log_every: int = 1000):
        """Run ``total_frames`` more env frames.  On a restored trainer the
        frame counter (and with it the epsilon and beta schedules)
        continues from the checkpoint."""
        cfg = self.cfg
        obs, _ = self.env.reset(seed=cfg.env.seed)
        episode_reward, episode_len, episode_idx = 0.0, 0, 0
        start = self.frames_rate.total

        for frame in range(start + 1, start + total_frames + 1):
            obs_np = np.asarray(obs)
            actions, q = self.policy(
                torch.as_tensor(obs_np[None]).to(self.device),
                self.epsilon(frame), self.generator)
            action = int(actions[0])
            next_obs, reward, terminated, truncated, _ = self.env.step(action)
            done = terminated or truncated
            self.accumulator.add(obs_np, action, float(reward),
                                 q[0].cpu().numpy(),
                                 terminated=bool(terminated),
                                 truncated=bool(truncated),
                                 final_obs=(np.asarray(next_obs)
                                            if truncated else None))
            obs = next_obs
            episode_reward += float(reward)
            episode_len += 1
            self.frames_rate.tick()

            if done:
                self._flush_accumulator()
                obs, _ = self.env.reset()
                self.log.scalars({"episode_reward": episode_reward,
                                  "episode_length": episode_len}, episode_idx)
                episode_reward, episode_len = 0.0, 0
                episode_idx += 1
            elif len(self.accumulator) >= cfg.actor.send_interval:
                self._flush_accumulator()

            warm = self.ingested >= cfg.replay.warmup
            if warm and frame % self.train_every == 0:
                metrics = self.train_step(self.beta(frame))
                self.steps_rate.tick()
                if (self.checkpointer is not None and self.steps_rate.total
                        % cfg.learner.save_interval == 0):
                    self.save_checkpoint()
                if self.steps_rate.total % log_every == 0:
                    self.log.scalars(
                        {k: float(v) for k, v in metrics.items()}
                        | {"bps": self.steps_rate.rate,
                           "fps": self.frames_rate.rate},
                        self.steps_rate.total)
        return self

    # -- evaluation (DQN.py:124-149) ---------------------------------------

    def evaluate(self, episodes: int = 10, epsilon: float = 0.0,
                 max_steps: int = 10_000) -> float:
        """Mean score on the unclipped, full-episode eval env
        (``eval.py:52``)."""
        if not hasattr(self, "_eval_env"):
            self._eval_env = make_eval_env(self.cfg.env.env_id, self.cfg.env,
                                           seed=self.cfg.env.seed + 999)
        rewards = run_policy_episodes(
            self._eval_env, self.policy, self.generator, episodes, epsilon,
            max_steps, seed_base=self.cfg.env.seed + 1000)
        return float(np.mean(rewards))
