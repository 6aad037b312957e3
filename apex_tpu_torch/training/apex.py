"""Ape-X learner on the frame-pool replay: construction and the consume path.

Counterpart of the learner half of :class:`apex_tpu.training.apex.ApexTrainer`:
``dqn_env_specs`` (``apex.py:58-70``), the construction of replay, model,
optimizer, train state and core (``apex.py:1525-1577``), and the
single-chunk consume path of ``_drain_serial`` (``apex.py:1437-1467``):
each chunk message runs the fused ingest+train step once the replay is
warm and the replay-ratio cap allows, else it is ingested only.

Not ported yet: the actor pool and the concurrent ``train()`` loop
(``apex.py:284-540``), the scan dispatch, the ingest pipeline, the fleet,
SLO, ctl and span planes, checkpointing and evaluation.  ``pool`` is
accepted as an injected argument, as in the JAX trainer, and is not driven
here: the caller feeds :meth:`ApexTrainer.consume` with chunk messages
(:func:`apex_tpu_torch.replay.frame_chunks.drain_builder_chunks`).
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.registry import (make_env, num_actions,
                                          unstacked_env_spec)
from apex_tpu_torch.models.dueling import DuelingDQN, make_policy_fn
from apex_tpu_torch.ops.losses import make_optimizer
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.base import check_hbm_budget
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.learner import LearnerCore
from apex_tpu_torch.training.state import create_train_state


def dqn_env_specs(cfg: ApexConfig):
    """(model_spec, frame_shape, frame_dtype, frame_stack) from a probe env.
    The model spec carries ``obs_shape`` (the stacked observation), which
    torch layers need up front."""
    probe = make_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed)
    frame_shape, frame_dtype, frame_stack = unstacked_env_spec(probe, cfg.env)
    model_spec = dict(
        num_actions=num_actions(probe),
        obs_shape=frame_shape[:-1] + (frame_stack * frame_shape[-1],),
        obs_is_image=len(frame_shape) == 3,
        compute_dtype=getattr(torch, cfg.learner.compute_dtype),
        scale_uint8=np.dtype(frame_dtype) == np.uint8)
    probe.close()
    return model_spec, frame_shape, frame_dtype, frame_stack


class ApexTrainer:
    """The frame-pool Ape-X learner (``ApeX.py:13-82``).

    ``train_ratio`` caps samples consumed per transition ingested, as in
    the JAX trainer; ``None`` = uncapped.  ``device`` defaults to the card
    and raises without one unless ``"cpu"`` is asked for.
    """

    def __init__(self, config: ApexConfig | None = None, pool=None,
                 train_ratio: float | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg = config or ApexConfig()
        self.train_ratio = train_ratio
        self.pool = pool

        self.model_spec, frame_shape, frame_dtype, frame_stack = \
            dqn_env_specs(cfg)
        self.replay = FramePoolReplay(
            capacity=cfg.replay.capacity, frame_shape=frame_shape,
            frame_stack=frame_stack, frame_dtype=np.dtype(frame_dtype).name,
            alpha=cfg.replay.alpha, eps=cfg.replay.eps)
        check_hbm_budget(self.replay.hbm_bytes(), cfg.replay.hbm_budget_gb,
                         "frame-pool replay", cfg.replay.capacity,
                         self.device)
        lc = cfg.learner
        optimizer = make_optimizer(
            lr=lc.lr, decay=lc.rmsprop_decay, eps=lc.rmsprop_eps,
            centered=lc.rmsprop_centered, max_grad_norm=lc.max_grad_norm,
            lr_decay_steps=lc.lr_decay_steps, lr_decay_rate=lc.lr_decay_rate)
        init_gen = torch.Generator().manual_seed(cfg.env.seed)
        self.model = DuelingDQN(**self.model_spec,
                                generator=init_gen).to(self.device)
        self.train_state = create_train_state(self.model, optimizer)
        self.core = LearnerCore(
            replay=self.replay, optimizer=optimizer,
            batch_size=lc.batch_size,
            target_update_interval=lc.target_update_interval)
        self.policy = make_policy_fn(self.model)
        self.replay_state = self.replay.init(self.device)
        # the PER sample's uniforms; the JAX trainer's key chain
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.env.seed + 1)
        self.ingested = 0
        self.steps = 0

    def _beta(self) -> float:
        frac = min(1.0, self.ingested / max(1, self.cfg.replay.beta_anneal))
        return self.cfg.replay.beta + (1.0 - self.cfg.replay.beta) * frac

    def consume(self, msgs: list[dict]):
        """One poll's chunk messages, in order: the fused step when warm
        and under the replay-ratio cap, else ingest only.  Returns the
        last step's metrics (device scalars) or None."""
        warm = self.ingested >= self.cfg.replay.warmup
        budget = (float("inf") if self.train_ratio is None
                  else self.ingested * self.train_ratio / self.core.batch_size)
        metrics = None
        for msg in msgs:
            if warm and self.steps < budget:
                offsets = stratified_offsets(self.core.batch_size,
                                             self.generator, self.device)
                self.train_state, self.replay_state, metrics = \
                    self.core.fused_step(self.train_state, self.replay_state,
                                         msg["payload"], msg["priorities"],
                                         offsets, self._beta())
                self.steps += 1
            else:
                self.replay_state = self.core.ingest(
                    self.replay_state, msg["payload"], msg["priorities"])
            self.ingested += int(msg["n_trans"])
        return metrics
