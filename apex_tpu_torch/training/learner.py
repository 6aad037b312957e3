"""The learner step: ingest -> PER sample -> loss/grads -> clip+RMSprop ->
periodic target sync -> priority write-back.

Counterpart of :mod:`apex_tpu.training.learner`.  JAX compiles the fused
step into one XLA program over donated buffers; here it runs eagerly on
the card, updating the replay and train state in place (no copies of the
ring, the trees or the weights).  The replay is either the frame pool of
the Ape-X trainer or the stacked :class:`~apex_tpu_torch.replay.device.
DeviceReplay` of the DQN driver (:func:`build_learner`).  The kernels of
the step written by hand are the frame-ring gather inside
:meth:`~apex_tpu_torch.replay.frame_pool.FramePoolReplay.sample` and the
segment-tree update (:mod:`apex_tpu_torch.ops.tree`), one launch for both
trees at ingest and one at the priority write-back.

Where the JAX step takes a PRNG key, these take ``offsets``: the
per-stratum uniforms of the PER sample (``f32[B]`` in ``[0, 1)``), drawn
by the caller from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.obs.trace import LEARNER_TRACK, span
from apex_tpu_torch.ops.losses import (ClipRMSprop, double_dqn_loss,
                                       make_optimizer)
from apex_tpu_torch.replay.base import check_hbm_budget
from apex_tpu_torch.replay.device import DeviceReplay, ReplayState
from apex_tpu_torch.replay.frame_pool import FramePoolReplay, FramePoolState
from apex_tpu_torch.training.state import TrainState, create_train_state

ReplayStates = FramePoolState | ReplayState


@dataclass(frozen=True)
class LearnerCore:
    """Static wiring of replay and optimizer into the step functions; the
    networks travel in the :class:`TrainState`."""

    replay: FramePoolReplay | DeviceReplay
    optimizer: ClipRMSprop
    batch_size: int = 512
    target_update_interval: int = 2500

    def update_from_batch(self, train_state: TrainState, batch: dict,
                          weights: torch.Tensor, group=None):
        """The update body, see :func:`td_update` (``group``: the dp group
        whose ranks mean their gradients and metrics)."""

        def loss_fn():
            return double_dqn_loss(train_state.params,
                                   train_state.target_params, batch, weights)

        return td_update(self.optimizer, self.target_update_interval,
                         train_state, loss_fn, group)

    def train_step(self, train_state: TrainState, replay_state: ReplayStates,
                   offsets: torch.Tensor, beta: float):
        """Sample -> loss -> update -> priorities."""
        with span("apex.learner.sample", LEARNER_TRACK):
            batch, weights, idx = self.replay.sample(replay_state, offsets,
                                                     beta)
        train_state, priorities, metrics = self.update_from_batch(
            train_state, batch, weights)
        with span("apex.learner.priorities", LEARNER_TRACK):
            replay_state = self.replay.update_priorities(replay_state, idx,
                                                         priorities)
        return train_state, replay_state, metrics

    def ingest(self, replay_state: ReplayStates, chunk: dict,
               priorities) -> ReplayStates:
        with span("apex.learner.ingest", LEARNER_TRACK):
            return self.replay.add(replay_state, chunk, priorities)

    def fused_step(self, train_state: TrainState, replay_state: ReplayStates,
                   chunk: dict, priorities, offsets: torch.Tensor,
                   beta: float):
        """Ingest + train: the Ape-X learner inner loop."""
        replay_state = self.ingest(replay_state, chunk, priorities)
        return self.train_step(train_state, replay_state, offsets, beta)

    def fused_multi_step(self, train_state: TrainState,
                         replay_state: ReplayStates, chunks: list,
                         priorities: list, offsets: torch.Tensor, betas):
        """K fused steps in a row (``offsets`` ``[K, B]``, ``betas`` a
        scalar or K values); the JAX ``lax.scan`` dispatch becomes a loop.
        Metrics come back stacked ``[K]``."""
        k_steps = len(chunks)
        if isinstance(betas, (int, float)):
            betas = [betas] * k_steps
        per_step = []
        for i in range(k_steps):
            train_state, replay_state, metrics = self.fused_step(
                train_state, replay_state, chunks[i], priorities[i],
                offsets[i], float(betas[i]))
            per_step.append(metrics)
        stacked = {name: torch.stack([m[name] for m in per_step])
                   for name in per_step[0]}
        return train_state, replay_state, stacked


def td_update(optimizer: ClipRMSprop, target_update_interval: int,
              train_state: TrainState, loss_fn, group=None):
    """Loss/grads -> (the mean over the dp ``group``) -> clip+optimizer ->
    target sync when the new step count is a multiple of
    ``target_update_interval``.  ``loss_fn() -> (loss, TDOutput)``.
    Returns ``(train_state, priorities, metrics)``; the metrics are device
    scalars (no host sync): ``loss``, ``grad_norm`` (of the unclipped
    grads), ``q_mean`` and ``td_mean``.

    With a ``group`` (:class:`~apex_tpu_torch.parallel.mesh.DpGroup`) the
    grads, ``loss``, ``q_mean`` and ``td_mean`` are meaned over its ranks
    in one all-reduce before the optimizer step, so the clip and
    ``grad_norm`` see the averaged grads and every rank takes the same
    update (``apex_tpu/training/learner.py:135-152``); the priorities stay
    this rank's."""
    params = list(train_state.params.parameters())
    with span("apex.learner.loss", LEARNER_TRACK):
        loss, aux = loss_fn()
        grads = list(torch.autograd.grad(loss, params))
    scalars = None
    with span("apex.learner.optimizer", LEARNER_TRACK):
        if group is not None:
            scalars = torch.stack([aux.loss, aux.q_taken.detach().mean(),
                                   aux.td_abs.mean()])
            group.all_reduce_mean_(grads + [scalars])
        grad_norm = optimizer.step(params, grads, train_state.opt_state)

        train_state.step += 1
        if train_state.step % target_update_interval == 0:
            with torch.no_grad():
                for tgt, src in zip(train_state.target_params.parameters(),
                                    params):
                    tgt.copy_(src)

    if scalars is None:
        metrics = {
            "loss": aux.loss,
            "grad_norm": grad_norm,
            "q_mean": aux.q_taken.mean(),
            "td_mean": aux.td_abs.mean(),
        }
    else:
        metrics = {"loss": scalars[0], "grad_norm": grad_norm,
                   "q_mean": scalars[1], "td_mean": scalars[2]}
    return train_state, aux.priorities, metrics


def build_learner(model: nn.Module, replay_capacity: int,
                  example_obs: np.ndarray, *, alpha: float = 0.6,
                  batch_size: int = 512, lr: float = 6.25e-5,
                  max_grad_norm: float = 40.0, rmsprop_decay: float = 0.95,
                  rmsprop_eps: float = 1.5e-7, rmsprop_centered: bool = True,
                  replay_eps: float = 1e-6,
                  target_update_interval: int = 2500,
                  lr_decay_steps: int | None = 1000,
                  lr_decay_rate: float = 0.99,
                  hbm_budget_gb: float | None = None
                  ) -> tuple[LearnerCore, TrainState, ReplayState]:
    """The DQN driver's learner (``apex_tpu/training/learner.py:224-260``):
    ``model`` (initialized, on its device) wrapped in a train state, and a
    :class:`DeviceReplay` on the same device whose rows are shaped like
    ``example_obs[0]``."""
    optimizer = make_optimizer(lr=lr, decay=rmsprop_decay, eps=rmsprop_eps,
                               centered=rmsprop_centered,
                               max_grad_norm=max_grad_norm,
                               lr_decay_steps=lr_decay_steps,
                               lr_decay_rate=lr_decay_rate)
    train_state = create_train_state(model, optimizer)
    replay = DeviceReplay(capacity=replay_capacity, alpha=alpha,
                          eps=replay_eps)
    obs = np.zeros(example_obs.shape[1:], example_obs.dtype)
    example_item = dict(obs=obs, action=np.int32(0), reward=np.float32(0),
                        next_obs=obs, discount=np.float32(0))
    device = next(model.parameters()).device
    if hbm_budget_gb is not None:
        check_hbm_budget(replay.hbm_bytes(example_item), hbm_budget_gb,
                         "replay (stacked obs storage)", replay_capacity,
                         device)
    replay_state = replay.init(example_item, device)
    core = LearnerCore(replay=replay, optimizer=optimizer,
                       batch_size=batch_size,
                       target_update_interval=target_update_interval)
    return core, train_state, replay_state
