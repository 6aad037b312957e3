"""The learner step: ingest -> PER sample -> loss/grads -> clip+RMSprop ->
periodic target sync -> priority write-back.

Counterpart of :mod:`apex_tpu.training.learner`.  JAX compiles the fused
step into one XLA program over donated buffers; here it runs eagerly on
the card, updating the replay and train state in place (no copies of the
ring, the trees or the weights).  The only kernel of the step written by
hand is the frame-ring gather inside
:meth:`~apex_tpu_torch.replay.frame_pool.FramePoolReplay.sample`.

Where the JAX step takes a PRNG key, these take ``offsets``: the
per-stratum uniforms of the PER sample (``f32[B]`` in ``[0, 1)``), drawn
by the caller from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from apex_tpu_torch.ops.losses import ClipRMSprop, double_dqn_loss
from apex_tpu_torch.replay.frame_pool import FramePoolReplay, FramePoolState
from apex_tpu_torch.training.state import TrainState


@dataclass(frozen=True)
class LearnerCore:
    """Static wiring of replay and optimizer into the step functions; the
    networks travel in the :class:`TrainState`."""

    replay: FramePoolReplay
    optimizer: ClipRMSprop
    batch_size: int = 512
    target_update_interval: int = 2500

    def update_from_batch(self, train_state: TrainState, batch: dict,
                          weights: torch.Tensor):
        """The update body, see :func:`td_update`."""

        def loss_fn():
            return double_dqn_loss(train_state.params,
                                   train_state.target_params, batch, weights)

        return td_update(self.optimizer, self.target_update_interval,
                         train_state, loss_fn)

    def train_step(self, train_state: TrainState, replay_state: FramePoolState,
                   offsets: torch.Tensor, beta: float):
        """Sample -> loss -> update -> priorities."""
        batch, weights, idx = self.replay.sample(replay_state, offsets, beta)
        train_state, priorities, metrics = self.update_from_batch(
            train_state, batch, weights)
        replay_state = self.replay.update_priorities(replay_state, idx,
                                                     priorities)
        return train_state, replay_state, metrics

    def ingest(self, replay_state: FramePoolState, chunk: dict,
               priorities) -> FramePoolState:
        return self.replay.add(replay_state, chunk, priorities)

    def fused_step(self, train_state: TrainState, replay_state: FramePoolState,
                   chunk: dict, priorities, offsets: torch.Tensor,
                   beta: float):
        """Ingest + train: the Ape-X learner inner loop."""
        replay_state = self.ingest(replay_state, chunk, priorities)
        return self.train_step(train_state, replay_state, offsets, beta)

    def fused_multi_step(self, train_state: TrainState,
                         replay_state: FramePoolState, chunks: list,
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
              train_state: TrainState, loss_fn):
    """Loss/grads -> clip+optimizer -> target sync when the new step count
    is a multiple of ``target_update_interval``.  ``loss_fn() -> (loss,
    TDOutput)``.  Returns ``(train_state, priorities, metrics)``; the
    metrics are device scalars (no host sync): ``loss``, ``grad_norm`` (of
    the unclipped grads), ``q_mean`` and ``td_mean``."""
    params = list(train_state.params.parameters())
    loss, aux = loss_fn()
    grads = torch.autograd.grad(loss, params)
    grad_norm = optimizer.step(params, list(grads), train_state.opt_state)

    train_state.step += 1
    if train_state.step % target_update_interval == 0:
        with torch.no_grad():
            for tgt, src in zip(train_state.target_params.parameters(),
                                params):
                tgt.copy_(src)

    metrics = {
        "loss": aux.loss,
        "grad_norm": grad_norm,
        "q_mean": aux.q_taken.mean(),
        "td_mean": aux.td_abs.mean(),
    }
    return train_state, aux.priorities, metrics
