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

An update has one body, :func:`td_update` (forwards, loss,
``autograd.grad``, the dp mean, the optimizer's step, the metrics, the
target sync).  On the card, :meth:`LearnerCore.update_from_batch` runs
it eagerly at the first update of a batch layout over the same parameter
and optimizer tensors (:func:`graph_key`), captures its device half as
one CUDA graph (:class:`UpdateGraph`) at the second and replays that from
then on: one launch where the eager update makes over four hundred.
``GRAPH_COUNTS`` counts the captures, replays and eager updates.

Where the JAX step takes a PRNG key, these take ``offsets``: the
per-stratum uniforms of the PER sample (``f32[B]`` in ``[0, 1)``), drawn
by the caller from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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

#: updates of :meth:`LearnerCore.update_from_batch` by kind: graphs
#: captured, graph replays (the capturing update's included) and eager
#: updates (the CPU's, a dp group's, the first of each graph key's)
GRAPH_COUNTS = {"capture": 0, "replay": 0, "eager": 0}

#: the update's metrics (:func:`td_update`), in the order an
#: :class:`UpdateGraph` keeps them
METRICS = ("loss", "grad_norm", "q_mean", "td_mean")


def _views(batch: dict) -> dict:
    """``{name: owner}`` of the batch tensors that view another batch
    tensor, a contiguous one (``obs`` and ``next_obs`` as the halves of
    ``obs_pair``)."""
    ids = {id(t): name for name, t in batch.items()}
    return {name: ids[id(t._base)] for name, t in batch.items()
            if t._base is not None and id(t._base) in ids
            and t._base.is_contiguous()}


def static_batch(batch: dict) -> tuple[dict, dict]:
    """Static copies of ``batch`` for a captured update: ``(inputs,
    static)``, ``inputs`` a clone of each tensor that views no other
    (what each replay copies into), ``static`` the batch over them, where
    a view of another batch tensor views that tensor's clone alike."""
    views = _views(batch)
    inputs = {name: t.clone() for name, t in batch.items()
              if name not in views}
    static = dict(inputs)
    for name, owner in views.items():
        t = batch[name]
        static[name] = inputs[owner].as_strided(
            t.shape, t.stride(),
            t.storage_offset() - batch[owner].storage_offset())
    return inputs, {name: static[name] for name in batch}


def graph_key(train_state: TrainState, batch: dict,
              weights: torch.Tensor) -> tuple:
    """What a captured update is bound to: the batch's layout (names,
    shapes, dtypes, strides and which tensor views which, at what offset)
    and ``weights``' shape, and the storage of every tensor it updates or
    reads in place: the online and target parameters, RMSprop's moments
    and learning rate (:meth:`ClipRMSprop.lr_tensor`, set before)."""
    views = _views(batch)
    layout = tuple(
        (name, tuple(t.shape), t.dtype, t.stride(), views.get(name),
         t.storage_offset() - batch[views[name]].storage_offset()
         if name in views else 0)
        for name, t in batch.items())
    opt = train_state.opt_state
    held = opt.lr_held
    tensors = [*train_state.params.parameters(),
               *train_state.target_params.parameters(), *opt.mu, *opt.nu]
    return (layout, tuple(weights.shape),
            tuple(t.data_ptr() for t in tensors),
            None if held is None else held[1].data_ptr())


def graph_engages(train_state: TrainState, group) -> bool:
    """Whether :meth:`LearnerCore.update_from_batch` takes its graph:
    with CUDA parameters and no dp group."""
    return group is None and next(train_state.params.parameters()).is_cuda


def _advance(train_state: TrainState, target_update_interval: int) -> None:
    """Count the update; copy the online weights into the target net in
    place when the count is a multiple of ``target_update_interval``."""
    train_state.step += 1
    if train_state.step % target_update_interval == 0:
        with torch.no_grad():
            for tgt, src in zip(train_state.target_params.parameters(),
                                train_state.params.parameters()):
                tgt.copy_(src)


class UpdateGraph:
    """:func:`td_update`'s device half captured as one CUDA graph: both
    nets' forwards, the loss, ``autograd.grad``, the global norm, the clip
    and RMSprop, in place on the live parameters and moments.  Its inputs
    are static copies of the batch (:func:`static_batch`) and weights,
    which ``loss(batch, weights)`` reads; its output, the priorities then
    :data:`METRICS`, one static tensor.  Captured with ``thread_local``
    errors, so threads that launch on their own streams meanwhile (the
    staging thread, the rollout engine) may, as long as they draw from
    generators of their own (the capture holds the default CUDA
    generator); its memory is a pool of its own."""

    def __init__(self, optimizer: ClipRMSprop, train_state: TrainState,
                 loss, batch: dict, weights: torch.Tensor,
                 lr: torch.Tensor):
        self.inputs, static = static_batch(batch)
        self.weights = weights.clone()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            _, priorities, metrics = td_update(
                optimizer, None, train_state,
                lambda: loss(static, self.weights), lr=lr)
            self.out = torch.cat([priorities, torch.stack(
                [metrics[name] for name in METRICS])])

    def replay(self, batch: dict, weights: torch.Tensor) -> torch.Tensor:
        """Copy ``batch`` and ``weights`` in, replay, and return a copy of
        the output (the next replay overwrites it)."""
        for name, t in self.inputs.items():
            t.copy_(batch[name])
        self.weights.copy_(weights)
        self.graph.replay()
        return self.out.clone()


@dataclass(frozen=True)
class LearnerCore:
    """Static wiring of replay and optimizer into the step functions; the
    networks travel in the :class:`TrainState`."""

    replay: FramePoolReplay | DeviceReplay
    optimizer: ClipRMSprop
    batch_size: int = 512
    target_update_interval: int = 2500
    # {graph_key: UpdateGraph, or None after the key's first, eager update}
    # for the last key seen; a new key drops the graph of the old one
    _graph: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    def update_from_batch(self, train_state: TrainState, batch: dict,
                          weights: torch.Tensor, group=None):
        """The update body, see :func:`td_update` (``group``: the dp group
        whose ranks mean their gradients and metrics), inside span
        ``apex.learner.update``.  With CUDA parameters and no ``group``
        it runs eagerly at the first update of a :func:`graph_key`, which
        warms what a capture needs (cuBLAS, cuDNN, autocast), captures an
        :class:`UpdateGraph` at the second and replays it from then on."""
        with span("apex.learner.update", LEARNER_TRACK):
            params = train_state.params

            def loss(batch, weights):
                return double_dqn_loss(params, train_state.target_params,
                                       batch, weights)

            if graph_engages(train_state, group):
                lr = self.optimizer.lr_tensor(
                    train_state.opt_state, next(params.parameters()).device)
                key = graph_key(train_state, batch, weights)
                if key in self._graph:
                    return self._replayed(key, lr, train_state, loss, batch,
                                          weights)
                self._graph.clear()
                self._graph[key] = None
            GRAPH_COUNTS["eager"] += 1
            return td_update(self.optimizer, self.target_update_interval,
                             train_state, lambda: loss(batch, weights), group)

    def _replayed(self, key: tuple, lr: torch.Tensor,
                  train_state: TrainState, loss, batch: dict,
                  weights: torch.Tensor):
        """The update as a replay of ``key``'s graph, captured first if
        this is the key's second update; the host does the rest: the
        optimizer's count and the target sync."""
        with span("apex.learner.loss", LEARNER_TRACK):
            graph = self._graph[key]
            if graph is None:
                graph = self._graph[key] = UpdateGraph(
                    self.optimizer, train_state, loss, batch, weights, lr)
                GRAPH_COUNTS["capture"] += 1
            out = graph.replay(batch, weights)
            GRAPH_COUNTS["replay"] += 1
        with span("apex.learner.optimizer", LEARNER_TRACK):
            train_state.opt_state.count += 1
            _advance(train_state, self.target_update_interval)
        b = weights.shape[0]
        return train_state, out[:b], dict(zip(METRICS, out[b:]))

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


def td_update(optimizer, target_update_interval: int | None,
              train_state: TrainState, loss_fn, group=None,
              lr: torch.Tensor | None = None):
    """Loss/grads -> (the mean over the dp ``group``) -> clip+optimizer ->
    target sync when the new step count is a multiple of
    ``target_update_interval``.  ``loss_fn() -> (loss, TDOutput)``.
    Returns ``(train_state, priorities, metrics)``; the metrics are device
    scalars (no host sync): ``loss``, ``grad_norm`` (of the unclipped
    grads), ``q_mean`` and ``td_mean``.  With ``lr`` (a 0-d tensor, as an
    :class:`UpdateGraph` captures it) the optimizer's device half runs at
    that rate (:meth:`ClipRMSprop.apply`: no host work), and the count and
    the target sync are left to the caller.

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
    with span("apex.learner.optimizer", LEARNER_TRACK):
        loss, q_mean, td_mean = (aux.loss, aux.q_taken.detach().mean(),
                                 aux.td_abs.mean())
        if group is not None:
            scalars = torch.stack([loss, q_mean, td_mean])
            group.all_reduce_mean_(grads + [scalars])
            loss, q_mean, td_mean = scalars.unbind()
        if lr is None:
            grad_norm = optimizer.step(params, grads, train_state.opt_state)
            _advance(train_state, target_update_interval)
        else:
            grad_norm = optimizer.apply(params, grads, train_state.opt_state,
                                        lr)
    return train_state, aux.priorities, dict(zip(
        METRICS, (loss, grad_norm, q_mean, td_mean)))


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
