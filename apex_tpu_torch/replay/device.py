"""Device-resident prioritized replay over whole transitions.

Counterpart of :mod:`apex_tpu.replay.device` (``device.py:42-130``;
reference ``memory.py:146-391``): a struct-of-arrays of preallocated
tensors, one row per transition, plus flat sum/min trees
(:mod:`apex_tpu_torch.ops.tree`).  The single-process DQN driver stores
its stacked observations here; the Ape-X trainer uses the frame pool.

As in the frame pool, the state is mutable: :meth:`DeviceReplay.add` and
the priority update write in place, and the cursors ``pos``/``size`` are
host integers, so ingest and sample need no host sync.  ``sample`` takes
the per-stratum uniforms (``offsets``) where the JAX method takes a PRNG
key.  Sampling gathers rows with plain tensor indexing, as the JAX replay
does with XLA indexing (``device.py:128``), outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from apex_tpu_torch.ops import tree as tree_ops
from apex_tpu_torch.replay.base import PERMethods


@dataclass
class ReplayState:
    """Mutable state of one replay."""

    storage: dict[str, torch.Tensor]   # name -> (capacity, ...) tensor
    sum_tree: torch.Tensor             # f32[2C]
    min_tree: torch.Tensor             # f32[2C]
    pos: int                           # next write index
    size: int                          # live element count
    max_priority: torch.Tensor         # f32 scalar (memory.py:233)


@dataclass(frozen=True)
class DeviceReplay(PERMethods):
    """Static spec + methods over a :class:`ReplayState`.  One transition
    is a dict of arrays or scalars (``obs``, ``action``, ``reward``,
    ``next_obs``, ``discount``)."""

    capacity: int
    alpha: float = 0.6
    eps: float = 1e-6

    def __post_init__(self):
        tree_ops._check_capacity(self.capacity)

    def hbm_bytes(self, example_item: dict) -> int:
        """Device footprint of one :class:`ReplayState` for transitions
        shaped like ``example_item``, checked before :meth:`init`."""
        per_item = sum(np.asarray(x).nbytes for x in example_item.values())
        tree_bytes = 2 * (2 * self.capacity) * 4
        return self.capacity * per_item + tree_bytes

    def init(self, example_item: dict,
             device: torch.device | str) -> ReplayState:
        """Zeroed storage shaped like one transition."""
        dev = torch.device(device)
        storage = {
            name: torch.zeros((self.capacity,) + np.shape(x),
                              dtype=torch.from_numpy(np.asarray(x)).dtype,
                              device=dev)
            for name, x in example_item.items()}
        return ReplayState(
            storage=storage,
            sum_tree=tree_ops.init_sum_tree(self.capacity, dev),
            min_tree=tree_ops.init_min_tree(self.capacity, dev),
            pos=0, size=0,
            max_priority=torch.tensor(1.0, device=dev))

    def add(self, state: ReplayState, batch: dict,
            priorities) -> ReplayState:
        """Ring-write K transitions (numpy arrays or tensors, ``[K, ...]``)
        with their priorities ``f32[K]``, in place."""
        dev = state.sum_tree.device
        prios = torch.as_tensor(priorities).to(device=dev,
                                               dtype=torch.float32)
        k = prios.shape[0]
        idx = (state.pos + torch.arange(k, device=dev)) % self.capacity
        for name, rows in state.storage.items():
            rows[idx] = torch.as_tensor(batch[name]).to(device=dev,
                                                        dtype=rows.dtype)
        tree_ops.update_both(state.sum_tree, state.min_tree, idx,
                             self._to_tree_priority(prios))
        state.pos = (state.pos + k) % self.capacity
        state.size = min(state.size + k, self.capacity)
        state.max_priority = torch.maximum(state.max_priority, prios.max())
        return state

    # update_priorities / is_weights / _to_tree_priority: PERMethods.

    def sample(self, state: ReplayState, offsets: torch.Tensor,
               beta: float):
        """Stratified PER sample with one uniform per stratum
        (``offsets`` f32[B] in [0, 1)); returns ``(batch, weights, idx)``."""
        idx = tree_ops.stratified_sample(state.sum_tree, offsets, state.size)
        batch = {name: rows[idx] for name, rows in state.storage.items()}
        weights = self.is_weights(state, idx, beta)
        return batch, weights, idx
