"""The sharded learner: one replay shard per rank, gradients meaned over
the dp group.

Counterpart of :mod:`apex_tpu.parallel.learner` (read its docstring for
the sampling semantics).  There every chip runs one ``shard_map``-ped
program; here every rank is a process (or, in the tests, a thread) that
runs the same body on its own state:

* the replay is sharded: each rank owns a whole replay of
  ``core.replay.capacity`` (trees, ring and all) on its device, so the
  total is capacity x dp.  A rank ingests its own chunks, samples
  ``batch / dp`` from its own tree with its own uniforms, and writes its
  priorities back locally;
* the IS weights use the local total and size with the max-weight
  normalizer taken over the ranks (one MAX all-reduce,
  :meth:`~apex_tpu_torch.replay.base.PERMethods.is_weights`);
* the gradients and the step's metrics are meaned over the ranks in one
  all-reduce before the optimizer step (:func:`~apex_tpu_torch.training.
  learner.td_update`, :meth:`~apex_tpu_torch.training.aql.AQLCore.
  update_from_batch`);
* weights and optimizer state start identical (rank 0 broadcasts them,
  :meth:`ShardedLearner.sync_train_state_`), and identical mean updates
  keep them bit-identical on every rank: the DP invariant.

The steps take the per-stratum uniforms (``offsets``, ``f32[batch/dp]``)
where the JAX steps take one key per chip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from apex_tpu_torch.parallel.mesh import DpGroup
from apex_tpu_torch.training.checkpoint import _set_numbers, _state_tree


def _tensors_of(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


def _numbers_of(tree):
    """``tree`` with its tensors dropped: what the wire carries."""
    if isinstance(tree, dict):
        return {k: _numbers_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numbers_of(v) for v in tree]
    return tree if isinstance(tree, (int, float)) else None


def per_rank_batch(batch_size: int, n_dp: int) -> int:
    """``batch_size / n_dp``, validated loudly (a ``ValueError`` naming
    the knobs, ``apex_tpu/parallel/learner.py:105-117``)."""
    per_chip, rem = divmod(batch_size, n_dp)
    if rem:
        raise ValueError(
            f"learner.batch_size={batch_size} must be divisible by the dp "
            f"axis (dp={n_dp}, from learner.mesh_shape) — raise batch_size "
            f"or shrink the mesh")
    return per_chip


@dataclass(frozen=True)
class ShardedLearner:
    """A learner core (:class:`~apex_tpu_torch.training.learner.
    LearnerCore` or a subclass: any core with ``replay``,
    ``batch_size`` and ``update_from_batch(..., group=)``) run as this
    rank's part of the dp plan."""

    core: object
    group: DpGroup

    @property
    def n_dp(self) -> int:
        return self.group.world

    def _per_chip_batch(self) -> int:
        return per_rank_batch(self.core.batch_size, self.n_dp)

    # -- the steps ---------------------------------------------------------

    def make_train_step(self):
        """``(ts, rs, offsets, beta) -> (ts, rs, metrics)``: sample
        ``batch/dp`` from this rank's shard, the family's update meaned
        over the group, the local priority write-back."""
        core, group = self.core, self.group
        per_chip = self._per_chip_batch()

        def train(ts, rs, offsets, beta: float):
            offsets = torch.as_tensor(offsets, dtype=torch.float32)
            if tuple(offsets.shape) != (per_chip,):
                raise ValueError(f"offsets of shape {tuple(offsets.shape)}; "
                                 f"this rank samples {per_chip}")
            offsets = offsets.to(group.device)
            batch, weights, idx = core.replay.sample(rs, offsets, beta,
                                                     group=group)
            ts, priorities, metrics = core.update_from_batch(
                ts, batch, weights, group=group)
            rs = core.replay.update_priorities(rs, idx, priorities)
            return ts, rs, metrics

        return train

    def make_fused_step(self):
        """``(ts, rs, chunk, prios, offsets, beta) -> (ts, rs, metrics)``:
        this rank's chunk into its shard, then the train step."""
        core = self.core
        train = self.make_train_step()

        def fused(ts, rs, chunk, prios, offsets, beta: float):
            rs = core.replay.add(rs, chunk, prios)
            return train(ts, rs, offsets, beta)

        return fused

    def make_ingest(self):
        """``(rs, chunk, prios) -> rs``: ingest only (before warm-up)."""
        core = self.core

        def ingest(rs, chunk, prios):
            return core.replay.add(rs, chunk, prios)

        return ingest

    # -- state -------------------------------------------------------------

    @staticmethod
    def train_state_numbers(ts) -> dict:
        """The host numbers of a train state (its step, the optimizer's
        counts), which :meth:`sync_train_state_` takes on ranks >= 1."""
        return {"step": int(ts.step),
                "opt_state": _numbers_of(_state_tree(ts.opt_state))}

    def sync_train_state_(self, ts, numbers: dict | None = None):
        """Rank 0's weights, target weights and optimizer tensors onto
        every rank (one broadcast per dtype); ranks >= 1 take ``numbers``
        (:meth:`train_state_numbers` of rank 0's state, which rank 0 sends
        them beside the op).  Returns ``ts``."""
        tensors = (list(ts.params.state_dict().values())
                   + list(ts.target_params.state_dict().values())
                   + _tensors_of(_state_tree(ts.opt_state)))
        self.group.broadcast_(tensors)
        if self.group.rank != 0:
            _set_numbers(ts.opt_state, numbers["opt_state"])
            ts.step = int(numbers["step"])
        return ts

    # -- host-side helpers -------------------------------------------------

    def split_ingest(self, batch: dict, prios):
        """A host chunk ``(K, ...)`` -> ``(dp, K/dp, ...)``, round robin:
        transition i lands on rank ``i % dp``, so consecutive transitions
        go to different shards."""
        n = self.n_dp

        def split(x):
            x = np.asarray(x)
            k = x.shape[0]
            if k % n != 0:
                raise ValueError(
                    f"ingest chunk of {k} transitions must be divisible "
                    f"by the dp axis (dp={n}, from learner.mesh_shape) — "
                    f"align actor.send_interval / learner.ingest_chunk "
                    f"with the mesh")
            return x.reshape(k // n, n, *x.shape[1:]).swapaxes(0, 1)

        return ({k: split(v) for k, v in batch.items()}, split(prios))


class NoActors:
    """The pool of a rank >= 1: its trainer acts on nothing (rank 0's pool
    feeds every shard); start and cleanup are no-ops."""

    procs: list = []

    def start(self) -> None:
        pass

    def cleanup(self) -> None:
        pass
