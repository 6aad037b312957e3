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

The replay service's batches (``apex_tpu/training/apex.py:1221-1273``):
:func:`split_batch` cuts a pulled batch into contiguous per-rank blocks of
``batch / dp``, each rank updates on its block with the gradients meaned
over the group (:meth:`ShardedLearner.make_batch_train`), and the
per-rank priorities come back as ``[batch]`` in sample order, so the
write-back's ``idx`` is the batch's own.

Checkpoints hold the replay in JAX's stacked layout, every field with a
leading ``[dp]`` axis in rank order (``apex_tpu/parallel/learner.py:
90-104``): :func:`gather_shards` streams the ranks' shards into it on
rank 0 and :func:`scatter_shards` streams it back, both over the host
group (:meth:`~apex_tpu_torch.parallel.mesh.DpGroup.gather_tensors`).
"""

from __future__ import annotations

from dataclasses import dataclass

import dataclasses

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


def split_batch(batch: dict, weights, n_dp: int) -> list[tuple]:
    """A pulled batch (host arrays, ``[B, ...]`` leaves; an ``obs_pair``
    leaf is ``[2B, ...]``, the observations then the next ones) and its IS
    weights as ``n_dp`` contiguous blocks of ``B / n_dp`` rows, rank r's
    rows ``[r*B/n_dp, (r+1)*B/n_dp)``: ``[(batch_r, weights_r), ...]``."""
    weights = np.asarray(weights, np.float32)
    b = per_rank_batch(weights.shape[0], n_dp)
    total = weights.shape[0]

    def block(x, r, pair=False):
        if isinstance(x, dict):
            return {k: block(v, r, k == "obs_pair") for k, v in x.items()}
        x = np.asarray(x)
        rows = slice(r * b, (r + 1) * b)
        if pair:
            return np.concatenate([x[rows], x[total:][rows]])
        return x[rows]

    return [(block(batch, r), weights[r * b:(r + 1) * b])
            for r in range(n_dp)]


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

    def make_batch_train(self):
        """``(ts, batch, weights) -> (ts, priorities, metrics)``: this
        rank's block of a pulled batch (:func:`split_batch`), the family's
        update meaned over the group, and every rank's priorities in rank
        order, ``[batch]`` (``apex_tpu/training/apex.py:1239-1267``)."""
        core, group = self.core, self.group
        per_chip = self._per_chip_batch()

        def train(ts, batch, weights):
            weights = torch.as_tensor(weights).to(group.device)
            if weights.shape[0] != per_chip:
                raise ValueError(f"a batch block of {weights.shape[0]} "
                                 f"rows; this rank trains on {per_chip}")
            ts, priorities, metrics = core.update_from_batch(
                ts, batch, weights, group=group)
            return ts, group.all_gather_blocks(priorities), metrics

        return train

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


# -- shard transfer (checkpoints) --------------------------------------------

def state_leaves(state) -> tuple[list, list]:
    """A replay state's tensors and host numbers, each as ``(path,
    value)`` in field order; a dict field's entries (the frame pool's
    sidecars, the stacked replay's storage) as ``field/key``, sorted."""
    tensors, numbers = [], []
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, dict):
            tensors += [(f"{f.name}/{k}", value[k]) for k in sorted(value)]
        elif isinstance(value, torch.Tensor):
            tensors.append((f.name, value))
        else:
            numbers.append((f.name, int(value)))
    return tensors, numbers


def _put(tree: dict, path: str, value) -> None:
    head, _, rest = path.partition("/")
    if rest:
        _put(tree.setdefault(head, {}), rest, value)
    else:
        tree[head] = value


def _get(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def gather_shards(group: DpGroup, state, extra: tuple = ()) -> tuple:
    """Every rank calls it with its replay ``state`` and ``extra`` host
    tensors (its generators' states; same shapes on every rank).  Rank 0
    returns ``(stacked, extra_stacked)``: the replay in JAX's stacked
    layout, ``{field: [dp, ...] tensor}`` on the host with the host
    numbers as ``int64[dp]`` and dict fields nested, and each extra tensor
    stacked ``[dp, ...]``; the other ranks return ``(None, None)``.  The
    tensors stream over the host group one field and one slice at a time
    (:meth:`DpGroup.gather_tensors`)."""
    tensors, numbers = state_leaves(state)
    flat = [t for _, t in tensors] + [torch.as_tensor(x) for x in extra]
    nums = group.all_gather_host(torch.tensor(
        [v for _, v in numbers], dtype=torch.int64).reshape(-1))
    out = None
    if group.rank == 0:
        out = [torch.empty((group.world,) + tuple(t.shape), dtype=t.dtype)
               for t in flat]
    group.gather_tensors(flat, out)
    if group.rank != 0:
        return None, None
    stacked: dict = {}
    for (path, _), t in zip(tensors, out):
        _put(stacked, path, t)
    for i, (path, _) in enumerate(numbers):
        _put(stacked, path, nums[:, i].clone())
    return stacked, out[len(tensors):]


def tile_shard(state, world: int) -> dict:
    """``world`` copies of ``state`` in the stacked layout, on the host:
    the shards of ranks that never started, each as fresh as this one."""
    tensors, numbers = state_leaves(state)
    out: dict = {}
    for path, t in tensors:
        host = t.detach().to("cpu")
        _put(out, path, host.unsqueeze(0).repeat(world, *[1] * host.dim()))
    for path, value in numbers:
        _put(out, path, torch.full((world,), value, dtype=torch.int64))
    return out


def unstack_shard(state, stacked: dict, rank: int) -> None:
    """Row ``rank`` of a stacked replay into ``state`` in place (shapes and
    dtypes checked, the host numbers set)."""
    tensors, numbers = state_leaves(state)
    for path, t in tensors:
        row = _get(stacked, path)[rank]
        if tuple(row.shape) != tuple(t.shape) or row.dtype != t.dtype:
            raise ValueError(
                f"checkpoint replay_state/{path}: {tuple(row.shape)} "
                f"{row.dtype} does not fit {tuple(t.shape)} {t.dtype}")
        t.copy_(row)
    for path, _ in numbers:
        setattr(state, path, int(_get(stacked, path)[rank]))


def shard_numbers(stacked: dict, state, rank: int) -> dict:
    """Rank ``rank``'s host numbers of a stacked replay, by field."""
    return {path: int(_get(stacked, path)[rank])
            for path, _ in state_leaves(state)[1]}


def scatter_shards(group: DpGroup, state, stacked: dict | None = None,
                   extra: tuple = (), extra_stacked: tuple = (),
                   numbers: dict | None = None) -> None:
    """The reverse of :func:`gather_shards` for ranks >= 1: every rank
    calls it; rank 0 holds ``stacked`` (and ``extra_stacked``) and keeps
    its own state as it is (it restored row 0 itself, :func:`unstack_shard`);
    each other rank receives its row into ``state``'s tensors and
    ``extra`` in place and takes its host ``numbers`` (sent beside the
    op, :func:`shard_numbers`)."""
    tensors, _ = state_leaves(state)
    flat = [t for _, t in tensors] + list(extra)
    rows = None
    if group.rank == 0:
        rows = [_get(stacked, p) for p, _ in tensors] + list(extra_stacked)
    group.scatter_tensors(flat, rows)
    if group.rank != 0:
        for path, value in (numbers or {}).items():
            setattr(state, path, int(value))


class NoActors:
    """The pool of a rank >= 1: its trainer acts on nothing (rank 0's pool
    feeds every shard); start and cleanup are no-ops."""

    procs: list = []

    def start(self) -> None:
        pass

    def cleanup(self) -> None:
        pass
