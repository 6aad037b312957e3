"""Device-resident segment trees for prioritized replay.

Counterpart of :mod:`apex_tpu.ops.tree`: the tree is ONE flat f32 tensor
of length ``2 * capacity``.  Node 1 is the root; node ``i`` has children
``2i`` and ``2i+1``; leaves occupy ``[capacity, 2*capacity)``.  Every
operation is vectorized over a batch of indices as a fixed-depth loop of
gathers and scatters (``O(K log C)`` work for K updates).

Where the JAX functions return a new array, the ``update_*`` functions here
write into the tree in place and return it.  Scatters may carry duplicate
indices only with equal values (the invariant of ``tree.py:57-58,
107-110``), so plain assignment through advanced indexing is
deterministic.

Sampling is split in two: :func:`stratified_offsets` draws the per-stratum
uniforms from a ``torch.Generator`` and :func:`stratified_sample` takes
them as an argument, so a test can feed the offsets the JAX side drew.
"""

from __future__ import annotations

import torch


def init_sum_tree(capacity: int, device=None) -> torch.Tensor:
    _check_capacity(capacity)
    return torch.zeros(2 * capacity, dtype=torch.float32, device=device)


def init_min_tree(capacity: int, device=None) -> torch.Tensor:
    _check_capacity(capacity)
    return torch.full((2 * capacity,), float("inf"), dtype=torch.float32,
                      device=device)


def _check_capacity(capacity: int) -> None:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a positive power of 2, got {capacity}")


def capacity_of(tree: torch.Tensor) -> int:
    return tree.shape[0] // 2


def depth_of(tree: torch.Tensor) -> int:
    return (tree.shape[0] // 2).bit_length() - 1


def _propagate(tree: torch.Tensor, leaf_nodes: torch.Tensor,
               reduce_op) -> torch.Tensor:
    """Recompute ancestors of ``leaf_nodes`` level by level, in place.
    Duplicate parents in a level all write the same recomputed value."""
    nodes = leaf_nodes // 2
    for _ in range(depth_of(tree)):
        tree[nodes] = reduce_op(tree[2 * nodes], tree[2 * nodes + 1])
        nodes = nodes // 2
    return tree


def update_sum(tree: torch.Tensor, idx: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """Set leaves ``idx`` (buffer coordinates, 0-based) to ``values``."""
    leaf = idx.long() + capacity_of(tree)
    tree[leaf] = values.to(tree.dtype)
    return _propagate(tree, leaf, torch.add)


def update_min(tree: torch.Tensor, idx: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    leaf = idx.long() + capacity_of(tree)
    tree[leaf] = values.to(tree.dtype)
    return _propagate(tree, leaf, torch.minimum)


def update_both(sum_tree: torch.Tensor, min_tree: torch.Tensor,
                idx: torch.Tensor, values: torch.Tensor):
    """Sum and min leaf update for one priority write."""
    return update_sum(sum_tree, idx, values), update_min(min_tree, idx, values)


def tree_total(sum_tree: torch.Tensor) -> torch.Tensor:
    return sum_tree[1]


def tree_min(min_tree: torch.Tensor) -> torch.Tensor:
    return min_tree[1]


def get_leaves(tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tree[idx.long() + capacity_of(tree)]


def find_prefixsum_idx(sum_tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Vectorized root-to-leaf descent (reference: ``memory.py:106-129``):
    go right with ``u -= left`` when ``u >= left``.  Returns int64 leaf
    indices in buffer coordinates."""
    node = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    u = u.to(sum_tree.dtype)
    for _ in range(depth_of(sum_tree)):
        left = sum_tree[2 * node]
        go_right = u >= left
        u = torch.where(go_right, u - left, u)
        node = 2 * node + go_right.long()
    return node - capacity_of(sum_tree)


def stratified_offsets(batch_size: int, generator: torch.Generator,
                       device=None) -> torch.Tensor:
    """One uniform in ``[0, 1)`` per stratum, drawn on ``device``."""
    return torch.rand(batch_size, generator=generator, device=device,
                      dtype=torch.float32)


def stratified_sample(sum_tree: torch.Tensor, offsets: torch.Tensor,
                      size: int) -> torch.Tensor:
    """Proportional stratified sampling (reference: ``memory.py:242-250``):
    ``u_i = (i + offsets_i) * total / B``.  ``size`` (live element count)
    clamps the result so round-off at stratum boundaries can never select
    an empty leaf."""
    batch_size = offsets.shape[0]
    total = tree_total(sum_tree)
    u = (torch.arange(batch_size, dtype=sum_tree.dtype, device=sum_tree.device)
         + offsets.to(sum_tree.dtype)) * (total / batch_size)
    idx = find_prefixsum_idx(sum_tree, u)
    return idx.clamp(0, max(size - 1, 0))
