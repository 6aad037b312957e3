"""Device-resident segment trees for prioritized replay.

Counterpart of :mod:`apex_tpu.ops.tree`: the tree is ONE flat f32 tensor
of length ``2 * capacity``.  Node 1 is the root; node ``i`` has children
``2i`` and ``2i+1``; leaves occupy ``[capacity, 2*capacity)``.  Every
operation is vectorized over a batch of indices (``O(K log C)`` work for K
updates).

Where the JAX functions return a new array, the ``update_*`` functions here
write into the tree in place and return it.  Updates may carry duplicate
indices only with equal values (the invariant of ``tree.py:57-58,
107-110``), so the writes are deterministic.  For CUDA trees an update is
ONE launch of the hand-written kernel ``apex_tree_update``
(``csrc/tree.cu``; its design note says what bounds it): it writes the
leaves and recomputes every ancestor in both trees, and is counted in
``LAUNCH_COUNTS``.  For CPU trees it is a fixed-depth loop of gathers and
scatters (:func:`_propagate`), the plain version the kernel is held to bit
for bit.  There is no mode switch and no fallback: a CUDA call that cannot
launch raises.  The root-to-leaf descent of the sample is the same loop on
both devices.

Sampling is split in two: :func:`stratified_offsets` draws the per-stratum
uniforms from a ``torch.Generator`` and :func:`stratified_sample` takes
them as an argument, so a test can feed the offsets the JAX side drew.
"""

from __future__ import annotations

import ctypes
import os

import torch

from apex_tpu_torch.ops import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "tree.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libapex_tree.so")

# kernel launches (one per update of one or both trees on the card)
LAUNCH_COUNTS = {"tree_update": 0}


def build(verbose: bool = False) -> str:
    """Compile ``csrc/tree.cu`` into ``_build/`` unless the library is
    newer than the source.  Returns the library path; raises on failure."""
    return cuda_build.build(SOURCE, LIBRARY, verbose)


_ptr, _i64 = ctypes.c_void_p, ctypes.c_int64
_LIB = cuda_build.Library(build, {
    "apex_tree_update": [_ptr, _ptr, _ptr, _i64, _ptr, _i64, _i64, _i64],
})


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


def update_plain(tree: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
                 reduce_op) -> torch.Tensor:
    """Leaves ``idx`` set to ``values``, then :func:`_propagate`: the CPU
    path of ``update_sum``/``update_min``, on whatever device the tree is
    (the plain version the kernel is held to on the card)."""
    leaf = idx.long() + capacity_of(tree)
    tree[leaf] = values.to(tree.dtype)
    return _propagate(tree, leaf, reduce_op)


def _update_on_card(sum_tree: torch.Tensor | None,
                    min_tree: torch.Tensor | None, idx: torch.Tensor,
                    values: torch.Tensor) -> None:
    """One ``apex_tree_update`` launch: leaves ``idx`` of the given trees
    (``None`` skips one) set to ``values``, their ancestors recomputed.
    An index outside ``[0, capacity)`` traps inside the kernel and the
    error surfaces at the next synchronisation."""
    trees = [t for t in (sum_tree, min_tree) if t is not None]
    tree = trees[0]
    for t in trees:
        if (t.device.type != "cuda" or t.device != tree.device
                or t.shape != tree.shape):
            raise ValueError(f"trees {tuple(t.shape)} on {t.device} and "
                             f"{tuple(tree.shape)} on {tree.device} differ")
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"the tree kernel takes contiguous 1-D f32 "
                             f"trees, got {t.dtype} {tuple(t.shape)}")
    if idx.device != tree.device or values.device != tree.device:
        raise ValueError(f"idx on {idx.device}, values on {values.device}: "
                         f"both must be on the trees' {tree.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    if values.dtype != tree.dtype or values.shape != idx.shape:
        values = values.to(tree.dtype).expand(idx.shape)
    if idx.dim() != 1:
        idx, values = idx.reshape(-1), values.reshape(-1)
    idx, values = idx.contiguous(), values.contiguous()
    if idx.numel() == 0:            # nothing to launch
        return
    _LIB.launch("tree_update", tree.device,
                None if sum_tree is None else sum_tree.data_ptr(),
                None if min_tree is None else min_tree.data_ptr(),
                idx.data_ptr(), idx.element_size(), values.data_ptr(),
                idx.numel(), capacity_of(tree), depth_of(tree))
    LAUNCH_COUNTS["tree_update"] += 1


def update_sum(tree: torch.Tensor, idx: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """Set leaves ``idx`` (buffer coordinates, 0-based) to ``values``."""
    if tree.device.type != "cpu":
        _update_on_card(tree, None, idx, values)
        return tree
    return update_plain(tree, idx, values, torch.add)


def update_min(tree: torch.Tensor, idx: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    if tree.device.type != "cpu":
        _update_on_card(None, tree, idx, values)
        return tree
    return update_plain(tree, idx, values, torch.minimum)


def update_both(sum_tree: torch.Tensor, min_tree: torch.Tensor,
                idx: torch.Tensor, values: torch.Tensor):
    """Sum and min leaf update for one priority write (one launch on the
    card)."""
    if sum_tree.device.type != "cpu":
        _update_on_card(sum_tree, min_tree, idx, values)
        return sum_tree, min_tree
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
