"""Prioritized replay's trees, sample and weights, written plainly.

A sum tree and a min tree over ``capacity`` leaves, stored flat with the
root at node 1 and leaves at ``[capacity, 2 * capacity)``.  Every parent
is the float32 sum (or min) of its two children, so a tree is a pure
function of its leaves and two correct implementations agree bit for bit.
"""

from __future__ import annotations

import torch


def tree_priority(priorities: torch.Tensor, alpha: float,
                  eps: float) -> torch.Tensor:
    """``max(p, eps) ** alpha``, the power taken in float64 and rounded to
    float32 once."""
    p = priorities.float().clamp_min(eps)
    return (p.double() ** alpha).float()


class Trees:
    """Leaves plus lazily rebuilt sum and min trees."""

    def __init__(self, capacity: int, device):
        self.capacity = capacity
        self.sum_leaves = torch.zeros(capacity, dtype=torch.float32,
                                      device=device)
        self.min_leaves = torch.full((capacity,), float("inf"),
                                     dtype=torch.float32, device=device)

    def set(self, idx: torch.Tensor, values: torch.Tensor) -> None:
        idx = idx.long().to(self.sum_leaves.device)
        values = values.float().to(self.sum_leaves.device)
        self.sum_leaves[idx] = values
        self.min_leaves[idx] = values

    @staticmethod
    def _build(leaves: torch.Tensor, op) -> torch.Tensor:
        c = leaves.shape[0]
        tree = torch.empty(2 * c, dtype=torch.float32, device=leaves.device)
        tree[c:] = leaves
        lo = c
        while lo > 1:
            hi, lo = lo, lo // 2
            level = tree[hi:2 * hi]
            tree[lo:hi] = op(level[0::2], level[1::2])
        tree[0] = 0.0 if op is torch.add else float("inf")
        return tree

    def sum_tree(self) -> torch.Tensor:
        return self._build(self.sum_leaves, torch.add)

    def min_tree(self) -> torch.Tensor:
        return self._build(self.min_leaves, torch.minimum)


def stratified_sample(sum_tree: torch.Tensor, offsets: torch.Tensor,
                      size: int) -> torch.Tensor:
    """One draw per stratum: ``u_i = (i + offsets_i) * total / B``, found
    by the root-to-leaf descent (right, less the left sum, when ``u`` is
    at least the left child), clamped to the ``size`` live leaves."""
    c = sum_tree.shape[0] // 2
    b = offsets.shape[0]
    total = sum_tree[1]
    u = (torch.arange(b, dtype=torch.float32, device=sum_tree.device)
         + offsets.float().to(sum_tree.device)) * (total / b)
    node = torch.ones(b, dtype=torch.int64, device=sum_tree.device)
    for _ in range(c.bit_length() - 1):
        left = sum_tree[2 * node]
        right = u >= left
        u = torch.where(right, u - left, u)
        node = 2 * node + right.long()
    return (node - c).clamp(0, max(size - 1, 0))


def is_weights(sum_tree: torch.Tensor, min_tree: torch.Tensor,
               idx: torch.Tensor, size: int, beta: float) -> torch.Tensor:
    """Importance weights ``(P(i) N) ** -beta`` over their maximum, which
    belongs to the smallest leaf."""
    c = sum_tree.shape[0] // 2
    total = sum_tree[1]
    p_min = min_tree[1] / total
    max_weight = (p_min * float(size)) ** (-beta)
    p = sum_tree[idx.long() + c] / total
    return ((p * float(size)) ** (-beta) / max_weight).float()
