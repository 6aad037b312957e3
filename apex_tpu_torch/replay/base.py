"""PER math shared by replay layouts.

Counterpart of :mod:`apex_tpu.replay.base` (reference:
``memory.py:252-320``).  Replay states are mutable here: the priority
update writes into the state's trees in place and returns the state.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import tree as tree_ops


class PERMethods:
    """Mixin over replay specs with ``alpha``/``eps`` fields and states
    carrying ``sum_tree``/``min_tree``/``size``/``max_priority``."""

    def update_priorities(self, state, idx: torch.Tensor,
                          priorities: torch.Tensor):
        """Store ``priority ** alpha`` and track the running max
        (``memory.py:300-320``).  Duplicate ``idx`` entries must carry
        equal values (they do: duplicates share batch rows)."""
        p_alpha = self._to_tree_priority(priorities)
        tree_ops.update_both(state.sum_tree, state.min_tree, idx, p_alpha)
        state.max_priority = torch.maximum(state.max_priority,
                                           priorities.max())
        return state

    def is_weights(self, state, idx: torch.Tensor, beta: float,
                   group=None) -> torch.Tensor:
        """IS weights normalized by the max weight, which comes from the
        min-priority leaf (``memory.py:252-298``).

        ``group`` (a :class:`~apex_tpu_torch.parallel.mesh.DpGroup`): the
        state is one rank's replay shard, sampled on its own, so a
        transition's true inclusion probability is ``leaf / (n_shards *
        shard_total)``; the local total and local size reproduce exactly
        that, and only the max-weight normalizer is taken over the ranks
        (one MAX all-reduce), so every shard scales its loss terms alike
        (``apex_tpu/replay/base.py:36-59``)."""
        total = tree_ops.tree_total(state.sum_tree)
        size = float(state.size)
        p_min = tree_ops.tree_min(state.min_tree) / total
        max_weight = (p_min * size) ** (-beta)
        if group is not None:
            max_weight = group.all_reduce_max_(max_weight)
        p_sample = tree_ops.get_leaves(state.sum_tree, idx) / total
        return ((p_sample * size) ** (-beta) / max_weight).float()

    def _to_tree_priority(self, priorities: torch.Tensor) -> torch.Tensor:
        """``max(p, eps) ** alpha`` in f32, the power taken in f64 and
        rounded once.  The CPU's f32 ``pow`` rounds differently in its
        vector body and its scalar tail, so a value would depend on its
        position in the batch, and one merged ingest would not equal the
        same chunks ingested one by one."""
        p = priorities.float().clamp_min(self.eps)
        return (p.double() ** self.alpha).float()


def check_hbm_budget(estimated_bytes: int, budget_gb: float, what: str,
                     capacity: int, device: torch.device) -> None:
    """Refuse to allocate a replay over the configured budget or, on a
    card, over the card's own memory: an actionable error instead of an
    allocator failure mid-run."""
    budget = int(budget_gb * 2 ** 30)
    if estimated_bytes > budget:
        raise ValueError(
            f"{what} would need ~{estimated_bytes / 2**30:.1f} GiB, over the "
            f"{budget_gb:.1f} GiB budget (replay.hbm_budget_gb).  Shrink "
            f"replay.capacity (currently {capacity}) or raise the budget.")
    if device.type == "cuda":
        card = torch.cuda.get_device_properties(device).total_memory
        if estimated_bytes > card:
            raise ValueError(
                f"{what} would need ~{estimated_bytes / 2**30:.1f} GiB, over "
                f"the {card / 2**30:.1f} GiB of {device}.  Shrink "
                f"replay.capacity (currently {capacity}).")
