"""Replay rebuilt from the chunk messages the actors shipped.

A DQN chunk carries its frames once (``frames [Kf, D]``) and, per
transition ``t < n_trans``, the chunk rows of its observation and next
observation stacks (``obs_ref``/``next_ref [K, S]``, oldest first), its
action, n-step return and bootstrap coefficient.  Transitions take
replay slots in arrival order from the cursor, modulo the capacity; a
stack is read from its own message, so nothing here depends on where
the program keeps its frames.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.per import Trees, tree_priority


class Replay:
    """Slots filled from messages in order."""

    def __init__(self, capacity: int, frame_shape, alpha: float, eps: float,
                 device):
        self.capacity = capacity
        self.frame_shape = tuple(frame_shape)
        self.alpha, self.eps = alpha, eps
        self.device = device
        self.trees = Trees(capacity, device)
        self.slots: dict[int, tuple[int, int]] = {}
        self.messages: list[dict] = []
        self.pos = 0
        self.size = 0

    def ingest(self, payload: dict, priorities) -> None:
        j = len(self.messages)
        self.messages.append(payload)
        n = int(payload["n_trans"])
        slots = [(self.pos + i) % self.capacity for i in range(n)]
        for i, s in enumerate(slots):
            self.slots[s] = (j, i)
        prios = torch.as_tensor(np.asarray(priorities, np.float32)[:n])
        self.trees.set(torch.tensor(slots),
                       tree_priority(prios, self.alpha, self.eps))
        self.pos = (self.pos + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def _stack(self, payload: dict, rows) -> np.ndarray:
        """Frames ``rows`` of a message as one stack ``[H, W, S*c]``."""
        h, w, c = self.frame_shape
        f = np.asarray(payload["frames"])[np.asarray(rows)]
        return f.reshape(len(rows), h, w, c).transpose(1, 2, 0, 3).reshape(
            h, w, len(rows) * c)

    def batch(self, idx) -> dict:
        """The items at slots ``idx``, as device tensors."""
        idx = [int(i) for i in np.asarray(idx)]
        where = [self.slots[i] for i in idx]
        dev = self.device
        cols: dict[str, list] = {k: [] for k in ("obs", "next_obs", "action",
                                                 "reward", "discount")}
        for j, t in where:
            m = self.messages[j]
            cols["obs"].append(self._stack(m, m["obs_ref"][t]))
            cols["next_obs"].append(self._stack(m, m["next_ref"][t]))
            for k in ("action", "reward", "discount"):
                cols[k].append(np.asarray(m[k])[t])
        out = {k: torch.as_tensor(np.stack(v)).to(dev)
               for k, v in cols.items()}
        out["action"] = out["action"].long()
        for k in out:
            if out[k].dtype == torch.float64:
                out[k] = out[k].float()
        return out
