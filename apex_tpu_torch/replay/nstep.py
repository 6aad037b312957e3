"""Actor-side n-step transition accumulation.

A numpy copy of :class:`apex_tpu.replay.nstep.NStepAccumulator`
(``nstep.py:38-150``; reference ``BatchStorage``, ``memory.py:393-478``):
a sliding window emits ``(s_t, a_t, R_t^(n), s_{t+n}, discount)`` with the
Q-values observed while acting, so initial TD priorities are computed
without re-running the network (``memory.py:396-397,451-464``).

As in the JAX package, the emitted return is the n-step sum of exactly k
rewards, and each transition carries its own bootstrap ``discount``:
``gamma ** n`` for a full window, 0 for the tail of a terminated episode,
``gamma ** k`` (bootstrapping from the final observation) for the tail of
a truncated one.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np


class NStepAccumulator:
    """Single-environment accumulator. For fleets, keep one per env slot."""

    def __init__(self, n_steps: int, gamma: float = 0.99):
        self.n_steps = n_steps
        self.gamma = gamma
        self._window: deque = deque()
        self._out: dict[str, list] = self._empty_out()

    @staticmethod
    def _empty_out() -> dict[str, list]:
        return {k: [] for k in ("obs", "action", "reward", "next_obs",
                                "discount", "q0", "qn")}

    def add(self, obs: Any, action: int, reward: float,
            q_values: np.ndarray, terminated: bool,
            truncated: bool = False, final_obs: Any = None) -> None:
        """Record one env step.

        ``obs`` is the state acted on, ``reward``/``terminated``/``truncated``
        the step outcome, ``q_values`` the network output at ``obs``.  On a
        truncated (but not terminated) step, ``final_obs`` must be the
        observation AFTER the step — the tail bootstraps from it.
        """
        if truncated and not terminated and final_obs is None:
            raise ValueError(
                "truncated step requires final_obs to bootstrap from")
        self._window.append((obs, action, reward, q_values))
        if len(self._window) == self.n_steps + 1:
            self._emit_full()
            self._window.popleft()
        if terminated:
            # True terminal: flush tail with no bootstrap.  next_obs is a
            # placeholder (the last acted state) — discount=0 masks it.
            placeholder = self._window[-1][0]
            while self._window:
                self._emit_tail(next_obs=placeholder, bootstrap=False)
                self._window.popleft()
        elif truncated:
            while self._window:
                self._emit_tail(next_obs=final_obs, bootstrap=True)
                self._window.popleft()

    def _emit_full(self) -> None:
        """Emit the oldest transition with a full n-step window."""
        w = self._window
        n = self.n_steps
        ret = sum((self.gamma ** i) * w[i][2] for i in range(n))
        self._push(w[0], ret, next_obs=w[n][0], discount=self.gamma ** n,
                   qn=w[n][3])

    def _emit_tail(self, next_obs: Any, bootstrap: bool) -> None:
        """Emit the oldest windowed transition at episode end (k < n rewards).

        For truncation the bootstrap Q estimate ``qn`` is the Q at the LAST
        acted state (one step before ``final_obs``) — the closest estimate
        available without re-running the network; it only seeds the initial
        priority, which the learner corrects on first sample.
        """
        w = self._window
        k = len(w)
        ret = sum((self.gamma ** i) * w[i][2] for i in range(k))
        discount = (self.gamma ** k) if bootstrap else 0.0
        self._push(w[0], ret, next_obs=next_obs, discount=discount,
                   qn=w[-1][3])

    def _push(self, head: tuple, ret: float, next_obs: Any, discount: float,
              qn: np.ndarray) -> None:
        obs0, action0, _, q0 = head
        o = self._out
        o["obs"].append(obs0)
        o["action"].append(action0)
        o["reward"].append(np.float32(ret))
        o["next_obs"].append(next_obs)
        o["discount"].append(np.float32(discount))
        o["q0"].append(q0)
        o["qn"].append(qn)

    def __len__(self) -> int:
        return len(self._out["obs"])

    def compute_priorities(self) -> np.ndarray:
        """Initial TD priorities from stored Q-values (``memory.py:451-464``)."""
        o = self._out
        actions = np.asarray(o["action"])
        rewards = np.asarray(o["reward"], np.float32)
        discounts = np.asarray(o["discount"], np.float32)
        q0 = np.stack(o["q0"])
        qn = np.stack(o["qn"])
        q_taken = q0[np.arange(len(q0)), actions]
        target = rewards + discounts * qn.max(1)
        return np.abs(target - q_taken).astype(np.float32) + 1e-6

    def make_batch(self) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Materialize accumulated transitions + priorities, then reset
        (``memory.py:466-469``).  LazyFrames force-materialize here — the one
        host-side copy before the wire/device."""
        prios = self.compute_priorities()
        o = self._out
        batch = dict(
            obs=np.stack([np.asarray(x) for x in o["obs"]]),
            action=np.asarray(o["action"], np.int32),
            reward=np.asarray(o["reward"], np.float32),
            next_obs=np.stack([np.asarray(x) for x in o["next_obs"]]),
            discount=np.asarray(o["discount"], np.float32),
        )
        self._out = self._empty_out()
        return batch, prios

    def reset(self) -> None:
        """Drop window and pending output (new episode hard reset)."""
        self._window.clear()
        self._out = self._empty_out()
