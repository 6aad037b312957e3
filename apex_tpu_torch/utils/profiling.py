"""Host-side phase and dispatch-gap timers.

Counterpart of :class:`apex_tpu.utils.profiling.PhaseTimer` and
:class:`~apex_tpu.utils.profiling.DispatchGapTimer`, without the trace-ring
hookup (the port has no obs plane yet).  Both read the host clock only and
never wait for the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Iterator

from apex_tpu_torch.utils.metrics import percentile


class PhaseTimer:
    """Named wall-time phases of a host loop: callers wrap each phase of a
    step (policy wait, env step, chunk drain) and :meth:`window` reports
    the fraction of the elapsed wall each phase took since the last reset.
    The fractions need not sum to 1; the rest is unattributed host time."""

    def __init__(self):
        self._acc: dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t)

    def add(self, name: str, seconds: float) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    def window(self, reset: bool = True) -> dict:
        """``{"wall_s", "fracs": {name: frac}}`` since construction or the
        last resetting call."""
        now = time.perf_counter()
        wall = max(now - self._t0, 1e-9)
        out = {"wall_s": wall,
               "fracs": {k: v / wall for k, v in self._acc.items()}}
        if reset:
            self._acc = {k: 0.0 for k in self._acc}
            self._t0 = now
        return out


class DispatchGapTimer:
    """Host time between one dispatch returning and the next being issued:
    the hole in the work feed that polling and bookkeeping leave."""

    def __init__(self, window: int = 512):
        self._last_return: float | None = None
        self._gaps: deque[float] = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def about_to_dispatch(self) -> None:
        """Call immediately before issuing a dispatch."""
        if self._last_return is None:
            return
        gap = time.perf_counter() - self._last_return
        self._gaps.append(gap)
        self.count += 1
        self.total += gap
        self.max = max(self.max, gap)
        self._last_return = None

    def dispatch_returned(self) -> None:
        """Call immediately after the dispatch returns."""
        self._last_return = time.perf_counter()

    def snapshot(self) -> dict:
        """Stats in ms: mean, nearest-rank p50/p90/p99 over the last
        ``window`` gaps, max, and the count."""
        gaps = sorted(self._gaps)
        return {
            "dispatch_gap_ms_mean":
                1000.0 * self.total / self.count if self.count else 0.0,
            "dispatch_gap_ms_p50": 1000.0 * percentile(gaps, 0.50),
            "dispatch_gap_ms_p90": 1000.0 * percentile(gaps, 0.90),
            "dispatch_gap_ms_p99": 1000.0 * percentile(gaps, 0.99),
            "dispatch_gap_ms_max": 1000.0 * self.max,
            "dispatches": self.count,
        }
