"""Throughput counters and scalar logging.

Counterpart of :mod:`apex_tpu.utils.metrics`: sliding-window rates
(learner steps/s, env frames/s) and a name-spaced scalar log.  Where the
JAX logger writes tensorboardX events, this one appends JSON lines to
``<logdir>/scalars.jsonl`` (no extra dependency on the card's machine).
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of a pre-sorted sequence: the smallest
    element with at least ``q`` of the mass at or below it
    (``ceil(q*n) - 1``).  0.0 on empty input."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    return sorted_vals[max(0, math.ceil(q * n) - 1)]


class RateCounter:
    """Sliding-window events/sec (learner steps, env frames)."""

    def __init__(self, window: int = 100):
        self._ticks: deque[tuple[float, int]] = deque(maxlen=window)
        self.total = 0

    def tick(self, n: int = 1) -> None:
        self.total += n
        self._ticks.append((time.perf_counter(), n))

    @property
    def rate(self) -> float:
        if len(self._ticks) < 2:
            return 0.0
        span = self._ticks[-1][0] - self._ticks[0][0]
        events = sum(n for _, n in list(self._ticks)[1:])
        return 0.0 if span <= 0 else events / span


class MetricLogger:
    """Name-spaced scalar log: an in-memory history per tag, JSON lines
    under ``logdir`` when one is given, and stdout when ``verbose``."""

    def __init__(self, role: str, logdir: str | None = None,
                 verbose: bool = False):
        self.role = role
        self.logdir = logdir
        self.verbose = verbose
        self._file = None
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            self._file = open(os.path.join(logdir, "scalars.jsonl"), "a",
                              encoding="utf-8")
        self.history: dict[str, deque[tuple[int, float]]] = {}

    def scalar(self, name: str, value: float, step: int) -> None:
        tag = f"{self.role}/{name}"
        value = float(value)
        self.history.setdefault(tag, deque(maxlen=100_000)).append(
            (step, value))
        if self._file is not None:
            self._file.write(json.dumps({"tag": tag, "step": step,
                                         "value": value}) + "\n")
        if self.verbose:
            print(f"[{tag}] step={step} {value:.6g}", flush=True)

    def scalars(self, values: dict[str, Any], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, float(v), step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
