"""Per-role trace ring: bounded, sampled, host-only Chrome trace events.

Counterpart of :mod:`apex_tpu.obs.trace` (stdlib only).

One :class:`TraceRing` per process, enabled when ``APEX_TRACE_DIR`` is
set (else :func:`get_ring` returns a disabled stub whose methods cost one
attribute check).  Producers are the existing hook points — the actor
families' :class:`~apex_tpu_torch.utils.profiling.PhaseTimer` /
:class:`~apex_tpu_torch.utils.profiling.DispatchGapTimer`, the program
spans of the learner, the ingest pipeline's staging thread and the rollout
engine (:func:`span`), and the learner's chunk-lineage join
(:class:`apex_tpu_torch.obs.spans.LearnerObs`) — all of which record plain
host clock reads into a ``deque(maxlen=...)``: no device sync ever,
no lock on the append path (GIL-atomic), and a
``sample`` stride bounds the recording rate independently of the ring
bound.

Two timebases per event: ``perf`` (``time.perf_counter`` — in-process
phases/gaps) and ``wall`` (``time.time`` — chunk-lineage hops, whose
stamps cross process boundaries).  At dump time everything is emitted in
WALL microseconds using the anchor captured at ring creation, so each
per-process file is immediately perfetto-loadable and
:mod:`apex_tpu_torch.obs.merge` only has to apply cross-host skew offsets and
re-zero the fleet timeline.

Dump triggers: atexit, a periodic flusher thread (every
``APEX_TRACE_FLUSH_S``, default 10 — so SIGKILLed/terminated roles still
leave a near-complete trace, the same evidence-survival discipline as
``fleet_summary.json``), and SIGUSR2 when the process's main thread can
install handlers.

Program spans (:func:`span`) name the phases of the port's hot loops
(``apex.learner.*``, ``apex.ingest.*``, ``apex.anakin.*``) for both
tools at once.  While a ``torch.profiler`` records, a span is a
``record_function`` range, which the profiler keeps for the thread that
started it, with the device launches made inside it; every thread's spans
are also kept in memory on ``time.time_ns`` (:func:`profiled_spans`), the
clock the profiler stamps its events on.  While the ring is enabled, a
span is one ring event on its track.  With neither, a span costs two flag
reads and records nothing.  A span never waits for the device.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import signal
import sys
import threading
import time
from collections import deque

#: env knobs (read at ring creation)
TRACE_DIR_ENV = "APEX_TRACE_DIR"
SAMPLE_ENV = "APEX_TRACE_SAMPLE"
CAPACITY_ENV = "APEX_TRACE_CAPACITY"
FLUSH_ENV = "APEX_TRACE_FLUSH_S"


class TraceRing:
    """Bounded ring of trace events for one process."""

    def __init__(self, label: str, enabled: bool = True,
                 capacity: int = 65536, sample: int = 1):
        self.label = label
        self.enabled = enabled
        self.sample = max(1, int(sample))
        self._events: deque[tuple] = deque(maxlen=capacity)
        self._n = 0
        self._tracks: dict[str, int] = {}
        self._tracks_lock = threading.Lock()
        # wall<->perf anchor: dump converts perf-timebase events to wall
        self._anchor_wall = time.time()
        self._anchor_perf = time.perf_counter()

    # -- producers (hot-loop safe) ----------------------------------------

    def _tid(self, track: str | None) -> int:
        if track is None:
            return threading.get_ident() % 100_000
        tid = self._tracks.get(track)
        if tid is None:
            with self._tracks_lock:
                tid = self._tracks.setdefault(track,
                                              1000 + len(self._tracks))
        return tid

    def complete(self, name: str, t0_perf: float, dur_s: float,
                 track: str | None = None, args: dict | None = None) -> None:
        """One complete ("X") event on the perf_counter timebase."""
        if not self.enabled:
            return
        self._n += 1
        if self._n % self.sample:
            return
        self._events.append(("perf", name, t0_perf, dur_s,
                             self._tid(track), args))

    def complete_wall(self, name: str, t0_wall: float, dur_s: float,
                      track: str | None = None,
                      args: dict | None = None) -> None:
        """One complete event whose start is a WALL timestamp (lineage
        hops stamped in another process)."""
        if not self.enabled:
            return
        self._n += 1
        if self._n % self.sample:
            return
        self._events.append(("wall", name, t0_wall, dur_s,
                             self._tid(track), args))

    def instant(self, name: str, track: str | None = None,
                args: dict | None = None) -> None:
        if not self.enabled:
            return
        self._events.append(("perf", name, time.perf_counter(), None,
                             self._tid(track), args))

    # -- dump --------------------------------------------------------------

    def _to_wall(self, timebase: str, t: float) -> float:
        if timebase == "wall":
            return t
        return self._anchor_wall + (t - self._anchor_perf)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (ts/dur in wall microseconds) with the
        clock anchor + label in metadata."""
        pid = os.getpid()
        events: list[dict] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": self.label}},
        ]
        with self._tracks_lock:
            tracks = dict(self._tracks)
        for track, tid in tracks.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
        for timebase, name, t0, dur, tid, args in list(self._events):
            ev = {"name": name, "pid": pid, "tid": tid,
                  "ts": round(self._to_wall(timebase, t0) * 1e6, 1)}
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 1)
            if args:
                ev["args"] = args
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "label": self.label, "pid": pid,
                "clock_sync": {"wall": self._anchor_wall,
                               "perf": self._anchor_perf},
            },
        }

    def dump(self, path: str) -> None:
        """Atomic write (readers of a mid-run flush never see a torn
        file)."""
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self.to_chrome(), fh)
        os.replace(tmp, path)


# -- process-global ring ----------------------------------------------------

_RING: TraceRing | None = None
_RING_LOCK = threading.Lock()
_FLUSHER: threading.Thread | None = None


def trace_dir() -> str | None:
    return os.environ.get(TRACE_DIR_ENV) or None


def _ring_path() -> str | None:
    d = trace_dir()
    if d is None or _RING is None:
        return None
    label = _RING.label.replace("/", "_")
    return os.path.join(d, f"trace-{label}-{os.getpid()}.json")


def dump_ring() -> str | None:
    """Flush the process ring to its trace file; returns the path (None
    when disabled).  Never raises — observability must not kill a run."""
    path = _ring_path()
    if path is None or not _RING.enabled:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _RING.dump(path)
        return path
    except OSError:
        return None


def _flusher_loop(interval_s: float) -> None:
    while True:
        time.sleep(interval_s)
        dump_ring()


def _install_triggers() -> None:
    global _FLUSHER
    atexit.register(dump_ring)
    interval = float(os.environ.get(FLUSH_ENV, "10"))
    if interval > 0 and _FLUSHER is None:
        _FLUSHER = threading.Thread(target=_flusher_loop, args=(interval,),
                                    daemon=True, name="apex-trace-flush")
        _FLUSHER.start()
    try:
        # SIGUSR2 -> on-demand dump (main thread only; worker children
        # spawned by mp enter here on their own main threads)
        signal.signal(signal.SIGUSR2, lambda *_: dump_ring())
    except (ValueError, OSError, AttributeError):
        pass                        # non-main thread / platform without it


def get_ring() -> TraceRing:
    """The process's trace ring — a real one when ``APEX_TRACE_DIR`` is
    set, else a disabled stub (every producer call is one attr check)."""
    global _RING
    if _RING is not None:
        return _RING
    with _RING_LOCK:
        if _RING is None:
            d = trace_dir()
            _RING = TraceRing(
                label=f"pid{os.getpid()}",
                enabled=d is not None,
                capacity=int(os.environ.get(CAPACITY_ENV, "65536")),
                sample=int(os.environ.get(SAMPLE_ENV, "1")))
            if d is not None:
                _install_triggers()
    return _RING


def set_process_label(label: str) -> None:
    """Name this process's trace track by its role identity ("actor-3",
    "learner") — the merge tool joins these against the fleet registry's
    peer identities for clock-offset correction."""
    get_ring().label = label


def reset_for_tests() -> None:
    """Drop the process-global ring and the profiled spans (tests re-enter
    with fresh env)."""
    global _RING
    with _RING_LOCK:
        _RING = None
    _PROFILED.clear()


# -- program spans ------------------------------------------------------------

#: the tracks of the learner thread's and the staging thread's spans
LEARNER_TRACK = "learner-hot-loop"
STAGING_TRACK = "ingest-staging"

#: spans recorded while a profiler ran, ``(name, thread name, start_ns,
#: end_ns)`` on ``time.time_ns``; the oldest fall off past the bound
_PROFILED: deque[tuple] = deque(maxlen=1 << 17)
_PROFILER = None        # torch.autograd.profiler, once torch is imported


def _profiler():
    """``torch.autograd.profiler`` if torch is loaded (looked up, never
    imported: this module stays stdlib-only), else None."""
    global _PROFILER
    mod = sys.modules.get("torch.autograd.profiler")
    if mod is not None and hasattr(mod, "_is_profiler_enabled"):
        _PROFILER = mod
    return mod


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "track", "ring", "prof", "rf", "t0_ns", "t0_perf")

    def __init__(self, name: str, track: str | None, ring, prof):
        self.name, self.track, self.ring, self.prof = name, track, ring, prof

    def __enter__(self):
        if self.prof is not None:
            self.rf = self.prof.record_function(self.name)
            self.rf.__enter__()
            # stamped once the range has begun: the profiler stamps it
            # inside the enter, on a clock that read 20-35 us ahead of
            # time.time_ns on an H100 host
            self.t0_ns = time.time_ns()
        if self.ring is not None:
            self.t0_perf = time.perf_counter()
        return None

    def __exit__(self, *exc) -> bool:
        if self.ring is not None:
            self.ring.complete(self.name, self.t0_perf,
                               time.perf_counter() - self.t0_perf,
                               track=self.track)
        if self.prof is not None:
            # a profiler stopped inside the span leaves a range that
            # exits as any other
            self.rf.__exit__(None, None, None)
            _PROFILED.append((self.name, threading.current_thread().name,
                              self.t0_ns, time.time_ns()))
        return False


def span(name: str, track: str | None = None):
    """``with span("apex.learner.sample", LEARNER_TRACK): ...`` — one
    program span (module docstring): a profiler range and an in-memory
    record while a profiler records, a ring event on ``track`` while the
    ring is enabled, otherwise nothing."""
    ring = _RING or get_ring()
    prof = _PROFILER or _profiler()
    on = prof is not None and prof._is_profiler_enabled
    if not (on or ring.enabled):
        return _NO_SPAN
    return _Span(name, track, ring if ring.enabled else None,
                 prof if on else None)


def profiled_spans() -> list[tuple]:
    """The spans recorded while a profiler ran, oldest first:
    ``(name, thread name, start_ns, end_ns)`` on the profiler's clock."""
    return list(_PROFILED)
