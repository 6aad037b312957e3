"""Python bindings for the shared-memory MPSC ring (``shm_ring.cpp``).

Counterpart of :mod:`apex_tpu.native.ring`.  Two layers:

* :class:`ShmRing` -- thin ctypes wrapper over the C ABI (bytes in/out).
* :class:`ShmChunkQueue` -- the ``multiprocessing.Queue``-shaped facade
  the port's :class:`~apex_tpu_torch.actors.pool.ActorPool` uses for its
  chunk plane: ``put / get / get_nowait / close / cancel_join_thread``,
  blocking while full.  Messages are pickled (protocol 5) and read back
  through :func:`apex_tpu_torch.runtime.wire.restricted_loads`.

The facade pickles to its segment name only; worker processes re-open the
ring lazily on first use.  The creating process owns the segment and
unlinks it on close.  Segment names start with :data:`SEGMENT_PREFIX`,
which differs from the JAX package's, so the two packages' pools on one
host never open each other's rings.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import pickle
import queue as queue_lib
import time

from apex_tpu_torch import native
from apex_tpu_torch.runtime.wire import restricted_loads

SEGMENT_PREFIX = "apextorchshm"

_segment_ids = itertools.count(1)


def segment_name() -> str:
    """A fresh segment name, unique to this process and call:
    ``apextorchshm-<pid>-<n>``."""
    return f"{SEGMENT_PREFIX}-{os.getpid()}-{next(_segment_ids)}"


class ShmRingError(RuntimeError):
    pass


class ShmRing:
    """One shared-memory ring: many producers, one consumer."""

    _h = None       # the C handle; None once closed (or never opened)

    def __init__(self, name: str, slot_size: int = 0, n_slots: int = 0,
                 create: bool = False):
        lib = native._load()
        if lib is None:
            raise ShmRingError(
                f"native ring unavailable: {native.build_error()}")
        if not name.startswith("/"):
            name = "/" + name
        self.name = name
        self._lib = lib
        if create:
            if slot_size <= 8 or n_slots <= 0:
                raise ValueError("create needs slot_size > 8 and n_slots > 0")
            self._h = lib.apex_shm_create(name.encode(), slot_size, n_slots)
        else:
            self._h = lib.apex_shm_open(name.encode())
        if not self._h:
            raise ShmRingError(f"could not {'create' if create else 'open'} "
                               f"shm ring {name!r}")
        self.slot_size = int(lib.apex_shm_slot_size(self._h))
        self._buf = ctypes.create_string_buffer(self.slot_size)
        self.corrupt_drops = 0   # torn-length payloads disposed by pop

    def push(self, data: bytes, timeout_ms: int = -1) -> bool:
        """False when not delivered: the ring stayed full until the
        timeout, or the consumer force-skipped this producer's ticket
        while it stalled.  Either way a retry re-sends under a fresh
        ticket.  Raises when ``data`` can never fit a slot."""
        rc = self._lib.apex_shm_push(self._h, data, len(data), timeout_ms)
        if rc == -2:
            raise ShmRingError(
                f"message of {len(data)} bytes exceeds slot size "
                f"{self.slot_size} (raise ActorConfig.shm_slot_bytes)")
        return rc == 0

    def pop(self, timeout_ms: int = 0) -> bytes | None:
        """Next message, or None on timeout."""
        rc = self._lib.apex_shm_pop(self._h, self._buf, self.slot_size,
                                    timeout_ms)
        if rc == -2:       # cannot happen: _buf is slot-sized
            raise ShmRingError("pop buffer smaller than slot")
        if rc == -3:       # torn length prefix, disposed in place
            self.corrupt_drops += 1
            return None
        if rc < 0:
            return None
        return self._buf.raw[:rc]

    def pending(self) -> int:
        return int(self._lib.apex_shm_pending(self._h))

    def force_skip(self) -> bool:
        """Dispose of a claimed-but-never-published head ticket (its
        producer died mid-write).  Call only after a long starvation
        window: see the contract in ``shm_ring.cpp``."""
        return bool(self._lib.apex_shm_force_skip(self._h))

    def push_timeouts(self) -> int:
        """Push calls that timed out on a full ring: backpressure events,
        not lost messages."""
        return int(self._lib.apex_shm_dropped(self._h))

    def disposed(self) -> int:
        """Tickets force-skipped away from stalled producers."""
        return int(self._lib.apex_shm_disposed(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.apex_shm_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class ShmChunkQueue:
    """``multiprocessing.Queue`` facade over :class:`ShmRing` for the
    actor pool's chunk plane.  The creating process owns and unlinks the
    segment; workers get a pickled copy holding only the name.  ``put``
    blocks while the ring is full, in 200 ms slices."""

    # a wedged head ticket (producer killed inside its claim->publish
    # window) is force-skipped after this much continuous starvation with
    # messages pending: far beyond any live producer's memcpy
    STUCK_SECONDS = 10.0

    def __init__(self, name: str, slot_bytes: int, depth: int):
        self.name = name
        self.slot_bytes = slot_bytes
        self.depth = depth
        self._ring: ShmRing | None = ShmRing(
            name, slot_size=slot_bytes, n_slots=depth, create=True)
        self._starved_since: float | None = None
        self.skipped = 0                # force-skipped or unreadable messages

    def __getstate__(self):
        return {"name": self.name, "slot_bytes": self.slot_bytes,
                "depth": self.depth}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._ring = None               # re-opened lazily in the worker
        self._starved_since = None
        self.skipped = 0

    def _open(self) -> ShmRing:
        if self._ring is None:
            self._ring = ShmRing(self.name)
        return self._ring

    def put(self, item) -> None:
        data = pickle.dumps(item, protocol=5)
        ring = self._open()
        while not ring.push(data, timeout_ms=200):
            pass                        # full: keep blocking, like mp.Queue

    def get(self, timeout: float = 0.0):
        return self._get(max(1, int(timeout * 1000)))

    def get_nowait(self):
        return self._get(0)

    def _get(self, timeout_ms: int):
        ring = self._open()
        corrupt_before = ring.corrupt_drops
        got = ring.pop(timeout_ms=timeout_ms)
        if got is None and ring.corrupt_drops > corrupt_before:
            self.skipped += 1           # a torn payload, not a timeout
            raise queue_lib.Empty
        if got is not None:
            self._starved_since = None
            try:
                return restricted_loads(got)
            except Exception as e:
                # a force-skipped producer's late memcpy can corrupt one
                # payload (shm_ring.cpp), and a payload naming a global
                # outside the wire allowlist is refused: either costs one
                # message, counted, never the learner
                self.skipped += 1
                raise queue_lib.Empty from e
        if ring.pending() > 0:
            now = time.monotonic()
            if self._starved_since is None:
                self._starved_since = now
            elif now - self._starved_since > self.STUCK_SECONDS:
                if ring.force_skip():
                    self.skipped += 1
                self._starved_since = None
        else:
            self._starved_since = None
        raise queue_lib.Empty

    def pending(self) -> int:
        return self._open().pending()

    def cancel_join_thread(self) -> None:   # no feeder thread to detach
        pass

    def close(self) -> None:
        if self._ring is not None:
            self._ring.close()
            self._ring = None


def chunk_slot_bytes(frame_dim: int, frame_dtype_size: int, kf: int,
                     k: int, stack: int, margin: int = 65536) -> int:
    """Slot size for a frame-chunk message: the frames array dominates;
    transition fields and pickle framing ride in the margin."""
    frames = kf * frame_dim * frame_dtype_size
    trans = k * (2 * stack + 3) * 4 + k * 4
    return frames + trans + margin
