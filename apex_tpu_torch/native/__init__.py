"""Host-side native code of the port (C++, ctypes-bound).

Counterpart of :mod:`apex_tpu.native`: the in-host actor->learner chunk
plane, a shared-memory MPSC ring (``shm_ring.cpp``, a copy of the JAX
package's) with its Python facade in :mod:`apex_tpu_torch.native.ring`.

The library builds with ``g++`` at first use into ``_build/`` (plain C
ABI + ctypes).  Anything that can fail (no compiler, no ``/dev/shm``)
leaves :func:`shm_available` false, and the actor pool then carries
chunks over ``multiprocessing.Queue``: host transport, never the
learner's device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "shm_ring.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")
_LIB = os.path.join(_BUILD_DIR, "libapex_torch_shm.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile the ring if the library is missing or older than the
    source.  Returns an error string, or None on success."""
    try:
        if (os.path.exists(_LIB)
                and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
            return None
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = _LIB + f".tmp{os.getpid()}"
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
               _SRC, "-lrt", "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            return f"g++ failed: {proc.stderr[-2000:]}"
        os.replace(tmp, _LIB)  # atomic: concurrent builders never see a torn file
        return None
    except (OSError, subprocess.SubprocessError) as e:
        return f"{type(e).__name__}: {e}"


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            _build_error = str(e)
            return None
        ptr, u64 = ctypes.c_void_p, ctypes.c_uint64
        lib.apex_shm_create.restype = ptr
        lib.apex_shm_create.argtypes = [ctypes.c_char_p, u64, u64]
        lib.apex_shm_open.restype = ptr
        lib.apex_shm_open.argtypes = [ctypes.c_char_p]
        lib.apex_shm_close.restype = None
        lib.apex_shm_close.argtypes = [ptr]
        lib.apex_shm_push.restype = ctypes.c_int
        lib.apex_shm_push.argtypes = [ptr, ctypes.c_char_p, u64,
                                      ctypes.c_int]
        lib.apex_shm_pop.restype = ctypes.c_int64
        lib.apex_shm_pop.argtypes = [ptr, ctypes.c_char_p, u64, ctypes.c_int]
        for fn in ("apex_shm_dropped", "apex_shm_disposed",
                   "apex_shm_pending", "apex_shm_slot_size"):
            getattr(lib, fn).restype = u64
            getattr(lib, fn).argtypes = [ptr]
        lib.apex_shm_force_skip.restype = ctypes.c_int
        lib.apex_shm_force_skip.argtypes = [ptr]
        lib.apex_shm_test_claim.restype = None
        lib.apex_shm_test_claim.argtypes = [ptr]
        _lib = lib
        return _lib


def shm_available() -> bool:
    """True when the native ring compiled, loads, and /dev/shm exists."""
    return _load() is not None and os.path.isdir("/dev/shm")


def build_error() -> str | None:
    """Why the native library is unavailable (None if it is)."""
    _load()
    return _build_error
