"""Frame-ring row gather: a hand-written CUDA kernel and its plain version.

Replaces ``apex_tpu/ops/gather.py:_pallas_gather``, the TPU kernel that
rebuilds sample-time frame stacks from the replay's frame ring
(:meth:`apex_tpu_torch.replay.frame_pool.FramePoolReplay._gather_stacks`
calls it twice per learner step).  The kernel lives in
``csrc/gather.cu``; its design note says what bounds it and how.

* :func:`gather_rows` launches the kernel for CUDA tensors and counts the
  launch in ``LAUNCH_COUNTS``.  For CPU tensors it runs
  :func:`gather_rows_reference`.  There is no mode switch and no fallback:
  a CUDA call that cannot launch the kernel raises.
* The kernel is compiled with ``nvcc`` at first use into ``_build/`` (a
  plain C ABI shared library loaded with ``ctypes``; rebuilt when the
  source is newer).  A failed build raises.

The TPU ring was stored padded to whole (8, 128) tiles and viewed
``[F, 8, D/8]`` for Mosaic; here the ring is the plain ``[F, D]`` tensor.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "gather.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libapex_gather.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches per wrapper; chip_smoke.py zeroes and reads these
LAUNCH_COUNTS = {"gather_rows": 0}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the gather "
                       "kernel is built from source at first use")


def build(verbose: bool = False) -> str:
    """Compile ``csrc/gather.cu`` into ``_build/`` unless the library is
    newer than the source.  Returns the library path; raises on failure."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="", flush=True)
    os.replace(tmp, LIBRARY)        # atomic: a concurrent loader never
    return LIBRARY                  # sees a half-written library


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.apex_gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            lib.apex_gather_rows.restype = ctypes.c_int
            _lib = lib
        return _lib


def gather_rows_reference(frames: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[i] = frames[ids[i]]``."""
    return frames[ids.long()]


def gather_rows(frames: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather from a frame ring ``[F, D]`` (u8 or f32, contiguous) by
    int32 ids ``[N]`` in ``[0, F)``; returns ``[N, D]``.  Repeated ids are
    legal.  On the card an id outside ``[0, F)`` traps inside the kernel
    (a host-side check would cost a device-to-host copy per call), and the
    error surfaces at the next synchronisation."""
    if frames.device.type == "cpu":
        return gather_rows_reference(frames, ids)
    if frames.device.type != "cuda" or ids.device != frames.device:
        raise ValueError(f"gather_rows: frames on {frames.device}, ids on "
                         f"{ids.device}; both must be on one CUDA device")
    if frames.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"gather_rows wants frames [F, D] and ids [N], got "
                         f"{tuple(frames.shape)} and {tuple(ids.shape)}")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"gather_rows takes u8 or f32 rings, got {frames.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"gather_rows takes int32 ids, got {ids.dtype}")
    if not (frames.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_rows wants contiguous frames and ids")
    n = ids.shape[0]
    out = torch.empty((n, frames.shape[1]), dtype=frames.dtype,
                      device=frames.device)
    if n == 0 or frames.shape[1] == 0:
        return out
    lib = _library()
    with torch.cuda.device(frames.device):
        err = lib.apex_gather_rows(
            frames.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
            frames.shape[0], frames.shape[1] * frames.element_size(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {err}")
    LAUNCH_COUNTS["gather_rows"] += 1
    return out
