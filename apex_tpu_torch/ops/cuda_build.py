"""Build-at-first-use of the ops' hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  :func:`build` compiles it
with ``nvcc`` into a shared library under ``_build/`` unless the library is
newer than the source; :class:`Library` loads it once with ``ctypes`` and
launches its ``apex_<name>`` entry points on the current stream.  A failed
build or launch raises.
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
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the ops' "
                       "CUDA kernels are built from source at first use")


def build(source: str, library: str, verbose: bool = False) -> str:
    """Compile ``source`` into ``library`` unless the library is newer than
    the source.  Returns the library path; raises on failure."""
    if (os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library
    build_dir = os.path.dirname(library)
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="", flush=True)
    os.replace(tmp, library)        # atomic: a concurrent loader never
    return library                  # sees a half-written library


class Library:
    """A kernel library loaded at its first launch.

    ``build_fn()`` returns the library's path, building it if need be (it
    is called then, so a module's build paths may be changed before the
    first launch); ``signatures`` maps each ``apex_<name>`` entry point to
    its ctypes argument types, the trailing stream left out."""

    def __init__(self, build_fn, signatures: dict):
        self._build_fn = build_fn
        self._signatures = signatures
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self._build_fn())
                for entry, argtypes in self._signatures.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = [*argtypes, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def launch(self, name: str, device: torch.device, *args) -> None:
        """Call ``apex_<name>`` on ``device``'s current stream; raise if
        the launch failed."""
        with torch.cuda.device(device):
            err = getattr(self.load(), f"apex_{name}")(
                *args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
