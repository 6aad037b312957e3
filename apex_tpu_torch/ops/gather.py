"""Frame-ring gathers: hand-written CUDA kernels and their plain versions.

Replaces ``apex_tpu/ops/gather.py:_pallas_gather``, the TPU kernel that
gathers frame-ring rows, together with the re-layout that
``apex_tpu/replay/frame_pool.py:_gather_stacks`` applies to its rows.  The
kernels live in ``csrc/gather.cu``; its design note says what bounds them
and how.

* :func:`gather_rows` -- ``out[i] = frames[ids[i]]``.
* :func:`gather_stacks` -- the frame stacks ``(N, *shape[:-1], S*shape[-1])``
  of ids ``[N, S]``, oldest frame first, written by one kernel.
  :meth:`apex_tpu_torch.replay.frame_pool.FramePoolReplay.sample` calls it
  once per learner step, for obs and next_obs together.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``LAUNCH_COUNTS``; for CPU tensors it runs its plain version
(:func:`gather_rows_reference`, :func:`gather_stacks_reference`).  There is
no mode switch and no fallback: a CUDA call that cannot launch raises.

The kernels are compiled with ``nvcc`` at first use into ``_build/`` (a
plain C ABI shared library loaded with ``ctypes``; rebuilt when the source
is newer; :mod:`~apex_tpu_torch.ops.cuda_build`).  A failed build raises.

The TPU ring was stored padded to whole (8, 128) tiles and viewed
``[F, 8, D/8]`` for Mosaic; here the ring is the plain ``[F, D]`` tensor.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from apex_tpu_torch.ops import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "gather.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libapex_gather.so")

# kernel launches per wrapper; chip_smoke.py zeroes and reads these
LAUNCH_COUNTS = {"gather_rows": 0, "gather_stacks": 0}


def build(verbose: bool = False) -> str:
    """Compile ``csrc/gather.cu`` into ``_build/`` unless the library is
    newer than the source.  Returns the library path; raises on failure."""
    return cuda_build.build(SOURCE, LIBRARY, verbose)


_ptr, _i64 = ctypes.c_void_p, ctypes.c_int64
_LIB = cuda_build.Library(build, {
    "apex_gather_rows": [_ptr, _ptr, _ptr, _i64, _i64, _i64],
    "apex_gather_stacks": [_ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _i64],
})


def _check(name: str, frames: torch.Tensor, ids: torch.Tensor,
           ids_dim: int) -> None:
    if frames.device.type != "cuda" or ids.device != frames.device:
        raise ValueError(f"{name}: frames on {frames.device}, ids on "
                         f"{ids.device}; both must be on one CUDA device")
    if frames.dim() != 2 or ids.dim() != ids_dim:
        raise ValueError(f"{name} wants frames [F, D] and {ids_dim}-D ids, "
                         f"got {tuple(frames.shape)} and {tuple(ids.shape)}")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{name} takes u8 or f32 rings, got {frames.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 ids, got {ids.dtype}")
    if not (frames.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name} wants contiguous frames and ids")


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the library's ``apex_<name>`` on ``device``'s current stream,
    raise if the launch failed, else count it."""
    _LIB.launch(name, device, *args)
    LAUNCH_COUNTS[name] += 1


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
    _check("gather_rows", frames, ids, 1)
    n = ids.shape[0]
    out = torch.empty((n, frames.shape[1]), dtype=frames.dtype,
                      device=frames.device)
    if out.numel() == 0:            # nothing to launch
        return out
    _launch("gather_rows", frames.device, frames.data_ptr(), ids.data_ptr(),
            out.data_ptr(), n, frames.shape[0],
            frames.shape[1] * frames.element_size())
    return out


def _stacked_shape(frames: torch.Tensor, ids: torch.Tensor,
                   frame_shape) -> tuple[int, ...]:
    shape = tuple(frame_shape)
    if math.prod(shape) != frames.shape[1]:
        raise ValueError(f"frame_shape {shape} does not hold the ring's "
                         f"{frames.shape[1]}-element rows")
    n, s = ids.shape
    return (n, *shape[:-1], s * shape[-1])


def gather_stacks_reference(frames: torch.Tensor, ids: torch.Tensor,
                            frame_shape) -> torch.Tensor:
    """Plain version: gather the ``N*S`` rows, move the stack axis before
    the channel axis and lay the result out contiguously."""
    n, s = ids.shape
    rows = gather_rows_reference(frames, ids.reshape(-1))
    rows = rows.view(n, s, *frame_shape).movedim(1, -2)   # stack before channel
    return rows.reshape(_stacked_shape(frames, ids, frame_shape)).contiguous()


def gather_stacks(frames: torch.Tensor, ids: torch.Tensor,
                  frame_shape) -> torch.Tensor:
    """Frame stacks from a ring ``[F, D]`` (u8 or f32, contiguous) of
    frames of ``frame_shape`` (``(H, W, C)`` or ``(D,)``) by int32 ids
    ``[N, S]``, oldest frame first: returns the contiguous
    ``(N, *frame_shape[:-1], S * frame_shape[-1])`` tensor with
    ``out[n, h, w, s*C + c] = frames[ids[n, s], (h*W + w)*C + c]``.  Ids
    trap on the card as in :func:`gather_rows`."""
    if frames.device.type == "cpu":
        return gather_stacks_reference(frames, ids, frame_shape)
    _check("gather_stacks", frames, ids, 2)
    out = torch.empty(_stacked_shape(frames, ids, frame_shape),
                      dtype=frames.dtype, device=frames.device)
    if out.numel() == 0:            # nothing to launch
        return out
    n, s = ids.shape
    _launch("gather_stacks", frames.device, frames.data_ptr(), ids.data_ptr(),
            out.data_ptr(), n, s, frames.shape[0],
            math.prod(frame_shape[:-1]),
            frame_shape[-1] * frames.element_size())
    return out
