"""Port of the frame-ring gathers: the plain versions against the JAX paths.

On the CPU ``apex_tpu_torch.ops.gather.gather_rows`` and ``gather_stacks``
run their plain versions; the CUDA kernels themselves are held against
those on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
A gather is a copy, so every comparison here is bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.gather import gather_rows as jax_gather_rows
from apex_tpu_torch.ops.gather import (LAUNCH_COUNTS, gather_rows,
                                       gather_rows_reference, gather_stacks,
                                       gather_stacks_reference)


@pytest.mark.parametrize("n,f,d,dtype", [
    (32, 64, 256, np.uint8),        # aligned rows
    (13, 16, 2048, np.uint8),       # 42x42 rows as the JAX ring pads them
    (48, 128, 136, np.float32),     # f32 vector rows
])
def test_gather_matches_jax_take_and_interpret_kernel(n, f, d, dtype):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (f, d)).astype(dtype)
    ids = rng.integers(0, f, n).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(frames), jnp.asarray(ids),
                                      mode="xla"))
    interp = np.asarray(jax_gather_rows(jnp.asarray(frames),
                                        jnp.asarray(ids), mode="interpret"))
    got = gather_rows(torch.from_numpy(frames), torch.from_numpy(ids))
    assert got.dtype == torch.from_numpy(frames).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), interp)


@pytest.mark.parametrize("d", [1764, 1763])
def test_gather_unpadded_rows_match_jax_take(d):
    """The port's ring is unpadded: 42x42 rows (1764 B, the kernel's
    4-byte path) and odd rows (its byte path).  The JAX kernel cannot take
    these (rows must be a multiple of 8), so the reference is jnp.take."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (24, d)).astype(np.uint8)
    ids = rng.integers(0, 24, 40).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(frames), jnp.asarray(ids),
                                      mode="xla"))
    got = gather_rows(torch.from_numpy(frames), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_repeated_and_boundary_ids():
    frames = np.arange(8 * 384, dtype=np.uint8).reshape(8, 384)
    ids = np.asarray([0, 7, 7, 3, 0, 0, 7, 1, 2], np.int32)
    interp = np.asarray(jax_gather_rows(jnp.asarray(frames), jnp.asarray(ids),
                                        mode="interpret"))
    got = gather_rows(torch.from_numpy(frames), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), frames[ids])
    np.testing.assert_array_equal(got.numpy(), interp)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    frames = torch.arange(16 * 8, dtype=torch.uint8).reshape(16, 8)
    ids = torch.tensor([3, 3, 15], dtype=torch.int32)
    before = LAUNCH_COUNTS["gather_rows"]
    got = gather_rows(frames, ids)
    assert LAUNCH_COUNTS["gather_rows"] == before
    assert torch.equal(got, gather_rows_reference(frames, ids))
    assert torch.equal(got, frames[[3, 3, 15]])



# -- gather_stacks: the frame stacks of FramePoolReplay.sample ---------------

ROW_UNIT = 8 * 128          # the JAX pool pads rows to whole (8, 128) tiles


def _jax_stacks(frames, ids, shape, mode):
    """``apex_tpu/replay/frame_pool.py:_gather_stacks`` on a ring padded to
    whole tiles, as the JAX pool stores it: the row gather, the padding
    dropped, then moveaxis/reshape."""
    f, d = frames.shape
    ring = np.zeros((f, -(-d // ROW_UNIT) * ROW_UNIT), frames.dtype)
    ring[:, :d] = frames
    n, s = ids.shape
    rows = jax_gather_rows(jnp.asarray(ring), jnp.asarray(ids.reshape(-1)),
                           mode=mode)[:, :d]
    rows = jnp.moveaxis(rows.reshape(n, s, *shape), 1, -2)
    return np.asarray(rows.reshape(n, *shape[:-1], s * shape[-1]))


@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("shape,dtype", [((84, 84, 1), np.uint8),
                                         ((42, 42, 3), np.uint8),
                                         ((136,), np.float32)])
def test_gather_stacks_matches_jax_pool_layout(shape, dtype, s, mode):
    rng = np.random.default_rng(len(shape) + s)
    f = 12
    frames = rng.integers(0, 255, (f, int(np.prod(shape)))).astype(dtype)
    ids = rng.integers(0, f, (7, s)).astype(np.int32)
    ids[0], ids[1] = f - 1, ids[2]                 # boundary and repeated ids
    want = _jax_stacks(frames, ids, shape, mode)
    got = gather_stacks(torch.from_numpy(frames), torch.from_numpy(ids),
                        shape)
    assert got.shape == want.shape == (7, *shape[:-1], s * shape[-1])
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_stacks_on_cpu_takes_the_plain_version_and_counts_no_launch():
    frames = torch.arange(6 * 12, dtype=torch.uint8).reshape(6, 12)
    ids = torch.tensor([[0, 5], [5, 5], [2, 1]], dtype=torch.int32)
    before = dict(LAUNCH_COUNTS)
    got = gather_stacks(frames, ids, (2, 3, 2))
    assert LAUNCH_COUNTS == before
    assert torch.equal(got, gather_stacks_reference(frames, ids, (2, 3, 2)))
    # out[n, h, w, s*C + c] = frames[ids[n, s], (h*W + w)*C + c]
    want = frames[ids.long()].view(3, 2, 2, 3, 2).permute(0, 2, 3, 1, 4)
    assert torch.equal(got, want.reshape(3, 2, 3, 4))
