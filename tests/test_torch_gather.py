"""Port of the frame-ring gather: the plain version against the JAX paths.

On the CPU ``apex_tpu_torch.ops.gather.gather_rows`` runs its plain
version; the CUDA kernel itself is held against that plain version on the
card by ``chip_smoke.py``.  A gather is a copy, so every comparison here
is bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.gather import gather_rows as jax_gather_rows
from apex_tpu_torch.ops.gather import (LAUNCH_COUNTS, gather_rows,
                                       gather_rows_reference)


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

