"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card with ``nvcc`` (the kernels build from
``apex_tpu_torch/ops/csrc`` at first use).  Without one they skip.  The
file imports neither JAX nor ``apex_tpu``, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

A gather is a copy, so every comparison is bit-exact.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import gather
from apex_tpu_torch.replay.frame_pool import FramePoolReplay

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,d,dtype", [
    (4096, 7056, torch.uint8),      # 84x84 frames: 16-byte copies
    (4096, 1764, torch.uint8),      # 42x42 frames: 4-byte copies
    (4096, 1763, torch.uint8),      # odd rows: byte copies
    (1024, 1024, torch.float32),    # f32 rows
])
def test_gather_kernel_matches_plain_version(card, rows, d, dtype):
    g = torch.Generator(device=card).manual_seed(d)
    if dtype == torch.uint8:
        frames = torch.empty((rows, d), dtype=dtype, device=card)
        frames.random_(0, 256, generator=g)
    else:
        frames = torch.randn((rows, d), device=card, generator=g)
    ids = torch.randint(0, rows, (2048,), dtype=torch.int32, device=card,
                        generator=g)
    ids[:6] = torch.tensor([0, rows - 1, rows - 1, 0, 5, 5])
    before = gather.LAUNCH_COUNTS["gather_rows"]
    got = gather.gather_rows(frames, ids)
    torch.cuda.synchronize()
    assert gather.LAUNCH_COUNTS["gather_rows"] == before + 1
    assert torch.equal(got, gather.gather_rows_reference(frames, ids))


def test_gather_kernel_refuses_what_it_cannot_take(card):
    frames = torch.zeros((16, 64), dtype=torch.uint8, device=card)
    ids = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(frames, ids.long())
    with pytest.raises(ValueError, match="u8 or f32"):
        gather.gather_rows(frames.half(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(frames[:, ::2], ids)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_rows(frames, ids.cpu())
    assert gather.gather_rows(frames, ids[:0]).shape == (0, 64)


def test_gather_kernel_traps_an_id_outside_the_ring(card):
    """An out-of-range id fails the launch instead of reading past the
    ring.  The fault poisons the CUDA context, so it runs in a process of
    its own."""
    code = ("import torch\n"
            "from apex_tpu_torch.ops.gather import gather_rows\n"
            "f = torch.zeros((8, 64), dtype=torch.uint8, device='cuda')\n"
            "ids = torch.tensor([1, 8], dtype=torch.int32, device='cuda')\n"
            "gather_rows(f, ids)\n"
            "torch.cuda.synchronize()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA error" in proc.stderr, proc.stderr[-2000:]


def test_frame_pool_sample_on_the_card_matches_the_cpu(card):
    """Same chunks and uniforms on both devices: the card's batch (through
    the kernel) equals the CPU's (through the plain version)."""
    rng = np.random.default_rng(0)
    shape, s, k, kf, b = (42, 42, 1), 4, 64, 80, 32
    pool = FramePoolReplay(capacity=256, frame_shape=shape, frame_stack=s)
    states = {dev: pool.init(dev) for dev in ("cpu", card)}
    for _ in range(3):
        refs = np.sort(rng.integers(0, kf - 1, (k, s)), axis=1).astype(np.int32)
        chunk = dict(frames=rng.integers(0, 255, (kf, 42 * 42), np.uint8),
                     n_frames=np.int32(kf), n_trans=np.int32(k),
                     action=rng.integers(0, 3, k).astype(np.int32),
                     reward=rng.normal(size=k).astype(np.float32),
                     discount=np.full(k, 0.97, np.float32),
                     obs_ref=refs, next_ref=refs + 1)
        prios = np.abs(rng.normal(size=k)).astype(np.float32) + 0.1
        for state in states.values():
            pool.add(state, chunk, prios)
    offsets = torch.from_numpy(rng.random(b, dtype=np.float32))
    want, want_w, want_idx = pool.sample(states["cpu"], offsets, 0.4)
    before = gather.LAUNCH_COUNTS["gather_rows"]
    got, got_w, got_idx = pool.sample(states[card], offsets.to(card), 0.4)
    torch.cuda.synchronize()
    assert gather.LAUNCH_COUNTS["gather_rows"] == before + 2
    assert torch.equal(got_idx.cpu(), want_idx)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key
    # the same f32 tree sums on both devices; pow may round differently
    torch.testing.assert_close(got_w.cpu(), want_w, rtol=1e-6, atol=0)
