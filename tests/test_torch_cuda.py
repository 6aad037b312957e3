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
import time

import numpy as np
import pytest
import torch

from apex_tpu_torch.actors.pool import ActorPool
from apex_tpu_torch.config import ActorConfig, ApexConfig
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


def _ring(card, rows, d, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    if dtype == torch.uint8:
        frames = torch.empty((rows, d), dtype=dtype, device=card)
        return frames.random_(0, 256, generator=g)
    return torch.randn((rows, d), device=card, generator=g)


def _stack_ids(card, n, s, rows, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(0, rows, (n, s), dtype=torch.int32, device=card,
                        generator=g)
    ids[:3] = torch.tensor([[0] * s, [rows - 1] * s, [0, rows - 1] * (s // 2)
                            + [5] * (s % 2)], dtype=torch.int32)
    return ids


@pytest.mark.parametrize("shape,s,dtype", [
    ((84, 84, 1), 4, torch.uint8),      # bulk copies, 4x4 byte transpose
    ((84, 84, 1), 1, torch.uint8),      # one frame per sample: row gather
    ((84, 84, 3), 4, torch.uint8),      # bulk copies, byte interleave
    ((42, 42, 4), 2, torch.uint8),      # bulk copies, word interleave
    ((42, 42, 1), 4, torch.float32),    # f32: bulk copies, word interleave
    ((42, 42, 1), 4, torch.uint8),      # 1764-byte rows: byte path
    ((42, 42, 3), 3, torch.uint8),      # 5292-byte rows: byte path
    ((21, 21, 1), 4, torch.float32),    # 1764-byte rows: word path
    ((136,), 4, torch.float32),         # vector frames: row gather
    ((1763,), 4, torch.uint8),          # odd vector frames: byte rows
])
def test_gather_stacks_kernel_matches_plain_version(card, shape, s, dtype):
    rows = 2048
    frames = _ring(card, rows, int(np.prod(shape)), dtype, seed=s)
    ids = _stack_ids(card, 300, s, rows, seed=len(shape))
    before = dict(gather.LAUNCH_COUNTS)
    got = gather.gather_stacks(frames, ids, shape)
    torch.cuda.synchronize()
    assert gather.LAUNCH_COUNTS["gather_stacks"] == before["gather_stacks"] + 1
    assert gather.LAUNCH_COUNTS["gather_rows"] == before["gather_rows"]
    want = gather.gather_stacks_reference(frames, ids, shape)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [4, 1])
def test_unaligned_ring_views_take_the_register_paths(card, offset):
    """A ring whose base is 4- or 1-byte aligned but not 16: the bulk
    copies cannot take it, the register paths do, and stay exact."""
    rows, shape = 512, (84, 84, 1)
    d = int(np.prod(shape))
    buf = _ring(card, rows * d + 16, 1, torch.uint8, seed=offset).view(-1)
    frames = buf[offset:offset + rows * d].view(rows, d)
    assert frames.data_ptr() % 16 != 0
    ids = _stack_ids(card, 64, 4, rows, seed=offset)
    got = gather.gather_stacks(frames, ids, shape)
    flat = gather.gather_rows(frames, ids.view(-1))
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_stacks_reference(frames, ids, shape))
    assert torch.equal(flat, gather.gather_rows_reference(frames, ids.view(-1)))


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
    with pytest.raises(ValueError, match="frame_shape"):
        gather.gather_stacks(frames, ids.view(2, 2), (9, 7, 1))
    # an empty call launches nothing, and counts nothing
    before = dict(gather.LAUNCH_COUNTS)
    assert gather.gather_rows(frames, ids[:0]).shape == (0, 64)
    assert gather.gather_stacks(frames, ids.view(2, 2)[:0],
                                (8, 8, 1)).shape == (0, 8, 8, 2)
    assert gather.LAUNCH_COUNTS == before


def _launch_in_a_process_of_its_own(call: str):
    code = ("import torch\n"
            "from apex_tpu_torch.ops.gather import gather_rows, gather_stacks\n"
            "f = torch.zeros((8, 64), dtype=torch.uint8, device='cuda')\n"
            "ids = torch.tensor([1, 8], dtype=torch.int32, device='cuda')\n"
            f"{call}\n"
            "torch.cuda.synchronize()\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_gather_kernel_traps_an_id_outside_the_ring(card):
    """An out-of-range id fails the launch instead of reading past the
    ring.  The fault poisons the CUDA context, so it runs in a process of
    its own."""
    proc = _launch_in_a_process_of_its_own("gather_rows(f, ids)")
    assert proc.returncode != 0
    assert "CUDA error" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.parametrize("call", [
    "gather_stacks(f, ids.view(1, 2), (8, 8, 1))",                # bulk
    "gather_stacks(f[:, :63].contiguous(), ids.view(1, 2), (9, 7, 1))",
])
def test_gather_stacks_kernel_traps_an_id_outside_the_ring(card, call):
    proc = _launch_in_a_process_of_its_own(call)
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
    before = dict(gather.LAUNCH_COUNTS)
    got, got_w, got_idx = pool.sample(states[card], offsets.to(card), 0.4)
    torch.cuda.synchronize()
    # obs and next_obs come from one launch
    assert gather.LAUNCH_COUNTS == dict(before, gather_stacks=before[
        "gather_stacks"] + 1)
    assert torch.equal(got_idx.cpu(), want_idx)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key
    # the same f32 tree sums on both devices; pow may round differently
    torch.testing.assert_close(got_w.cpu(), want_w, rtol=1e-6, atol=0)


def _report_devices(actor_id, cfg, model_spec, chunk_queue, param_queue,
                    stat_queue, stop_event, epsilon, chunk_transitions):
    """A worker body (the pool's signature) that reports what it sees."""
    import os

    stat_queue.put((actor_id, torch.cuda.is_available(),
                    torch.cuda.device_count(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.get_num_threads()))


def test_spawned_actor_workers_see_no_cuda_device(card):
    """The learner's process holds a CUDA context; the actor processes it
    spawns see no card and run the intra-op threads the pool gave them."""
    torch.zeros(1, device=card)
    pool = ActorPool(ApexConfig(actor=ActorConfig(n_actors=2)), {},
                     chunk_transitions=16, worker_fn=_report_devices)
    pool.start()
    reports = []
    try:
        deadline = time.monotonic() + 120
        while len(reports) < 2 and time.monotonic() < deadline:
            reports.extend(pool.poll_stats())
            time.sleep(0.1)
    finally:
        pool.cleanup()
    assert sorted(r[0] for r in reports) == [0, 1]
    for _, available, count, visible, threads in reports:
        assert (available, count, visible) == (False, 0, "")
        assert threads == pool.threads
    assert not any(p.is_alive() for p in pool.procs)
    assert torch.cuda.is_available()       # the parent still has its card
