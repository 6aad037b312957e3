"""The segment-tree kernel (``apex_tree_update``) against the plain loop.

On the card :func:`apex_tpu_torch.ops.tree.update_both` (and
``update_sum``/``update_min`` alone) is one launch of the hand-written
kernel in ``apex_tpu_torch/ops/csrc/tree.cu``; on the CPU it is the loop of
gathers and scatters that ``tests/test_torch_tree.py`` holds against JAX.
Every parent is one f32 add or minimum of its two children, so the card's
trees must equal the CPU's bit for bit.  These tests need an NVIDIA card
with ``nvcc`` and skip without one.  The file imports neither JAX nor
``apex_tpu``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tree_kernel.py
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from apex_tpu_torch.models.dueling import DuelingDQN
from apex_tpu_torch.ops import tree
from apex_tpu_torch.ops.losses import make_optimizer
from apex_tpu_torch.replay.frame_chunks import FrameChunkBuilder
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.learner import LearnerCore
from apex_tpu_torch.training.state import create_train_state

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tree kernel has no CPU mode")
    return torch.device("cuda", 0)


def _filled_trees(capacity: int, seed: int):
    """CPU sum and min trees over random leaves, a few of them 0."""
    g = torch.Generator().manual_seed(seed)
    leaves = torch.rand(capacity, generator=g) * 4
    leaves[::7] = 0.0
    s, m = tree.init_sum_tree(capacity), tree.init_min_tree(capacity)
    idx = torch.arange(capacity)
    tree.update_both(s, m, idx, leaves)
    return s, m


def _update(capacity: int, k: int, seed: int, dtype=torch.int64):
    """``k`` indices with duplicates, and values that agree wherever the
    indices do (the trees' invariant)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, capacity, (k,), generator=g)
    idx[k // 2:] = idx[:k - k // 2].clone()                 # duplicates
    idx[0] = capacity - 1
    table = torch.rand(capacity, generator=g) * 3
    return idx.to(dtype), table[idx]


def _assert_trees_equal(card_tree: torch.Tensor, cpu_tree: torch.Tensor):
    torch.cuda.synchronize()
    got = card_tree.cpu()
    assert torch.equal(got[1:], cpu_tree[1:]), int((got != cpu_tree).sum())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k", [1, 64, 512, 2049])
@pytest.mark.parametrize("capacity", [2 ** 6, 2 ** 16, 2 ** 20])
def test_tree_kernel_matches_the_loop(card, capacity, k, dtype):
    cs, cm = _filled_trees(capacity, seed=capacity)
    ds, dm = cs.to(card), cm.to(card)
    for step in range(3):
        idx, vals = _update(capacity, k, seed=1000 * step + k, dtype=dtype)
        before = tree.LAUNCH_COUNTS["tree_update"]
        tree.update_both(ds, dm, idx.to(card), vals.to(card))
        assert tree.LAUNCH_COUNTS["tree_update"] == before + 1
        tree.update_both(cs, cm, idx, vals)
        _assert_trees_equal(ds, cs)
        _assert_trees_equal(dm, cm)


def test_fifty_updates_in_a_row_stay_bit_equal(card):
    """The learner's pattern at capacity 2^16: a ring write of 64
    consecutive leaves, then a write-back of 512 sampled ones."""
    capacity = 2 ** 16
    cs, cm = tree.init_sum_tree(capacity), tree.init_min_tree(capacity)
    ds, dm = cs.to(card), cm.to(card)
    g = torch.Generator().manual_seed(5)
    for step in range(50):
        ring = (step * 64 + torch.arange(64)) % capacity
        vals = torch.rand(64, generator=g)
        tree.update_both(cs, cm, ring, vals)
        tree.update_both(ds, dm, ring.to(card), vals.to(card))
        idx, vals = _update(step * 64 + 64, 512, seed=step)
        tree.update_both(cs, cm, idx, vals)
        tree.update_both(ds, dm, idx.to(card), vals.to(card))
    _assert_trees_equal(ds, cs)
    _assert_trees_equal(dm, cm)


def test_update_sum_and_update_min_alone(card):
    capacity = 2 ** 16
    cs, cm = _filled_trees(capacity, seed=3)
    ds, dm = cs.to(card), cm.to(card)
    idx, vals = _update(capacity, 512, seed=4, dtype=torch.int32)
    before = tree.LAUNCH_COUNTS["tree_update"]
    assert tree.update_sum(ds, idx.to(card), vals.to(card)) is ds
    _assert_trees_equal(ds, tree.update_sum(cs, idx, vals))
    _assert_trees_equal(dm, cm)                  # the min tree untouched
    assert tree.update_min(dm, idx.to(card), vals.to(card)) is dm
    _assert_trees_equal(dm, tree.update_min(cm, idx, vals))
    assert tree.LAUNCH_COUNTS["tree_update"] == before + 2


def test_a_nan_leaf_propagates_as_torch_minimum_does(card):
    capacity = 2 ** 10
    cs, cm = _filled_trees(capacity, seed=6)
    ds, dm = cs.to(card), cm.to(card)
    idx = torch.tensor([17, 17, 600])
    vals = torch.tensor([float("nan"), float("nan"), 0.5])
    tree.update_both(cs, cm, idx, vals)
    tree.update_both(ds, dm, idx.to(card), vals.to(card))
    torch.cuda.synchronize()
    for got, want in ((ds.cpu(), cs), (dm.cpu(), cm)):
        assert torch.equal(got.isnan(), want.isnan())
        assert bool(got[1].isnan())
        keep = ~want.isnan()
        assert torch.equal(got[keep][1:], want[keep][1:])


def test_frame_pool_trees_match_on_the_card_and_the_cpu(card):
    """One replay at capacity 2^16 on each device, driven through 50
    ingests of 64 transitions and 50 priority write-backs of 512."""
    pool = FramePoolReplay(capacity=2 ** 16, frame_shape=(4,), frame_stack=4,
                           frame_dtype="float32")
    on_cpu, on_card = pool.init("cpu"), pool.init(card)
    rng = np.random.default_rng(7)
    kf, k = 80, 64
    for step in range(50):
        n_trans = 64 if step % 5 else 40        # some chunks carry pad rows
        prios = rng.uniform(0.01, 5, k).astype(np.float32)
        prios[n_trans:] = prios[n_trans - 1]
        chunk = {
            "frames": rng.normal(size=(kf, 4)).astype(np.float32),
            "n_frames": np.int32(kf), "n_trans": np.int32(n_trans),
            "action": rng.integers(0, 3, k).astype(np.int32),
            "reward": rng.normal(size=k).astype(np.float32),
            "discount": np.full(k, 0.97, np.float32),
            "obs_ref": rng.integers(0, kf, (k, 4)).astype(np.int32),
            "next_ref": rng.integers(0, kf, (k, 4)).astype(np.int32),
        }
        pool.add(on_cpu, chunk, prios)
        pool.add(on_card, chunk, prios)
        idx = torch.from_numpy(rng.integers(0, on_cpu.size, 512))
        table = torch.from_numpy(rng.uniform(0, 8, pool.capacity)
                                 .astype(np.float32))
        pool.update_priorities(on_cpu, idx, table[idx])
        pool.update_priorities(on_card, idx.to(card), table[idx].to(card))
    _assert_trees_equal(on_card.sum_tree, on_cpu.sum_tree)
    _assert_trees_equal(on_card.min_tree, on_cpu.min_tree)
    assert float(on_card.max_priority) == float(on_cpu.max_priority)


def _chunks(n: int, shape=(42, 42, 1)):
    rng = np.random.default_rng(0)
    b = FrameChunkBuilder(3, 0.99, 4, shape, chunk_transitions=24)
    out = []
    while len(out) < n:
        b.begin_episode(rng.integers(0, 255, shape).astype(np.uint8))
        for t in range(30):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, shape).astype(np.uint8),
                       t == 29, False)
        out.extend(b.poll())
    return out[:n]


def test_a_fused_step_launches_the_tree_kernel_twice(card):
    """One launch at ingest, one at the priority write-back."""
    pool = FramePoolReplay(capacity=2 ** 10, frame_shape=(42, 42, 1),
                           frame_stack=4)
    core = LearnerCore(replay=pool, optimizer=make_optimizer(lr=1e-3),
                       batch_size=32, target_update_interval=2)
    model = DuelingDQN(3, (42, 42, 4),
                       generator=torch.Generator().manual_seed(0)).to(card)
    ts = create_train_state(model, core.optimizer)
    rs = pool.init(card)
    chunks = _chunks(6)
    for chunk in chunks[:2]:
        core.ingest(rs, chunk, chunk.pop("priorities"))
    g = torch.Generator(device=card).manual_seed(1)
    before = tree.LAUNCH_COUNTS["tree_update"]
    for chunk in chunks[2:]:
        offsets = tree.stratified_offsets(32, g, card)
        ts, rs, _ = core.fused_step(ts, rs, chunk, chunk.pop("priorities"),
                                    offsets, 0.4)
    torch.cuda.synchronize()
    assert tree.LAUNCH_COUNTS["tree_update"] - before == 2 * 4
    assert float(rs.sum_tree[1]) > 0


def test_tree_kernel_refuses_what_it_cannot_take(card):
    s = tree.init_sum_tree(64, card)
    m = tree.init_min_tree(64, card)
    idx = torch.arange(4, device=card)
    vals = torch.ones(4, device=card)
    with pytest.raises(ValueError, match="f32"):
        tree.update_sum(s.double(), idx, vals)
    with pytest.raises(ValueError, match="contiguous"):
        tree.update_sum(torch.zeros(256, device=card)[::2], idx, vals)
    with pytest.raises(ValueError, match="must be on"):
        tree.update_both(s, m, idx.cpu(), vals)
    with pytest.raises(ValueError, match="differ"):
        tree.update_both(s, tree.init_min_tree(32, card), idx, vals)
    # an empty update launches nothing, and counts nothing
    before = dict(tree.LAUNCH_COUNTS)
    tree.update_both(s, m, idx[:0], vals[:0])
    assert tree.LAUNCH_COUNTS == before


def test_tree_kernel_traps_an_index_outside_the_tree(card):
    """The fault poisons the CUDA context, so it runs in a process of its
    own."""
    code = ("import torch\n"
            "from apex_tpu_torch.ops import tree\n"
            "s = tree.init_sum_tree(64, 'cuda')\n"
            "m = tree.init_min_tree(64, 'cuda')\n"
            "idx = torch.tensor([3, 64], device='cuda')\n"
            "tree.update_both(s, m, idx, torch.ones(2, device='cuda'))\n"
            "torch.cuda.synchronize()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA error" in proc.stderr, proc.stderr[-2000:]
