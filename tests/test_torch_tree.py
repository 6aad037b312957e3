"""Port of the segment trees against ``apex_tpu.ops.tree``, bit-exact.

Both sides do the same f32 additions and minima in the same tree order,
so every node must match bit for bit.  The stratified sample is fed the
uniforms JAX draws from its key, so the sampled indices match too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import tree as jt
from apex_tpu_torch.ops import tree as tt


def _updates(rng, capacity, n):
    """n leaf writes with duplicates; a duplicated index carries one value
    (the invariant both implementations rely on)."""
    idx = rng.integers(0, capacity, n).astype(np.int32)
    idx[-3:] = idx[0]
    per_leaf = rng.uniform(0.01, 5.0, capacity).astype(np.float32)
    return idx, per_leaf[idx]


@pytest.mark.parametrize("capacity", [64, 1024])
def test_updates_match_bit_exact(capacity):
    rng = np.random.default_rng(capacity)
    js, jm = jt.init_sum_tree(capacity), jt.init_min_tree(capacity)
    ts, tm = tt.init_sum_tree(capacity), tt.init_min_tree(capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tt.capacity_of(ts) == jt.capacity_of(js) == capacity
    assert tt.depth_of(ts) == jt.depth_of(js)
    for n in (5, 37, capacity // 2):
        idx, vals = _updates(rng, capacity, n)
        js, jm = jt.update_both(js, jm, jnp.asarray(idx), jnp.asarray(vals))
        tt.update_both(ts, tm, torch.from_numpy(idx), torch.from_numpy(vals))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    idx, vals = _updates(rng, capacity, 9)
    js = jt.update_sum(js, jnp.asarray(idx), jnp.asarray(vals))
    jm = jt.update_min(jm, jnp.asarray(idx), jnp.asarray(vals))
    np.testing.assert_array_equal(
        tt.update_sum(ts, torch.from_numpy(idx), torch.from_numpy(vals)).numpy(),
        np.asarray(js))
    np.testing.assert_array_equal(
        tt.update_min(tm, torch.from_numpy(idx), torch.from_numpy(vals)).numpy(),
        np.asarray(jm))
    assert tt.tree_total(ts).item() == float(jt.tree_total(js)) > 0
    assert tt.tree_min(tm).item() == float(jt.tree_min(jm))
    probe = rng.integers(0, capacity, 17).astype(np.int32)
    np.testing.assert_array_equal(
        tt.get_leaves(ts, torch.from_numpy(probe)).numpy(),
        np.asarray(jt.get_leaves(js, jnp.asarray(probe))))


def test_find_prefixsum_idx_matches_bit_exact():
    capacity = 256
    rng = np.random.default_rng(3)
    prios = rng.uniform(0.0, 2.0, capacity).astype(np.float32)
    prios[rng.integers(0, capacity, 40)] = 0.0      # empty leaves to skip
    all_idx = np.arange(capacity, dtype=np.int32)
    js = jt.update_sum(jt.init_sum_tree(capacity), jnp.asarray(all_idx),
                       jnp.asarray(prios))
    ts = tt.update_sum(tt.init_sum_tree(capacity), torch.from_numpy(all_idx),
                       torch.from_numpy(prios))
    total = float(js[1])
    # interior points plus exact prefix-sum boundaries (ties go right)
    u = np.concatenate([rng.uniform(0, total, 300),
                        np.cumsum(prios)[:50]]).astype(np.float32)
    got = tt.find_prefixsum_idx(ts, torch.from_numpy(u))
    want = np.asarray(jt.find_prefixsum_idx(js, jnp.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [100, 256])
def test_stratified_sample_matches_with_the_same_offsets(size):
    capacity, batch = 256, 32
    rng = np.random.default_rng(size)
    prios = np.zeros(capacity, np.float32)
    prios[:size] = rng.uniform(0.1, 3.0, size)
    all_idx = np.arange(capacity, dtype=np.int32)
    js = jt.update_sum(jt.init_sum_tree(capacity), jnp.asarray(all_idx),
                       jnp.asarray(prios))
    ts = tt.update_sum(tt.init_sum_tree(capacity), torch.from_numpy(all_idx),
                       torch.from_numpy(prios))
    key = jax.random.key(size)
    # the uniforms jt.stratified_sample draws internally from this key
    offsets = np.array(jax.random.uniform(key, (batch,), jnp.float32))
    # apexlint: disable=J004 -- parity test: the JAX sampler must redraw the offsets above from the same key
    want = np.asarray(jt.stratified_sample(js, key, batch, jnp.int32(size)))
    got = tt.stratified_sample(ts, torch.from_numpy(offsets), size)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max().item() < size


def test_stratified_offsets_are_uniform_draws_from_the_generator():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tt.stratified_offsets(64, g1)
    assert a.dtype == torch.float32 and a.shape == (64,)
    assert bool(((a >= 0) & (a < 1)).all())
    assert torch.equal(a, tt.stratified_offsets(64, g2))


def test_capacity_must_be_a_power_of_two():
    with pytest.raises(ValueError, match="power of 2"):
        tt.init_sum_tree(48)
