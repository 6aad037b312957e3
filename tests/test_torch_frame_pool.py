"""Port of the frame-pool replay and its chunk builder against ``apex_tpu``.

The same chunk stream goes into ``apex_tpu``'s ``FramePoolReplay`` and the
port's; state and samples must agree bit for bit.  The JAX ring stores
rows padded to whole (8, 128) tiles, so its rows are compared through
``rows[:, :frame_dim]``.

One tolerance: the trees hold ``priority ** alpha``, and XLA's and
PyTorch's f32 ``pow`` differ in the last place on about 2% of inputs.  The
bit-exact tests therefore run at ``alpha = 1`` (no rounding in the leaf
values); at the default ``alpha = 0.6`` the leaves and IS weights are held
to rtol 1e-6 (a few ulps) and everything else stays bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.actors.pool import drain_builder_chunks as jax_drain
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu.replay.frame_pool import FramePoolReplay as JaxPool
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.replay import frame_pool as frame_pool_module
from apex_tpu_torch.replay.frame_pool import FramePoolReplay

SHAPE = (42, 42, 1)
S = 4


def _drive(builders, rng, episodes=5, ep_len=(1, 30), extras=False,
           flush=True, shape=SHAPE):
    """Feed identical trajectories to every builder; returns the chunks
    each emitted (poll, then force_flush when ``flush``)."""
    out = [[] for _ in builders]
    for _ in range(episodes):
        f0 = rng.integers(0, 255, shape).astype(np.uint8)
        for b in builders:
            b.begin_episode(f0)
        n = int(rng.integers(*ep_len))
        truncated_end = bool(rng.random() < 0.3)
        for t in range(n):
            last = t == n - 1
            args = (int(rng.integers(0, 3)), float(rng.normal()),
                    rng.normal(size=3).astype(np.float32),
                    rng.integers(0, 255, shape).astype(np.uint8),
                    last and not truncated_end, last and truncated_end)
            ex = ({"a_mu": rng.normal(size=(2, 3)).astype(np.float32)}
                  if extras else None)
            for b in builders:
                b.add_step(*args, extras=ex)
        if flush:
            for i, b in enumerate(builders):
                out[i].extend(b.poll())
    if flush:
        for i, b in enumerate(builders):
            out[i].extend(b.force_flush())
    return out


@pytest.mark.parametrize("chunk_transitions,extras", [(8, False), (32, True)])
def test_chunk_streams_are_equal(chunk_transitions, extras):
    kw = dict(chunk_transitions=chunk_transitions, frame_margin=6,
              extra_shapes={"a_mu": (2, 3)} if extras else None)
    jb = JaxBuilder(3, 0.99, S, SHAPE, **kw)
    tb = FrameChunkBuilder(3, 0.99, S, SHAPE, **kw)
    want, got = _drive([jb, tb], np.random.default_rng(0), extras=extras)
    assert len(want) == len(got) > 2
    for cw, cg in zip(want, got):
        assert cw.keys() == cg.keys()
        for k in cw:
            if k == "extras":
                np.testing.assert_array_equal(cg[k]["a_mu"], cw[k]["a_mu"])
            else:
                np.testing.assert_array_equal(cg[k], cw[k])


def test_drained_messages_match(monkeypatch):
    monkeypatch.setenv("APEX_OBS_SPANS", "0")     # the port ships no spans
    jb = JaxBuilder(3, 0.99, S, SHAPE, chunk_transitions=8)
    tb = FrameChunkBuilder(3, 0.99, S, SHAPE, chunk_transitions=8)
    _drive([jb, tb], np.random.default_rng(1), episodes=3, ep_len=(10, 20),
           flush=False)
    want, got = jax_drain(jb), drain_builder_chunks(tb)
    assert len(want) == len(got) > 0
    for mw, mg in zip(want, got):
        assert mw.keys() == mg.keys() == {"payload", "priorities", "n_trans"}
        assert mw["n_trans"] == mg["n_trans"]
        np.testing.assert_array_equal(mg["priorities"], mw["priorities"])
        np.testing.assert_array_equal(mg["payload"]["frames"],
                                      mw["payload"]["frames"])


def _assert_state_equal(jpool, js, ts, leaves_rtol=None):
    f = jpool.f_capacity
    jframes = np.asarray(js.frames).reshape(f, -1)[:, :jpool.frame_dim]
    np.testing.assert_array_equal(ts.frames.numpy(), jframes)
    for name in ("action", "reward", "discount", "obs_ids", "next_ids",
                 "frame_epoch"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in ("sum_tree", "min_tree"):
        got, want = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        if leaves_rtol is None:
            np.testing.assert_array_equal(got, want, name)
        else:
            np.testing.assert_allclose(got, want, rtol=leaves_rtol,
                                       err_msg=name)
    assert (ts.pos, ts.f_epoch, ts.size) == (int(js.pos), int(js.f_epoch),
                                             int(js.size))
    assert ts.max_priority.item() == float(js.max_priority)


def _chunk_stream(seed, n_chunks_min=6, shape=SHAPE):
    rng = np.random.default_rng(seed)
    b = JaxBuilder(3, 0.99, S, shape, chunk_transitions=16)
    chunks = _drive([b], rng, episodes=8, ep_len=(5, 40), shape=shape)[0]
    assert len(chunks) >= n_chunks_min
    return chunks


@pytest.mark.parametrize("alpha,rtol,shape", [
    pytest.param(1.0, None, SHAPE, id="1.0-None"),
    pytest.param(0.6, 1e-6, SHAPE, id="0.6-1e-06"),
    pytest.param(1.0, None, (42, 42, 3), id="1.0-None-42x42x3"),
    pytest.param(1.0, None, (136,), id="1.0-None-136"),
])
def test_add_sample_update_match(alpha, rtol, shape, monkeypatch):
    """Chunks wrap both rings several times; after every add the states
    agree, and samples from the same uniforms return the same batch.  One
    ``gather_stacks`` call per sample builds obs and next_obs, as the two
    halves of one tensor, which the batch carries as ``obs_pair``."""
    calls = []
    real = frame_pool_module.gather_stacks
    monkeypatch.setattr(frame_pool_module, "gather_stacks",
                        lambda *args: calls.append(args) or real(*args))
    jpool = JaxPool(capacity=64, frame_shape=shape, frame_stack=S,
                    alpha=alpha)
    tpool = FramePoolReplay(capacity=64, frame_shape=shape, frame_stack=S,
                            alpha=alpha)
    js, ts = jpool.init(), tpool.init("cpu")
    _assert_state_equal(jpool, js, ts)
    add = jax.jit(jpool.add)
    sample = jax.jit(jpool.sample, static_argnums=(2,))
    update = jax.jit(jpool.update_priorities)
    for i, chunk in enumerate(_chunk_stream(seed=2, shape=shape)):
        prios = chunk.pop("priorities")
        js = add(js, {k: jnp.asarray(v) for k, v in chunk.items()},
                 jnp.asarray(prios))
        tpool.add(ts, chunk, prios)
        _assert_state_equal(jpool, js, ts, rtol)

        key = jax.random.key(i)
        offsets = np.array(jax.random.uniform(key, (16,), jnp.float32))
        # apexlint: disable=J004 -- parity test: JAX redraws the offsets above from the same key
        jb, jw, jidx = sample(js, key, 16, 0.4)
        calls.clear()
        tb, tw, tidx = tpool.sample(ts, torch.from_numpy(offsets), 0.4)
        assert len(calls) == 1
        pair = tb.pop("obs_pair")
        assert pair.data_ptr() == tb["obs"].data_ptr()
        assert torch.equal(pair, torch.cat([tb["obs"], tb["next_obs"]]))
        assert tb["next_obs"].data_ptr() == pair.data_ptr() + tb["obs"].nbytes
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        for k in jb:
            assert tb[k].shape == jb[k].shape, k
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), k)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)

        # a function of the index, so duplicated indices carry one value
        new_p = (np.asarray(jidx) % 7 + 1).astype(np.float32) * 0.3
        js = update(js, jidx, jnp.asarray(new_p))
        tpool.update_priorities(ts, tidx, torch.from_numpy(new_p))
        _assert_state_equal(jpool, js, ts, rtol)


def test_stale_transitions_redirect_to_newest_slot():
    """Mirror of tests/test_frame_pool.py's staleness test on both sides:
    frames outpace transitions, age out of the ring, and sampling
    redirects the stale transitions to the newest slot."""
    shape = (8, 8, 1)
    jpool = JaxPool(capacity=16, frame_shape=shape, frame_stack=2,
                    frame_capacity=8)
    tpool = FramePoolReplay(capacity=16, frame_shape=shape, frame_stack=2,
                            frame_capacity=8)
    js, ts = jpool.init(), tpool.init("cpu")
    for tag in range(1, 4):          # 3 chunks: 24 frame epochs >> F=8
        refs = np.stack([np.arange(4), np.arange(4) + 1], 1).astype(np.int32)
        chunk = dict(frames=np.full((8, 64), tag, np.uint8),
                     n_frames=np.int32(8), n_trans=np.int32(4),
                     action=np.full(4, tag % 3, np.int32),
                     reward=np.full(4, float(tag), np.float32),
                     discount=np.full(4, 0.97, np.float32),
                     obs_ref=refs, next_ref=refs + 2)
        js = jpool.add(js, chunk, jnp.full(4, 1.0))
        tpool.add(ts, chunk, np.full(4, 1.0, np.float32))
    key = jax.random.key(0)
    offsets = np.array(jax.random.uniform(key, (64,), jnp.float32))
    # apexlint: disable=J004 -- parity test: JAX redraws the offsets above from the same key
    jb, jw, jidx = jpool.sample(js, key, 64, jnp.float32(0.4))
    tb, tw, tidx = tpool.sample(ts, torch.from_numpy(offsets), 0.4)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    newest = (ts.pos - 1) % 16
    assert set(tidx.tolist()) <= {8, 9, 10, 11, newest}
    assert bool((tb["obs"] == 3).all())
    np.testing.assert_array_equal(tb["obs"].numpy(), np.asarray(jb["obs"]))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


def test_valid_mask_and_epoch_offsets():
    """``valid=False`` leaves every field untouched, ``valid=True`` is the
    unmasked add, and ``epoch_off`` shifts the recorded epochs: all as the
    JAX add does."""
    jpool = JaxPool(capacity=64, frame_shape=SHAPE, frame_stack=S,
                    alpha=1.0)
    tpool = FramePoolReplay(capacity=64, frame_shape=SHAPE, frame_stack=S,
                            alpha=1.0)
    js, ts = jpool.init(), tpool.init("cpu")
    chunks = _chunk_stream(seed=3)
    for chunk in chunks[:2]:
        prios = chunk.pop("priorities")
        js = jpool.add(js, chunk, jnp.asarray(prios))
        tpool.add(ts, chunk, prios)
    chunk = chunks[2]
    prios = chunk.pop("priorities")
    chunk["epoch_off"] = np.arange(16, dtype=np.int32) * 3

    js_off = jpool.add(js, chunk, jnp.asarray(prios), valid=jnp.bool_(False))
    tpool.add(ts, chunk, prios, valid=torch.tensor(False))
    _assert_state_equal(jpool, js_off, ts)
    _assert_state_equal(jpool, js, ts)

    js = jpool.add(js, chunk, jnp.asarray(prios), valid=jnp.bool_(True))
    tpool.add(ts, chunk, prios, valid=True)
    _assert_state_equal(jpool, js, ts)
    pos = ts.pos
    assert ts.frame_epoch[pos - 1].item() != ts.frame_epoch[pos - 2].item()


def test_hbm_bytes_estimate_matches_allocated_state():
    pool = FramePoolReplay(capacity=64, frame_shape=SHAPE, frame_stack=S)
    state = pool.init("cpu")
    actual = sum(t.numel() * t.element_size()
                 for t in (state.frames, state.action, state.reward,
                           state.discount, state.obs_ids, state.next_ids,
                           state.frame_epoch, state.sum_tree, state.min_tree))
    assert pool.hbm_bytes() == actual


def test_add_rejects_oversized_and_misshapen_chunks():
    pool = FramePoolReplay(capacity=8, frame_capacity=16, frame_shape=SHAPE,
                           frame_stack=2)
    state = pool.init("cpu")
    rng = np.random.default_rng(0)

    def chunk(k, kf):
        return dict(frames=rng.integers(0, 255, (kf, pool.frame_dim),
                                        dtype=np.uint8),
                    n_frames=np.int32(kf), n_trans=np.int32(k),
                    action=np.zeros(k, np.int32),
                    reward=np.zeros(k, np.float32),
                    discount=np.zeros(k, np.float32),
                    obs_ref=np.zeros((k, 2), np.int32),
                    next_ref=np.zeros((k, 2), np.int32))

    with pytest.raises(ValueError, match="frame rows"):
        pool.add(state, chunk(4, 32), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="transition rows"):
        pool.add(state, chunk(16, 8), np.ones(16, np.float32))
    bad = chunk(4, 8)
    bad["frames"] = bad["frames"][:, :-1]
    with pytest.raises(ValueError, match="frame_dim"):
        pool.add(state, bad, np.ones(4, np.float32))
    bad = chunk(4, 8)
    bad["obs_ref"] = np.zeros((4, 3), np.int32)
    with pytest.raises(ValueError, match="obs_ref"):
        pool.add(state, bad, np.ones(4, np.float32))
    pool.add(state, chunk(4, 8), np.ones(4, np.float32))
    assert state.size == 4
