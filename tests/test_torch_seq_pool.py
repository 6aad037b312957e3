"""Port of the sequence builder, the sequence messages and the pooled
sequence replay against ``apex_tpu``.

One episode stream goes into both packages' ``SequenceBuilder`` (stacked
and pooled); the sequences, the messages made of them and the replay
states after each ingest must agree bit for bit, and samples from the
same uniforms return the same batch.  The JAX side gathers through the
Pallas kernel in interpret mode and through ``jnp.take``.  As in
``tests/test_torch_frame_pool.py``, the bit-exact replay runs take
``alpha = 1``; at the default 0.6 the trees' leaves and the IS weights
are held to rtol 1e-6 (XLA's and PyTorch's ``pow`` differ in the last
place).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.actors.r2d2 import drain_grouped as jax_drain_grouped
from apex_tpu.actors.r2d2 import \
    pooled_sequence_message as jax_pooled_message
from apex_tpu.actors.r2d2 import sequence_message as jax_sequence_message
from apex_tpu.replay.seq_pool import SequenceFramePoolReplay as JaxSeqPool
from apex_tpu.training.r2d2 import SequenceBuilder as JaxBuilder
from apex_tpu_torch.actors.r2d2 import (drain_grouped,
                                        pooled_sequence_message,
                                        sequence_message)
from apex_tpu_torch.convert import seq_pool_state_from_jax
from apex_tpu_torch.replay import seq_pool as seq_pool_module
from apex_tpu_torch.replay.seq_pool import SequenceFramePoolReplay
from apex_tpu_torch.training.r2d2 import SequenceBuilder

BURN, UNROLL, NSTEP = 2, 4, 1
T_TOTAL = BURN + UNROLL + NSTEP
H = 8
SHAPE = (42, 42, 1)            # the JAX ring pads these rows to 2048
GROUP = 4


def _feed(builder, rng, shape=SHAPE, lengths=(9, 4, 15, 1, 7, 12, 3, 20),
          with_q=True):
    """An episode stream with terminated and truncated ends, episodes
    shorter than the burn-in and (``with_q``) acting-time Q vectors."""
    for e, n in enumerate(lengths):
        truncated = e % 3 == 2
        for t in range(n):
            need = builder.needs_carry
            builder.add_step(
                rng.integers(1, 255, shape).astype(np.uint8),
                int(rng.integers(0, 3)), float(rng.normal()),
                terminated=(t == n - 1 and not truncated),
                carry_c=(rng.normal(size=H).astype(np.float32) if need
                         else None),
                carry_h=(rng.normal(size=H).astype(np.float32) if need
                         else None),
                q_values=(rng.normal(size=3).astype(np.float32) if with_q
                          else None))
        builder.end_episode(truncated=truncated)


def _builders(pooled, seed=0, stride=3, **kw):
    out = []
    for cls in (JaxBuilder, SequenceBuilder):
        b = cls(BURN, UNROLL, NSTEP, gamma=0.9, stride=stride, pooled=pooled)
        _feed(b, np.random.default_rng(seed), **kw)
        out.append(b)
    return out


def _assert_seqs_equal(a, b):
    assert len(a) == len(b) > 0
    for sa, sb in zip(a, b):
        assert sa.keys() == sb.keys()
        for k in sa:
            if k == "ep_frames":
                np.testing.assert_array_equal(sa[k], sb[k])
            else:
                assert np.asarray(sa[k]).dtype == np.asarray(sb[k]).dtype, k
                np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("pooled", [False, True], ids=["stacked", "pooled"])
@pytest.mark.parametrize("with_q", [True, False], ids=["q", "no-q"])
def test_builder_sequences_match_jax(pooled, with_q):
    """Windows, padding, the truncation mask, the stored carries,
    acting-time priorities (1 without Q vectors) and ``n_new``."""
    jb, tb = _builders(pooled, with_q=with_q)
    jseqs, tseqs = jb.drain(), tb.drain()
    _assert_seqs_equal(jseqs, tseqs)
    assert sum(s["n_new"] for s in tseqs) == 9 + 4 + 15 + 7 + 12 + 3 + 20
    assert any(not s["mask"][BURN:].all() for s in tseqs)     # truncations
    if not with_q:
        assert all(s["priority"] == 1.0 for s in tseqs)
    assert tb.drain() == []


def test_builder_contract_checks():
    with pytest.raises(ValueError, match="stride <= t_total"):
        SequenceBuilder(BURN, UNROLL, NSTEP, gamma=0.9, stride=T_TOTAL + 1,
                        pooled=True)
    SequenceBuilder(BURN, UNROLL, NSTEP, gamma=0.9, stride=T_TOTAL + 1)
    b = SequenceBuilder(BURN, UNROLL, NSTEP, gamma=0.9)
    assert b.stride == UNROLL // 2 and b.needs_carry
    with pytest.raises(ValueError, match="needs its carry"):
        b.add_step(np.zeros(2), 0, 0.0, False, None, None)
    b.end_episode()
    assert b.drain() == []


@pytest.mark.parametrize("pooled", [False, True], ids=["stacked", "pooled"])
def test_grouped_messages_match_jax(pooled):
    """Fixed-shape messages of GROUP sequences: payloads, priorities and
    ``n_trans`` bit-equal; the pooled one ships overlapping windows'
    frames once (fewer rows than G*T) and row 0 is the zero pad frame."""
    jb, tb = _builders(pooled)
    jready, tready = jb.drain(), tb.drain()
    fns = ((jax_pooled_message, pooled_sequence_message) if pooled
           else (jax_sequence_message, sequence_message))
    jmsgs = jax_drain_grouped(jready, GROUP, fns[0])
    tmsgs = drain_grouped(tready, GROUP, fns[1])
    assert len(jmsgs) == len(tmsgs) > 1
    assert len(jready) == len(tready) < GROUP          # the remainder waits
    for jm, tm in zip(jmsgs, tmsgs):
        assert tm.keys() == {"payload", "priorities", "n_trans"}
        assert jm["n_trans"] == tm["n_trans"]
        np.testing.assert_array_equal(jm["priorities"], tm["priorities"])
        assert jm["payload"].keys() == tm["payload"].keys()
        for k, v in tm["payload"].items():
            assert np.asarray(v).dtype == np.asarray(jm["payload"][k]).dtype
            np.testing.assert_array_equal(v, jm["payload"][k], err_msg=k)
        if pooled:
            p = tm["payload"]
            assert int(p["n_frames"]) < GROUP * T_TOTAL + 1
            assert not p["frames"][0].any()
            assert not p["frames"][int(p["n_frames"]):].any()


def _pooled_messages(seed=0, shape=SHAPE, lengths=(9, 4, 15, 1, 7, 12, 3,
                                                   20, 11, 8)):
    b = SequenceBuilder(BURN, UNROLL, NSTEP, gamma=0.9, stride=3,
                        pooled=True)
    _feed(b, np.random.default_rng(seed), shape=shape, lengths=lengths)
    return drain_grouped(b.drain(), GROUP, pooled_sequence_message)


def _assert_state_equal(jpool, js, ts, leaves_rtol=None):
    f = jpool.f_capacity
    jframes = np.asarray(js.frames).reshape(f, -1)[:, :jpool.frame_dim]
    np.testing.assert_array_equal(ts.frames.numpy(), jframes)
    for name in ("action", "reward", "discount", "mask", "state_c",
                 "state_h", "obs_ids", "frame_epoch"):
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
    np.testing.assert_allclose(ts.max_priority.item(),
                               float(js.max_priority), rtol=0)


def _pools(mode, alpha, capacity=8, frame_capacity=5 * T_TOTAL):
    jpool = JaxSeqPool(capacity=capacity, t_total=T_TOTAL, lstm_features=H,
                       frame_shape=SHAPE, frame_capacity=frame_capacity,
                       alpha=alpha, gather_mode=mode)
    tpool = SequenceFramePoolReplay(capacity=capacity, t_total=T_TOTAL,
                                    lstm_features=H, frame_shape=SHAPE,
                                    frame_capacity=frame_capacity,
                                    alpha=alpha)
    return jpool, tpool


@pytest.mark.parametrize("mode,alpha,rtol", [
    ("interpret", 1.0, None), ("xla", 1.0, None), ("xla", 0.6, 1e-6)])
def test_add_sample_update_match_jax(mode, alpha, rtol, monkeypatch):
    """Messages wrap the ring (frame capacity 5 windows) and the
    sequence table: after each add the states agree, and samples from the
    same uniforms return the same batch, obs, stale redirects and IS
    weights included."""
    jpool, tpool = _pools(mode, alpha)
    assert len(jpool.ring_shape) == 3 and jpool.row_dim == 2048   # padded
    js, ts = jpool.init(), tpool.init("cpu")
    _assert_state_equal(jpool, js, ts)
    add = jax.jit(jpool.add)
    sample = jax.jit(jpool.sample, static_argnums=(2,))
    update = jax.jit(jpool.update_priorities)
    calls = []
    real = seq_pool_module.gather_rows
    monkeypatch.setattr(seq_pool_module, "gather_rows",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    redirected = 0
    msgs = _pooled_messages()
    assert len(msgs) >= 5
    for i, msg in enumerate(msgs):
        js = add(js, {k: jnp.asarray(v) for k, v in msg["payload"].items()},
                 jnp.asarray(msg["priorities"]))
        tpool.add(ts, msg["payload"], msg["priorities"])
        _assert_state_equal(jpool, js, ts, rtol)

        key = jax.random.key(i)
        offsets = np.array(jax.random.uniform(key, (8,), jnp.float32))
        # apexlint: disable=J004 -- parity test: JAX redraws the offsets above from the same key
        jb, jw, jidx = sample(js, key, 8, 0.4)
        tb, tw, tidx = tpool.sample(ts, torch.from_numpy(offsets), 0.4)
        assert calls.pop() == (8 * T_TOTAL,)        # one gather of B*T ids
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        newest = (ts.pos - 1) % tpool.capacity
        redirected += int((tidx == newest).sum())
        assert tb.keys() == jb.keys()
        for k in jb:
            assert tb[k].shape == jb[k].shape, k
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), k)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)

        new_p = (np.asarray(jidx) % 5 + 1).astype(np.float32) * 0.3
        js = update(js, jidx, jnp.asarray(new_p))
        tpool.update_priorities(ts, tidx, torch.from_numpy(new_p))
        _assert_state_equal(jpool, js, ts, rtol)
    assert ts.f_epoch > 2 * tpool.f_capacity          # the ring wrapped
    assert ts.size == tpool.capacity                  # so did the table
    assert redirected > 0


def test_padded_tail_samples_zero_frames():
    """A short episode's padded positions sample as zero frames with mask
    0, what the stacked layout stores there."""
    b = SequenceBuilder(BURN, UNROLL, NSTEP, gamma=0.9, stride=3,
                        pooled=True)
    rng = np.random.default_rng(7)
    for t in range(BURN + 2):
        b.add_step(rng.integers(1, 255, SHAPE).astype(np.uint8), 0, 0.0,
                   terminated=(t == BURN + 1),
                   carry_c=np.zeros(H, np.float32),
                   carry_h=np.zeros(H, np.float32))
    b.end_episode()
    msg = pooled_sequence_message(b.drain())
    pool = SequenceFramePoolReplay(capacity=4, t_total=T_TOTAL,
                                   lstm_features=H, frame_shape=SHAPE,
                                   frame_capacity=64)
    state = pool.add(pool.init("cpu"), msg["payload"], msg["priorities"])
    batch, _, _ = pool.sample(state, torch.rand(4), 0.4)
    obs, mask = batch["obs"].numpy(), batch["mask"].numpy()
    assert obs.shape == (4, T_TOTAL) + SHAPE
    assert (obs[:, :BURN + 2] > 0).any()
    assert not obs[:, BURN + 2:].any() and not mask[:, BURN + 2:].any()


def test_state_converted_from_jax_samples_the_same_batch():
    """``seq_pool_state_from_jax`` strips the JAX ring's tile padding
    (1764 -> 2048 at 42x42): the converted state equals the port's own
    after the same ingests and samples the same batch."""
    jpool, tpool = _pools("xla", 1.0, capacity=16, frame_capacity=200)
    js, ts = jpool.init(), tpool.init("cpu")
    for msg in _pooled_messages(seed=3):
        js = jpool.add(js, {k: jnp.asarray(v)
                            for k, v in msg["payload"].items()},
                       jnp.asarray(msg["priorities"]))
        tpool.add(ts, msg["payload"], msg["priorities"])
    raw = jax.tree.map(np.asarray, js).__dict__
    assert raw["frames"].shape == (200, 8, 256)
    converted = seq_pool_state_from_jax(raw, tpool, "cpu")
    _assert_state_equal(jpool, js, converted)
    offsets = torch.rand(8, generator=torch.Generator().manual_seed(0))
    got = tpool.sample(converted, offsets, 0.5)
    want = tpool.sample(ts, offsets, 0.5)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    with pytest.raises(ValueError, match="capacity"):
        seq_pool_state_from_jax(raw, SequenceFramePoolReplay(
            capacity=32, t_total=T_TOTAL, lstm_features=H,
            frame_shape=SHAPE, frame_capacity=200), "cpu")


def test_hbm_bytes_and_message_checks():
    pool = SequenceFramePoolReplay(capacity=2 ** 16, t_total=27,
                                   lstm_features=128,
                                   frame_capacity=1_277_952)
    # the unpadded 84x84 ring: 1 277 952 rows of 7056 B, 9.0 GB, and the
    # per-sequence tables and trees beside it
    assert pool.hbm_bytes() == (1_277_952 * 7056
                                + 2 ** 16 * 4 * (5 * 27 + 2 * 128 + 1)
                                + 2 * 2 ** 17 * 4)
    small = SequenceFramePoolReplay(capacity=4, t_total=T_TOTAL,
                                    lstm_features=H, frame_shape=SHAPE,
                                    frame_capacity=64)
    state = small.init("cpu")
    allocated = sum(t.numel() * t.element_size() for t in (
        state.frames, state.action, state.reward, state.discount, state.mask,
        state.state_c, state.state_h, state.obs_ids, state.frame_epoch,
        state.sum_tree, state.min_tree))
    assert small.hbm_bytes() == allocated
    msg = _pooled_messages()[0]
    bad = dict(msg["payload"], obs_ref=msg["payload"]["obs_ref"][:, 1:])
    with pytest.raises(ValueError, match="obs_ref shape"):
        small.add(state, bad, msg["priorities"])
    with pytest.raises(ValueError, match="frame_capacity"):
        SequenceFramePoolReplay(capacity=4, t_total=T_TOTAL, lstm_features=H,
                                frame_capacity=T_TOTAL - 1)
