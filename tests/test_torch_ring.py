"""The port's shared-memory chunk ring (``apex_tpu_torch.native``).

The same cases as ``tests/test_native.py`` for the JAX package's ring
(FIFO order, full/timeout/drain, oversized messages, force-skip recovery,
the chunk-queue facade), run against the port's own copy, plus: a chunk
message made by ``drain_builder_chunks`` crosses the ring bit-equal, the
wire refuses globals outside its allowlist, and the pool falls back to a
host queue when the ring is turned off.  Segment names carry the test
process's pid, so parallel test workers never share one.
"""

import copy
import os
import pickle
import queue as queue_lib
import time

import numpy as np
import pytest

from apex_tpu.native.ring import ShmChunkQueue as JaxShmChunkQueue
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu_torch import native
from apex_tpu_torch.actors.pool import ActorPool, EpisodeStat
from apex_tpu_torch.config import ActorConfig, ApexConfig
from apex_tpu_torch.native.ring import (SEGMENT_PREFIX, ShmChunkQueue,
                                        ShmRing, ShmRingError,
                                        chunk_slot_bytes, segment_name)
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.runtime.wire import WireRejected, restricted_loads


def _name(tag: str) -> str:
    return f"/{SEGMENT_PREFIX}-test-{os.getpid()}-{tag}"


def _ring(tag, slot_size=4096, n_slots=4):
    return ShmRing(_name(tag), slot_size=slot_size, n_slots=n_slots,
                   create=True)


def test_the_port_builds_its_own_ring():
    assert native.shm_available(), native.build_error()
    assert native._LIB.startswith(os.path.dirname(native.__file__))
    # its segments never collide with the JAX package's
    assert not segment_name().startswith("apexshm-")
    assert segment_name() != segment_name()


def test_ring_fifo_roundtrip():
    r = _ring("fifo")
    try:
        msgs = [bytes([i]) * (i + 1) for i in range(10)]
        for m in msgs[:4]:
            assert r.push(m, timeout_ms=100)
        assert r.pending() == 4
        assert [r.pop(timeout_ms=100) for _ in range(4)] == msgs[:4]
        for m in msgs[4:]:
            assert r.push(m, timeout_ms=100)
            assert r.pop(timeout_ms=100) == m
        assert r.pending() == 0
        assert r.pop(timeout_ms=1) is None           # empty -> timeout
    finally:
        r.close()


def test_ring_full_timeout_then_drain():
    r = _ring("full", slot_size=256, n_slots=2)
    try:
        assert r.push(b"a", timeout_ms=50)
        assert r.push(b"b", timeout_ms=50)
        assert not r.push(b"c", timeout_ms=50)       # full: clean timeout
        assert r.push_timeouts() == 1
        assert r.pop(timeout_ms=50) == b"a"
        assert r.push(b"c", timeout_ms=50)           # freed slot reusable
        assert r.pop(timeout_ms=50) == b"b"
        assert r.pop(timeout_ms=50) == b"c"
    finally:
        r.close()


def test_ring_rejects_oversized_payload():
    r = _ring("big", slot_size=64, n_slots=2)
    try:
        with pytest.raises(ShmRingError, match="slot size"):
            r.push(b"x" * 64, timeout_ms=10)         # 64 + 8 prefix > 64
        assert r.push(b"x" * 56, timeout_ms=10)      # exactly fits
    finally:
        r.close()


def test_force_skip_recovers_wedged_ring():
    """A producer killed between claim and publish starves the consumer;
    force_skip disposes of its ticket so later messages flow."""
    r = _ring("wedge", slot_size=256, n_slots=4)
    try:
        native._load().apex_shm_test_claim(r._h)   # claim, never publish
        assert r.push(b"real", timeout_ms=100)
        assert r.pop(timeout_ms=50) is None        # starved behind ticket 0
        assert r.pending() == 2
        assert r.force_skip()
        assert not r.force_skip()                  # head is published now
        assert r.pop(timeout_ms=100) == b"real"
        assert r.pending() == 0 and r.disposed() == 1
        assert r.push(b"again", timeout_ms=100)
        assert r.pop(timeout_ms=100) == b"again"
    finally:
        r.close()


def test_ring_random_sequences_match_fifo_model():
    """Arbitrary interleavings of push and pop against a deque: contents,
    order, pending count and full/empty behaviour agree."""
    from collections import deque

    from hypothesis import given, settings
    from hypothesis import strategies as st

    ops = st.lists(st.one_of(
        st.tuples(st.just("push"), st.binary(min_size=0, max_size=40)),
        st.tuples(st.just("pop"), st.none()),
    ), min_size=1, max_size=200)

    @settings(max_examples=50, deadline=None)
    @given(ops=ops)
    def run(ops):
        r = _ring("prop", slot_size=64, n_slots=4)
        model: deque = deque()
        try:
            for op, arg in ops:
                if op == "push":
                    ok = r.push(arg, timeout_ms=0)
                    assert ok == (len(model) < 4)
                    if ok:
                        model.append(arg)
                else:
                    assert r.pop(timeout_ms=0) == (model.popleft() if model
                                                   else None)
                assert r.pending() == len(model)
        finally:
            r.close()

    run()


def test_chunk_queue_auto_recovers_from_dead_producer(monkeypatch):
    monkeypatch.setattr(ShmChunkQueue, "STUCK_SECONDS", 0.3)
    q = ShmChunkQueue(_name("autoskip"), slot_bytes=4096, depth=4)
    try:
        native._load().apex_shm_test_claim(q._ring._h)   # wedge ticket 0
        q.put(("chunk", 1, {"n_trans": 3}))
        deadline = time.monotonic() + 10
        got = None
        while got is None and time.monotonic() < deadline:
            try:
                got = q.get(timeout=0.1)
            except queue_lib.Empty:
                pass
        assert got == ("chunk", 1, {"n_trans": 3})
        assert q.skipped == 1 and q._ring.disposed() == 1
    finally:
        q.close()


def test_chunk_queue_facade_and_segment_lifetime():
    name = _name("facade")
    q = ShmChunkQueue(name, slot_bytes=1 << 16, depth=4)
    seg = "/dev/shm" + name
    try:
        assert os.path.exists(seg)
        msg = {"payload": {"frames": np.arange(100, dtype=np.uint8)},
               "priorities": np.ones(3, np.float32), "n_trans": 3}
        q.put(("chunk", 0, msg))
        kind, actor_id, out = q.get(timeout=0.5)
        assert (kind, actor_id) == ("chunk", 0)
        np.testing.assert_array_equal(out["payload"]["frames"],
                                      msg["payload"]["frames"])
        with pytest.raises(queue_lib.Empty):
            q.get_nowait()
        with pytest.raises(queue_lib.Empty):
            q.get(timeout=0.05)
        # a worker's copy (made through the same __getstate__ and
        # __setstate__ as pickling) carries only the name and re-opens
        # the ring
        assert q.__getstate__() == {"name": name, "slot_bytes": 1 << 16,
                                    "depth": 4}
        child = copy.copy(q)
        assert child._ring is None
        child.put(("chunk", 1, {"n_trans": 1}))
        assert q.get(timeout=0.5) == ("chunk", 1, {"n_trans": 1})
        child.close()
        assert os.path.exists(seg)            # only the creator unlinks
    finally:
        q.close()
    assert not os.path.exists(seg)


def _builder_messages(builder_cls, drain):
    rng = np.random.default_rng(3)
    b = builder_cls(3, 0.99, 4, (42, 42, 1), chunk_transitions=16)
    msgs = []
    for _ in range(2):
        b.begin_episode(rng.integers(0, 255, (42, 42, 1)).astype(np.uint8))
        for t in range(25):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, (42, 42, 1)).astype(np.uint8),
                       t == 24, False)
        msgs.extend(drain(b))
    return msgs


def _assert_messages_equal(got, want):
    assert got.keys() == want.keys()
    assert got["n_trans"] == want["n_trans"]
    np.testing.assert_array_equal(got["priorities"], want["priorities"])
    assert got["priorities"].dtype == want["priorities"].dtype
    assert got["payload"].keys() == want["payload"].keys()
    for key, value in want["payload"].items():
        assert np.asarray(got["payload"][key]).dtype == np.asarray(value).dtype
        np.testing.assert_array_equal(got["payload"][key], value, err_msg=key)


def test_builder_messages_cross_the_ring_bit_equal():
    """drain_builder_chunks messages (frames, refs, the n-step fields,
    priorities, numpy scalar counts) come out of the ring as they went in,
    and match the JAX package's messages for the same steps."""
    msgs = _builder_messages(FrameChunkBuilder, drain_builder_chunks)
    jax_msgs = _builder_messages(
        JaxBuilder, lambda b: [{"payload": c, "priorities": c.pop("priorities"),
                                "n_trans": int(c["n_trans"])}
                               for c in b.poll()])
    assert len(msgs) == len(jax_msgs) >= 2
    slot = chunk_slot_bytes(frame_dim=42 * 42, frame_dtype_size=1,
                            kf=16 + 16, k=16, stack=4)
    q = ShmChunkQueue(_name("chunks"), slot_bytes=slot, depth=len(msgs))
    try:
        for i, msg in enumerate(msgs):
            q.put(("chunk", i, msg))
        for i, (msg, jmsg) in enumerate(zip(msgs, jax_msgs)):
            kind, actor_id, got = q.get(timeout=0.5)
            assert (kind, actor_id) == ("chunk", i)
            _assert_messages_equal(got, msg)
            _assert_messages_equal(got, jmsg)
    finally:
        q.close()


def test_the_jax_ring_and_the_port_ring_use_separate_segments():
    jq = JaxShmChunkQueue("apexshm-test-sep-%d" % os.getpid(),
                          slot_bytes=4096, depth=2)
    q = ShmChunkQueue(segment_name(), slot_bytes=4096, depth=2)
    try:
        jq.put(("chunk", 0, {"n_trans": 1}))
        with pytest.raises(queue_lib.Empty):
            q.get_nowait()
        assert jq.get(timeout=0.5) == ("chunk", 0, {"n_trans": 1})
    finally:
        q.close()
        jq.close()


def test_wire_admits_stats_and_refuses_other_globals():
    stat = EpisodeStat(3, 1.5, 18, param_version=2, dropped_stats=1)
    assert restricted_loads(pickle.dumps(stat)) == stat
    with pytest.raises(WireRejected, match="system"):
        restricted_loads(pickle.dumps(os.system))


def test_pool_takes_a_host_queue_when_the_ring_is_off():
    cfg = ApexConfig(actor=ActorConfig(n_actors=1, shm_data_plane=False))
    pool = ActorPool(cfg, {}, chunk_transitions=16)
    assert pool._make_chunk_queue()[1] == "mp.Queue"
    cfg = ApexConfig(actor=ActorConfig(n_actors=1))
    pool = ActorPool(cfg, {}, chunk_transitions=16, shm_slot_bytes=4096)
    q, plane = pool._make_chunk_queue()
    try:
        assert plane == "shm" and isinstance(q, ShmChunkQueue)
        assert q.slot_bytes == 4096
    finally:
        q.close()
