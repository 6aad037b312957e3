"""The sharded (dp > 1) plan of the port's ingest pipeline against
``apex_tpu.training.ingest_pipeline``'s.

* ``merge_group_messages`` returns JAX's merged group bit for bit, and on
  every shard one ``add`` of it leaves the port's frame pool exactly as
  the groups' adds one by one do (``tests/test_sharded_pipeline.py:104``).
* ``UniformPrefetcher`` hands out the draws of one host generator per
  rank in dispatch order, refilled or not (the role of JAX's
  ``KeyPrefetcher`` chain contract).
* Group-granular staging: the slots of an ``IngestPipeline(n_dp=2)`` over
  a ``ChunkAggregator``, rank 0's staged part and the other ranks'
  pickled parts, fill every shard exactly as the serial adds do.
* The pipelined plan against the serial one: ``ApexTrainer.train`` with
  ``mesh_shape=(2,)`` over a scripted pool, two spawned gloo ranks each
  time, ends with the same weights, optimizer state and shards, bit for
  bit.
"""

import copy
import dataclasses
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

from apex_tpu.parallel.aggregate import \
    stack_chunk_messages as jax_stack_chunk_messages
from apex_tpu.training.ingest_pipeline import \
    merge_group_messages as jax_merge_group_messages
from apex_tpu_torch.config import small_test_config
from apex_tpu_torch.parallel.aggregate import (ChunkAggregator,
                                               stack_chunk_messages,
                                               tree_index)
from apex_tpu_torch.parallel.mesh import per_rank_seed
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.runtime import wire
from apex_tpu_torch.training.apex import ApexTrainer
from apex_tpu_torch.training.ingest_pipeline import (IngestPipeline,
                                                     PipelineState,
                                                     UniformPrefetcher,
                                                     merge_group_messages)

K = 16          # transitions per worker chunk

FIELDS = ("frames", "action", "reward", "discount", "obs_ids", "next_ids",
          "frame_epoch", "sum_tree", "min_tree", "max_priority")


def _cartpole_chunk_messages(n_chunks: int, seed: int = 0) -> list[dict]:
    """Chunks of small_test_config's ApexCartPole spec, as actors ship
    them."""
    rng = np.random.default_rng(seed)
    builder = FrameChunkBuilder(3, 0.99, 1, (4,), chunk_transitions=K,
                                frame_dtype=np.float32)
    msgs: list[dict] = []
    while len(msgs) < n_chunks:
        builder.begin_episode(rng.normal(size=4).astype(np.float32))
        ep_len = int(rng.integers(4, 40))
        for t in range(ep_len):
            builder.add_step(int(rng.integers(0, 2)), float(rng.normal()),
                             rng.normal(size=2).astype(np.float32),
                             rng.normal(size=4).astype(np.float32),
                             terminated=t == ep_len - 1, truncated=False)
        msgs.extend(drain_builder_chunks(builder))
    return msgs[:n_chunks]


def _group(msgs: list[dict]) -> dict:
    payload, prios, n_trans = stack_chunk_messages(msgs)
    return {"payload": payload, "priorities": prios, "n_trans": n_trans}


def _pool():
    return FramePoolReplay(capacity=256, frame_shape=(4,), frame_stack=1,
                           frame_capacity=512, frame_dtype="float32")


def _assert_states_equal(a, b, where=""):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{where} field {name} diverged"
    assert (a.pos, a.f_epoch, a.size) == (b.pos, b.f_epoch, b.size), where


def _assert_trees_equal(a, b, path="payload"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for name in a:
            _assert_trees_equal(a[name], b[name], f"{path}/{name}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.mark.parametrize("n_dp,m", [(2, 2), (4, 3), (4, 8)])
def test_merge_group_messages_equals_jax_and_sequential_adds(n_dp, m):
    msgs = _cartpole_chunk_messages(n_dp * m, seed=n_dp * 10 + m)
    groups = [_group(msgs[i * n_dp:(i + 1) * n_dp]) for i in range(m)]
    jgroups = []
    for i in range(m):
        payload, prios, n_trans = jax_stack_chunk_messages(
            msgs[i * n_dp:(i + 1) * n_dp])
        jgroups.append({"payload": payload, "priorities": prios,
                        "n_trans": n_trans})
    merged = merge_group_messages(copy.deepcopy(groups), n_dp)
    want = jax_merge_group_messages(jgroups, n_dp)
    _assert_trees_equal(merged["payload"], want["payload"])
    np.testing.assert_array_equal(merged["priorities"], want["priorities"])
    assert merged["n_trans"] == want["n_trans"] == sum(
        g["n_trans"] for g in groups)

    pool = _pool()
    for s in range(n_dp):
        seq = pool.init("cpu")
        for g in groups:
            pool.add(seq, tree_index(g["payload"], s),
                     np.asarray(g["priorities"][s], np.float32))
        one = pool.add(pool.init("cpu"), tree_index(merged["payload"], s),
                       np.asarray(merged["priorities"][s], np.float32))
        _assert_states_equal(seq, one, f"shard {s}")


def test_merge_group_messages_single_group_passthrough():
    g = _group(_cartpole_chunk_messages(4))
    assert merge_group_messages([g], 4) is g


def test_uniform_prefetcher_keeps_dispatch_order():
    """Entry i is one draw from each rank's generator, whether the queue
    was refilled ahead or drawn inline."""

    def gens():
        return [torch.Generator().manual_seed(per_rank_seed(7, r))
                for r in range(3)]

    ahead, inline = UniformPrefetcher(gens(), 4, depth=3), \
        UniformPrefetcher(gens(), 4, depth=3)
    ahead.refill()
    got = [ahead.take() for _ in range(2)]
    ahead.refill()
    got += [ahead.take() for _ in range(5)]
    want = [inline.take() for _ in range(7)]
    ref = gens()
    for g, w in zip(got, want):
        for r in range(3):
            np.testing.assert_array_equal(g[r], w[r])
            np.testing.assert_array_equal(
                w[r], torch.rand(4, generator=ref[r]).numpy())
    assert len({float(g[0][0]) for g in got}) == 7     # fresh draws
    assert per_rank_seed(7, 0) == 7                    # rank 0 keeps it


def test_uniform_prefetcher_under_a_racing_refill():
    """The staging thread refills while the trainer takes: with a short
    switch interval and more refilling threads than cores, the taken
    sequence is still the inline one, no draw lost or repeated."""
    import os
    import sys
    import threading

    def gens():
        return [torch.Generator().manual_seed(per_rank_seed(3, r))
                for r in range(2)]

    n = 400
    shared, inline = UniformPrefetcher(gens(), 2, depth=4), \
        UniformPrefetcher(gens(), 2, depth=4)
    stop = threading.Event()

    def refill():
        while not stop.is_set():
            shared.refill()

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=refill, daemon=True)
               for _ in range((os.cpu_count() or 1) + 2)]
    try:
        for t in threads:
            t.start()
        got = [shared.take() for _ in range(n)]
    finally:
        stop.set()
        sys.setswitchinterval(saved)
        for t in threads:
            t.join(10.0)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, (inline.take() for _ in range(n))):
        for r in range(2):
            np.testing.assert_array_equal(g[r], w[r])


class ScriptedPool:
    """A deterministic in-process chunk source with the pool interface;
    an empty poll waits out its timeout, as a real queue's does."""

    def __init__(self, msgs):
        self._msgs = list(msgs)
        self.procs = []
        self.published = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        self.published.append(version)

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        if not out and timeout:
            time.sleep(timeout)
        return out


@pytest.mark.parametrize("train_eligible", [False, True],
                         ids=["merged-groups", "single-groups"])
def test_group_slots_fill_every_shard_as_the_serial_adds(train_eligible):
    n_dp, n_groups = 2, 6
    msgs = _cartpole_chunk_messages(n_dp * n_groups, seed=3)
    groups = [_group(msgs[i * n_dp:(i + 1) * n_dp]) for i in range(n_groups)]
    pipe = IngestPipeline(ChunkAggregator(ScriptedPool(copy.deepcopy(msgs)),
                                          n_dp),
                          device="cpu", n_dp=n_dp, merge_max=4,
                          state_fn=lambda: PipelineState(
                              train_eligible=train_eligible),
                          capacity=256, frame_capacity=512)
    pool = _pool()
    shards = [pool.init("cpu") for _ in range(n_dp)]
    consumed = 0
    pipe.start()
    try:
        while consumed < sum(g["n_trans"] for g in groups):
            slot = pipe.poll_slot(timeout=5.0)
            assert slot is not None, "the pipeline ran dry"
            assert slot.kind == ("single" if train_eligible else "merged")
            assert len(slot.remote) == n_dp - 1
            pool.add(shards[0], slot.payload, slot.prios)
            for r, blob in enumerate(slot.remote, start=1):
                payload, prios = wire.restricted_loads(blob)
                pool.add(shards[r], payload, prios)
            consumed += slot.n_trans
    finally:
        pipe.stop()
    assert pipe.stats["merged_slots"] == (0 if train_eligible else 2)
    for s in range(n_dp):
        seq = pool.init("cpu")
        for g in groups:
            pool.add(seq, tree_index(g["payload"], s),
                     np.asarray(g["priorities"][s], np.float32))
        _assert_states_equal(seq, shards[s], f"shard {s}")


def _run_sharded(pipeline_on, msgs, total_steps):
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, warmup=64),
        learner=dataclasses.replace(cfg.learner, ingest_pipeline=pipeline_on,
                                    target_update_interval=20,
                                    mesh_shape=(2,)))
    trainer = ApexTrainer(cfg, pool=ScriptedPool(copy.deepcopy(msgs)),
                          device="cpu", publish_min_seconds=10.0,
                          respawn_workers=False, dp_backend="gloo")
    trainer.train(total_steps=total_steps, max_seconds=120,
                  log_every=10 ** 9)
    return trainer


def test_pipelined_sharded_plan_is_bit_identical_to_the_serial_one():
    """One chunk stream across the warm-up (per-shard merged groups when
    pipelined), staged fused groups and train-only steps after the stream
    ends, over two ranks each time: the same weights, optimizer state and
    rank 0 shard bit for bit, and the same rank 1 shard size."""
    msgs = _cartpole_chunk_messages(24)               # 12 groups of 2
    before = set(mp.active_children())
    serial = _run_sharded(False, msgs, 30)
    piped = _run_sharded(True, msgs, 30)
    assert serial.steps == piped.steps == 30
    assert serial.ingested == piped.ingested == sum(
        int(m["n_trans"]) for m in msgs)
    assert piped._pipeline_last_stats["merged_chunks"] >= 2
    assert piped.dispatches["ingest"] < serial.dispatches["ingest"]
    for a, b in ((serial.train_state.params, piped.train_state.params),
                 (serial.train_state.target_params,
                  piped.train_state.target_params)):
        for (name, x), y in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(x, y), name
    for x, y in zip(serial.train_state.opt_state.nu,
                    piped.train_state.opt_state.nu):
        assert torch.equal(x, y)
    _assert_states_equal(serial.replay_state, piped.replay_state, "rank 0")
    for run in (serial, piped):
        ranks = run.dp_rank_stats
        assert ranks[1]["steps"] == ranks[0]["steps"] == 30
        # no shard wrapped: the two hold every transition ingested
        assert (ranks[0]["replay_size"] + ranks[1]["replay_size"]
                == run.ingested)
    assert (serial.dp_rank_stats[1]["replay_size"]
            == piped.dp_rank_stats[1]["replay_size"])
    # the ranks outlive train() (parked) and stop on close()
    for run in (serial, piped):
        run.close()
    assert set(mp.active_children()) <= before
