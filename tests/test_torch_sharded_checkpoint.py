"""Checkpoints of the port's sharded learner (``learner.mesh_shape=(2,)``)
and ranks that outlive one ``train()``.

* Bit-exact continuation, DQN (the frame pool) and AQL (the stacked
  replay with its ``a_mu`` item, NoisyNet draws from each rank's
  generator): trainer A trains N steps, saves, and trains N more on the
  same ranks (a second ``train()``); trainer B, fresh, restores A's
  checkpoint and trains N.  Both then save: the two files' train state,
  stacked replay (both ranks' shards), generators and uniforms are equal
  bit for bit.  No tolerance: the same ops on the same inputs.
* The bundle's layout: the train state once, every replay field with a
  leading ``[2]`` axis in rank order (JAX's stacked layout), each rank's
  generator state; restoring into a trainer of another dp degree raises.
* A JAX ``ApexTrainer`` with ``mesh_shape=(2,)`` saves a bundle that
  ``load_jax_bundle`` reads and ``convert.py`` carries into the port's two
  shard states (``shard=``): every field exact.
* No rank process is left after ``close()``.

The port's ranks are spawned processes over gloo on the CPU, as
``ApexTrainer.train`` starts them; the chunks come from a scripted pool
and the serial drain (``ingest_pipeline=False``), so the stream each
trainer consumes is a function of its step count alone.
"""

import copy
import dataclasses
import multiprocessing as mp

import jax
import numpy as np
import pytest
import torch

from apex_tpu_torch.config import small_test_config
from apex_tpu_torch.convert import frame_pool_state_from_jax
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.apex import ApexTrainer
from apex_tpu_torch.training.checkpoint import load_jax_bundle, load_raw
from tests.test_torch_sharded_pipeline import (ScriptedPool,
                                               _cartpole_chunk_messages)

N = 6          # learner steps per train() call


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _dqn_trainer(tmp, msgs):
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, warmup=64),
        learner=dataclasses.replace(cfg.learner, ingest_pipeline=False,
                                    target_update_interval=4,
                                    mesh_shape=(2,)))
    return ApexTrainer(cfg, pool=ScriptedPool(msgs), device="cpu",
                       publish_min_seconds=10.0, respawn_workers=False,
                       dp_backend="gloo", checkpoint_dir=str(tmp))


def _aql_trainer(tmp, msgs):
    from apex_tpu_torch.training.aql import AQLApexTrainer
    from tests.test_torch_aql import _cfg
    cfg = _cfg(capacity=256)
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, warmup=64),
        learner=dataclasses.replace(cfg.learner, ingest_pipeline=False,
                                    target_update_interval=4,
                                    mesh_shape=(2,)))
    return AQLApexTrainer(cfg, pool=ScriptedPool(msgs), device="cpu",
                          publish_min_seconds=10.0, respawn_workers=False,
                          dp_backend="gloo", checkpoint_dir=str(tmp))


def _aql_messages(n):
    from tests.test_torch_aql import _batch
    rng = np.random.default_rng(8)
    msgs = []
    for _ in range(n):
        batch = _batch(rng, 16)
        batch["obs"] = rng.uniform(-2, 2, (16, 2)).astype(np.float32)
        batch["next_obs"] = rng.uniform(-2, 2, (16, 2)).astype(np.float32)
        msgs.append({"payload": batch, "n_trans": 16,
                     "priorities": rng.uniform(0.1, 2, 16).astype(
                         np.float32)})
    return msgs


@pytest.mark.parametrize("family", ["dqn", "aql"])
def test_sharded_checkpoint_continues_bit_exactly(family, tmp_path):
    make, msgs = ((_dqn_trainer, _cartpole_chunk_messages(40, seed=11))
                  if family == "dqn" else (_aql_trainer, _aql_messages(40)))
    before = set(mp.active_children())
    a = make(tmp_path / "a", copy.deepcopy(msgs))
    b = None
    try:
        a.train(total_steps=N, max_seconds=120, log_every=10 ** 9)
        assert a.steps == N
        saved = a.save_checkpoint()
        rest = list(a.pool.pool._msgs)          # the stream after the save
        a.train(total_steps=N, max_seconds=120, log_every=10 ** 9)
        assert a.steps == 2 * N
        assert a.dp_rank_stats[1]["steps"] == 2 * N

        b = make(tmp_path / "b", rest)
        b.restore(saved)
        assert b.steps == N and b._dp_pending is not None
        b.train(total_steps=N, max_seconds=120, log_every=10 ** 9)
        assert b.steps == 2 * N and b._dp_pending is None
        got, want = load_raw(b.save_checkpoint()), load_raw(
            a.save_checkpoint())
        _assert_trees_equal(got[0], want[0])
        assert got[1]["steps"] == want[1]["steps"] == 2 * N
        assert got[1]["dp"] == 2

        # the layout: JAX's stacked replay, every rank's generator
        state = want[0]
        size = state["replay_state"]["size"]
        assert size.dtype == torch.int64 and size.shape == (2,)
        assert int(size.sum()) == a.ingested        # no shard wrapped
        assert all(v.shape[0] == 2 for k, v in state["replay_state"].items()
                   if isinstance(v, torch.Tensor))
        assert state["dp"]["generators"].shape[0] == 2
        assert not torch.equal(state["dp"]["generators"][0],
                               state["dp"]["generators"][1])
        assert "params" in state["train_state"]
    finally:
        for t in (a, b):
            if t is not None:
                t.close()
    assert set(mp.active_children()) <= before
    with pytest.raises(RuntimeError, match="replay shards"):
        a.save_checkpoint()


def test_a_sharded_checkpoint_restores_before_the_ranks_start(tmp_path):
    """Save and restore without ever training: the never-started
    trainer's bundle tiles its fresh shard, a restore holds the stacked
    rows until the ranks start, and a checkpoint of another dp degree is
    refused before anything is imposed."""
    a = _dqn_trainer(tmp_path / "a", [])
    path = a.save_checkpoint()
    raw, meta = load_raw(path)
    assert meta["dp"] == 2
    assert raw["replay_state"]["frames"].shape[0] == 2
    b = _dqn_trainer(tmp_path / "b", [])
    b.restore(path)
    _assert_trees_equal(load_raw(b.save_checkpoint())[0], raw)
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    one = ApexTrainer(cfg, pool=ScriptedPool([]), device="cpu",
                      respawn_workers=False,
                      checkpoint_dir=str(tmp_path / "one"))
    with pytest.raises((ValueError, KeyError)):
        one.restore(path)
    with pytest.raises(ValueError, match="dp 1"):
        b.restore(one.save_checkpoint())


def test_jax_dp2_bundle_converts_into_the_port_shards(tmp_path):
    """A JAX ``ApexTrainer`` at ``mesh_shape=(2,)`` ingests two round-robin
    groups and saves; ``load_jax_bundle`` + ``frame_pool_state_from_jax(...,
    shard=r)`` give each port shard JAX's row r, field for field."""
    from apex_tpu.config import small_test_config as jax_small_config
    from apex_tpu.parallel.aggregate import stack_chunk_messages
    from apex_tpu.training.apex import ApexTrainer as JaxApexTrainer

    cfg = jax_small_config(capacity=256, batch_size=16, n_actors=1)
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  mesh_shape=(2,)))
    jt = JaxApexTrainer(cfg, checkpoint_dir=str(tmp_path))
    msgs = _cartpole_chunk_messages(6, seed=4)
    for i in range(0, 6, 2):
        payload, prios, _ = stack_chunk_messages(msgs[i:i + 2])
        jt.replay_state = jt._ingest(jt.replay_state, payload, prios)
    path = jt.save_checkpoint()
    want = jax.device_get(jt.replay_state)

    raw, meta = load_jax_bundle(path)
    assert tuple(meta["config"]["learner"]["mesh_shape"]) == (2,)
    pool = FramePoolReplay(capacity=256, frame_shape=(4,), frame_stack=1,
                           frame_dtype="float32")
    sizes = []
    for r in range(2):
        got = frame_pool_state_from_jax(raw["replay_state"], pool, "cpu",
                                        shard=r)
        for f in dataclasses.fields(got):
            value = getattr(got, f.name)
            if f.name == "extras":
                assert value == {} and getattr(want, f.name) == {}
                continue
            ref = np.asarray(getattr(want, f.name))[r]
            if f.name == "frames":
                np.testing.assert_array_equal(
                    value.numpy(), ref.reshape(ref.shape[0], -1)[:, :4])
            elif isinstance(value, torch.Tensor):
                np.testing.assert_array_equal(value.numpy(), ref,
                                              err_msg=f.name)
            else:
                assert value == int(ref), f.name
        sizes.append(got.size)
    assert sizes[0] > 0 and sizes[1] > 0
    assert sum(sizes) == sum(int(m["n_trans"]) for m in msgs)
    with pytest.raises(ValueError, match="shard"):
        frame_pool_state_from_jax(raw["replay_state"], pool, "cpu")
