"""The replay service's batches on the port's sharded learner (dp 2)
against JAX's shard-mapped batch train (``apex_tpu/training/apex.py:
1221-1273``, pinned by ``tests/test_fused_dp.py:266-330``).

* :func:`~apex_tpu_torch.parallel.learner.split_batch` cuts a pulled batch
  into contiguous per-rank blocks (``obs_pair`` by its two halves).
* DQN: the two ranks (threads over gloo on one ``HashStore``) update on
  their blocks with the gradients meaned over the group; the priorities
  come back ``[batch]`` in sample order, each block the rank's own (the
  per-chip normalizer of JAX's ``mixed_max_priorities``), against JAX's
  ``_make_batch_train`` on 2 of the 8 virtual host devices: priorities
  and the loss within rtol 1e-5, the weights within atol 1e-6, both ranks'
  weights bit-identical.
* AQL: the update's NoisyNet draws per rank replay JAX's
  ``fold_in(key, axis_index("dp"))`` (the port reseeds each rank's
  generator instead; here each rank's draws are JAX's chip's): metrics
  within rtol 1e-4, weights within atol 1e-5 (1% of one Adam step), as
  ``tests/test_torch_parallel.py`` holds the AQL dp step.
* ``ApexTrainer.train`` with ``mesh_shape=(2,)`` (one spawned gloo rank)
  on a stub client's batches, pipelined and serial: every batch trains on
  both ranks and its write-back goes to its shard as JAX routes it,
  ``[(0,0),(0,1),(1,0),(1,1)]``; a tenant-qualified learner (APEX_TENANT)
  trains the same way; no rank is left after ``close()``.
"""

import dataclasses
import multiprocessing as mp
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.config import small_test_config
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.parallel.learner import (NoActors, ShardedLearner,
                                             split_batch)
from apex_tpu_torch.replay_service.shard import batch_from_wire
from apex_tpu_torch.training.apex import ApexTrainer
from tests.test_torch_parallel import run_ranks

BATCH, WORLD = 16, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Every rank is a thread in the JAX comparisons: one torch thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _service_batches(count, wire=True):
    """Pulled batches of small_test_config's CartPole spec: the port's
    wire format (``obs_pair``) or JAX's (``obs``/``next_obs``)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(count):
        obs = rng.normal(size=(BATCH, 4)).astype(np.float32)
        nxt = rng.normal(size=(BATCH, 4)).astype(np.float32)
        batch = {"action": rng.integers(0, 2, BATCH).astype(np.int32),
                 "reward": rng.normal(size=BATCH).astype(np.float32),
                 "discount": np.full(BATCH, 0.97, np.float32)}
        batch |= ({"obs_pair": np.concatenate([obs, nxt])} if wire
                  else {"obs": obs, "next_obs": nxt})
        out.append({"batch": batch,
                    "weights": rng.uniform(0.5, 1, BATCH).astype(np.float32),
                    "idx": rng.integers(0, 256, BATCH).astype(np.int32),
                    "seq": i // 2, "shard": i % 2, "ingested": 2048})
    return out


def test_split_batch_cuts_contiguous_blocks():
    item = _service_batches(1)[0]
    blocks = split_batch(item["batch"], item["weights"], 4)
    pair = item["batch"]["obs_pair"]
    for r, (batch, weights) in enumerate(blocks):
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_array_equal(
            batch["obs_pair"], np.concatenate([pair[:BATCH][rows],
                                               pair[BATCH:][rows]]))
        np.testing.assert_array_equal(batch["action"],
                                      item["batch"]["action"][rows])
        np.testing.assert_array_equal(weights, item["weights"][rows])
    with pytest.raises(ValueError, match="batch_size=16.*dp=3"):
        split_batch(item["batch"], item["weights"], 3)


def _jax_dp_cfg():
    from apex_tpu.config import small_test_config as jax_small_config
    cfg = jax_small_config(capacity=256, batch_size=BATCH)
    return cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                   mesh_shape=(WORLD,)))


class _JaxStubPool:
    procs: list = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def poll_chunks(self, n, timeout=0.0):
        return []

    def poll_stats(self):
        return []

    def publish_params(self, version, params):
        pass


def test_dqn_batch_train_at_dp_2_matches_jax():
    from apex_tpu.training.apex import ApexTrainer as JaxApexTrainer

    jt = JaxApexTrainer(_jax_dp_cfg(), pool=_JaxStubPool(),
                        respawn_workers=False)
    params = jax.device_get(jt.train_state.params)
    jitem = _service_batches(1, wire=False)[0]
    jts, jprios, jmetrics = jt._make_batch_train()(
        jt.train_state, jitem["batch"], jitem["weights"])
    jprios = np.asarray(jax.device_get(jprios))
    item = _service_batches(1)[0]
    blocks = split_batch(item["batch"], item["weights"], WORLD)

    def rank(r, group):
        t = ApexTrainer(small_test_config(capacity=256, batch_size=BATCH),
                        pool=NoActors(), device="cpu", respawn_workers=False)
        state = params_from_flax(params)
        t.train_state.params.load_state_dict(state)
        t.train_state.target_params.load_state_dict(state)
        train = ShardedLearner(t.core, group).make_batch_train()
        batch, weights = blocks[r]
        ts, prios, metrics = train(
            t.train_state, batch_from_wire(
                {k: torch.as_tensor(v) for k, v in batch.items()}), weights)
        return {"ts": ts, "prios": prios.numpy(),
                "metrics": {k: v.item() for k, v in metrics.items()}}

    res = run_ranks(WORLD, rank)
    for r in range(WORLD):
        assert res[r]["prios"].shape == (BATCH,)
        np.testing.assert_array_equal(res[r]["prios"], res[0]["prios"])
        np.testing.assert_allclose(res[r]["prios"], jprios, rtol=1e-5)
        for k in ("loss", "q_mean", "td_mean"):
            np.testing.assert_allclose(res[r]["metrics"][k],
                                       float(jmetrics[k]), rtol=1e-5,
                                       err_msg=k)
        for x, y in zip(res[0]["ts"].params.parameters(),
                        res[r]["ts"].params.parameters()):
            assert torch.equal(x, y)
    want = params_from_flax(jax.device_get(jts.params))
    for name, p in res[0]["ts"].params.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_aql_batch_train_at_dp_2_matches_jax():
    from apex_tpu.ops import losses as jax_losses
    from apex_tpu.parallel.learner import ShardedLearner as JaxSharded
    from apex_tpu.parallel.mesh import make_mesh
    from apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
    from apex_tpu.training import aql as jax_aql
    from apex_tpu.training.apex import ApexTrainer as JaxApexTrainer
    from apex_tpu.training.state import TrainState as JaxTrainState
    from apex_tpu_torch.ops import losses
    from apex_tpu_torch.replay.device import DeviceReplay
    from apex_tpu_torch.training.aql import AQLCore
    from apex_tpu_torch.training.state import TrainState
    from tests.test_torch_aql import JaxAQLDraws, _batch, _models
    from tests.test_torch_parallel import _assert_weights_close

    b = 8
    jm, params, pm0 = _models(False)
    jopt = jax_losses.make_aql_optimizer(q_lr=1e-3, proposal_lr=1e-3)
    jcore = jax_aql.AQLCore(model=jm, replay=JaxDeviceReplay(capacity=32),
                            optimizer=jopt, batch_size=b,
                            target_update_interval=2)
    jsl = JaxSharded(jcore, make_mesh(dp=WORLD,
                                      devices=jax.devices()[:WORLD]))
    jts = jsl.replicate_train_state(JaxTrainState(
        params=jax.tree.map(jnp.copy, params),
        target_params=jax.tree.map(jnp.copy, params),
        opt_state=jopt.init(params), step=jnp.int32(0)))
    # JAX's own dp batch train, off a stand-in for its trainer
    fn = JaxApexTrainer._make_batch_train(types.SimpleNamespace(
        core=jcore, sharded=jsl, n_dp=WORLD))
    rng = np.random.default_rng(3)
    batch = _batch(rng, b)
    weights = rng.uniform(0.5, 1, b).astype(np.float32)
    key = jax.random.key(21)
    jts, jprios, jmetrics = fn(jts, batch, weights, key)
    jprios = np.asarray(jax.device_get(jprios))
    blocks = split_batch(batch, weights, WORLD)

    def rank(r, group):
        import copy
        pm = copy.deepcopy(pm0)
        opt = losses.make_aql_optimizer(q_lr=1e-3, proposal_lr=1e-3)
        # chip r's update key: fold_in(key, axis_index("dp")), then the
        # online and the target noise keys
        draws = JaxAQLDraws(jm, params, noise=list(
            jax.random.split(jax.random.fold_in(key, r))))
        core = AQLCore(replay=DeviceReplay(32), optimizer=opt, batch_size=b,
                       target_update_interval=2, draws=draws)
        ts = TrainState(params=pm,
                        target_params=copy.deepcopy(pm).requires_grad_(False),
                        opt_state=opt.init(pm), step=0)
        block, w = blocks[r]
        ts, prios, metrics = ShardedLearner(core, group).make_batch_train()(
            ts, {k: torch.as_tensor(v) for k, v in block.items()}, w)
        assert not draws.noise_keys             # every draw consumed
        return {"ts": ts, "prios": prios.numpy(),
                "metrics": {k: v.item() for k, v in metrics.items()}}

    res = run_ranks(WORLD, rank)
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["prios"], jprios, rtol=1e-4,
                                   atol=1e-6)
        for name in ("loss", "loss_proposal", "grad_norm", "q_mean",
                     "td_mean"):
            np.testing.assert_allclose(res[r]["metrics"][name],
                                       float(jmetrics[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    for x, y in zip(res[0]["ts"].params.state_dict().values(),
                    res[1]["ts"].params.state_dict().values()):
        assert torch.equal(x, y)
    _assert_weights_close(res[0]["ts"], jts, atol=1e-5)


class _StubPool:
    """No chunks: the trainer must train on the service's batches alone."""

    procs: list = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def poll_chunks(self, n, timeout=0.0):
        if timeout:
            time.sleep(min(timeout, 0.005))
        return []

    def poll_stats(self):
        return []

    def publish_params(self, version, params):
        pass


class _StubClient:
    """Serves pre-made batches with the client's interface and records the
    write-backs the trainer routes back."""

    def __init__(self, batches):
        self._lock = threading.Lock()
        self._batches = list(batches)
        self.n_shards = 2
        self.batches = 0
        self.prio = []
        self.rejected = self.prio_sent = self.prio_dropped = 0
        self.learner_epoch = 0

    def poll_batch(self, timeout=0.0):
        with self._lock:
            if not self._batches:
                return None
            self.batches += 1
            return self._batches.pop(0)

    def push_priorities(self, shard, seq, idx, priorities):
        priorities = np.asarray(priorities)
        assert priorities.dtype == np.float32
        assert priorities.shape == np.asarray(idx).shape == (BATCH,)
        with self._lock:
            self.prio.append((int(shard), int(seq)))
            self.prio_sent += 1
        return True

    def ingested_total(self):
        return 4096

    def shard_status(self):
        return []

    def close(self):
        pass


@pytest.mark.parametrize("tenant,pipelined", [(None, True), ("rally", False)],
                         ids=["pipelined", "tenant-serial"])
def test_service_batches_train_on_two_ranks(tenant, pipelined, monkeypatch):
    if tenant is not None:
        monkeypatch.setenv("APEX_TENANT", tenant)
    cfg = small_test_config(capacity=256, batch_size=BATCH)
    cfg = cfg.replace(learner=dataclasses.replace(
        cfg.learner, mesh_shape=(WORLD,), ingest_pipeline=pipelined))
    client = _StubClient(_service_batches(4))
    before = set(mp.active_children())
    t = ApexTrainer(cfg, pool=_StubPool(), device="cpu",
                    respawn_workers=False, dp_backend="gloo")
    try:
        t.replay_client = client
        p_before = [p.detach().clone() for p in t.train_state.params.parameters()]
        t.train(total_steps=4, max_seconds=120, log_every=10 ** 9)
        assert t.service_steps == 4
        assert sorted(client.prio) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert not all(torch.equal(a, b) for a, b in zip(
            p_before, t.train_state.params.parameters()))
        svc = t.fleet_summary()["metrics"]["replay_service"]
        assert svc["service_steps"] == 4 and svc["batches_pulled"] == 4
        rec = t.dp_rank_stats[1]
        assert rec["service_steps"] == 4 and rec["steps"] == 4
        assert rec["replay_size"] == 0        # batches only, no chunks
    finally:
        t.close()
    assert set(mp.active_children()) <= before
