"""JAX checkpoints carried into the port (:mod:`apex_tpu_torch.convert`).

A JAX ``ApexTrainer``, a JAX ``DQNTrainer`` and a JAX ``AQLApexTrainer``
(pixel and continuous) train briefly and save;
their bundles, read with ``apex_tpu``'s ``load_raw`` (msgpack, which the
port does not read), are converted into the port's state and compared
field by field: replay fields equal (the frame ring without the JAX
ring's tile padding), the trees' leaves to a few ulps against the port's
own ingest of the same stream (f32 ``pow``, as in
``tests/test_torch_frame_pool.py``), optimizer moments and count equal,
Q-values within the model-parity tolerance of ``tests/test_torch_model.py``
(f32: rtol 1e-5, atol 1e-6), and the converted state drives the port's
learner.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.config import ActorConfig as JaxActorConfig
from apex_tpu.config import ApexConfig as JaxApexConfig
from apex_tpu.config import EnvConfig as JaxEnvConfig
from apex_tpu.config import LearnerConfig as JaxLearnerConfig
from apex_tpu.config import ReplayConfig as JaxReplayConfig
from apex_tpu.config import small_test_config as jax_small_config
from apex_tpu.training import apex as jax_apex
from apex_tpu.training import checkpoint as jax_checkpoint
from apex_tpu.training.dqn import DQNTrainer as JaxDQNTrainer
from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig,
                                   small_test_config)
from apex_tpu_torch.convert import (device_replay_state_from_jax,
                                    frame_pool_state_from_jax,
                                    train_state_from_flax)
from apex_tpu_torch.models.dueling import DuelingDQN
from apex_tpu_torch.ops.losses import aql_param_labels
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.training.apex import ApexTrainer
from apex_tpu_torch.training.dqn import DQNTrainer

ENV, B, K = "ApexCatchSmall-v0", 16, 16


class StubPool:
    def __init__(self, msgs=()):
        self._msgs = list(msgs)
        self.procs = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        pass

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        return out


def _catch_messages(n):
    rng = np.random.default_rng(0)
    b = FrameChunkBuilder(3, 0.99, 4, (42, 42, 1), chunk_transitions=K)
    msgs = []
    while len(msgs) < n:
        b.begin_episode(rng.integers(0, 255, (42, 42, 1)).astype(np.uint8))
        length = int(rng.integers(5, 40))
        for t in range(length):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, (42, 42, 1)).astype(np.uint8),
                       t == length - 1, False)
        msgs.extend(drain_builder_chunks(b))
    return msgs[:n]


def test_jax_apex_bundle_converts_into_the_port_state(tmp_path, monkeypatch):
    """A JAX ``ApexTrainer`` trained on a chunk stream and saved; the
    port's converters carry its bundle across, field by field."""
    monkeypatch.setenv("APEX_OBS_SPANS", "0")
    msgs = _catch_messages(10)
    jcfg = JaxApexConfig(
        env=JaxEnvConfig(env_id=ENV, seed=5),
        replay=JaxReplayConfig(capacity=512, warmup=64),
        learner=JaxLearnerConfig(batch_size=B, compute_dtype="float32",
                                 target_update_interval=7,
                                 ingest_pipeline=False),
        actor=JaxActorConfig(send_interval=K))
    jt = jax_apex.ApexTrainer(jcfg, pool=StubPool(copy.deepcopy(msgs)),
                              publish_min_seconds=0.0,
                              respawn_workers=False,
                              checkpoint_dir=str(tmp_path))
    jt.train(total_steps=6, max_seconds=120, log_every=10 ** 9)
    raw, meta = jax_checkpoint.load_raw(jt.save_checkpoint())
    assert meta["steps"] == 6

    pt = ApexTrainer(ApexConfig(
        env=EnvConfig(env_id=ENV, seed=5),
        replay=ReplayConfig(capacity=512, warmup=64),
        learner=LearnerConfig(batch_size=B, compute_dtype="float32",
                              target_update_interval=7),
        actor=ActorConfig(send_interval=K)), pool=StubPool(), device="cpu")
    for msg in copy.deepcopy(msgs):      # the same stream, ingest only
        pt._dispatch_one(msg["payload"], msg["priorities"], msg["n_trans"],
                         False)
    model = DuelingDQN(**pt.model_spec,
                       generator=torch.Generator().manual_seed(0))
    ts = train_state_from_flax(raw["train_state"], model,
                               pt.core.optimizer)
    rs = frame_pool_state_from_jax(raw["replay_state"], pt.replay, "cpu")

    # every field is the JAX state's; what ingestion alone decides is
    # also what the port's own ingest of the stream wrote
    jrs = raw["replay_state"]
    np.testing.assert_array_equal(
        rs.frames.numpy(),
        np.asarray(jrs["frames"]).reshape(pt.replay.f_capacity, -1)
        [:, :pt.replay.frame_dim])
    for f in dataclasses.fields(rs):
        got, own = getattr(rs, f.name), getattr(pt.replay_state, f.name)
        if isinstance(got, dict):          # sidecars: none in a DQN pool
            assert got == own == dict(jrs.get(f.name) or {}), f.name
            continue
        if not isinstance(got, torch.Tensor):
            assert got == int(jrs[f.name]) == own, f.name
            continue
        if f.name != "frames":
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jrs[f.name]), f.name)
        if f.name not in ("sum_tree", "min_tree", "max_priority"):
            assert torch.equal(got, own), f.name
    # the trees carry the JAX learner's priority write-backs; the port's
    # own ingest wrote each leaf's p ** alpha to a few ulps of JAX's
    # (f32 pow), so the leaves the JAX learner never sampled agree so
    written = (rs.sum_tree != pt.replay_state.sum_tree)[pt.replay.capacity:]
    assert 0 < int(written.sum()) <= 6 * B
    c, size = pt.replay.capacity, rs.size
    kept = ~written[:size]
    np.testing.assert_allclose(rs.sum_tree[c:c + size][kept].numpy(),
                               pt.replay_state.sum_tree[c:c + size][kept]
                               .numpy(), rtol=1e-6)

    jopt = raw["train_state"]["opt_state"]
    assert ts.step == 6 == ts.opt_state.count
    assert int(jopt["1"]["1"]["count"]) == 6
    kernel = np.asarray(jopt["1"]["0"]["nu"]["params"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(ts.opt_state.nu[0].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    names = [n for n, _ in model.named_parameters()]
    for key, moments in (("mu", ts.opt_state.mu), ("nu", ts.opt_state.nu)):
        tree = jopt["1"]["0"][key]["params"]
        for name, value in zip(names, moments, strict=True):
            layer, kind = name.split(".")
            leaf = np.asarray(tree[layer]["kernel" if kind == "weight"
                                          else "bias"])
            want = (leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4
                    else leaf.T if leaf.ndim == 2 else leaf)
            np.testing.assert_array_equal(value.numpy(), want, name)

    obs = np.random.default_rng(1).integers(
        0, 256, (8, 42, 42, 4)).astype(np.uint8)
    want_q = np.asarray(jt.model.apply(jt.train_state.params,
                                       jnp.asarray(obs)))
    got_q = ts.params(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=1e-5, atol=1e-6)
    tgt_q = np.asarray(jt.model.apply(jt.train_state.target_params,
                                      jnp.asarray(obs)))
    np.testing.assert_allclose(
        ts.target_params(torch.from_numpy(obs)).detach().numpy(), tgt_q,
        rtol=1e-5, atol=1e-6)


def test_jax_dqn_bundle_converts_into_the_port_replay(tmp_path):
    jt = JaxDQNTrainer(jax_small_config(capacity=256, batch_size=16,
                                        n_actors=1),
                       checkpoint_dir=str(tmp_path))
    jt.train(total_frames=120)
    raw, _ = jax_checkpoint.load_raw(jt.save_checkpoint())
    pt = DQNTrainer(small_test_config(capacity=256, batch_size=16,
                                      n_actors=1), device="cpu")
    rs = device_replay_state_from_jax(raw["replay_state"], pt.core.replay,
                                      "cpu")
    jrs = jax.device_get(jt.replay_state)
    assert (rs.pos, rs.size) == (int(jrs.pos), int(jrs.size)) != (0, 0)
    assert rs.storage.keys() == pt.replay_state.storage.keys()
    for name, rows in rs.storage.items():
        np.testing.assert_array_equal(rows.numpy(),
                                      np.asarray(jrs.storage[name]), name)
        assert rows.dtype == pt.replay_state.storage[name].dtype
    for name in ("sum_tree", "min_tree", "max_priority"):
        np.testing.assert_array_equal(getattr(rs, name).numpy(),
                                      np.asarray(getattr(jrs, name)), name)
    # the converted state drives the port's learner
    pt.replay_state = rs
    pt.train_state = train_state_from_flax(
        raw["train_state"], pt.model, pt.core.optimizer)
    metrics = pt.train_step(0.5)
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("env_id", ["ApexCatchSmall-v0",
                                    "ApexContinuousNav-v0"],
                         ids=["pixels-frame-pool", "continuous-stacked"])
def test_jax_aql_apex_bundle_converts_into_the_port_state(tmp_path,
                                                          monkeypatch,
                                                          env_id):
    """A JAX ``AQLApexTrainer`` trained on a message stream and saved: its
    NoisyNet params, the two Adam groups' moments and counts, the replay
    with its ``a_mu`` candidate sets (the frame pool's sidecar, or the
    stacked replay's item) carried across equal, and the converted state
    drives the port's AQL learner."""
    from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
    from apex_tpu.training import aql as jax_aql
    from apex_tpu_torch.training.aql import AQLApexTrainer

    monkeypatch.setenv("APEX_OBS_SPANS", "0")
    pixels = env_id.startswith("ApexCatch")
    out = []
    for cls in ((JaxApexConfig, JaxEnvConfig, JaxReplayConfig,
                 JaxLearnerConfig, JaxActorConfig),
                (ApexConfig, EnvConfig, ReplayConfig, LearnerConfig,
                 ActorConfig)):
        apex, env, replay, learner, actor = cls
        cfg = apex(env=env(env_id=env_id, seed=5),
                   replay=replay(capacity=256, warmup=32),
                   learner=learner(batch_size=8, compute_dtype="float32",
                                   target_update_interval=3,
                                   ingest_pipeline=False, n_steps=1),
                   actor=actor(send_interval=K))
        out.append(cfg.replace(aql=dataclasses.replace(
            cfg.aql, propose_sample=6, uniform_sample=10)))
    jcfg, cfg = out
    t = 6 + (3 if pixels else 10)
    rng = np.random.default_rng(2)
    msgs = []
    if pixels:
        builder = JaxBuilder(1, 0.99, 4, (42, 42, 1), chunk_transitions=K,
                             extra_shapes={"a_mu": (t, 1)})
        while len(msgs) < 8:
            builder.begin_episode(rng.integers(0, 255, (42, 42, 1))
                                  .astype(np.uint8))
            length = int(rng.integers(4, 20))
            for i in range(length):
                builder.add_step(
                    int(rng.integers(0, t)), float(rng.normal()),
                    rng.normal(size=t).astype(np.float32),
                    rng.integers(0, 255, (42, 42, 1)).astype(np.uint8),
                    i == length - 1, False,
                    extras={"a_mu": rng.integers(0, 3, (t, 1)).astype(
                        np.float32)})
            from apex_tpu.actors.pool import drain_builder_chunks as drain
            msgs.extend(drain(builder))
    else:
        builder = jax_aql.AQLTransitionBuilder(0.99)
        for i in range(8 * K + 1):
            builder.add_step(rng.normal(size=2).astype(np.float32),
                             int(rng.integers(0, t)), float(rng.normal()),
                             rng.normal(size=2).astype(np.float32),
                             rng.uniform(-1, 1, (t, 2)).astype(np.float32),
                             rng.normal(size=t).astype(np.float32),
                             False, i % 30 == 29)
        while len(builder) >= K:
            batch, prios = builder.drain(K)
            msgs.append({"payload": batch, "priorities": prios,
                         "n_trans": K})
    jt = jax_aql.AQLApexTrainer(jcfg, pool=StubPool(copy.deepcopy(msgs[:8])),
                                publish_min_seconds=0.0,
                                checkpoint_dir=str(tmp_path))
    jt.respawn_workers = False
    jt.train(total_steps=4, max_seconds=120, log_every=10 ** 9)
    raw, meta = jax_checkpoint.load_raw(jt.save_checkpoint())
    assert meta["steps"] == 4

    pt = AQLApexTrainer(cfg, pool=StubPool(), device="cpu")
    assert pt.model_spec["action_dim"] == meta["model_spec"]["action_dim"]
    ts = train_state_from_flax(raw["train_state"], pt.model,
                               pt.core.optimizer)
    assert ts.step == 4
    jopt = raw["train_state"]["opt_state"]["inner_states"]
    for group in ("q", "proposal"):
        state = getattr(ts.opt_state, group)
        adam = jopt[group]["inner_state"]["1"]["0"]
        assert state.count == int(adam["count"]) == 4
        labels = [n for n, lbl in aql_param_labels(pt.model).items()
                  if lbl == group]
        for key in ("mu", "nu"):
            tree = adam[key]["params"]
            for name, value in zip(labels, getattr(state, key), strict=True):
                layer, leaf = name.split(".")
                want = np.asarray(tree[layer][{"weight": "kernel"}.get(
                    leaf, leaf)])
                np.testing.assert_array_equal(
                    value.numpy(), want.T if leaf == "weight" else want,
                    name)
    jparams = jax.device_get(jt.train_state.params)
    for name, value in ts.params.state_dict().items():
        layer, leaf = name.split(".")
        jleaf = np.asarray(jparams["params"][layer][
            {"weight": "kernel"}.get(leaf, leaf)])
        np.testing.assert_array_equal(
            value.numpy(), jleaf.T if leaf == "weight" else jleaf, name)

    jrs = jax.device_get(jt.replay_state)
    if pixels:
        rs = frame_pool_state_from_jax(raw["replay_state"], pt.replay, "cpu")
        np.testing.assert_array_equal(rs.extras["a_mu"].numpy(),
                                      np.asarray(jrs.extras["a_mu"]))
        assert rs.extras["a_mu"].shape == (256, t, 1)
        for name in ("action", "obs_ids", "next_ids", "frame_epoch"):
            np.testing.assert_array_equal(getattr(rs, name).numpy(),
                                          np.asarray(getattr(jrs, name)))
        assert (rs.pos, rs.size, rs.f_epoch) == (
            int(jrs.pos), int(jrs.size), int(jrs.f_epoch))
        bad = dict(raw["replay_state"], extras={})
        with pytest.raises(ValueError, match="sidecars"):
            frame_pool_state_from_jax(bad, pt.replay, "cpu")
    else:
        rs = device_replay_state_from_jax(raw["replay_state"], pt.replay,
                                          "cpu")
        assert rs.storage.keys() == pt.replay_state.storage.keys()
        for name, rows in rs.storage.items():
            np.testing.assert_array_equal(rows.numpy(),
                                          np.asarray(jrs.storage[name]),
                                          name)
    # the converted state drives the port's learner
    for _ in range(2):
        ts, rs, metrics = pt.core.train_step(ts, rs, pt._offsets(), 0.5)
    assert ts.step == 6 == ts.opt_state.q.count
    assert all(np.isfinite(float(v)) for v in metrics.values())
