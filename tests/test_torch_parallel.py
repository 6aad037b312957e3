"""The port's sharded learner (``apex_tpu_torch.parallel``) against
``apex_tpu.parallel.learner.ShardedLearner``.

The port's ranks run as threads of this process, each joined to bare gloo
groups over one ``HashStore`` (``init_dp(..., device="cpu")``); JAX's
``ShardedLearner`` runs on 2 or 4 of the 8 virtual host devices that
``tests/conftest.py`` forces.  Both start from the same weights, ingest
the same round-robin groups and sample with the same per-chip uniforms
(``jax.random.uniform(wrap_key_data(device_keys(key)[r]), (B/dp,))``, the
pattern of ``tests/test_torch_learner.py`` applied per shard).

Tolerances, as the one-card parity tests state them: losses, ``q_mean``
and ``td_mean`` rtol 1e-5 and ``grad_norm`` rtol 1e-4 (the DQN frame
pool; R2D2 and AQL rtol 1e-4 on all); every shard's sum tree rtol 1e-5;
the weights after three updates atol 1e-6 (AQL: atol 1e-5, 1% of one
Adam step).  What holds bit for bit: every rank's weights, metrics and
optimizer state equal every other rank's after every step (the DP
invariant: one gloo all-reduce hands every rank the same sum).  Against
JAX's ``pmean`` the 2-rank mean is the same f32 operation (one add, one
halving), the 4-rank sum may associate differently, so both are held to
the f32 tolerances above, not to bit equality.

Also: the IS weights under a x1000 priority burst on one shard against
the oracle of ``tests/test_parallel.py:226``, ``split_ingest``'s round
robin, the divisibility ``ValueError``\\ s, the dp update against the
single-device update on the whole batch, ``init_dp(backend="nccl")``
refusing without a card per rank, and one ``ApexTrainer.train`` with
``mesh_shape=(2,)`` over two spawned gloo ranks that leaves no process.
"""

import copy
import dataclasses
import multiprocessing as mp
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
from apex_tpu.ops.losses import make_optimizer as jax_make_optimizer
from apex_tpu.parallel.aggregate import stack_chunk_messages
from apex_tpu.parallel.learner import ShardedLearner as JaxSharded
from apex_tpu.parallel.mesh import make_mesh
from apex_tpu.replay.device import DeviceReplay as JaxDeviceReplay
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu.replay.frame_pool import FramePoolReplay as JaxPool
from apex_tpu.training.learner import LearnerCore as JaxCore
from apex_tpu.training.state import create_train_state as jax_train_state
from apex_tpu_torch.config import small_test_config
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.models.dueling import DuelingDQN
from apex_tpu_torch.ops.losses import make_optimizer
from apex_tpu_torch.parallel.aggregate import tree_index
from apex_tpu_torch.parallel.learner import ShardedLearner
from apex_tpu_torch.parallel.mesh import DpGroup, init_dp
from apex_tpu_torch.replay.device import DeviceReplay
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.learner import LearnerCore
from apex_tpu_torch.training.state import create_train_state

SHAPE, S, B = (42, 42, 1), 4, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Every rank is a thread here: each takes one torch thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def run_ranks(world: int, body, timeout: float = 120.0) -> list:
    """``body(rank, group)`` on ``world`` threads, each joined to bare
    gloo groups over one HashStore; the results in rank order.  A rank's
    exception is raised here."""
    store = dist.HashStore()
    out, errors = [None] * world, []

    def run(rank):
        try:
            group = init_dp(world, rank, backend="gloo", store=store,
                            timeout=60.0, device="cpu")
            out[rank] = body(rank, group)
        except BaseException as exc:       # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return out


def per_chip_offsets(jsl, key, per_chip: int, split_update=False):
    """Each chip's PER uniforms from JAX's per-chip keys (AQL's chips
    split theirs first, the update key second)."""
    keys = np.asarray(jsl.device_keys(key))
    out, update = [], []
    for r in range(keys.shape[0]):
        chip_key = jax.random.wrap_key_data(keys[r])
        if split_update:
            chip_key, update_key = jax.random.split(chip_key)
            update.append(update_key)
        out.append(np.array(jax.random.uniform(chip_key, (per_chip,),
                                                jnp.float32)))
    return out, update


def _frame_chunks(seed, n):
    rng = np.random.default_rng(seed)
    b = JaxBuilder(3, 0.99, S, SHAPE, chunk_transitions=24)
    out = []
    while len(out) < n:
        b.begin_episode(rng.integers(0, 255, SHAPE).astype(np.uint8))
        for t in range(30):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, SHAPE).astype(np.uint8),
                       t == 29, False)
        out.extend(b.poll())
    return out[:n]


def _assert_ranks_identical(results):
    """The DP invariant: every rank's weights, target weights and metrics
    bit-equal rank 0's."""
    first = results[0]
    for res in results[1:]:
        for a, b in zip(first["ts"].params.state_dict().values(),
                        res["ts"].params.state_dict().values()):
            assert torch.equal(a, b)
        for a, b in zip(first["ts"].target_params.state_dict().values(),
                        res["ts"].target_params.state_dict().values()):
            assert torch.equal(a, b)
        assert res["metrics"] == first["metrics"]


def _assert_weights_close(ts, jts, atol):
    jparams, jtarget = jax.device_get((jts.params, jts.target_params))
    for mod, tree in ((ts.params, jparams), (ts.target_params, jtarget)):
        want = params_from_flax(tree)
        for name, p in mod.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=0, atol=atol, err_msg=name)


# -- the fused steps against JAX's ShardedLearner ---------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_dqn_frame_pool_fused_steps_match_jax(world):
    opt_kw = dict(lr=1e-3, lr_decay_steps=2, lr_decay_rate=0.5)
    flax_model = FlaxDQN(num_actions=3, compute_dtype=jnp.float32)
    jopt = jax_make_optimizer(**opt_kw)
    jpool = JaxPool(capacity=128, frame_shape=SHAPE, frame_stack=S)
    jts = jax_train_state(flax_model, jopt, jax.random.key(0),
                          jnp.zeros((1, 42, 42, S), jnp.uint8))
    params0 = params_from_flax(jax.device_get(jts.params))
    jcore = JaxCore(apply_fn=flax_model.apply, replay=jpool, optimizer=jopt,
                    batch_size=B, target_update_interval=2)
    jsl = JaxSharded(jcore, make_mesh(dp=world,
                                      devices=jax.devices()[:world]))
    jrs = jsl.shard_replay_state(jpool.init())
    jts = jsl.replicate_train_state(jts)
    chunks = _frame_chunks(world, 5 * world)
    groups = [stack_chunk_messages(
        [{"payload": {name: v for name, v in c.items()
                      if name != "priorities"},
          "priorities": c["priorities"], "n_trans": c["n_trans"]}
         for c in chunks[i * world:(i + 1) * world]]) for i in range(5)]

    ingest, fused = jsl.make_ingest(), jsl.make_fused_step()
    for payload, prios, _ in groups[:2]:
        jrs = ingest(jrs, payload, prios)
    keys = jax.random.split(jax.random.key(11), 3)
    offsets, jmetrics, jtrees = [], [], []
    for i, (payload, prios, _) in enumerate(groups[2:]):
        offsets.append(per_chip_offsets(jsl, keys[i], B // world)[0])
        jts, jrs, jm = fused(jts, jrs, payload, prios,
                             jsl.device_keys(keys[i]), jnp.float32(0.4))
        jmetrics.append({name: float(v) for name, v in jm.items()})
        jtrees.append(np.asarray(jrs.sum_tree))

    def rank(r, group):
        core = LearnerCore(
            replay=FramePoolReplay(capacity=128, frame_shape=SHAPE,
                                   frame_stack=S),
            optimizer=make_optimizer(**opt_kw), batch_size=B,
            target_update_interval=2)
        model = DuelingDQN(3, (42, 42, S), compute_dtype=torch.float32,
                           generator=torch.Generator().manual_seed(r))
        if r == 0:           # rank 0's weights reach the others by broadcast
            model.load_state_dict(params0)
        ts = create_train_state(model, core.optimizer)
        rs = core.replay.init("cpu")
        sl = ShardedLearner(core, group)
        sl.sync_train_state_(ts, sl.train_state_numbers(ts))
        sl_ingest, sl_fused = sl.make_ingest(), sl.make_fused_step()
        for payload, prios, _ in groups[:2]:
            rs = sl_ingest(rs, tree_index(payload, r), prios[r])
        metrics, trees = [], []
        for i, (payload, prios, _) in enumerate(groups[2:]):
            ts, rs, m = sl_fused(ts, rs, tree_index(payload, r), prios[r],
                                 offsets[i][r], 0.4)
            metrics.append({name: v.item() for name, v in m.items()})
            trees.append(rs.sum_tree.numpy().copy())
        return {"ts": ts, "rs": rs, "metrics": metrics, "trees": trees}

    results = run_ranks(world, rank)
    _assert_ranks_identical(results)
    for r, res in enumerate(results):
        assert res["ts"].step == int(jts.step) == 3
        for got, want in zip(res["metrics"], jmetrics):
            for name in ("loss", "q_mean", "td_mean"):
                np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                           atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
        for got, want in zip(res["trees"], jtrees):
            np.testing.assert_allclose(got, want[r], rtol=1e-5)
        assert (res["rs"].pos, res["rs"].size) == (
            int(jrs.pos[r]), int(jrs.size[r]))
    _assert_weights_close(results[0]["ts"], jts, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_r2d2_fused_steps_match_jax(world):
    from apex_tpu.models.recurrent import RecurrentDuelingDQN as FlaxR2D2
    from apex_tpu.training import r2d2 as jax_r2d2
    from apex_tpu.training.state import TrainState as JaxTrainState
    from apex_tpu_torch.models.recurrent import RecurrentDuelingDQN
    from apex_tpu_torch.training.r2d2 import R2D2Core

    burn, unroll, nstep, h, b = 2, 4, 1, 8, 8
    t_total = burn + unroll + nstep
    opt_kw = dict(lr=1e-3, lr_decay_steps=2, lr_decay_rate=0.5)
    flax_model = FlaxR2D2(num_actions=3, obs_is_image=False,
                          compute_dtype=jnp.float32, scale_uint8=False,
                          lstm_features=h)
    params = flax_model.init(jax.random.key(0),
                             jnp.zeros((1, t_total, 2), jnp.float32),
                             flax_model.initial_state(1))
    params0 = params_from_flax(jax.device_get(params))
    jopt = jax_make_optimizer(**opt_kw)
    jts = JaxTrainState(params=params,
                        target_params=jax.tree.map(jnp.copy, params),
                        opt_state=jopt.init(params), step=jnp.int32(0))
    example = dict(obs=np.zeros((t_total, 2), np.float32),
                   action=np.zeros(t_total, np.int32),
                   **{name: np.zeros(t_total, np.float32)
                      for name in ("reward", "discount", "mask")},
                   state_c=np.zeros(h, np.float32),
                   state_h=np.zeros(h, np.float32))
    jreplay = JaxDeviceReplay(capacity=32)
    jcore = jax_r2d2.R2D2Core(model=flax_model, replay=jreplay,
                              optimizer=jopt, batch_size=b,
                              target_update_interval=2, burn_in=burn,
                              n_steps=nstep)
    jsl = JaxSharded(jcore, make_mesh(dp=world,
                                      devices=jax.devices()[:world]))
    jrs = jsl.shard_replay_state(jreplay.init(
        jax.tree.map(jnp.asarray, example)))
    jts = jsl.replicate_train_state(jts)

    rng = np.random.default_rng(3)

    def seq_chunk(k):
        return dict(
            obs=rng.normal(size=(k, t_total, 2)).astype(np.float32),
            action=rng.integers(0, 3, (k, t_total)).astype(np.int32),
            reward=rng.normal(size=(k, t_total)).astype(np.float32),
            discount=np.full((k, t_total), 0.97, np.float32),
            mask=np.ones((k, t_total), np.float32),
            state_c=(rng.normal(size=(k, h)) * 0.3).astype(np.float32),
            state_h=(rng.normal(size=(k, h)) * 0.3).astype(np.float32))

    # 4 sequences per shard per chunk, split round robin by both sides
    port_split = ShardedLearner(None, DpGroup(0, world, torch.device("cpu"),
                                              None, None)).split_ingest
    chunks = []
    for _ in range(5):
        batch = seq_chunk(4 * world)
        prios = rng.uniform(0.1, 2.0, 4 * world).astype(np.float32)
        jbatch, jprios = jsl.split_ingest(batch, prios)
        pbatch, pprios = port_split(batch, prios)
        for name in batch:
            np.testing.assert_array_equal(pbatch[name], jbatch[name])
        np.testing.assert_array_equal(pprios, jprios)
        chunks.append((pbatch, pprios))
    ingest, fused = jsl.make_ingest(), jsl.make_fused_step()
    for batch, prios in chunks[:2]:
        jrs = ingest(jrs, batch, prios)
    keys = jax.random.split(jax.random.key(5), 3)
    offsets, jmetrics = [], []
    for i, (batch, prios) in enumerate(chunks[2:]):
        offsets.append(per_chip_offsets(jsl, keys[i], b // world)[0])
        jts, jrs, jm = fused(jts, jrs, batch, prios,
                             jsl.device_keys(keys[i]), jnp.float32(0.4))
        jmetrics.append({name: float(v) for name, v in jm.items()})

    def rank(r, group):
        model = RecurrentDuelingDQN(
            3, (2,), obs_is_image=False, compute_dtype=torch.float32,
            scale_uint8=False, lstm_features=h,
            generator=torch.Generator().manual_seed(0))
        model.load_state_dict(params0)
        core = R2D2Core(replay=DeviceReplay(capacity=32),
                        optimizer=make_optimizer(**opt_kw), batch_size=b,
                        target_update_interval=2, burn_in=burn,
                        n_steps=nstep)
        ts = create_train_state(model, core.optimizer)
        rs = core.replay.init(example, "cpu")
        sl = ShardedLearner(core, group)
        sl_ingest, sl_fused = sl.make_ingest(), sl.make_fused_step()
        for batch, prios in chunks[:2]:
            rs = sl_ingest(rs, tree_index(batch, r), prios[r])
        metrics = []
        for i, (batch, prios) in enumerate(chunks[2:]):
            ts, rs, m = sl_fused(ts, rs, tree_index(batch, r), prios[r],
                                 offsets[i][r], 0.4)
            metrics.append({name: v.item() for name, v in m.items()})
        return {"ts": ts, "rs": rs, "metrics": metrics}

    results = run_ranks(world, rank)
    _assert_ranks_identical(results)
    for r, res in enumerate(results):
        for got, want in zip(res["metrics"], jmetrics):
            for name in ("loss", "q_mean", "td_mean", "grad_norm"):
                np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                           atol=1e-6, err_msg=name)
        np.testing.assert_allclose(res["rs"].sum_tree.numpy(),
                                   np.asarray(jrs.sum_tree)[r], rtol=1e-5)
    _assert_weights_close(results[0]["ts"], jts, atol=1e-6)


def test_aql_fused_steps_match_jax_at_dp_2():
    from apex_tpu.ops import losses as jax_losses
    from apex_tpu.training import aql as jax_aql
    from apex_tpu.training.state import TrainState as JaxTrainState
    from apex_tpu_torch.ops import losses
    from apex_tpu_torch.training.aql import AQLCore
    from apex_tpu_torch.training.state import TrainState
    from tests.test_torch_aql import JaxAQLDraws, _batch, _models

    world, b = 2, 8
    jm, params, pm0 = _models(False)
    jopt = jax_losses.make_aql_optimizer(q_lr=1e-3, proposal_lr=1e-3)
    rng = np.random.default_rng(7)
    example = {name: v[0] for name, v in _batch(rng, 1).items()}
    jreplay = JaxDeviceReplay(capacity=32)
    jcore = jax_aql.AQLCore(model=jm, replay=jreplay, optimizer=jopt,
                            batch_size=b, target_update_interval=2)
    jsl = JaxSharded(jcore, make_mesh(dp=world,
                                      devices=jax.devices()[:world]))
    jrs = jsl.shard_replay_state(jreplay.init(
        jax.tree.map(jnp.asarray, example)))
    jts = jsl.replicate_train_state(JaxTrainState(
        params=jax.tree.map(jnp.copy, params),
        target_params=jax.tree.map(jnp.copy, params),
        opt_state=jopt.init(params), step=jnp.int32(0)))
    chunks = []
    for _ in range(5):
        chunks.append(jsl.split_ingest(
            _batch(rng, 4 * world),
            rng.uniform(0.1, 2, 4 * world).astype(np.float32)))
    chunks = [(jax.device_get(c), np.asarray(p)) for c, p in chunks]
    ingest, fused = jsl.make_ingest(), jsl.make_fused_step()
    for batch, prios in chunks[:2]:
        jrs = ingest(jrs, batch, prios)
    keys = jax.random.split(jax.random.key(13), 3)
    offsets, noise, jmetrics = [], [[] for _ in range(world)], []
    for i, (batch, prios) in enumerate(chunks[2:]):
        offs, k_update = per_chip_offsets(jsl, keys[i], b // world,
                                          split_update=True)
        offsets.append(offs)
        for r in range(world):     # the online and the target noise key
            noise[r].extend(jax.random.split(k_update[r]))
        jts, jrs, jm_ = fused(jts, jrs, batch, prios,
                              jsl.device_keys(keys[i]), jnp.float32(0.4))
        jmetrics.append({name: float(v) for name, v in jm_.items()})

    def rank(r, group):
        pm = copy.deepcopy(pm0)
        opt = losses.make_aql_optimizer(q_lr=1e-3, proposal_lr=1e-3)
        draws = JaxAQLDraws(jm, params, noise=noise[r])
        core = AQLCore(replay=DeviceReplay(32), optimizer=opt, batch_size=b,
                       target_update_interval=2, draws=draws)
        ts = TrainState(params=pm,
                        target_params=copy.deepcopy(pm).requires_grad_(False),
                        opt_state=opt.init(pm), step=0)
        rs = core.replay.init(example, "cpu")
        sl = ShardedLearner(core, group)
        sl_ingest, sl_fused = sl.make_ingest(), sl.make_fused_step()
        for batch, prios in chunks[:2]:
            rs = sl_ingest(rs, tree_index(batch, r), prios[r])
        metrics = []
        for i, (batch, prios) in enumerate(chunks[2:]):
            ts, rs, m = sl_fused(ts, rs, tree_index(batch, r), prios[r],
                                 offsets[i][r], 0.4)
            metrics.append({name: v.item() for name, v in m.items()})
        assert not draws.noise_keys            # every draw consumed
        return {"ts": ts, "rs": rs, "metrics": metrics}

    results = run_ranks(world, rank)
    _assert_ranks_identical(results)
    for r, res in enumerate(results):
        for got, want in zip(res["metrics"], jmetrics):
            for name in ("loss", "loss_proposal", "grad_norm", "q_mean",
                         "td_mean"):
                np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                           atol=1e-6, err_msg=name)
        np.testing.assert_allclose(res["rs"].sum_tree.numpy(),
                                   np.asarray(jrs.sum_tree)[r], rtol=1e-5)
    _assert_weights_close(results[0]["ts"], jts, atol=1e-5)


# -- the IS weights, the helpers and the guards -----------------------------

def _vector_batch(rng, k, dim=6, n_act=3):
    return dict(
        obs=rng.normal(size=(k, dim)).astype(np.float32),
        action=rng.integers(0, n_act, k).astype(np.int32),
        reward=rng.normal(size=k).astype(np.float32),
        next_obs=rng.normal(size=(k, dim)).astype(np.float32),
        discount=np.full(k, 0.99 ** 3, np.float32))


_ITEM = dict(obs=np.zeros(6, np.float32), action=np.int32(0),
             reward=np.float32(0), next_obs=np.zeros(6, np.float32),
             discount=np.float32(0))


def test_sharded_is_weights_under_a_burst_on_one_shard():
    """Each shard's weights are ``(leaf / shard_total * shard_size) **
    -beta`` over the max of that weight across ALL shards (the MAX
    all-reduce), with a x1000 burst on shard 0's rows; with uniform
    priorities every weight is 1, the single-buffer formula."""
    world, cap, per = 4, 512, 8
    rng = np.random.default_rng(7)
    n_total = 2048
    prios_all = rng.lognormal(0.0, 2.0, n_total).astype(np.float32)
    chunks = []
    for i in range(n_total // 64):
        batch, prios = ShardedLearner(None, DpGroup(
            0, world, torch.device("cpu"), None, None)).split_ingest(
                _vector_batch(rng, 64), prios_all[i * 64:(i + 1) * 64])
        prios = prios.copy()
        if i in (3, 4):
            prios[0] *= 1000.0                    # the burst: shard 0 only
        chunks.append((batch, prios))
    offsets = rng.random((world, per)).astype(np.float32)

    def rank(r, group):
        replay = DeviceReplay(capacity=cap)
        rs = replay.init(_ITEM, "cpu")
        for batch, prios in chunks:
            rs = replay.add(rs, tree_index(batch, r), prios[r])
        _, w, idx = replay.sample(rs, torch.from_numpy(offsets[r]), 0.4,
                                  group=group)
        rs_u = replay.init(_ITEM, "cpu")
        for batch, _ in chunks[:4]:
            rs_u = replay.add(rs_u, tree_index(batch, r),
                              np.full(64 // world, 2.5, np.float32))
        _, w_u, _ = replay.sample(rs_u, torch.from_numpy(offsets[r]), 0.4,
                                  group=group)
        return (w.numpy(), idx.numpy(), rs.sum_tree.numpy(),
                rs.min_tree.numpy(), w_u.numpy())

    out = run_ranks(world, rank)
    totals = np.array([o[2][1] for o in out], np.float64)
    mins = np.array([o[3][1] for o in out], np.float64)
    n_shard = n_total / world
    assert totals[0] / totals[1:].mean() > 5.0       # the skew is real
    max_w = ((mins / totals * n_shard) ** -0.4).max()
    for r, (w, idx, tree, _, w_u) in enumerate(out):
        leaves = tree[cap + idx].astype(np.float64)
        expect = (leaves / totals[r] * n_shard) ** -0.4 / max_w
        np.testing.assert_allclose(w, expect, rtol=2e-4)
        # the local formula is the true sampler's correction
        p_eff = leaves / (world * totals[r])
        np.testing.assert_allclose((p_eff * n_total) ** -0.4 / max_w,
                                   expect, rtol=1e-5)
        np.testing.assert_allclose(w_u, 1.0, rtol=1e-5)


def test_split_ingest_round_robin():
    sl = ShardedLearner(None, DpGroup(0, 8, torch.device("cpu"), None, None))
    split, sp = sl.split_ingest({"x": np.arange(16)}, np.arange(16.0))
    np.testing.assert_array_equal(split["x"][:, 0], np.arange(8))
    np.testing.assert_array_equal(split["x"][:, 1], np.arange(8, 16))
    np.testing.assert_array_equal(sp[3], [3.0, 11.0])


def test_dp_divisibility_guards_are_value_errors_naming_the_knobs():
    core = LearnerCore(replay=DeviceReplay(capacity=64),
                       optimizer=make_optimizer(), batch_size=60)
    sl = ShardedLearner(core, DpGroup(0, 8, torch.device("cpu"), None, None))
    with pytest.raises(ValueError, match="batch_size"):
        sl.make_fused_step()
    with pytest.raises(ValueError, match="mesh_shape"):
        sl.make_train_step()
    with pytest.raises(ValueError, match="send_interval"):
        sl.split_ingest({"x": np.arange(12)}, np.arange(12.0))


def test_dp_update_matches_single_device_math():
    """The mean of per-rank gradients over an evenly split batch is the
    whole batch's gradient, so the dp update equals the single-device one
    (rtol 2e-5, atol 1e-7, as ``tests/test_parallel.py:162``)."""
    world = 4
    rng = np.random.default_rng(3)
    batch = {name: torch.from_numpy(v) for name, v in
             _vector_batch(rng, 64).items()}
    weights = torch.from_numpy(rng.uniform(0.5, 1.0, 64).astype(np.float32))

    def make():
        core = LearnerCore(replay=DeviceReplay(capacity=64),
                           optimizer=make_optimizer(lr=1e-3), batch_size=64)
        model = DuelingDQN(3, (6,), obs_is_image=False,
                           compute_dtype=torch.float32, scale_uint8=False,
                           generator=torch.Generator().manual_seed(0))
        return core, create_train_state(model, core.optimizer)

    core, ts1 = make()
    ts1, _, m1 = core.update_from_batch(ts1, batch, weights)

    def rank(r, group):
        core, ts = make()
        rows = slice(16 * r, 16 * (r + 1))
        ts, _, m = core.update_from_batch(
            ts, {name: v[rows] for name, v in batch.items()}, weights[rows],
            group=group)
        return ts, m

    out = run_ranks(world, rank)
    np.testing.assert_allclose(out[0][1]["loss"].item(), m1["loss"].item(),
                               rtol=1e-5)
    for a, b in zip(ts1.params.parameters(), out[0][0].params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=1e-7)
    for ts, _ in out[1:]:
        for a, b in zip(out[0][0].params.parameters(), ts.params.parameters()):
            assert torch.equal(a, b)


def test_nccl_refuses_without_a_card_per_rank_and_names_gloo():
    with pytest.raises(RuntimeError, match="gloo"):
        init_dp(2, 0, backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        init_dp(2, 0, backend="nccl", device="cpu")
    from apex_tpu_torch.training.apex import ApexTrainer
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  mesh_shape=(2,)))
    with pytest.raises(ValueError, match="gloo"):
        ApexTrainer(cfg, device="cpu", dp_backend="nccl")
    bad = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  batch_size=15))
    with pytest.raises(ValueError, match="batch_size"):
        ApexTrainer(bad, device="cpu", dp_backend="gloo")


def test_two_rank_apex_trainer_trains_and_leaves_no_process():
    """``ApexTrainer.train`` with ``mesh_shape=(2,)``: rank 0 here, rank 1
    spawned, one actor process; every rank takes every step and both
    shards fill.  The rank outlives ``train()`` (parked), a second
    ``train()`` continues on it, and neither a rank nor an actor is left
    after ``close()``."""
    from apex_tpu_torch.training.apex import ApexTrainer

    cfg = small_test_config(capacity=1024, batch_size=32, n_actors=1)
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  mesh_shape=(2,)))
    before = set(mp.active_children())
    t = ApexTrainer(cfg, device="cpu", dp_backend="gloo",
                    publish_min_seconds=0.05)
    assert t.n_dp == 2
    t.train(total_steps=12, max_seconds=120, log_every=6)
    assert t.steps_rate.total == 12
    assert t.ingested >= cfg.replay.warmup
    stats = t.dp_rank_stats
    assert sorted(stats) == [0, 1]
    for rec in stats.values():
        assert rec["steps"] == 12
        assert rec["replay_size"] > 0
        assert rec["collectives"]["allreduce_calls"] == 12
    # no shard wrapped: the two shards hold every transition ingested
    assert stats[0]["replay_size"] + stats[1]["replay_size"] == t.ingested
    alive = set(mp.active_children()) - before
    assert [p.name for p in alive] == ["apex-dp-rank1"]
    t.train(total_steps=2, max_seconds=120, log_every=6)
    assert t.steps_rate.total == 14
    assert t.dp_rank_stats[1]["steps"] == 14
    assert set(mp.active_children()) - before == alive    # the same rank
    t.close()
    assert set(mp.active_children()) <= before
    with pytest.raises(RuntimeError, match="replay shards"):
        t.train(total_steps=1)


def test_rank_ops_keep_a_follower_trainer_equal_to_rank_0(tmp_path):
    """The trainer's op protocol, rank 1 a thread running ``_follow``.
    First session: the start-of-train ``restore`` (rank 0's weights over
    rank 1's own), ingest and fused groups, a train-only step,
    ``apply_hparams`` (the optimizer rebuilt on both ranks), a no-op and
    ``stop``.  Second session: ``restore_weights`` of a donor checkpoint,
    one fused group, ``stop``.  After each, rank 1's weights, optimizer
    state, step and shard size equal rank 0's, bit for bit."""
    from apex_tpu_torch.parallel.learner import NoActors
    from apex_tpu_torch.training.apex import ApexTrainer
    from tests.test_torch_sharded_pipeline import (_cartpole_chunk_messages,
                                                   _group)

    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    donor = ApexTrainer(cfg, pool=NoActors(), device="cpu",
                        respawn_workers=False,
                        checkpoint_dir=str(tmp_path / "donor"))
    with torch.no_grad():
        for p in donor.train_state.params.parameters():
            p.mul_(0.5)
    donor.train_state.step = 7
    path = donor.save_checkpoint()

    dp_cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                     mesh_shape=(2,)))
    rank0 = ApexTrainer(dp_cfg, pool=NoActors(), device="cpu",
                        respawn_workers=False, dp_backend="gloo")
    one = cfg.replace(env=dataclasses.replace(cfg.env, seed=cfg.env.seed + 1))
    rank1 = ApexTrainer(one, pool=NoActors(), device="cpu",
                        respawn_workers=False)
    msgs = _cartpole_chunk_messages(10, seed=5)
    groups = [_group(msgs[i:i + 2]) for i in range(0, 10, 2)]

    def dispatch(g, train):
        rank0._dispatch_one(g["payload"], g["priorities"], g["n_trans"],
                            train)

    def session(rank0_ops):
        def rank(r, group):
            trainer = (rank0, rank1)[r]
            trainer._join_dp(group)
            if r == 1:
                trainer._follow()
            else:
                rank0_ops()
                rank0._dp_send("stop")
        run_ranks(2, rank)
        a, b = rank0.train_state, rank1.train_state
        assert a.step == b.step
        for x, y in zip(a.params.state_dict().values(),
                        b.params.state_dict().values()):
            assert torch.equal(x, y)
        for x, y in zip(a.target_params.state_dict().values(),
                        b.target_params.state_dict().values()):
            assert torch.equal(x, y)
        for x, y in zip(a.opt_state.nu, b.opt_state.nu):
            assert torch.equal(x, y)
        assert a.opt_state.count == b.opt_state.count
        assert rank1.replay_state.size == rank0.replay_state.size > 0

    def first():
        rank0._dp_sync()
        dispatch(groups[0], False)
        dispatch(groups[1], True)
        dispatch(groups[2], True)
        rank0._dp_dispatch("train")
        rank0.apply_hparams({"lr": 1e-3, "prio_beta": 0.5})
        dispatch(groups[3], True)
        rank0._dp_send("noop")

    session(first)
    assert rank0.train_state.step == 4
    assert rank1.core.optimizer.lr == rank0.core.optimizer.lr == 1e-3
    assert rank1.cfg.replay.beta == 0.5

    def second():
        rank0.restore_weights(path)
        dispatch(groups[4], True)

    session(second)
    assert rank0.train_state.step == 8            # the donor's 7, then one
