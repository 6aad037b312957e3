"""The port's fused plane at dp 2 (``apex_tpu_torch/ondevice/fused.py``)
against JAX's ``FusedStep`` on a 2-device mesh (``apex_tpu/ondevice/
fused.py:53-63,123-172,276-285,324-410``).

The port's ranks are threads of this process over gloo on one
``HashStore`` (``tests/test_torch_parallel.py:run_ranks``); JAX's mesh is
2 of the 8 virtual host devices ``tests/conftest.py`` forces.  Each port
rank owns two of the four lanes and replays JAX's fanned per-chip keys:
its engine's draws are chip r's key of ``split(rk, 2)`` for each macro's
engine key ``rk`` (reset draws: the full engine's lanes ``[2r, 2r+2)``),
its uniforms ``uniform(split(k, 2)[r], (batch/2,))`` for each train
slot's key ``k``.  Every lane acts at eps 1, so the actions do not depend
on the two frameworks' Q-values.

Tolerances, as ``tests/test_torch_ondevice.py`` states them for dp 1:
each partition's ring, tables, epochs and cursors exact; trees and the
running max priority rtol 1e-3 / atol 1e-5 (the priorities are ``|target
- q|`` of two networks, which magnifies their f32 round-off); losses
rtol 1e-5; weights atol 1e-5; counters, budget and episode stats equal,
with and without ``train_ratio``.  Bit for bit: both ranks' weights after
every dispatch, and the port's fused dp 2 against its serial dp 2
(``steps_per_dispatch`` 3 x 2 dispatches == 1 x 6).  Also the divisibility
errors, which name both knobs, and ``counters()`` / ``fleet_summary``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig)
from apex_tpu_torch.ondevice.fused import FusedApexTrainer, FusedStep
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu.training import anakin as jax_anakin
from tests.test_torch_anakin import JaxKeyDraws
from tests.test_torch_device_envs import keyed_draws, lane_keys
from tests.test_torch_ondevice import _assert_replay_equal
from tests.test_torch_parallel import run_ranks

WORLD, B, T, K, S, BATCH = 2, 4, 8, 8, 2, 16
LANES = B // WORLD


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Every rank is a thread here: each takes one torch thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class FannedKeyDraws(JaxKeyDraws):
    """Chip ``rank``'s draws of JAX's sharded engine: the reset of the
    whole engine's lanes, this chip's block of them; per dispatch one
    split of the chain, fanned ``split(rk, world)``, this chip's key
    (``apex_tpu/ondevice/fused.py:389-395``)."""

    def __init__(self, seed, num_actions, rank, world):
        super().__init__(seed, num_actions)
        self.rank, self.world = rank, world

    def reset(self, sites, n):
        keys = lane_keys(self.init_key, n * self.world)
        return keyed_draws(keys[self.rank * n:(self.rank + 1) * n], sites)

    def dispatch(self, sites, steps, n):
        self.chain, rk = jax.random.split(self.chain)
        key = jax.random.split(rk, self.world)[self.rank]
        env_sites = {k: v for k, v in sites.items()
                     if k not in ("explore", "action")}
        rows = []
        for sk in jax.random.split(key, steps):
            ek, ak = jax.random.split(
                jax.random.fold_in(sk, jax_anakin.T_POLICY))
            row = keyed_draws(lane_keys(
                jax.random.fold_in(sk, jax_anakin.T_ENV), n), env_sites)
            row["explore"] = torch.from_numpy(np.array(
                jax.random.uniform(ek, (n,))))
            row["action"] = torch.from_numpy(np.array(
                jax.random.randint(ak, (n,), 0, self.num_actions)))
            rows.append(row)
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class FannedUniforms:
    """Chip ``rank``'s PER uniforms of JAX's sharded fused dispatch: per
    train slot one split of the sample key, fanned ``split(k, world)``,
    ``uniform(k_r, (batch/world,))``."""

    def __init__(self, seed, rank, world):
        self.key = jax.random.key(seed)
        self.rank, self.world = rank, world

    def __call__(self, n):
        rows = []
        for _ in range(n):
            self.key, k = jax.random.split(self.key)
            kr = jax.random.split(k, self.world)[self.rank]
            rows.append(np.array(jax.random.uniform(
                kr, (BATCH // self.world,))))
        return torch.from_numpy(np.stack(rows))


KNOBS = dict(warmup=32, beta=0.4, beta_anneal=200, steps_per_dispatch=2,
             train_per_step=2)


def _jax_fused(train_ratio):
    from apex_tpu.envs.registry import make_jax_env
    from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
    from apex_tpu.models.dueling import make_policy_fn
    from apex_tpu.ondevice.fused import FusedStep as JaxFused
    from apex_tpu.ops.losses import make_optimizer as jax_optimizer
    from apex_tpu.parallel.learner import ShardedLearner as JaxSharded
    from apex_tpu.parallel.mesh import make_mesh
    from apex_tpu.replay.frame_pool import FramePoolReplay as JaxSpec
    from apex_tpu.training.anakin import AnakinRollout as JaxRollout
    from apex_tpu.training.learner import LearnerCore as JaxCore
    from apex_tpu.training.state import create_train_state as jax_state

    flax_model = FlaxDQN(num_actions=3, compute_dtype=jnp.float32)
    jspec = JaxSpec(capacity=256, frame_shape=(42, 42, 1), frame_stack=S)
    jopt = jax_optimizer(lr=1e-3)
    jts = jax_state(flax_model, jopt, jax.random.key(0),
                    jnp.zeros((1, 42, 42, S), jnp.uint8))
    jcore = JaxCore(apply_fn=flax_model.apply, replay=jspec, optimizer=jopt,
                    batch_size=BATCH, target_update_interval=4)
    mesh = make_mesh(dp=WORLD, devices=jax.devices()[:WORLD])
    jsl = JaxSharded(jcore, mesh)
    jeng = JaxRollout(make_jax_env("ApexCatchSmall-v0"),
                      make_policy_fn(flax_model), n_envs=B,
                      epsilons=[1.0] * B, frame_stack=S,
                      chunk_transitions=K, rollout_len=T, seed=5)
    params = jax.device_get(jts.params)
    jts = jsl.replicate_train_state(jts)
    jrs = jsl.shard_replay_state(jspec.init())
    jfused = JaxFused(jcore, jspec, jeng, mesh=mesh, train_ratio=train_ratio,
                      **KNOBS)
    return jfused, jts, jrs, params


def _port_rank(r, params, train_ratio):
    from apex_tpu_torch.convert import params_from_flax
    from apex_tpu_torch.envs.device_envs import make_device_env
    from apex_tpu_torch.models.dueling import DuelingDQN
    from apex_tpu_torch.ops.losses import make_optimizer
    from apex_tpu_torch.training.anakin import AnakinRollout
    from apex_tpu_torch.training.learner import LearnerCore
    from apex_tpu_torch.training.state import create_train_state

    model = DuelingDQN(3, (42, 42, S), compute_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_flax(params))
    spec = FramePoolReplay(capacity=256, frame_shape=(42, 42, 1),
                           frame_stack=S)
    core = LearnerCore(replay=spec, optimizer=make_optimizer(lr=1e-3),
                       batch_size=BATCH, target_update_interval=4)
    eng = AnakinRollout(make_device_env("ApexCatchSmall-v0", device="cpu"),
                        model, n_envs=LANES, epsilons=[1.0] * LANES,
                        slot_ids=list(range(r * LANES, (r + 1) * LANES)),
                        frame_stack=S, chunk_transitions=K, rollout_len=T,
                        draws=FannedKeyDraws(5, 3, r, WORLD))
    fused = FusedStep(core, spec, eng, train_ratio=train_ratio, n_dp=WORLD,
                      **KNOBS)
    return fused, create_train_state(model, core.optimizer), spec.init("cpu")


@pytest.mark.parametrize("train_ratio", [None, 1.0],
                         ids=["structural", "train_ratio"])
def test_fused_step_at_dp_2_matches_jax(train_ratio):
    from apex_tpu_torch.convert import params_from_flax

    jfused, jts, jrs, params = _jax_fused(train_ratio)
    skey = jax.random.key(9)
    want = []
    for _ in range(3):
        # apexlint: disable=J004 -- dispatch splits the chain and returns the advanced key
        jts, jrs, skey, jinfo = jfused.dispatch(jts, jrs, skey)
        # apexlint: disable=J006 -- the next dispatch donates the replay: read each dispatch's partitions before it
        want.append((jinfo, jax.device_get(jrs),
                     int(jfused.ingested_dev), float(jfused.budget_dev)))

    def rank(r, group):
        fused, ts, rs = _port_rank(r, params, train_ratio)
        fused.join(group)
        uniforms = FannedUniforms(9, r, WORLD)
        out = []
        for _ in range(3):
            ts, rs, info = fused.dispatch(ts, rs, uniforms)
            out.append((info, {f.name: (getattr(rs, f.name).clone()
                                        if isinstance(getattr(rs, f.name),
                                                      torch.Tensor)
                                        else getattr(rs, f.name))
                               for f in dataclasses.fields(rs)},
                        fused.ingested, fused.budget,
                        [p.detach().clone() for p in ts.params.parameters()]))
        return {"ts": ts, "fused": fused, "out": out}

    res = run_ranks(WORLD, rank)
    trained = 0
    for d, (jinfo, jstate, j_ing, j_bud) in enumerate(want):
        where = f"dispatch {d}"
        for r in range(WORLD):
            info, rs, ing, bud, weights = res[r]["out"][d]
            assert info["transitions"] == jinfo["transitions"], where
            assert info["train_steps"] == jinfo["train_steps"], where
            assert info["frames"] == jinfo["frames"], where
            assert ing == j_ing and bud == np.float32(j_bud), where
            part = jax.tree.map(lambda x, r=r: np.asarray(x)[r], jstate)
            _assert_replay_equal(_Ns(rs), part, rtol=1e-3, atol=1e-5,
                                 where=f"{where} rank {r}")
            assert [(s.actor_id, s.reward, s.length) for s in info["stats"]] \
                == [(s.actor_id, s.reward, s.length)
                    for s in jinfo["stats"]], where
            if jinfo["metrics"] is not None:
                for k in ("loss", "q_mean", "td_mean"):
                    np.testing.assert_allclose(
                        info["metrics"][k], jinfo["metrics"][k], rtol=1e-5,
                        atol=1e-6, err_msg=f"{where} {k}")
        # the DP invariant: both ranks' weights bit-identical
        for x, y in zip(res[0]["out"][d][4], res[1]["out"][d][4]):
            assert torch.equal(x, y), where
        trained += jinfo["train_steps"]
    assert trained >= 2
    if train_ratio is not None:
        assert trained < 2 * 2 * 3       # the budget held slots back
    ts = res[0]["ts"]
    assert ts.step == int(jts.step) == trained
    for r in range(WORLD):
        c = res[r]["fused"].counters()
        assert c["dp"] == WORLD and c["n_envs"] == B
        assert c["prio_writebacks"] == jfused.prio_writebacks
        assert c["train_steps"] == jfused.train_steps
        assert c["chunks"] == jfused.chunks
    want_w = params_from_flax(jax.device_get(jts.params))
    for name, p in ts.params.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_w[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


class _Ns:
    """A replay state's fields as attributes."""

    def __init__(self, fields):
        self.__dict__.update(fields)


# -- the port's own contracts ------------------------------------------------

def _cfg(dp=2, n_envs=2, batch=16, mesh=True):
    return ApexConfig(
        env=EnvConfig(env_id="ApexCatchSmall-v0", frame_stack=2, seed=3),
        replay=ReplayConfig(capacity=512, warmup=32, beta_anneal=2000),
        learner=LearnerConfig(batch_size=batch, compute_dtype="float32",
                              target_update_interval=50,
                              publish_interval=5, save_interval=10 ** 9,
                              mesh_shape=(dp,) if mesh else (1,)),
        actor=ActorConfig(n_actors=2, n_envs_per_actor=n_envs,
                          send_interval=8))


def _fused_dp_pair(steps_per_dispatch, dispatches, train_ratio):
    """Rank 0's and rank 1's ``FusedApexTrainer`` (threads), joined,
    after ``dispatches`` lockstep dispatches."""
    def rank(r, group):
        kw = dict(device="cpu", steps_per_dispatch=steps_per_dispatch,
                  rollout_len=8, train_ratio=train_ratio,
                  respawn_workers=False)
        if r == 0:
            t = FusedApexTrainer(_cfg(), dp_backend="gloo", **kw)
        else:
            t = FusedApexTrainer(_cfg(mesh=False), lanes=(r, WORLD), **kw)
        t._join_dp(group)
        for _ in range(dispatches):
            t._fused_dispatch()
        return t

    return run_ranks(WORLD, rank)


def _assert_ranks_equal(a, b, same_replay=True):
    for x, y in zip(list(a.train_state.params.parameters())
                    + list(a.train_state.target_params.parameters())
                    + a.train_state.opt_state.nu,
                    list(b.train_state.params.parameters())
                    + list(b.train_state.target_params.parameters())
                    + b.train_state.opt_state.nu):
        assert torch.equal(x, y)
    assert a.train_state.step == b.train_state.step
    if not same_replay:
        return
    for f in dataclasses.fields(a.replay_state):
        x, y = getattr(a.replay_state, f.name), getattr(b.replay_state,
                                                        f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.fused.engine.ring, b.fused.engine.ring)
    assert (a.fused.ingested, a.fused.budget, a.fused.train_steps) == (
        b.fused.ingested, b.fused.budget, b.fused.train_steps)


@pytest.mark.parametrize("train_ratio", [None, 0.5],
                         ids=["structural", "train_ratio"])
def test_fused_dp_2_equals_serial_dp_2_bit_for_bit(train_ratio):
    """steps_per_dispatch=3 x 2 dispatches == 1 x 6 on both ranks:
    weights, optimizer, each rank's shard, generators, engine ring and
    the global counters; the two ranks' weights equal each other, their
    shards differ (each ingests its own lanes)."""
    fused = _fused_dp_pair(3, 2, train_ratio)
    serial = _fused_dp_pair(1, 6, train_ratio)
    for r in range(WORLD):
        _assert_ranks_equal(fused[r], serial[r])
    _assert_ranks_equal(fused[0], fused[1], same_replay=False)
    assert fused[0].train_state.step > 0
    assert not torch.equal(fused[0].replay_state.frames,
                           fused[1].replay_state.frames)
    assert fused[0].fused.ingested == fused[1].fused.ingested
    assert fused[0].fused.shard_sizes == [int(t.replay_state.size)
                                          for t in fused]
    assert fused[0].fused.lane_ids == [0, 1, 2, 3]
    # the heartbeat gauges and fleet_summary's ondevice block
    from apex_tpu_torch.fleet.registry import FleetRegistry
    t = fused[0]
    t.fleet = FleetRegistry(t.cfg.comms)
    ond = t.fleet_summary()["metrics"]["ondevice"]
    assert ond["dp"] == 2 and ond["n_envs"] == 4
    assert ond["pool_size_per_shard"] == fused[0].fused.shard_sizes
    assert all(n > 0 for n in ond["pool_size_per_shard"])


def test_fused_dp_divisibility_errors_name_their_knobs():
    with pytest.raises(ValueError, match="batch_size=15.*mesh"):
        FusedApexTrainer(_cfg(batch=15), device="cpu", dp_backend="gloo")
    with pytest.raises(ValueError, match="n_envs_per_actor.*mesh"):
        FusedApexTrainer(_cfg(dp=4, n_envs=1), device="cpu",
                         dp_backend="gloo")
    t = FusedApexTrainer(_cfg(), device="cpu", dp_backend="gloo")
    assert t.n_dp == 2 and t.fused.engine.B == 2
    assert t.fused.counters()["dp"] == 2
    with pytest.raises(RuntimeError, match="joined dp group"):
        t._fused_dispatch()


def test_a_live_lr_reaches_the_fused_step():
    """``apply_hparams``' new lr rebuilds the core; the fused step trains
    with it (``apex_tpu/ondevice/fused.py:722-729``)."""
    t = FusedApexTrainer(_cfg(mesh=False, n_envs=2), device="cpu",
                         respawn_workers=False)
    assert t.apply_hparams({"lr": 1e-3}) == {"lr": 1e-3}
    assert t.fused.core is t.core and t.fused.core.optimizer.lr == 1e-3
