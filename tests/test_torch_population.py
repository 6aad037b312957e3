"""The port's population plane and the learner's ctl surface against
``apex_tpu.population`` and ``apex_tpu.training.apex``.

* Lineages: ``parse_population``, ``apply_lineage`` and the roster fold-in
  give the JAX package's specs and configs.
* :class:`PopulationController` of both packages, on one seed and one fake
  clock, takes the same exploit/explore decisions (stdlib ``random``
  draws the same vectors), skips the same lineages and never exploits a
  population of one; every tick's commands, the ``snapshot()`` dicts, the
  Prometheus sections and the status lines are equal.
* ``restore_weights``: a JAX donor's checkpoint, carried across by
  ``convert.py`` and saved as the port's bundle, is imposed bit for bit on
  a live port learner, whose next update on a fixed batch then matches the
  JAX learner's after its own ``restore_weights`` (loss rtol 1e-5, grad
  norm rtol 1e-4, as ``tests/test_torch_learner.py``).  ``apply_hparams``
  keeps the optimizer's moments and count and changes only the lr and
  beta, as JAX reports.
* The ctl queue: an exploit enqueued through the status server applies at
  the trainer thread's drain (epoch bumped, fleet re-fenced, a publish),
  a pruned donor path falls back to the newest checkpoint, a bad one is
  counted.  The trainer folds all three controllers' stats into its
  summary, status table and Prometheus text.
"""

from __future__ import annotations

import copy
import dataclasses
import queue as queue_lib
import shutil
import socket

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
from apex_tpu.population import controller as jax_ctl
from apex_tpu.population import lineage as jax_lineage
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu.tenancy import namespace as jax_ns
from apex_tpu.training import apex as jax_apex
from apex_tpu.training import checkpoint as jax_checkpoint
from apex_tpu_torch.config import (ActorConfig, ApexConfig, CommsConfig,
                                   EnvConfig, LearnerConfig, ReplayConfig,
                                   small_test_config)
from apex_tpu_torch.convert import train_state_from_flax
from apex_tpu_torch.fleet.registry import (FleetRegistry, FleetStatusServer,
                                           ctl_request, format_fleet_table)
from apex_tpu_torch.models.dueling import DuelingDQN
from apex_tpu_torch.population import controller as ctl
from apex_tpu_torch.population import lineage
from apex_tpu_torch.replay_service.shard import ReplayShardCore
from apex_tpu_torch.serving import deploy
from apex_tpu_torch.tenancy import namespace as ns
from apex_tpu_torch.tenancy import scheduler as sched
from apex_tpu_torch.training.apex import ApexTrainer

ENV, B, K = "ApexCatchSmall-v0", 16, 16

POPULATION = [
    dict(name="la", env_id="ApexCatchSmall-v0", lr=1e-4, prio_beta=0.4,
         eps_base=0.4),
    dict(name="lb", env_id="ApexCatchSmall-v0", lr=2e-4, prio_beta=0.5,
         eps_base=0.3, n_steps=2),
    dict(name="lc", env_id="ApexCatchSmall-v0"),
    dict(name="r0", env_id="ApexRallySmall-v0"),
]


class FakeClock:
    def __init__(self, t: float = 10.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- lineages ----------------------------------------------------------------

def test_lineages_parse_apply_and_fold_into_the_roster_as_jax_does():
    import json
    raw = json.dumps(POPULATION)
    mine, theirs = lineage.parse_population(raw), \
        jax_lineage.parse_population(raw)
    assert {n: s.to_dict() for n, s in mine.items()} == \
        {n: s.to_dict() for n, s in theirs.items()}
    assert all(isinstance(s, ns.TenantSpec) for s in mine.values())
    with pytest.raises(ValueError, match="duplicate"):
        lineage.parse_population(json.dumps(POPULATION[:1] * 2))
    cfg, jcfg = small_test_config(), jax_small_config()
    for name in mine:
        got = lineage.apply_lineage(cfg, mine[name])
        want = jax_lineage.apply_lineage(jcfg, theirs[name])
        for section in ("env", "learner", "replay", "actor"):
            a, b = getattr(got, section), getattr(want, section)
            for f in dataclasses.fields(a):
                if hasattr(b, f.name):
                    assert getattr(a, f.name) == getattr(b, f.name), \
                        (name, section, f.name)
    # a lineage without overrides leaves the config as it is
    assert lineage.apply_lineage(cfg, lineage.LineageSpec(name="x")) is cfg
    env = {"APEX_POPULATION": raw,
           "APEX_TENANTS": json.dumps([{"name": "la", "weight": 3.0}])}
    roster, jroster = ns.load_roster(env), jax_ns.load_roster(env)
    assert {n: s.to_dict() for n, s in roster.items()} == \
        {n: s.to_dict() for n, s in jroster.items()}
    assert roster["la"].weight == 3.0       # the operator's entry wins
    assert isinstance(roster["lb"], lineage.LineageSpec)
    assert lineage.load_population({}) == {}


# -- the controller ----------------------------------------------------------

def _controllers(specs, **kw):
    clock, wall = FakeClock(), FakeClock(1.7e9)
    mine = ctl.PopulationController(
        {d["name"]: lineage.LineageSpec(**d) for d in specs},
        clock=clock, wall=wall, seed=5, **kw)
    theirs = jax_ctl.PopulationController(
        {d["name"]: jax_lineage.LineageSpec(**d) for d in specs},
        clock=clock, wall=wall, seed=5, **kw)
    return mine, theirs, clock


def _agree(mine, theirs, cmds, jcmds):
    assert cmds == jcmds
    snap = mine.snapshot()
    assert snap == theirs.snapshot()
    assert ctl.prometheus_sections(snap) == jax_ctl.prometheus_sections(snap)
    assert ctl.format_population_lines(snap) == \
        jax_ctl.format_population_lines(snap)


def test_controller_exploits_and_explores_as_jax_does():
    mine, theirs, clock = _controllers(
        POPULATION, decide_every_s=10.0, frac=0.34, min_episodes=2)
    for name in mine.lineages:
        assert ctl.resolve_vector(mine.lineages[name].spec) == \
            jax_ctl.resolve_vector(theirs.lineages[name].spec)
    # rounds of observations: (seconds, {lineage: (score, episodes, ckpt)})
    rounds = [
        (0, {"la": (5.0, 4, None), "lb": (-3.0, 4, None),
             "lc": (1.0, 1, None), "r0": (9.0, 9, "/ck/r0/ckpt_1.pt")}),
        (4, {"la": (5.5, 5, "/ck/la/ckpt_12.pt"), "lb": (-2.0, 5, None),
             "lc": (0.5, 6, "/ck/lc/ckpt_3.pt")}),
        (7, {"la": (6.0, 6, "/ck/la/ckpt_14.pt"), "lb": (-1.0, 6, None),
             "lc": (0.0, 7, "/ck/lc/ckpt_4.pt")}),
        (11, {"la": (6.0, 7, None), "lb": (7.0, 8, "/ck/lb/ckpt_9.pt"),
              "lc": (-4.0, 9, None)}),
        (25, {"la": (1.0, 8, None), "lb": (2.0, 9, None),
              "lc": (3.0, 9, None)}),
        (30, {"la": (1.0, 8, None), "lb": (1.0, 9, None),
              "lc": (1.0, 9, None)}),
    ]
    sent = []
    for dt, obs in rounds:
        clock.t += dt
        for name in mine.lineages:
            alive = name in obs
            score, eps, ckpt = obs.get(name, (None, 0, None))
            for c in (mine, theirs):
                c.observe(name, alive=alive, score=score, episodes=eps,
                          steps=eps * 10 if alive else None, checkpoint=ckpt)
        cmds = mine.tick()
        _agree(mine, theirs, cmds, theirs.tick())
        sent.extend(cmds)
    assert mine.exploits >= 2 and mine.decisions >= 3
    assert "lb" in {lin for lin, _ in sent}
    assert all(cmd["op"] == "exploit" and cmd["restore_from"]
               for _, cmd in sent)
    for _, cmd in sent:
        for name, (lo, hi) in lineage.HPARAM_BANDS.items():
            assert lo <= cmd["hparams"][name] <= hi
    # the Rally ladder holds one lineage: never exploited
    assert mine.lineages["r0"].exploits_taken == 0
    assert any(e["event"] == ctl.SKIPPED for e in mine.timeline)


def test_population_of_one_never_exploits():
    mine, theirs, clock = _controllers(POPULATION[:1], decide_every_s=1.0,
                                       min_episodes=1)
    for _ in range(5):
        clock.t += 2.0
        for c in (mine, theirs):
            c.observe("la", alive=True, score=1.0, episodes=9,
                      checkpoint="/ck/la/ckpt_1.pt")
        _agree(mine, theirs, mine.tick(), theirs.tick())
    assert mine.exploits == 0 and mine.decisions == 5
    # the mutation draws are JAX's for one seed
    vec = ctl.resolve_vector(lineage.LineageSpec(name="la"))
    assert mine.mutate(dict(vec)) == theirs.mutate(dict(vec))


# -- restore_weights and apply_hparams against JAX ---------------------------

class StubPool:
    accepts_device_params = False

    def __init__(self, msgs=()):
        self._msgs = list(msgs)
        self.procs = []
        self.published = []
        self.epochs = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        self.published.append(version)

    def set_learner_epoch(self, epoch):
        self.epochs.append(epoch)

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        return out


def _catch_messages(n):
    rng = np.random.default_rng(0)
    b = JaxBuilder(3, 0.99, 4, (42, 42, 1), chunk_transitions=K)
    msgs = []
    while len(msgs) < n:
        b.begin_episode(rng.integers(0, 255, (42, 42, 1)).astype(np.uint8))
        length = int(rng.integers(5, 40))
        for t in range(length):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, (42, 42, 1)).astype(np.uint8),
                       t == length - 1, False)
        for chunk in b.poll():
            prios = chunk.pop("priorities")
            msgs.append({"payload": chunk, "priorities": prios,
                         "n_trans": int(chunk["n_trans"])})
    return msgs[:n]


def _jax_cfg(seed):
    return JaxApexConfig(
        env=JaxEnvConfig(env_id=ENV, seed=seed),
        replay=JaxReplayConfig(capacity=512, warmup=64),
        learner=JaxLearnerConfig(batch_size=B, compute_dtype="float32",
                                 target_update_interval=7,
                                 ingest_pipeline=False),
        actor=JaxActorConfig(send_interval=K))


def _port_cfg(seed):
    return ApexConfig(
        env=EnvConfig(env_id=ENV, seed=seed),
        replay=ReplayConfig(capacity=512, warmup=64),
        learner=LearnerConfig(batch_size=B, compute_dtype="float32",
                              target_update_interval=7),
        actor=ActorConfig(send_interval=K))


@pytest.fixture(scope="module")
def donors(tmp_path_factory):
    """A JAX donor trained 6 steps and saved; its state carried across
    into a port learner and saved as the port's bundle; a JAX and a port
    learner of another seed to take the copy."""
    ck = tmp_path_factory.mktemp("pbt")
    jt = jax_apex.ApexTrainer(_jax_cfg(5),
                              pool=StubPool(_catch_messages(10)),
                              publish_min_seconds=0.0, respawn_workers=False,
                              checkpoint_dir=str(ck / "jax"))
    jt.train(total_steps=6, max_seconds=120, log_every=10 ** 9)
    jpath = jt.save_checkpoint()
    raw, _ = jax_checkpoint.load_raw(jpath)
    pa = ApexTrainer(_port_cfg(5), pool=StubPool(), device="cpu",
                     checkpoint_dir=str(ck / "port"))
    model = DuelingDQN(**pa.model_spec,
                       generator=torch.Generator().manual_seed(0))
    pa.train_state = train_state_from_flax(raw["train_state"], model,
                                           pa.core.optimizer)
    ppath = pa.save_checkpoint()
    jb = jax_apex.ApexTrainer(_jax_cfg(777), pool=StubPool(),
                              publish_min_seconds=0.0,
                              respawn_workers=False)
    pb = ApexTrainer(_port_cfg(777), pool=StubPool(), device="cpu")
    return dict(jt=jt, jpath=jpath, pa=pa, ppath=ppath, jb=jb, pb=pb)


def _fixed_batch():
    rng = np.random.default_rng(4)
    obs = rng.integers(0, 256, (2 * B, 42, 42, 4)).astype(np.uint8)
    return dict(obs=obs[:B], next_obs=obs[B:],
                action=rng.integers(0, 3, B).astype(np.int32),
                reward=rng.normal(size=B).astype(np.float32),
                discount=np.full(B, 0.97, np.float32)), \
        rng.uniform(0.2, 1.0, B).astype(np.float32)


def _module_state(ts):
    return ({k: v for k, v in ts.params.state_dict().items()},
            {k: v for k, v in ts.target_params.state_dict().items()},
            ts.opt_state.mu + ts.opt_state.nu, ts.opt_state.count, ts.step)


def test_restore_weights_then_one_step_matches_jax(donors):
    pa, pb, jb = donors["pa"], donors["pb"], donors["jb"]
    replay_before = pb.replay_state
    gen_before = pb.generator.get_state().clone()
    steps_before, epoch_before = pb.steps_rate.total, pb.learner_epoch
    meta = pb.restore_weights(donors["ppath"])
    assert meta["steps"] == pa.steps_rate.total
    (pa_p, pa_t, pa_m, pa_c, pa_s) = _module_state(pa.train_state)
    (pb_p, pb_t, pb_m, pb_c, pb_s) = _module_state(pb.train_state)
    for want, got in ((pa_p, pb_p), (pa_t, pb_t)):
        for name in want:
            assert torch.equal(want[name], got[name]), name
    assert all(torch.equal(x, y) for x, y in zip(pa_m, pb_m))
    assert (pb_c, pb_s) == (pa_c, pa_s) == (6, 6)
    # replay, the generator and the host counters are this life's
    assert pb.replay_state is replay_before
    assert torch.equal(pb.generator.get_state(), gen_before)
    assert pb.steps_rate.total == steps_before
    assert pb.learner_epoch == epoch_before + 1
    jepoch = jb.learner_epoch
    jb.restore_weights(donors["jpath"])
    assert jb.learner_epoch == jepoch + 1 == pb.learner_epoch
    # the next update on one fixed batch
    batch, weights = _fixed_batch()
    jts, _, jm = jb.core.update_from_batch(
        jb.train_state, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(weights))
    _, _, m = pb.core.update_from_batch(
        pb.train_state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(weights))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert pb.train_state.step == int(jts.step) == 7
    # a shard that saw the new epoch drops the pre-copy life's write-backs
    core = ReplayShardCore(pb.replay, torch.Generator(), batch_size=B,
                           warmup=1, device="cpu")
    core.note_epoch(pb.learner_epoch)
    assert not core.write_back(0, np.zeros(B, np.int64), np.ones(B),
                               epoch=epoch_before)
    assert core.stale_wb == 1


def test_apply_hparams_keeps_the_moments_and_changes_the_lr(donors):
    pb, jb = donors["pb"], donors["jb"]
    ts = pb.train_state
    moments = [t.clone() for t in ts.opt_state.mu + ts.opt_state.nu]
    objects = [id(t) for t in ts.opt_state.mu + ts.opt_state.nu]
    count, decay_before = ts.opt_state.count, pb.core.optimizer
    h = {"lr": 1e-3, "prio_beta": 0.7, "n_steps": 4, "prio_alpha": None}
    applied = pb.apply_hparams(dict(h))
    assert applied == jb.apply_hparams(dict(h)) == {"lr": 1e-3,
                                                    "prio_beta": 0.7}
    assert pb.hparams_live == jb.hparams_live
    assert [id(t) for t in ts.opt_state.mu + ts.opt_state.nu] == objects
    assert all(torch.equal(a, b) for a, b in
               zip(moments, ts.opt_state.mu + ts.opt_state.nu))
    assert ts.opt_state.count == count
    opt = pb.core.optimizer
    assert opt == dataclasses.replace(decay_before, lr=1e-3)
    assert opt.learning_rate(count) == pytest.approx(
        1e-3 * opt.lr_decay_rate ** (count // opt.lr_decay_steps))
    assert pb.cfg.learner.lr == jb.cfg.learner.lr == 1e-3
    assert pb._beta(0) == jb._beta(0) == 0.7


# -- the ctl queue and the sections ------------------------------------------

def test_exploit_through_the_ctl_queue(donors, tmp_path):
    pb = donors["pb"]
    pb._ctl_queue = queue_lib.Queue(maxsize=8)
    pb.fleet = FleetRegistry(pb.cfg.comms)
    info = pb._enqueue_ctl({"op": "exploit", "donor": "la",
                            "restore_from": donors["ppath"],
                            "hparams": {"prio_beta": 0.6}})
    assert info == {"accepted": True, "pending": 1}
    epoch, published = pb.learner_epoch, len(pb.pool.published)
    pb._drain_ctl(steps=0)
    rec = pb._population_ctl
    assert (rec["exploits"], rec["applied"], rec["explores"]) == (1, 1, 1)
    assert rec["last"]["learner_epoch"] == epoch + 1 == pb.learner_epoch
    assert len(pb.pool.published) == published + 1
    assert pb.pool.epochs[-1] == pb.learner_epoch
    m = pb.fleet_summary()["metrics"]
    assert m["population_ctl"]["exploits"] == 1
    assert m["hparams_live"]["prio_beta"] == 0.6
    # a pruned donor path restores the newest file of its directory
    donor_dir = tmp_path / "donor"
    donor_dir.mkdir()
    shutil.copy(donors["ppath"], donor_dir / "ckpt_9.pt")
    pb._enqueue_ctl({"op": "exploit", "donor": "la",
                     "restore_from": str(donor_dir / "ckpt_1.pt")})
    pb._drain_ctl(steps=0)
    assert pb._population_ctl["errors"] == 0
    assert pb._population_ctl["last"]["restored_from"].endswith("ckpt_9.pt")
    # an unreadable path is counted; the epoch stays
    epoch = pb.learner_epoch
    pb._enqueue_ctl({"op": "exploit", "restore_from": "/nope/ckpt_1.pt"})
    pb._enqueue_ctl({"op": "bogus"})
    pb._drain_ctl(steps=0)
    assert pb._population_ctl["errors"] == 2
    assert pb.learner_epoch == epoch
    for _ in range(8):
        pb._enqueue_ctl({"op": "hparams", "hparams": {}})
    assert pb._enqueue_ctl({"op": "hparams"}) == {
        "accepted": False, "error": "ctl queue full"}
    pb._drain_ctl(steps=0)


def test_status_server_hands_ctl_frames_to_the_queue(donors):
    pb = donors["pb"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    comms = CommsConfig(status_port=port)
    pb._ctl_queue = queue_lib.Queue(maxsize=8)
    server = FleetStatusServer(comms, FleetRegistry(comms),
                               snapshot_fn=lambda: {"peers": []},
                               ctl_fn=pb._enqueue_ctl)
    server.start()
    try:
        info = ctl_request(comms, {"op": "hparams",
                                   "hparams": {"prio_beta": 0.5}},
                           learner_ip="127.0.0.1")
        assert info == {"accepted": True, "pending": 1}
        assert pb._ctl_queue.get_nowait()["op"] == "hparams"
    finally:
        server.stop()


def _snapshots():
    serving = deploy.DeployController(2, clock=FakeClock(),
                                      wall=FakeClock(1.0))
    serving.tick({"epoch": 1, "version": 3}, None)
    tenancy = sched.PlacementScheduler(2, 2, clock=FakeClock(),
                                       wall=FakeClock(1.0))
    tenancy.admit(ns.TenantSpec(name="rally"))
    population = ctl.PopulationController(
        {"la": lineage.LineageSpec(name="la")}, clock=FakeClock(),
        wall=FakeClock(1.0))
    population.tick()
    return {"serving": (deploy.ServingStat, serving.snapshot(),
                        deploy.format_serving_lines, "apex_serving_"),
            "tenancy": (sched.TenancyStat, tenancy.snapshot(),
                        sched.format_tenancy_lines, "apex_tenancy_"),
            "population": (ctl.PopulationStat, population.snapshot(),
                           ctl.format_population_lines,
                           "apex_population_")}


@pytest.mark.parametrize("section", ["serving", "tenancy", "population"])
def test_trainer_folds_each_controllers_stat(section):
    cls, snap, lines_fn, prefix = _snapshots()[section]
    t = ApexTrainer(small_test_config(), pool=StubPool(), device="cpu")
    t.fleet = FleetRegistry(t.cfg.comms)
    t.pool.poll_stats = lambda: [copy.deepcopy(cls(section, snap))]
    t._drain_stats(0)
    summary = t.fleet_summary()
    assert summary[section] == snap
    table = format_fleet_table(summary)
    assert all(line in table for line in lines_fn(snap))
    assert prefix in t._metrics_text()
    assert t._slo_signals()["serving"] == (snap if section == "serving"
                                           else {})
