"""The port's CLI (``python -m apex_tpu_torch.runtime``) against
``apex_tpu.runtime.cli``.

* Every flag of the port's parser that the JAX parser has keeps its name,
  default and env twin (set through ``monkeypatch``); the port's own
  flags are exactly ``--device``, ``--send-interval`` and
  ``--dp-backend``.
* ``config_from_args`` of both agree on every field the port's config
  shares with JAX's.
* ``--role apex --mesh-dp 2 --dp-backend gloo --device cpu`` trains two
  ranks and leaves no process, with host actors, ``--rollout fused``,
  ``--rollout ondevice`` and ``--checkpoint-dir`` (then ``--restore``),
  and so does ``--role learner --mesh-dp 2 --replay-shards 2`` on two
  localhost shard threads' batches.
  The three controllers (``--role serve-ctl|tenant-ctl|pbt-ctl``) read
  their flags and env twins and take their control rounds against a fake
  learner's status server on localhost, exiting 0.  ``--role status`` exits 1 with the JAX message when no
  learner answers, and against a live port learner prints the fleet table
  and exits 0.  The services (``--role replay|infer|loadgen``,
  ``--remote-policy``, ``--replay-shards`` and the socket learner's
  ``--rollout ondevice|fused``) no longer do: each starts, and the
  replay, infer and loadgen roles stop cleanly with their stats line.
* ``main([... "--role", "dqn", "--device", "cpu"])`` trains and saves, and
  ``--role enjoy`` scores that checkpoint, rendering to files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from apex_tpu.runtime import cli as jax_cli
from apex_tpu_torch.config import CommsConfig
from apex_tpu_torch.runtime import cli

PORT_ONLY = {"device", "send_interval", "dp_backend"}

#: every env twin of the port's parser, with a non-default value
ENV_TWINS = {
    "APEX_ROLE": "evaluator", "APEX_FAMILY": "r2d2", "APEX_ROLLOUT": "fused",
    "APEX_ROLLOUT_LEN": "7", "APEX_STEPS_PER_DISPATCH": "3",
    "APEX_ENV_ID": "ApexCatch-v0", "APEX_SEED": "5", "ACTOR_ID": "2",
    "N_ACTORS": "3", "N_ENVS_PER_ACTOR": "4", "N_EVALUATORS": "2",
    "LEARNER_IP": "10.0.0.2", "REPLAY_IP": "10.0.0.3",
    "APEX_BATCH_PORT": "1234", "APEX_PARAM_PORT": "1235",
    "APEX_BARRIER_PORT": "1236", "APEX_REMOTE_POLICY": "1",
    "APEX_WIRE_CODEC": "dict", "APEX_PARAM_DELTA": "yes",
    "APEX_PARAM_KEYFRAME_EVERY": "5", "APEX_HEARTBEAT_INTERVAL": "0.5",
    "APEX_PARK_AFTER": "3", "APEX_LR_DECAY_STEPS": "7",
    "APEX_LR_DECAY_RATE": "0.5", "APEX_SAVE_INTERVAL": "9",
    "APEX_MESH_DP": "1", "APEX_LOGDIR": "/tmp/logs",
    "APEX_CKPT_DIR": "/tmp/ckpt", "APEX_RESTORE": "1",
    "APEX_RENDER_DIR": "/tmp/render", "APEX_DEAD_AFTER": "4.5",
    "APEX_REPLAY_SHARDS": "3", "APEX_REPLAY_PORT_BASE": "1300",
    "SHARD_ID": "2", "APEX_REPLAY_LOOSE": "1",
    "APEX_REPLAY_SNAPSHOT_DIR": "/tmp/snap", "APEX_REPLAY_SNAPSHOT_S": "7",
    "APEX_INFER_PORT": "1400", "APEX_INFER_IP": "10.0.0.4",
    "APEX_INFER_BATCH_MAX": "8", "APEX_INFER_WINDOW_MS": "3.5",
    "APEX_INFER_WAIT": "0.25", "APEX_INFER_REPROBE": "2",
    "APEX_INFER_DEVICE_PARAMS": "1", "APEX_INFER_SHARDS": "2",
    "INFER_SHARD_ID": "1", "APEX_STATUS_PORT": "1500",
    "APEX_SUSPECT_AFTER": "2.5", "APEX_METRICS_HTTP": "9100",
    "APEX_TRACE_DIR": "/tmp/trace", "APEX_PROFILE_DIR": "/tmp/prof",
    "APEX_TENANT": "rally", "APEX_SERVE_CANARY_FRAC": "0.25",
    "APEX_SERVE_SOAK_S": "7", "APEX_SERVE_VERSION_EVERY": "2",
    "APEX_SERVE_INTERVAL_S": "0.5", "APEX_PBT_DECIDE_S": "3",
    "APEX_PBT_FRAC": "0.5", "APEX_PBT_RESAMPLE": "0.1",
    "APEX_PBT_MIN_EPISODES": "2",
}


def _defaults(parser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def _clear_env(monkeypatch) -> None:
    for name in ENV_TWINS | {"APEX_DEVICE": "", "APEX_SEND_INTERVAL": "",
                             "APEX_DP_BACKEND": "",
                             "APEX_TENANTS": "", "APEX_POPULATION": ""}:
        monkeypatch.delenv(name, raising=False)


def test_every_shared_flag_keeps_the_jax_default_and_env_twin(monkeypatch):
    _clear_env(monkeypatch)
    port, ref = cli.build_parser(), jax_cli.build_parser()
    port_flags = {o for a in port._actions for o in a.option_strings}
    ref_flags = {o for a in ref._actions for o in a.option_strings}
    port_only = {a.dest for a in port._actions
                 if not set(a.option_strings) <= ref_flags}
    assert port_only == PORT_ONLY, port_only
    shared = set(_defaults(port)) - PORT_ONLY
    assert len(shared) > 40
    base, jbase = _defaults(port), _defaults(ref)
    for dest in shared:
        assert base[dest] == jbase[dest], dest
    role = next(a for a in port._actions if a.dest == "role")
    jrole = next(a for a in ref._actions if a.dest == "role")
    assert role.choices == jrole.choices
    assert "--device" in port_flags

    for name, value in ENV_TWINS.items():
        monkeypatch.setenv(name, value)
    env, jenv = _defaults(cli.build_parser()), _defaults(
        jax_cli.build_parser())
    changed = {d for d in shared if env[d] != base[d]}
    assert len(changed) == len(ENV_TWINS), sorted(changed)
    for dest in shared:
        assert env[dest] == jenv[dest], dest

    monkeypatch.setenv("APEX_DEVICE", "cpu")
    monkeypatch.setenv("APEX_SEND_INTERVAL", "64")
    monkeypatch.setenv("APEX_DP_BACKEND", "gloo")
    got = _defaults(cli.build_parser())
    assert (got["device"], got["send_interval"], got["dp_backend"]) == (
        "cpu", 64, "gloo")
    assert (base["device"], base["send_interval"], base["dp_backend"]) == (
        "cuda", 50, "nccl")


def _fields(section) -> dict:
    return {f.name: getattr(section, f.name)
            for f in dataclasses.fields(section)}


def test_config_from_args_agrees_with_jax_on_every_shared_field(
        monkeypatch):
    _clear_env(monkeypatch)
    argv = ["--role", "actor", "--env-id", "ApexCatch-v0", "--seed", "9",
            "--frame-stack", "2", "--n-actors", "5", "--n-envs-per-actor",
            "3", "--batch-port", "2001", "--param-port", "2002",
            "--barrier-port", "2003", "--wire-codec", "delta",
            "--param-delta", "--param-keyframe-every", "4",
            "--heartbeat-interval", "0.7", "--park-after", "4.5",
            "--batch-size", "64", "--lr", "1e-4", "--lr-decay-steps", "10",
            "--lr-decay-rate", "0.9", "--gamma", "0.95", "--n-steps", "5",
            "--target-update-interval", "77", "--save-interval", "33",
            "--capacity", "4096", "--warmup", "128", "--alpha", "0.5",
            "--beta", "0.3", "--replay-ip", "10.1.1.1", "--mesh-dp", "1",
            "--replay-shards", "2", "--replay-port-base", "3001",
            "--replay-loose", "--replay-snapshot-every", "5",
            "--dead-after", "9", "--remote-policy", "--infer-port", "3100",
            "--infer-ip", "10.2.2.2", "--infer-batch-max", "4",
            "--infer-window-ms", "1.5", "--infer-wait", "0.3",
            "--infer-reprobe", "2.5", "--infer-device-params",
            "--infer-shards", "3"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    jcfg = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    checked = 0
    for section in dataclasses.fields(cfg):
        mine = _fields(getattr(cfg, section.name))
        theirs = _fields(getattr(jcfg, section.name))
        for name, value in mine.items():
            if name in theirs:
                assert value == theirs[name], f"{section.name}.{name}"
                checked += 1
    assert checked > 75
    assert cfg.comms.wire_codec == "delta" and cfg.comms.param_delta
    assert (cfg.comms.replay_shards, cfg.comms.replay_strict_order,
            cfg.comms.infer_shards, cfg.actor.remote_policy) == (
        2, False, 3, True)
    ident = cli.identity_from_args(cli.build_parser().parse_args(
        argv + ["--actor-id", "4", "--learner-ip", "10.0.0.9"]))
    assert (ident.role, ident.actor_id, ident.n_actors,
            ident.learner_ip) == ("actor", 4, 5, "10.0.0.9")


DP_ARGV = ["--mesh-dp", "2", "--dp-backend", "gloo", "--device", "cpu",
           "--batch-size", "16", "--max-seconds", "120"]
CATCH_ARGV = ["--env-id", "ApexCatchSmall-v0", "--frame-stack", "2",
              "--n-actors", "1", "--n-envs-per-actor", "2",
              "--send-interval", "8", "--capacity", "512"]
CARTPOLE_ARGV = ["--env-id", "ApexCartPole-v0", "--frame-stack", "1",
                 "--n-actors", "1", "--send-interval", "16", "--warmup",
                 "64", "--capacity", "1024"]


def _shard_threads(cfg_argv: list, n: int):
    """``n`` replay shard servers on threads of this process, each already
    warm with CartPole chunks, on the ports ``cfg_argv`` names."""
    import threading

    from apex_tpu_torch.replay_service.service import (ReplayShardServer,
                                                       build_shard_core)
    from tests.test_torch_sharded_pipeline import _cartpole_chunk_messages

    cfg = cli.config_from_args(cli.build_parser().parse_args(cfg_argv))
    msgs = _cartpole_chunk_messages(8 * n, seed=2)
    servers, threads, stop = [], [], threading.Event()
    for shard in range(n):
        core = build_shard_core(cfg, shard, device="cpu")
        for msg in msgs[shard::n]:
            core.ingest_msg(msg)
        assert core.warm
        servers.append(ReplayShardServer(cfg.comms, shard, core,
                                         bind_ip="127.0.0.1"))
    for srv in servers:
        threads.append(threading.Thread(target=srv.run, daemon=True,
                                        kwargs={"stop_event": stop}))
        threads[-1].start()

    def close():
        stop.set()
        for t, srv in zip(threads, servers):
            t.join(timeout=10)
            srv.close()

    return servers, close


@pytest.mark.parametrize("case", ["fused", "ondevice", "replay-shards",
                                  "checkpoint-dir"])
def test_sharded_paths_train_two_gloo_ranks_on_the_cpu(monkeypatch,
                                                       tmp_path, case):
    """Each path the sharded learner takes, through ``main`` with
    ``--mesh-dp 2 --dp-backend gloo --device cpu``: exit 0, both ranks
    take every step, and no process is left (the roles close their
    trainers)."""
    import multiprocessing as mp

    import torch

    _clear_env(monkeypatch)
    # two ranks share this host's cores: one torch thread each (the
    # spawned rank inherits the variable)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    from apex_tpu_torch.training.apex import ConcurrentTrainer

    # the trainers the roles close at their end, in order
    seen = []
    real_close = ConcurrentTrainer.close
    monkeypatch.setattr(ConcurrentTrainer, "close",
                        lambda self: seen.append(self) or real_close(self))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _run_sharded_case(case, tmp_path, seen, mp)
    finally:
        torch.set_num_threads(threads)


def _run_sharded_case(case, tmp_path, seen, mp):
    before = set(mp.active_children())
    if case == "fused":
        argv = ["--role", "apex", "--rollout", "fused", "--rollout-len",
                "8", "--steps-per-dispatch", "1", "--warmup", "16",
                "--total-steps", "3"] + CATCH_ARGV + DP_ARGV
        assert cli.main(argv) == 0
        (t,) = seen
        assert type(t).__name__ == "FusedApexTrainer" and t.n_dp == 2
        assert t.steps >= 3 and t.fused.counters()["dp"] == 2
        assert t.dp_rank_stats[1]["steps"] == t.steps
        assert len(t.fused.shard_sizes) == 2
        assert all(n > 0 for n in t.fused.shard_sizes)
    elif case == "ondevice":
        argv = ["--role", "apex", "--rollout", "ondevice", "--rollout-len",
                "16", "--warmup", "64", "--total-steps", "6"] + CATCH_ARGV \
            + DP_ARGV
        assert cli.main(argv) == 0
        (t,) = seen
        engine = t.pool.pool.engine                # AnakinPool, aggregated
        assert t.n_dp == 2 and engine.dispatches > 0
        assert t.pool.pool._version >= 1           # rank 0's live weights
        assert t.steps == 6 and t.dp_rank_stats[1]["steps"] == 6
        sizes = [t.dp_rank_stats[r]["replay_size"] for r in (0, 1)]
        assert min(sizes) > 0 and sum(sizes) == t.ingested
    elif case == "replay-shards":
        from tests.test_torch_replay_service import _free_port_block
        ports = [_free_port_block(2)] + [_free_port() for _ in range(4)]
        argv = ["--role", "learner", "--replay-shards", "2",
                "--replay-port-base", str(ports[0]),
                "--batch-port", str(ports[1]), "--param-port", str(ports[2]),
                "--barrier-port", str(ports[3]), "--status-port",
                str(ports[4]), "--total-steps", "6"] + CARTPOLE_ARGV \
            + DP_ARGV + ["--n-actors", "0", "--n-evaluators", "0"]
        servers, close = _shard_threads(argv, 2)
        try:
            assert cli.main(argv) == 0
        finally:
            close()
        (t,) = seen
        assert t.steps == t.service_steps == 6
        assert t.dp_rank_stats[1]["service_steps"] == 6
        assert t.replay_client.prio_sent == 6
        assert sum(s.core.wb_applied for s in servers) == 6
    else:
        ckpt = str(tmp_path / "ckpt")
        argv = ["--role", "apex", "--checkpoint-dir", ckpt,
                "--save-interval", "4"] + CARTPOLE_ARGV + DP_ARGV
        assert cli.main(argv + ["--total-steps", "8"]) == 0
        from apex_tpu_torch.training.checkpoint import (Checkpointer,
                                                        load_raw)
        path = Checkpointer(ckpt).latest_path()
        raw, meta = load_raw(path)
        assert meta["dp"] == 2 and meta["steps"] >= 4
        assert raw["replay_state"]["size"].shape == (2,)
        assert cli.main(argv + ["--total-steps", "4", "--restore"]) == 0
        first, second = seen
        assert first.steps == 8
        assert second.steps == meta["steps"] + 4
        assert second.dp_rank_stats[1]["steps"] == second.steps
    assert set(mp.active_children()) <= before


def test_apex_role_trains_two_gloo_ranks_on_the_cpu(monkeypatch):
    """``--mesh-dp 2 --dp-backend gloo --device cpu``: rank 0 in this
    process, rank 1 and one actor spawned, both ranks take every step, and
    ``main`` returns 0 with no process left."""
    import multiprocessing as mp

    from apex_tpu_torch.training.apex import ApexTrainer

    _clear_env(monkeypatch)
    seen = []
    real_train = ApexTrainer.train

    def train(self, *args, **kwargs):
        seen.append(self)
        return real_train(self, *args, **kwargs)

    monkeypatch.setattr(ApexTrainer, "train", train)
    argv = ["--role", "apex", "--env-id", "ApexCartPole-v0", "--frame-stack",
            "1", "--n-actors", "1", "--send-interval", "16", "--warmup",
            "64", "--batch-size", "16", "--capacity", "1024",
            "--total-steps", "8", "--max-seconds", "120", "--mesh-dp", "2",
            "--dp-backend", "gloo", "--device", "cpu"]
    before = set(mp.active_children())
    assert cli.main(argv) == 0
    (trainer,) = seen
    assert trainer.n_dp == 2 and trainer.dp_backend == "gloo"
    assert trainer.steps_rate.total == 8
    assert [rec["steps"] for rec in trainer.dp_rank_stats.values()] == [8, 8]
    assert set(mp.active_children()) <= before


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fake_learner(port: int):
    """A status server answering like a live learner: a published model
    fence, the canary gate's SLO states, one evaluator's gauges."""
    from apex_tpu_torch.fleet.registry import (FleetRegistry,
                                               FleetStatusServer)
    snap = {"steps": 12,
            "metrics": {"param_version": 4, "learner_epoch": 2,
                        "checkpoint_latest": "/ck/ckpt_12.pt"},
            "slo": {"severity": 0, "objectives": [
                {"name": "eval_score", "state": "OK"},
                {"name": "infer_rt_p99_ms", "state": "OK"}]},
            "peers": [{"identity": "evaluator-0-ab", "role": "evaluator",
                       "state": "ALIVE", "host": "h1",
                       "gauges": {"eval_score_mean": 1.5,
                                  "eval_episodes": 5}}]}
    comms = CommsConfig(status_port=port)
    cmds = []
    server = FleetStatusServer(comms, FleetRegistry(comms),
                               snapshot_fn=lambda: snap,
                               ctl_fn=lambda c: cmds.append(c) or
                               {"accepted": True})
    server.start()
    return server


@pytest.mark.parametrize("role", ["serve-ctl", "tenant-ctl", "pbt-ctl"])
def test_controller_roles_run_their_rounds_against_a_learner(
        monkeypatch, capsys, role):
    """Each controller reads its flags and env twins, takes its control
    rounds against a learner's status server on localhost and exits 0,
    printing its final snapshot."""
    _clear_env(monkeypatch)
    status = _free_port()
    learner = _fake_learner(status)
    lineage = {"learner_ip": "127.0.0.1", "status_port": status}
    env = {"serve-ctl": {"APEX_SERVE_CANARY_FRAC": "0.5",
                         "APEX_SERVE_SOAK_S": "7",
                         "APEX_SERVE_VERSION_EVERY": "2",
                         "APEX_INFER_SHARDS": "2"},
           "tenant-ctl": {"APEX_REPLAY_SHARDS": "2", "APEX_TENANTS":
                          json.dumps([dict(name="rally", **lineage)])},
           "pbt-ctl": {"APEX_PBT_DECIDE_S": "0.1", "APEX_PBT_FRAC": "0.5",
                       "APEX_PBT_MIN_EPISODES": "1", "APEX_POPULATION":
                       json.dumps([dict(name="la", **lineage),
                                   dict(name="lb", **lineage)])}}[role]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("APEX_SERVE_INTERVAL_S", "0.2")
    argv = ["--role", role, "--learner-ip", "127.0.0.1",
            "--status-port", str(status), "--batch-port", str(_free_port()),
            "--infer-port", str(_free_port()), "--max-seconds", "1.0"]
    try:
        assert cli.main(argv) == 0
    finally:
        learner.stop()
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines()
                if x.startswith(f"{role}: snapshot "))
    snap = json.loads(line[len(f"{role}: snapshot "):])
    if role == "serve-ctl":
        assert (snap["n_shards"], snap["canary_frac"], snap["soak_s"],
                snap["version_every"]) == (2, 0.5, 7.0, 2)
        assert snap["incumbent"] == {"epoch": 2, "version": 4, "id": "2:4"}
        assert snap["state"] == "IDLE"
    elif role == "tenant-ctl":
        assert snap["n_replay_shards"] == 2
        rally = snap["tenants"]["rally"]
        assert (rally["state"], rally["steps"], rally["replay_band"]) == (
            "ACTIVE", 12, [0, 1])
    else:
        assert (snap["decide_every_s"], snap["frac"]) == (0.1, 0.5)
        assert snap["decisions"] >= 1 and snap["exploits"] == 0
        for name in ("la", "lb"):
            got = snap["lineages"][name]
            assert got["alive"] and got["score"] == 1.5
            assert got["checkpoint"] == "/ck/ckpt_12.pt"


def test_status_without_a_learner_exits_1_with_the_jax_message(
        monkeypatch, capsys):
    _clear_env(monkeypatch)
    argv = ["--role", "status", "--status-port", str(_free_port())]
    assert cli.main(argv) == 1
    out = capsys.readouterr().out
    assert jax_cli.main(argv) == 1
    assert out == capsys.readouterr().out
    assert out.startswith("no fleet status from 127.0.0.1:")


class _PeerPool:
    """A socket pool's surface with no socket: one heartbeat per poll
    from each peer and their arrival times, no chunks."""

    needs_warmup_republish = False
    procs: list = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        pass

    def poll_chunks(self, max_chunks, timeout=0.0):
        time.sleep(timeout)
        return []

    def poll_stats(self):
        from apex_tpu_torch.fleet.heartbeat import Heartbeat
        return [Heartbeat("actor-0", fps=12.5, wall_ts=time.time()),
                Heartbeat("evaluator-0-abc123", role="evaluator")]

    def peer_seen(self):
        return {"actor-0": time.monotonic()}


def test_status_against_a_live_learner_prints_the_table_and_exits_0(
        monkeypatch, capsys):
    import threading

    from apex_tpu_torch.config import small_test_config
    from apex_tpu_torch.training.apex import ApexTrainer

    _clear_env(monkeypatch)
    port = _free_port()
    cfg = small_test_config()
    cfg = cfg.replace(comms=dataclasses.replace(cfg.comms, status_port=port))
    trainer = ApexTrainer(cfg, pool=_PeerPool(), device="cpu")
    run = threading.Thread(target=trainer.train, args=(10,),
                           kwargs=dict(max_seconds=60.0))
    run.start()
    try:
        deadline = time.monotonic() + 30
        while trainer._fleet_status is None or not trainer.fleet.peers:
            assert time.monotonic() < deadline, "no status server"
            time.sleep(0.05)
        argv = ["--role", "status", "--status-port", str(port)]
        assert cli.main(argv) == 0
        table = capsys.readouterr().out
        assert cli.main(argv + ["--metrics"]) == 0
        text = capsys.readouterr().out
    finally:
        trainer.request_stop()
        run.join(timeout=30)
    assert not run.is_alive()
    rows = {line.split()[0]: line.split()
            for line in table.splitlines()[1:] if line.strip()}
    assert rows["actor-0"][1:3] == ["actor", "ALIVE"]
    assert rows["evaluator-0-abc123"][1:3] == ["evaluator", "ALIVE"]
    assert "alive=2 suspect=0 dead=0" in table
    assert 'apex_fleet_peer_up{identity="actor-0"' in text
    assert "apex_learner_steps_total 0" in text


def test_dqn_role_trains_on_the_cpu_and_enjoy_scores_its_checkpoint(
        monkeypatch, tmp_path, capsys):
    _clear_env(monkeypatch)
    ckpt, render = tmp_path / "ckpt", tmp_path / "render"
    argv = ["--role", "dqn", "--env-id", "ApexCartPole-v0", "--frame-stack",
            "1", "--total-frames", "640", "--warmup", "64", "--batch-size",
            "16", "--capacity", "1024", "--save-interval", "40",
            "--checkpoint-dir", str(ckpt), "--logdir", str(tmp_path / "log"),
            "--device", "cpu"]
    assert cli.main(argv) == 0
    saved = sorted(os.listdir(ckpt))
    assert saved, "no checkpoint written"
    assert (tmp_path / "log" / "scalars.jsonl").stat().st_size > 0
    path = str(ckpt / saved[-1])
    assert cli.main(["--role", "enjoy", "--checkpoint", path, "--episodes",
                     "2", "--render", "save", "--render-dir", str(render),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "enjoy: mean episode reward" in out
    frames = sorted(os.listdir(render))
    assert frames == ["episode_000.npy", "episode_001.npy"]
    assert np.load(render / frames[0]).shape[1:] == (4,)
    # --restore picks the newest checkpoint back up
    assert cli.main(argv + ["--restore", "--total-frames", "8"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["--role", "dqn", "--restore", "--device", "cpu"])


def _port_block(n: int) -> int:
    """A base port with ``n`` consecutive free ports."""
    for _ in range(64):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        base = probe.getsockname()[1]
        probe.close()
        held = []
        try:
            for i in range(n):
                sk = socket.socket()
                held.append(sk)
                sk.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sk in held:
                sk.close()
    raise RuntimeError("no block of free ports")


SMALL = ["--device", "cpu", "--capacity", "1024", "--batch-size", "16",
         "--warmup", "64", "--barrier-timeout", "0.5", "--env-id"]


@pytest.mark.parametrize("argv", [
    ["--role", "replay", "--replay-shards", "2", "--shard-id", "1",
     "--max-seconds", "0.5", *SMALL, "ApexCartPole-v0",
     "--frame-stack", "1"],
    ["--role", "infer", "--max-seconds", "0.5", *SMALL,
     "ApexCartPole-v0", "--frame-stack", "1"],
], ids=["replay", "infer"])
def test_service_roles_run_and_print_their_stats(monkeypatch, capsys, argv):
    _clear_env(monkeypatch)
    base = _port_block(4)
    ports = ["--replay-port-base", str(base), "--infer-port",
             str(base + 2), "--batch-port", str(base + 3)]
    assert cli.main(argv + ports) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ": stats {" in ln)
    name, stats = line.split(": stats ", 1)
    stats = json.loads(stats)
    if argv[1] == "replay":
        assert name == "replay-1" and stats["shard"] == 1
        assert stats["gather_launches"]["gather_stacks"] == 0   # the CPU
        assert stats["tree_root"] == stats["tree_leaves"] == 0.0
    else:
        assert name == "infer-0" and stats["requests"] == 0


@pytest.mark.parametrize("argv,what", [
    (["--role", "replay", "--replay-shards", "2", "--shard-id", "2"],
     "--shard-id 2 outside"),
    (["--role", "infer", "--infer-shards", "2", "--infer-shard-id", "5"],
     "--infer-shard-id 5 outside"),
])
def test_out_of_range_shard_ids_are_refused(monkeypatch, argv, what):
    _clear_env(monkeypatch)
    with pytest.raises(SystemExit, match=what):
        cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--role", "actor", "--remote-policy", *SMALL, "ApexCartPole-v0",
     "--frame-stack", "1"],
    ["--role", "actor", "--replay-shards", "2", *SMALL, "ApexCartPole-v0",
     "--frame-stack", "1"],
    ["--role", "learner", "--replay-shards", "2", *SMALL,
     "ApexCartPole-v0", "--frame-stack", "1"],
    ["--role", "learner", "--rollout", "ondevice", *SMALL, "ApexCatch-v0"],
    ["--role", "learner", "--rollout", "fused", *SMALL, "ApexCatch-v0"],
], ids=["remote-policy", "actor-shards", "learner-shards", "ondevice",
        "fused"])
def test_service_flags_start_their_roles(monkeypatch, argv):
    """No refusal: each role builds, binds and waits at the startup
    barrier, which times out with no peers."""
    _clear_env(monkeypatch)
    base = _port_block(3)
    ports = ["--batch-port", str(base), "--param-port", str(base + 1),
             "--barrier-port", str(base + 2), "--replay-port-base", "1"]
    with pytest.raises(TimeoutError):
        cli.main(argv + ports)


def test_the_fused_socket_learner_refuses_replay_shards(monkeypatch):
    _clear_env(monkeypatch)
    with pytest.raises(ValueError, match="--replay-shards 0"):
        cli.main(["--role", "learner", "--rollout", "fused",
                  "--replay-shards", "1", *SMALL, "ApexCatch-v0"])


def test_loadgen_role_runs_until_sigterm_and_exits_0(tmp_path):
    """``--role loadgen`` in its own process: it builds its engine and
    waits for params (no learner here); SIGTERM stops it with exit 0 and
    its stats line."""
    base = _port_block(2)
    out_path, err_path = tmp_path / "out.txt", tmp_path / "err.txt"
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.runtime", "--role",
             "loadgen", "--device", "cpu", "--env-id", "ApexCatch-v0",
             "--n-envs-per-actor", "4", "--batch-port", str(base),
             "--param-port", str(base + 1)],
            stdout=out_f, stderr=err_f,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                     OMP_NUM_THREADS="1"),
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        deadline = time.monotonic() + 120.0    # interpreter, torch, engine
        while "waiting for params" not in out_path.read_text():
            assert proc.poll() is None, err_path.read_text()[-2000:]
            assert time.monotonic() < deadline, "loadgen never got ready"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0, err_path.read_text()[-2000:]
    out = out_path.read_text()
    stats = json.loads(out.split("loadgen-0: stats ", 1)[1].splitlines()[0])
    assert stats == {"chunks": 0, "frames": 0, "dispatches": 0,
                     "chunks_sent": 0, "acting_s": 0.0, "peak_bytes": 0}
