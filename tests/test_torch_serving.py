"""The port's serving tier (``apex_tpu_torch.serving.deploy`` and the infer
server's version gate) against ``apex_tpu.serving``.

* :class:`DeployController` of both packages walks the same observation
  scripts under one fake clock: canary -> promote, breach -> rollback with
  no re-canary, an epoch bump, an unreadable SLO, a one-shard tier.  Every
  tick's commands, the ``snapshot()`` dicts, the Prometheus sections and
  the status lines are equal.
* The gate: a JAX ``InferServer`` (run as ``tests/test_serving.py`` runs
  it) and the port's go through the same install and ctl sequence; their
  ``ctl_state`` replies, held and rollback counters and, at eps 0, their
  replies match.  Rollback loads the incumbent's tensors back bit for bit,
  with ``infer_device_params`` on and off.
* ``ServingStat`` crosses the port's wire, and the ctl frame round-trips
  over a real localhost ROUTER.
"""

from __future__ import annotations

import socket
import threading

import jax
import numpy as np
import pytest
import torch
import zmq

from apex_tpu.config import CommsConfig as JaxCommsConfig
from apex_tpu.config import small_test_config as jax_small_config
from apex_tpu.infer_service import InferServer as JaxInferServer
from apex_tpu.models.dueling import DuelingDQN as FlaxDQN
from apex_tpu.models.dueling import make_policy_fn as jax_policy_fn
from apex_tpu.ops.losses import make_optimizer as jax_make_optimizer
from apex_tpu.serving import deploy as jax_deploy
from apex_tpu.training.apex import dqn_env_specs as jax_env_specs
from apex_tpu.training.state import create_train_state as jax_train_state
from apex_tpu_torch.config import CommsConfig, small_test_config
from apex_tpu_torch.convert import params_from_flax
from apex_tpu_torch.fleet.registry import format_fleet_table
from apex_tpu_torch.infer_service.service import (InferServer,
                                                  dqn_policy_model)
from apex_tpu_torch.runtime import wire
from apex_tpu_torch.serving import deploy

SLO_OK = {"eval_score": "OK", "infer_rt_p99_ms": "OK"}
SLO_BAD = {"eval_score": "BREACHED", "infer_rt_p99_ms": "OK"}


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _pair(n_shards=2, **kw):
    """The JAX controller and the port's, on one fake clock and wall."""
    clock, wall = FakeClock(), FakeClock(1.7e9)
    make = (lambda mod: mod.DeployController(n_shards, clock=clock,
                                             wall=wall, **kw))
    return make(jax_deploy), make(deploy), clock


#: observation scripts: (seconds to advance, learner fence or None, SLO
#: states or None) per tick
SCRIPTS = {
    "canary_then_promote": [
        (0, (1, 3), SLO_OK), (1, (1, 3), SLO_OK), (1, (2, 1), SLO_OK),
        (1, (2, 4), SLO_OK), (5, (2, 6), SLO_OK), (6, (2, 7), SLO_OK),
        (1, (2, 8), SLO_OK), (12, (2, 9), SLO_OK)],
    "breach_rolls_back_and_never_recanaries": [
        (0, (1, 1), SLO_OK), (1, (2, 1), SLO_OK), (1, (2, 2), SLO_BAD),
        (1, (2, 3), SLO_OK), (1, (2, 9), SLO_OK), (30, (2, 12), SLO_OK),
        (1, (3, 1), SLO_OK), (11, (3, 2), SLO_OK)],
    "unreadable_slo_holds_and_epoch_bumps_deploy": [
        (0, (4, 10), None), (1, (5, 1), None), (20, (5, 2), None),
        (1, (5, 3), {"eval_score": "OK"}), (20, (5, 4), SLO_OK),
        (1, None, SLO_OK), (11, (5, 5), SLO_OK), (1, (6, 1), SLO_BAD)],
}


@pytest.mark.parametrize("n_shards,kw", [
    (2, dict(canary_frac=0.5, soak_s=10.0)),
    (4, dict(canary_frac=0.5, soak_s=10.0, version_every=3,
             gate_open_s=5.0)),
    (1, dict(canary_frac=0.5, soak_s=10.0)),
])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_deploy_controller_walks_the_jax_machine(script, n_shards, kw):
    ref, port, clock = _pair(n_shards, **kw)
    assert port.canary_shards == ref.canary_shards
    seen = set()
    for dt, fence_now, slo in SCRIPTS[script]:
        clock.t += dt
        learner = (None if fence_now is None
                   else {"epoch": fence_now[0], "version": fence_now[1]})
        cmds = port.tick(learner, slo)
        assert cmds == ref.tick(learner, slo)
        # the shards' replies feed the view both ways
        for s, cmd in cmds:
            view = {"shard": s, "pinned": cmd["cmd"] != "promote",
                    "version": fence_now[1] if fence_now else 0,
                    "epoch": fence_now[0] if fence_now else 0}
            port.shard_view[s] = ref.shard_view[s] = view
        snap = port.snapshot()
        assert snap == ref.snapshot()
        assert deploy.prometheus_sections(snap) == \
            jax_deploy.prometheus_sections(snap)
        assert deploy.format_serving_lines(snap) == \
            jax_deploy.format_serving_lines(snap)
        seen.add(snap["state"])
    if script == "canary_then_promote" and n_shards == 2:
        assert {deploy.CANARY, deploy.PROMOTED} <= seen
        assert port.promotions == 1 and port.rollbacks == 0
    if script.startswith("breach"):
        assert port.rollbacks >= 1 and port.rejected is not None
        # the rejected fence was never canaried again
        assert [e["version"] for e in port.timeline
                if e["to"] == deploy.CANARY].count("2:1") <= 1


# -- the gate ----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_params(jcfg, seed):
    spec, frame_shape, frame_dtype, frame_stack = jax_env_specs(jcfg)
    stacked = frame_shape[:-1] + (frame_stack * frame_shape[-1],)
    model = FlaxDQN(**spec)
    ts = jax_train_state(model, jax_make_optimizer(), jax.random.key(seed),
                         np.zeros((1,) + stacked, frame_dtype))
    return model, jax.device_get(ts.params)


def _host(params_flax) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(params_flax).items()}


def _servers(device_params: bool):
    port = _free_port()
    jcfg = jax_small_config()
    jcfg = jcfg.replace(comms=JaxCommsConfig(
        infer_port=port, infer_device_params=device_params))
    cfg = small_test_config()
    cfg = cfg.replace(comms=CommsConfig(infer_port=port + 1,
                                        infer_device_params=device_params))
    flax_model, p1 = _jax_params(jcfg, 0)
    _, p2 = _jax_params(jcfg, 7)
    ref = JaxInferServer(jcfg.comms, jax_policy_fn(flax_model),
                         heartbeat=False)
    model = dqn_policy_model(cfg, "cpu")
    srv = InferServer(cfg.comms, model, heartbeat=False,
                      obs_shape=model.obs_shape)
    return ref, srv, (p1, p2), model


def _request(rid, obs):
    key = np.asarray(jax.random.key_data(jax.random.key(rid)))
    return {"rid": rid, "obs": obs, "eps": np.zeros(len(obs), np.float32),
            "key": key, "seed": 1000 + rid, "group": 0}


def _replies(server, obs):
    got = []
    server._reply = lambda ident, msg: got.append(msg)
    server._dispatch([(b"c", _request(1, obs), 0.0)])
    return got


@pytest.mark.parametrize("device_params", [False, True])
def test_gate_matches_jax_and_rollback_is_bit_exact(device_params):
    ref, srv, (p1, p2), model = _servers(device_params)
    h1, h2 = _host(p1), _host(p2)
    obs = np.random.default_rng(3).normal(
        size=(4,) + model.obs_shape).astype(np.float32)
    try:
        def both(op, *args):
            if op == "install":
                version, which, epoch = args
                ref.set_params(version, (p1, p2)[which], epoch=epoch)
                srv.set_params(version, (h1, h2)[which], epoch=epoch)
                return None
            mine, theirs = srv.apply_ctl(dict(args[0])), \
                ref.apply_ctl(dict(args[0]))
            assert mine == theirs
            return mine

        def counters_agree():
            assert (srv.held, srv.gate_rollbacks, srv.param_version,
                    srv.learner_epoch, srv.ctl_cmds) == (
                ref.held, ref.gate_rollbacks, ref.param_version,
                ref.learner_epoch, ref.ctl_cmds)
            assert srv.ctl_state() == ref.ctl_state()

        def replies_agree():
            mine, theirs = _replies(srv, obs), _replies(ref, obs)
            assert [m[0] for m in mine] == [t[0] for t in theirs]
            for (kind, a), (_, b) in zip(mine, theirs):
                if kind == "act":
                    assert (a["pv"], a["epoch"]) == (b["pv"], b["epoch"])
                    np.testing.assert_array_equal(a["actions"],
                                                  np.asarray(b["actions"]))
                    np.testing.assert_allclose(a["q"], np.asarray(b["q"]),
                                               rtol=1e-5, atol=1e-6)

        both("install", 5, 0, 1)
        replies_agree()
        incumbent = {k: v.clone() for k, v in model.state_dict().items()} \
            if device_params else {k: torch.as_tensor(v)
                                   for k, v in h1.items()}
        assert both("ctl", {"cmd": "canary", "rid": 1})["has_incumbent"]
        both("install", 9, 1, 1)            # the candidate, tracked
        both("ctl", {"cmd": "canary"})      # idempotent: no re-stash
        counters_agree()
        replies_agree()                     # serves the candidate
        assert not all(torch.equal(model.state_dict()[k], incumbent[k])
                       for k in incumbent)
        st = both("ctl", {"cmd": "rollback", "epoch": 1, "version": 5})
        assert st["pinned"] and st["version"] == 5
        for name, t in model.state_dict().items():
            assert torch.equal(t, incumbent[name]), name
        counters_agree()
        replies_agree()
        both("install", 12, 1, 1)           # beyond the pin: held
        both("install", 4, 0, 1)            # at or before: installs
        counters_agree()
        both("ctl", {"cmd": "pin", "epoch": 1, "version": 50})
        both("install", 2, 1, 2)            # a new life is beyond (1, 50)
        counters_agree()
        both("ctl", {"cmd": "promote"})
        both("install", 12, 1, 1)
        both("ctl", {"cmd": "freeze"})
        both("install", 13, 0, 1)           # frozen: held
        for _ in range(3):                  # the reconcile is idempotent
            both("ctl", {"cmd": "rollback", "epoch": 1, "version": 5})
        counters_agree()
        replies_agree()
        assert srv.held == 3 and srv.gate_rollbacks == 1
    finally:
        ref.close()
        srv.close()


def test_rollback_without_a_stash_serves_dry_as_jax_does():
    ref, srv, (_, p2), model = _servers(False)
    try:
        ref.set_params(9, p2, epoch=1)
        srv.set_params(9, _host(p2), epoch=1)
        body = {"cmd": "rollback", "epoch": 1, "version": 5}
        assert srv.apply_ctl(dict(body)) == ref.apply_ctl(dict(body))
        obs = np.zeros((2,) + model.obs_shape, np.float32)
        assert [m[0] for m in _replies(srv, obs)] == ["dry"]
        assert srv.gauges()["serve_pinned"] == 1
    finally:
        ref.close()
        srv.close()


def test_ctl_frame_round_trips_over_the_router():
    cfg = small_test_config()
    cfg = cfg.replace(comms=CommsConfig(infer_port=_free_port()))
    model = dqn_policy_model(cfg, "cpu")
    srv = InferServer(cfg.comms, model, heartbeat=False,
                      obs_shape=model.obs_shape)
    stop = threading.Event()
    t = threading.Thread(target=srv.run, kwargs={"stop_event": stop},
                         daemon=True)
    t.start()
    sock = zmq.Context.instance().socket(zmq.DEALER)
    sock.connect(f"tcp://127.0.0.1:{cfg.comms.infer_port}")
    try:
        sock.send(wire.dumps(("ctl", {"cmd": "pin", "epoch": 2,
                                      "version": 7, "rid": 3})))
        assert sock.poll(5000, zmq.POLLIN)
        kind, body = wire.restricted_loads(sock.recv())
        assert kind == "ctl_ok" and body["rid"] == 3
        assert body["pinned"] and body["pin"] == [2, 7]
        assert srv.stats()["ctl_cmds"] == 1 and srv.requests == 0
    finally:
        stop.set()
        t.join(timeout=5)
        sock.close(linger=0)
        srv.close()


def test_serving_stat_crosses_the_wire_and_renders_in_the_table():
    ctrl = deploy.DeployController(2, clock=FakeClock(), wall=FakeClock(1.0))
    ctrl.tick({"epoch": 1, "version": 2}, SLO_OK)
    stat = deploy.ServingStat("serve-ctl", ctrl.snapshot())
    got = wire.restricted_loads(wire.dumps(stat))
    assert isinstance(got, deploy.ServingStat)
    assert got.snapshot == ctrl.snapshot()
    snap = {"peers": [], "metrics": {}, "serving": got.snapshot}
    table = format_fleet_table(snap)
    for line in jax_deploy.format_serving_lines(got.snapshot):
        assert line in table
