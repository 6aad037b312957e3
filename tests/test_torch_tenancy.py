"""The port's multi-tenant plane against ``apex_tpu.tenancy``.

* :class:`PlacementScheduler` of both packages admits, bands, evicts,
  re-admits and rebalances under one fake clock; every tick's events,
  the ``snapshot()`` dicts, the Prometheus sections and the status lines
  are equal, and so are ``assign_bands`` and ``place`` over a grid.
* The param channel: the default tenant's frames are the bare pickles the
  port sent before tenant topics (and the JAX publisher's bytes); a
  tenant's frames carry its topic, reach its subscribers (the JAX one
  too) and no default subscriber, and sparse tenant publishes all arrive.
* Replay partitions: the default partition is bit-identical with and
  without a second tenant beside it; an unknown tenant is refused and the
  quota is enforced, with the JAX shard's counters on the same chunks.
* The infer server answers each tenant under its own model, the clients
  stamp their tenant on requests, pulls and write-backs.
"""

from __future__ import annotations

import copy
import dataclasses
import pickle
import socket
import time

import jax
import numpy as np
import pytest
import torch
import zmq

from apex_tpu.config import CommsConfig as JaxCommsConfig
from apex_tpu.replay.frame_chunks import FrameChunkBuilder as JaxBuilder
from apex_tpu.replay.frame_pool import FramePoolReplay as JaxPool
from apex_tpu.replay_service import ReplayShardCore as JaxShardCore
from apex_tpu.replay_service import ReplayShardServer as JaxShardServer
from apex_tpu.runtime import transport as jax_transport
from apex_tpu.tenancy import namespace as jax_ns
from apex_tpu.tenancy import scheduler as jax_sched
from apex_tpu_torch.config import CommsConfig, small_test_config
from apex_tpu_torch.infer_service.client import InferClient
from apex_tpu_torch.infer_service.service import (InferServer,
                                                  dqn_policy_model)
from apex_tpu_torch.models.dueling import host_params
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.replay_service.client import ReplayServiceClient
from apex_tpu_torch.replay_service.service import ReplayShardServer
from apex_tpu_torch.replay_service.shard import ReplayShardCore
from apex_tpu_torch.runtime import transport, wire
from apex_tpu_torch.tenancy import namespace as ns
from apex_tpu_torch.tenancy import scheduler as sched

FRAME_SHAPE, STACK, K, BATCH = (3,), 2, 8, 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class FakeClock:
    def __init__(self, t: float = 50.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- the placement scheduler -------------------------------------------------

def test_assign_bands_and_place_match_jax():
    for n in (1, 2, 3, 5, 8):
        for weights in ({"a": 1.0}, {"a": 1.0, "b": 1.0},
                        {"a": 3.0, "b": 1.0, "c": 1.0},
                        {"t0": 0.5, "rally": 2.5, "x": 1.0, "y": 1.0}):
            assert sched.assign_bands(weights, n) == \
                jax_sched.assign_bands(weights, n)
    hosts = {"h-cpu": False, "h-card": True, "a-cpu": False}
    for accel in (False, True):
        spec = ns.TenantSpec(name="rally", accel=accel)
        jspec = jax_ns.TenantSpec(name="rally", accel=accel)
        assert sched.place(spec, hosts) == jax_sched.place(jspec, hosts)
        assert sched.place(spec, {}) is None


def test_scheduler_walks_the_jax_machine_under_one_clock():
    clock, wall = FakeClock(), FakeClock(1.7e9)
    kw = dict(dead_after_s=15.0, clock=clock, wall=wall)
    port = sched.PlacementScheduler(2, 2, **kw)
    ref = jax_sched.PlacementScheduler(2, 2, **kw)
    roster = [dict(name="t0", env_id="ApexCatch-v0", weight=1.0, accel=True),
              dict(name="rally", env_id="ApexRally-v0", weight=1.0,
                   replay_quota=2 ** 16)]
    hosts = {"card-host": True, "cpu-host": False}

    def agree(mine, theirs):
        assert mine == theirs
        snap = port.snapshot()
        assert snap == ref.snapshot()
        assert sched.prometheus_sections(snap) == \
            jax_sched.prometheus_sections(snap)
        assert sched.format_tenancy_lines(snap) == \
            jax_sched.format_tenancy_lines(snap)

    for d in roster:
        port.admit(ns.TenantSpec(**d))
        ref.admit(jax_ns.TenantSpec(**d))
        agree(None, None)
    agree(port.tick(hosts), ref.tick(hosts))
    assert port.replay_bands == {"rally": [0], "t0": [1]}
    script = [(5, {"t0": 10, "rally": 4}), (5, {"t0": 20}),
              (6, {"t0": 30}), (6, {"t0": 41}), (3, {"t0": 50}),
              (4, {"t0": 60, "rally": 5}), (2, {"t0": 70, "rally": 9})]
    states = []
    for dt, alive in script:
        clock.t += dt
        for name in ("t0", "rally"):
            for s in (port, ref):
                s.observe(name, alive=name in alive, severity=0,
                          steps=alive.get(name))
        agree(port.tick(hosts), ref.tick(hosts))
        states.append(port.snapshot()["tenants"]["rally"]["state"])
        if states[-1] == sched.EVICTED:
            # the survivor's band grows to the whole tier
            assert port.replay_bands == {"t0": [0, 1]}
    assert sched.EVICTED in states and states[-1] == sched.ACTIVE
    assert port.evictions == 1 and port.admissions == 3
    # the admission is idempotent for an active tenant with one spec
    port.admit(ns.TenantSpec(**roster[0]))
    assert port.admissions == 3


def test_tenancy_stat_crosses_the_wire():
    port = sched.PlacementScheduler(2, 1, clock=FakeClock(),
                                    wall=FakeClock(1.0))
    port.admit(ns.TenantSpec(name="rally"))
    stat = sched.TenancyStat("tenant-ctl", port.snapshot())
    got = wire.restricted_loads(wire.dumps(stat))
    assert isinstance(got, sched.TenancyStat)
    assert got.snapshot == port.snapshot()


# -- the param channel -------------------------------------------------------

def _raw_sub(port: int, topic: bytes = b""):
    sock = zmq.Context.instance().socket(zmq.SUB)
    sock.setsockopt(zmq.SUBSCRIBE, topic)
    sock.connect(f"tcp://127.0.0.1:{port}")
    return sock


def _first_frame(pub, raw, version, params, timeout_s=10.0) -> bytes:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        pub.publish(version, params)
        if raw.poll(100, zmq.POLLIN):
            return raw.recv()
    raise AssertionError("no frame arrived")


@pytest.mark.parametrize("delta", [False, True])
def test_default_tenant_frames_are_the_bare_pickles(monkeypatch, delta):
    monkeypatch.delenv("APEX_TENANT", raising=False)
    params = {"w": np.arange(6, dtype=np.float32), "b": np.ones(2)}
    port_no = _free_port()
    comms = CommsConfig(param_port=port_no, param_hwm=1000)
    pub = transport.ParamPublisher(comms, bind_ip="127.0.0.1", delta=delta)
    raw = _raw_sub(port_no)
    try:
        assert pub.topic == b""
        time.sleep(0.2)
        frame = _first_frame(pub, raw, 3, params)
        got = wire.restricted_loads(frame)
        if delta:
            assert got["pdelta"] == 1 and got["key"]
            assert frame == pickle.dumps(got, protocol=5)
        else:
            assert frame == pickle.dumps((3, params), protocol=5)
    finally:
        pub.close()
        raw.close(linger=0)
    if delta:
        return
    # the JAX publisher's default frame is the same bytes
    jport = _free_port()
    jpub = jax_transport.ParamPublisher(
        JaxCommsConfig(param_port=jport, param_hwm=1000),
        bind_ip="127.0.0.1", topic=b"")
    jraw = _raw_sub(jport)
    try:
        time.sleep(0.2)
        assert _first_frame(jpub, jraw, 3, params) == frame
    finally:
        jpub.close()
        jraw.close(linger=0)


def _version(got, version):
    return got if got is not None and got[0] == version else None


def test_tenant_topics_reach_their_subscribers_only(monkeypatch):
    monkeypatch.setenv("APEX_TENANT", "rally")
    port_no = _free_port()
    comms = CommsConfig(param_port=port_no)
    pub = transport.ParamPublisher(comms, bind_ip="127.0.0.1")
    assert pub.topic == ns.param_topic("rally") == b"apxt/rally|"
    sub = transport.ParamSubscriber(comms)          # rally, from the env
    default_sub = transport.ParamSubscriber(comms, topic=b"")
    jsub = jax_transport.ParamSubscriber(
        JaxCommsConfig(param_port=port_no),
        topic=jax_ns.param_topic("rally"))
    raw = _raw_sub(port_no, pub.topic)
    try:
        time.sleep(0.3)
        # sparse publishes at the default high-water mark all arrive
        frames = []
        for version in range(1, 7):
            pub.publish(version, {"w": np.float32(version)})
            if raw.poll(2000, zmq.POLLIN):
                frames.append(raw.recv())
            time.sleep(0.05)
        assert len(frames) == 6
        assert all(f.startswith(b"apxt/rally|") for f in frames)
        assert wire.restricted_loads(frames[-1][len(pub.topic):]) == (
            6, {"w": np.float32(6)})
        got = jgot = None
        deadline = time.monotonic() + 10
        while (got is None or jgot is None) and time.monotonic() < deadline:
            pub.publish(7, {"w": np.float32(1.5)})
            # the conflating sockets may still hold an earlier version
            got = got or _version(sub.poll(100), 7)
            jgot = jgot or _version(jsub.poll(100), 7)
        assert got is not None and jgot is not None
        assert float(got[1]["w"]) == float(jgot[1]["w"]) == 1.5
        assert default_sub.poll(200) is None and default_sub.rejected > 0
    finally:
        for s in (pub, sub, default_sub, jsub):
            s.close()
        raw.close(linger=0)


# -- replay partitions -------------------------------------------------------

def _messages(seed: int, n: int, tenant: str | None = None) -> list[dict]:
    """Chunk messages from the JAX ``FrameChunkBuilder`` (numpy payloads
    both packages ingest), each with its chunk id."""
    rng = np.random.default_rng(seed)
    b = JaxBuilder(2, 0.9, STACK, FRAME_SHAPE, chunk_transitions=K,
                   frame_margin=4, frame_dtype=np.uint8)
    out: list[dict] = []
    while len(out) < n:
        b.begin_episode(rng.integers(0, 255, FRAME_SHAPE))
        length = int(rng.integers(1, 3 * K))
        for t in range(length):
            b.add_step(int(rng.integers(0, 4)), float(rng.normal()),
                       rng.normal(size=4).astype(np.float32),
                       rng.integers(0, 255, FRAME_SHAPE),
                       terminated=t == length - 1, truncated=False)
        for chunk in b.poll():
            prios = chunk.pop("priorities")
            out.append({"payload": chunk, "priorities": prios,
                        "n_trans": int(chunk["n_trans"])})
    ident = ns.qualify(tenant or ns.DEFAULT_TENANT, "actor-0")
    return [dict(m, chunk_id=ns.chunk_id(ident, i))
            for i, m in enumerate(out[:n])]


def _port_core(seed, quota=0, warmup=24):
    pool = FramePoolReplay(capacity=64, frame_shape=FRAME_SHAPE,
                           frame_stack=STACK, frame_capacity=128)
    return ReplayShardCore(pool, torch.Generator().manual_seed(seed),
                           batch_size=BATCH, warmup=warmup, device="cpu",
                           quota=quota)


def _jax_core(seed, quota=0, warmup=24):
    pool = JaxPool(capacity=64, frame_shape=FRAME_SHAPE, frame_stack=STACK,
                   frame_capacity=128, frame_dtype="uint8")
    return JaxShardCore(pool, jax.random.key(seed), batch_size=BATCH,
                        warmup=warmup, n_shards=1, strict_order=True,
                        quota=quota)


def _port_server(specs: dict):
    comms = CommsConfig(replay_shards=1, replay_port_base=_free_port())

    def factory(tenant):
        spec = specs.get(tenant)
        return None if spec is None else _port_core(
            900 + len(tenant), quota=spec.replay_quota)

    server = ReplayShardServer(comms, 0, _port_core(77), bind_ip="127.0.0.1",
                               heartbeat=False,
                               tenant_factory=factory if specs else None)
    replies: list = []
    server._reply = lambda ident, reply: replies.append(reply)
    return server, replies


def _drive(server, replies, default_msgs, rally_msgs=()):
    """Interleave the two tenants' chunks; pull, and write each default
    batch back, after every default chunk."""
    rally = list(rally_msgs)
    batches = []
    for msg in default_msgs:
        if rally:
            server._handle_chunk(b"r", copy.deepcopy(rally.pop(0)))
            server._handle_pull(b"rl", 0, "rally")
        server._handle_chunk(b"a", copy.deepcopy(msg))
        server._handle_pull(b"l", 0)
        kind, body = replies[-1]
        if kind == "batch":
            batches.append(body)
            server._handle_prio(body["seq"], body["idx"],
                                np.linspace(0.5, 2.0, BATCH,
                                            dtype=np.float32))
    return batches


def test_default_partition_is_bit_identical_beside_a_second_tenant():
    alone, alone_replies = _port_server({})
    shared, shared_replies = _port_server(
        {"rally": ns.TenantSpec(name="rally")})
    try:
        default_msgs = _messages(21, 12)
        want = _drive(alone, alone_replies, default_msgs)
        got = _drive(shared, shared_replies, default_msgs,
                     _messages(99, 12, "rally"))
        assert len(want) == len(got) > 4
        for a, b in zip(want, got):
            for name in ("batch", "weights", "idx", "seq"):
                va, vb = a[name], b[name]
                if isinstance(va, dict):
                    for key in va:
                        np.testing.assert_array_equal(va[key], vb[key])
                else:
                    np.testing.assert_array_equal(va, vb)
        for f in dataclasses.fields(alone.core.state):
            x = getattr(alone.core.state, f.name)
            y = getattr(shared.core.state, f.name)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), f.name
        assert torch.equal(alone.core.generator.get_state(),
                           shared.core.generator.get_state())
        rally = shared.cores["rally"]
        assert rally.ingested > 0 and rally.sampled > 0
        stats = shared.stats()
        assert set(stats["tenants"]) == {ns.DEFAULT_TENANT, "rally"}
        assert stats["unknown_tenant"] == 0 and stats["tenants"][
            "rally"]["ingested"] == rally.ingested
    finally:
        alone.close()
        shared.close()


def test_unknown_tenant_refused_and_quota_enforced_as_jax_does():
    specs = {"rally": ns.TenantSpec(name="rally", replay_quota=3 * K)}
    jspecs = {"rally": jax_ns.TenantSpec(name="rally", replay_quota=3 * K)}
    server, replies = _port_server(specs)
    jcomms = JaxCommsConfig(replay_shards=1, replay_port_base=_free_port())
    ref = JaxShardServer(
        jcomms, 0, _jax_core(77), bind_ip="127.0.0.1", heartbeat=False,
        tenant_factory=lambda t: (None if t not in jspecs else _jax_core(
            900, quota=jspecs[t].replay_quota)))
    try:
        stream = (_messages(31, 8, "rally") + _messages(5, 3, "ghost")
                  + _messages(32, 4))
        for msg in stream:
            server._handle_chunk(b"x", copy.deepcopy(msg))
            ref._handle_chunk(b"x", copy.deepcopy(msg))
        server._handle_pull(b"g", 0, "ghost")
        ref._handle_pull(b"g", 0, "ghost")
        assert replies[-1][0] == "dry"
        assert server.unknown_tenant == ref.unknown_tenant == 4
        assert "ghost" not in server.cores
        mine, theirs = server.cores["rally"], ref.cores["rally"]
        assert mine.quota_dropped == theirs.quota_dropped > 0
        assert mine.ingested == theirs.ingested
        assert mine.over_quota() and theirs.over_quota()
        assert mine.resident() == theirs.resident()
        assert server.core.ingested == ref.core.ingested > 0
        assert server.core.quota_dropped == 0
        for key in ("quota", "quota_dropped", "ingested", "chunks"):
            assert mine.stats()[key] == theirs.stats()[key], key
    finally:
        server.close()
        ref.close()


# -- tenant identity on the infer and replay wires ---------------------------

def test_infer_server_answers_each_tenant_under_its_own_model():
    cfg = small_test_config()
    cfg = cfg.replace(comms=CommsConfig(infer_port=_free_port()))
    model = dqn_policy_model(cfg, "cpu")
    rally_cfg = cfg.replace(env=dataclasses.replace(cfg.env, seed=91))
    rally_model = dqn_policy_model(rally_cfg, "cpu")
    srv = InferServer(cfg.comms, model, heartbeat=False,
                      obs_shape=model.obs_shape)
    srv.add_tenant("rally", rally_model)
    srv.add_tenant(ns.DEFAULT_TENANT, rally_model)      # a no-op
    assert set(srv.tenants) == {"rally"}
    replies = []
    srv._reply = lambda ident, msg: replies.append((ident, msg))
    rng = np.random.default_rng(0)

    def request(rid, tenant=None):
        msg = {"rid": rid, "obs": rng.normal(size=(3,) + model.obs_shape)
               .astype(np.float32), "eps": np.zeros(3, np.float32),
               "seed": rid, "group": 0}
        if tenant:
            msg["tenant"] = tenant
        assert srv._well_formed(("infer", msg))
        return (tenant or "t0").encode(), msg, 0.0

    try:
        srv.set_params(4, host_params(model), epoch=2)
        pending = [request(1), request(2, "rally"), request(3),
                   request(4, "ghost")]
        for group in srv._group_by_shape(pending):
            srv._dispatch(group)
        kinds = {ident: msg[0] for ident, msg in replies}
        # rally has no params yet, the ghost is unknown: both act locally
        assert kinds == {b"t0": "act", b"rally": "dry", b"ghost": "dry"}
        assert srv.unknown_tenant == 1
        srv.set_tenant_params("rally", 9, host_params(rally_model), epoch=3)
        replies.clear()
        pending = [request(5), request(6, "rally"), request(7, "rally")]
        groups = srv._group_by_shape(pending)
        assert [len(g) for g in groups] == [1, 2]
        for group in groups:
            srv._dispatch(group)
        by_rid = {msg[1]["rid"]: msg[1] for _, msg in replies}
        for rid, net, pv, epoch in ((5, model, 4, 2), (6, rally_model, 9, 3),
                                    (7, rally_model, 9, 3)):
            obs = next(m["obs"] for _, m, _ in pending if m["rid"] == rid)
            with torch.no_grad():
                want = net(torch.from_numpy(obs)).numpy()
            np.testing.assert_allclose(by_rid[rid]["q"], want, rtol=1e-6,
                                       atol=1e-6)
            assert (by_rid[rid]["pv"], by_rid[rid]["epoch"]) == (pv, epoch)
        assert srv.gauges()["tenants"] == 2
    finally:
        srv.close()


@pytest.mark.parametrize("tenant", ["", "rally"])
def test_clients_stamp_their_tenant(monkeypatch, tenant):
    if tenant:
        monkeypatch.setenv("APEX_TENANT", tenant)
    else:
        monkeypatch.delenv("APEX_TENANT", raising=False)
    router = zmq.Context.instance().socket(zmq.ROUTER)
    port_no = router.bind_to_random_port("tcp://127.0.0.1")
    comms = CommsConfig(infer_port=port_no, replay_shards=1,
                        replay_port_base=port_no)
    infer = InferClient(comms, "actor-0", wait_s=0.1, reprobe_s=0.0)
    replay = ReplayServiceClient(comms)
    try:
        infer.submit(np.zeros((2, 4), np.float32), np.zeros(2), 1, 0,
                     fallback=None)
        replay.learner_epoch = 2
        replay._ensure_pull(0, time.monotonic())
        replay.push_priorities(0, 0, np.zeros(BATCH, np.int64),
                               np.ones(BATCH, np.float32))
        got = {}
        for _ in range(3):
            assert router.poll(5000, zmq.POLLIN)
            ident, payload = router.recv_multipart()
            msg = wire.restricted_loads(payload)
            got[msg[0]] = (ident, msg)
        ident, (_, req) = got["infer"]
        assert req.get("tenant") == (tenant or None)
        assert ("tenant" in req) == bool(tenant)
        pull_ident, pull = got["pull"]
        _, prio = got["prio"]
        if tenant:
            assert pull == ("pull", 2, "rally") and prio[-1] == "rally"
            assert pull_ident == ns.qualify("rally", "learner-0").encode()
        else:
            assert pull == ("pull", 2) and len(prio) == 5
            assert pull_ident == b"learner-0"
    finally:
        infer.close()
        replay.close()
        router.close(linger=0)
