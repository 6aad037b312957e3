"""The replay shard role: its socket, heartbeats and lifecycle.

Counterpart of :mod:`apex_tpu.replay_service.service`.  The reference ran
replay as a standalone process between actors and the learner
(``origin_repo/replay.py:48-74``); this role restores it, sharded.  Shard
``s`` binds one ROUTER at ``replay_port_base + s`` and multiplexes three
message kinds on it:

* ``("chunk", msg)`` / ``("chunkc", enc)`` from actors: restricted
  decode, ingest into the shard's
  :class:`~apex_tpu_torch.replay_service.shard.ReplayShardCore`, then the
  ack (the sender's next credit, as at the learner's
  :class:`~apex_tpu_torch.runtime.transport.ChunkReceiver`).  A hostile
  payload is counted and dropped without an ack.
* ``("pull", [epoch])`` from the learner: the next pre-sampled batch, or
  ``("dry", info)`` so the learner's round-robin moves on.
* ``("prio", seq, idx, prios, [epoch])`` from the learner: the write-back.

Strict deferral: while a write-back is outstanding the core refuses
ingest, so arriving chunks wait in an inbox without their acks, and the
actors' credit windows backpressure as the learner's bounded queue does.
Write-back silence past ``comms.dead_after_s`` forgives the outstanding
batches, so a learner that died mid-round-trip cannot wedge the shard.

The shard beats :class:`~apex_tpu_torch.fleet.heartbeat.Heartbeat`\\ s
(role ``"replay"``) on a stat channel to the learner.  One thread owns
the socket, the ingest and the sample.

Lineage and chaos: a chunk's spans are stamped ``shard_recv`` on
arrival and a served batch's ``batch_send``.  Under ``CHAOS_SEED`` the
shard's identity (``replay-<s>``) draws one fate per chunk from its
seeded stream (:class:`_ShardChaos`: a kill, or a silent drop that is
still acked), and a ``mute`` entry drops its replies to the learner
while its ingress stays up (``chaos_dropped`` / ``chaos_muted`` in its
stats).

Tenant partitions: the default tenant's core is ``core``, exactly the
single-tenant shard.  A roster tenant's chunk or pull builds that
tenant's partition on first sight (``tenant_factory``): its own
:class:`~apex_tpu_torch.replay.frame_pool.FramePoolReplay` sized from its
env id, its own warm-up and beta over its own ingest count, its own
sample generator (seeded from the crc32 of its name, so the default
partition's stream is untouched) and its quota.  A population lineage's
partition takes its own priority exponent and beta.  A chunk's tenant is
parsed from its chunk id, a pull's and a write-back's ride the message;
an unknown tenant is counted (``unknown_tenant``) and refused, acked so
its sender never wedges.  With ``snapshot_dir`` every partition
snapshots to its own file.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib

import numpy as np
import torch
import zmq

from apex_tpu_torch import resolve_device
from apex_tpu_torch.config import ApexConfig, CommsConfig
from apex_tpu_torch.fleet.chaos import _die, chaos_from_env
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.obs.trace import get_ring, set_process_label
from apex_tpu_torch.replay_service.shard import ReplayShardCore
from apex_tpu_torch.runtime import codec, transport, wire
from apex_tpu_torch.tenancy import namespace as tenancy_ns


def shard_warmup(global_warmup: int, n_shards: int) -> int:
    """Per-shard warm-up: the global gate split over the shards, rounded
    up (the fleet never trains earlier than one learner would)."""
    return max(1, -(-int(global_warmup) // max(1, n_shards)))


def dqn_replay_spec(cfg: ApexConfig, device: torch.device):
    """The frame pool the DQN learner builds
    (:class:`~apex_tpu_torch.training.apex.ApexTrainer`), from the same
    env probe, checked against the replay budget and the card."""
    from apex_tpu_torch.replay.base import check_hbm_budget
    from apex_tpu_torch.replay.frame_pool import FramePoolReplay
    from apex_tpu_torch.training.apex import dqn_env_specs

    _, frame_shape, frame_dtype, frame_stack = dqn_env_specs(cfg)
    replay = FramePoolReplay(
        capacity=cfg.replay.capacity, frame_shape=frame_shape,
        frame_stack=frame_stack, frame_dtype=np.dtype(frame_dtype).name,
        alpha=cfg.replay.alpha, eps=cfg.replay.eps)
    check_hbm_budget(replay.hbm_bytes(), cfg.replay.hbm_budget_gb,
                     "replay-shard frame pool", cfg.replay.capacity, device)
    return replay


def build_shard_core(cfg: ApexConfig, shard_id: int, family: str = "dqn",
                     device: torch.device | str = "cuda",
                     tenant_spec=None) -> ReplayShardCore:
    """One shard's core from the fleet config: capacity per shard (N
    shards hold N x capacity), warm-up split, the sample generator seeded
    ``env.seed + 977_000 + shard_id`` on the shard's device.

    ``tenant_spec`` builds a tenant partition instead (module docstring):
    the config takes the tenant's env id (and a lineage's vector), the
    quota is the tenant's, and a non-default tenant's generator seed
    folds in the crc32 of its name."""
    if family != "dqn":
        raise NotImplementedError(
            f"replay shards serve the dqn family only (got {family!r}); "
            f"aql/r2d2 keep replay in the learner")
    quota = 0
    if tenant_spec is not None:
        if tenant_spec.family != "dqn":
            raise NotImplementedError(
                f"tenant {tenant_spec.name!r}: replay partitions serve the "
                f"dqn family only (got {tenant_spec.family!r})")
        cfg = cfg.replace(env=dataclasses.replace(
            cfg.env, env_id=tenant_spec.env_id))
        quota = tenant_spec.replay_quota
        from apex_tpu_torch.population.lineage import (LineageSpec,
                                                       apply_lineage)
        if isinstance(tenant_spec, LineageSpec):
            # a lineage's partition builds its trees with its own
            # priority exponent and beta
            cfg = apply_lineage(cfg, tenant_spec)
    device = resolve_device(device)
    replay = dqn_replay_spec(cfg, device)
    n = max(1, cfg.comms.replay_shards)
    seed = cfg.env.seed + 977_000 + int(shard_id)
    if tenant_spec is not None and not tenancy_ns.is_default(
            tenant_spec.name):
        seed = (seed << 31) + zlib.crc32(tenant_spec.name.encode()) % 2 ** 31
    generator = torch.Generator(device=device).manual_seed(seed)
    return ReplayShardCore(
        replay, generator, batch_size=cfg.learner.batch_size,
        warmup=shard_warmup(cfg.replay.warmup, n), beta=cfg.replay.beta,
        beta_anneal=cfg.replay.beta_anneal, n_shards=n,
        strict_order=cfg.comms.replay_strict_order,
        presample_depth=cfg.comms.replay_presample, device=device,
        quota=quota)


def _peak_bytes(device: torch.device) -> int:
    """The card memory this process has held at most (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def snapshot_path_for(snapshot_dir: str, shard_id: int,
                      tenant: str = tenancy_ns.DEFAULT_TENANT) -> str:
    """The snapshot file of one (shard, tenant) partition in
    ``snapshot_dir``; the default tenant keeps the single-tenant name."""
    if tenancy_ns.is_default(tenant):
        return os.path.join(snapshot_dir, f"replay_shard_{shard_id}.pt")
    return os.path.join(snapshot_dir, f"replay_shard_{shard_id}.{tenant}.pt")


class _ShardChaos:
    """The shard's fault gate: one draw per arriving chunk off the seeded
    per-identity stream (:mod:`apex_tpu_torch.fleet.chaos`), so a shard's
    kills and drops replay exactly, run after run."""

    def __init__(self, plan):
        self.plan = plan
        self._rng = plan.rng() if plan is not None else None
        self._n = 0
        self.dropped = 0

    def on_chunk(self) -> str:
        """"ok" or "drop"; a scheduled kill never returns."""
        if self.plan is None:
            return "ok"
        i = self._n
        self._n += 1
        if self.plan.kill_at is not None and i >= self.plan.kill_at:
            _die(self.plan.identity, i)
        if self._rng.random() < self.plan.drop_frac:
            self.dropped += 1
            return "drop"
        return "ok"


class ReplayShardServer:
    """The socket loop around one :class:`ReplayShardCore` (module
    docstring)."""

    def __init__(self, comms: CommsConfig, shard_id: int,
                 core: ReplayShardCore, bind_ip: str = "*",
                 heartbeat: bool = True, snapshot_path: str | None = None,
                 snapshot_s: float | None = None, tenant_factory=None,
                 snapshot_dir: str | None = None):
        self.comms = comms
        self.shard_id = int(shard_id)
        self.core = core
        # the partitions: the default tenant's is ``core``; a roster
        # tenant's is built by ``tenant_factory(tenant)`` on first sight
        # (None refuses the tenant)
        self.cores: dict[str, ReplayShardCore] = {
            tenancy_ns.DEFAULT_TENANT: core}
        self._tenant_factory = tenant_factory
        self.unknown_tenant = 0
        self.identity = f"replay-{shard_id}"
        self.port = comms.replay_port_base + self.shard_id
        self.sock = zmq.Context.instance().socket(zmq.ROUTER)
        transport._bind(self.sock, f"tcp://{bind_ip}:{self.port}")
        self.rejected = 0           # payloads dropped without an ack
        self.codec_chunks = 0       # compressed chunks decoded
        self.codec_rejected = 0     # garbage compressed chunks, unacked
        self.batches_served = 0
        self.forgiven = 0           # batches forgiven after silence
        self._inbox: list = []      # strict-mode deferred (tenant, ident,
        #                             msg)
        # write-back liveness per tenant: one tenant's learner lives and
        # dies on its own
        self._last_wb = {tenancy_ns.DEFAULT_TENANT: time.monotonic()}
        self.snapshot_path = snapshot_path
        self.snapshot_dir = snapshot_dir
        self.tenant_snapshots: dict[str, int] = {}
        self.snapshot_s = (comms.replay_snapshot_s if snapshot_s is None
                           else float(snapshot_s))
        self._last_snapshot = time.monotonic()
        self.snapshots = 0
        self.snapshot_errors = 0
        chaos = chaos_from_env()
        plan = chaos.plan_for(self.identity) if chaos is not None else None
        self.chaos = _ShardChaos(plan)
        # a directional link drop: the learner's pulls arrive, this
        # shard's replies never make it back
        self._mute = bool(plan is not None and plan.mute_replies)
        self.chaos_muted = 0
        self._hb = None
        self._hb_sender = None
        if heartbeat:
            from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
            self._hb_sender = transport.ChunkSender(comms, self.identity)
            self._hb = HeartbeatEmitter(
                self.identity, role="replay",
                interval_s=comms.heartbeat_interval_s,
                counters_fn=lambda: {
                    "chunks_sent": self.batches_served,
                    "acks_received": sum(c.wb_applied
                                         for c in self.cores.values())},
                gauges_fn=self.gauges)

    # -- message handlers ----------------------------------------------------

    def _core_for(self, tenant: str) -> ReplayShardCore | None:
        """This tenant's partition, built by the factory on first sight
        (restored from its own snapshot when there is one); None for a
        tenant nobody admitted."""
        got = self.cores.get(tenant)
        if got is not None or self._tenant_factory is None:
            return got
        got = self._tenant_factory(tenant)
        if got is None:
            return None
        path = self._tenant_snapshot_path(tenant)
        if path is not None and os.path.exists(path):
            try:
                got.restore_snapshot(path)
                print(f"{self.identity}: warm restore ({got.ingested} "
                      f"transitions, tenant {tenant}) from {path}",
                      flush=True)
            except ValueError as exc:
                print(f"{self.identity}: tenant {tenant!r} cold start, "
                      f"snapshot unusable ({exc})", flush=True)
        self.cores[tenant] = got
        self._last_wb[tenant] = time.monotonic()
        print(f"{self.identity}: tenant partition for {tenant!r} "
              f"(warmup={got.warmup}, quota={got.quota or 'unlimited'})",
              flush=True)
        return got

    def _tenant_snapshot_path(self, tenant: str) -> str | None:
        """A partition's snapshot file: the default tenant's is
        ``snapshot_path``; a roster tenant's lives in ``snapshot_dir``
        (None: that partition does not snapshot)."""
        if tenancy_ns.is_default(tenant):
            return self.snapshot_path
        if not self.snapshot_dir:
            return None
        return snapshot_path_for(self.snapshot_dir, self.shard_id, tenant)

    def _ingest(self, core: ReplayShardCore, ident: bytes,
                msg: dict) -> None:
        core.ingest_msg(msg)
        if self._hb is not None:
            self._hb.tick(int(msg.get("n_trans", 0)))
        self.sock.send_multipart([ident, b"ack"])

    def _handle_chunk(self, ident: bytes, msg: dict) -> None:
        if self.chaos.on_chunk() == "drop":
            self.sock.send_multipart([ident, b"ack"])   # silent data loss
            return
        obs_spans.stamp(msg, "shard_recv")
        tenant = tenancy_ns.tenant_of(str(msg.get("chunk_id") or ""))
        core = self._core_for(tenant)
        if core is None:
            self.unknown_tenant += 1    # refused, but acked: a stranger's
            self.sock.send_multipart([ident, b"ack"])   # window never
            return                                      # wedges
        if core.over_quota():
            core.quota_dropped += 1     # the partition holds its quota
            self.sock.send_multipart([ident, b"ack"])
            return
        if not core.can_ingest():
            self._inbox.append((tenant, ident, msg))    # ack withheld:
            return                      # the credit window paces the sender
        self._ingest(core, ident, msg)

    def _drain_inbox(self) -> None:
        """Ingest deferred chunks whose partition takes them now, in
        order per tenant (strict mode closes again after one warm
        ingest, so later chunks of that tenant stay parked)."""
        rest: list = []
        for tenant, ident, msg in self._inbox:
            core = self.cores.get(tenant)
            if core is not None and core.can_ingest():
                self._ingest(core, ident, msg)
            else:
                rest.append((tenant, ident, msg))
        self._inbox = rest

    def _handle_pull(self, ident: bytes, epoch: int = 0,
                     tenant: str = tenancy_ns.DEFAULT_TENANT) -> None:
        core = self._core_for(tenant)
        if core is None:
            self.unknown_tenant += 1
            self._reply(ident, ("dry", {"ingested": 0, "warm": False,
                                        "stale_wb": 0, "restored": 0}))
            return
        if core.note_epoch(int(epoch)):
            # a restarted learner's first pull: its predecessor's
            # outstanding write-backs are gone with it
            self._last_wb[tenant] = time.monotonic()
            self._drain_inbox()
        batch = core.next_batch()
        if batch is None:
            reply = ("dry", {"ingested": core.ingested, "warm": core.warm,
                             "stale_wb": core.stale_wb,
                             "restored": core.restored})
        else:
            obs_spans.stamp(batch, "batch_send")
            self.batches_served += 1
            reply = ("batch", batch)
        self._reply(ident, reply)

    def _reply(self, ident: bytes, reply) -> None:
        if self._mute:
            self.chaos_muted += 1       # the reply dies on the down link
            return
        self.sock.send_multipart([ident, wire.dumps(reply)])

    def _handle_prio(self, seq: int, idx, prios, epoch: int = 0,
                     tenant: str = tenancy_ns.DEFAULT_TENANT) -> None:
        core = self.cores.get(tenant)
        if core is None:
            self.unknown_tenant += 1
            return
        stale_before = core.stale_wb
        core.write_back(int(seq), idx, prios, epoch=int(epoch))
        if core.stale_wb > stale_before:
            return      # a dead learner's write-back is not liveness
        self._last_wb[tenant] = time.monotonic()
        self._drain_inbox()

    # -- lifecycle -----------------------------------------------------------

    def step(self, timeout_ms: int = 100) -> bool:
        """One poll-and-dispatch round; True when a message was handled."""
        if self._hb is not None:
            hb = self._hb.maybe_beat(0)
            if hb is not None:
                self._hb_sender.send_stat(hb)
        for tenant, core in list(self.cores.items()):
            if (core.outstanding() > 0
                    and time.monotonic() - self._last_wb[tenant]
                    > self.comms.dead_after_s):
                n = core.forgive_outstanding()
                self.forgiven += n
                self._last_wb[tenant] = time.monotonic()
                print(f"{self.identity}: forgave {n} outstanding "
                      f"write-back(s) (tenant {tenant}) after "
                      f"{self.comms.dead_after_s:.0f} s of learner silence",
                      flush=True)
                self._drain_inbox()
        self._maybe_snapshot()
        if not self.sock.poll(timeout_ms, zmq.POLLIN):
            return False
        frames = self.sock.recv_multipart()
        if len(frames) != 2:
            self.rejected += 1
            return True
        ident, payload = frames
        try:
            msg = wire.restricted_loads(payload)
        except wire.WireRejected:
            self.rejected += 1      # counted, dropped and not acked
            return True
        kind = msg[0] if isinstance(msg, tuple) and msg else None
        try:
            if kind == "chunkc":
                try:
                    body = codec.decode_chunk(msg[1])
                except codec.CodecError:
                    self.codec_rejected += 1
                    return True
                self.codec_chunks += 1
                self._handle_chunk(ident, body)
            elif kind == "chunk":
                self._handle_chunk(ident, msg[1])
            elif kind == "pull":
                # ("pull",) / ("pull", epoch) is the default tenant; a
                # tenant's learner appends its name
                self._handle_pull(ident, int(msg[1]) if len(msg) > 1 else 0,
                                  str(msg[2]) if len(msg) > 2
                                  else tenancy_ns.DEFAULT_TENANT)
            elif kind == "prio":
                self._handle_prio(msg[1], msg[2], msg[3],
                                  int(msg[4]) if len(msg) > 4 else 0,
                                  str(msg[5]) if len(msg) > 5
                                  else tenancy_ns.DEFAULT_TENANT)
            elif kind == "stat":
                pass                # stats belong to the learner
            else:
                self.rejected += 1
        except (KeyError, IndexError, TypeError, ValueError) as exc:
            # a well-pickled message of the wrong shape: dropped unacked
            self.rejected += 1
            print(f"{self.identity}: dropped a malformed {kind!r} "
                  f"({type(exc).__name__}: {exc})", flush=True)
        return True

    def _maybe_snapshot(self) -> None:
        """Snapshot every partition at most every ``snapshot_s`` seconds,
        each at its own quiescent points only (a busy one is skipped this
        round); a failed write is counted, never fatal."""
        if ((not self.snapshot_path and not self.snapshot_dir)
                or self.snapshot_s <= 0):
            return
        if time.monotonic() - self._last_snapshot < self.snapshot_s:
            return
        for tenant, core in sorted(self.cores.items()):
            path = self._tenant_snapshot_path(tenant)
            if path is None or not core.quiescent():
                continue
            try:
                core.save_snapshot(path)
                self.snapshots += 1
                if not tenancy_ns.is_default(tenant):
                    self.tenant_snapshots[tenant] = \
                        self.tenant_snapshots.get(tenant, 0) + 1
            except OSError as exc:
                self.snapshot_errors += 1
                print(f"{self.identity}: snapshot failed (tenant {tenant}): "
                      f"{exc}", flush=True)
        self._last_snapshot = time.monotonic()

    def run(self, stop_event=None, max_seconds: float | None = None) -> dict:
        deadline = (None if max_seconds is None
                    else time.monotonic() + max_seconds)
        while not (stop_event is not None and stop_event.is_set()):
            if deadline is not None and time.monotonic() > deadline:
                break
            self.step()
        return self.stats()

    def gauges(self) -> dict:
        return {"tenants": len(self.cores),
                "unknown_tenant": self.unknown_tenant,
                "quota_dropped": sum(c.quota_dropped
                                     for c in self.cores.values()),
                "batches_served": self.batches_served,
                "inbox": len(self._inbox),
                "outstanding": self.core.outstanding(),
                "backend_accel": float(self.core.device.type != "cpu")}

    def stats(self) -> dict:
        """The core's counters, the server's, the tree's root against the
        sum of its leaves and the gather and tree kernels' launches in
        this process."""
        from apex_tpu_torch.ops import tree
        from apex_tpu_torch.ops.gather import LAUNCH_COUNTS

        rs, c = self.core.state, self.core.replay.capacity
        leaves = rs.sum_tree[c:c + rs.size].double()
        return {**self.core.stats(), "shard": self.shard_id,
                "batches_served": self.batches_served,
                "rejected": self.rejected,
                "codec_chunks": self.codec_chunks,
                "codec_rejected": self.codec_rejected,
                "forgiven": self.forgiven,
                "chaos_dropped": self.chaos.dropped,
                "chaos_muted": self.chaos_muted,
                "snapshots": self.snapshots,
                "tenant_snapshots": dict(self.tenant_snapshots),
                "inbox_deferred": len(self._inbox),
                "unknown_tenant": self.unknown_tenant,
                # per-partition counters (the default tenant's repeat the
                # top-level keys)
                "tenants": {t: c.stats()
                            for t, c in sorted(self.cores.items())},
                "tree_root": float(rs.sum_tree[1]),
                "tree_leaves": float(leaves.sum()),
                "gather_launches": dict(LAUNCH_COUNTS),
                "tree_launches": dict(tree.LAUNCH_COUNTS),
                "peak_bytes": _peak_bytes(self.core.device)}

    def close(self) -> None:
        self.sock.close(linger=0)
        if self._hb_sender is not None:
            self._hb_sender.close(drain_s=0.0)


def run_replay_shard(cfg: ApexConfig, shard_id: int, family: str = "dqn",
                     stop_event=None, max_seconds: float | None = None,
                     bind_ip: str = "*", snapshot_dir: str | None = None,
                     device: torch.device | str = "cuda") -> dict:
    """The ``--role replay`` entry point: build the shard core on
    ``device`` (the card by default), restore the shard's snapshot from
    ``snapshot_dir`` when there is one, serve until ``stop_event`` or
    ``max_seconds``.  Returns the final stats."""
    set_process_label(f"replay-{shard_id}")
    get_ring()                      # arm the trace ring's dump triggers
    core = build_shard_core(cfg, shard_id, family=family, device=device)
    roster = tenancy_ns.load_roster()

    def tenant_factory(tenant: str):
        spec = roster.get(tenant)
        if spec is None:
            return None
        return build_shard_core(cfg, shard_id, family=family, device=device,
                                tenant_spec=spec)

    snap_path = None
    if snapshot_dir:
        os.makedirs(snapshot_dir, exist_ok=True)
        snap_path = snapshot_path_for(snapshot_dir, shard_id)
        if os.path.exists(snap_path):
            try:
                core.restore_snapshot(snap_path)
                print(f"replay-{shard_id}: warm restore ({core.ingested} "
                      f"transitions, {core.sampled} batches sampled) from "
                      f"{snap_path}", flush=True)
            except ValueError as exc:
                print(f"replay-{shard_id}: cold start, snapshot unusable "
                      f"({exc})", flush=True)
    server = ReplayShardServer(cfg.comms, shard_id, core, bind_ip=bind_ip,
                               snapshot_path=snap_path,
                               tenant_factory=(tenant_factory if roster
                                               else None),
                               snapshot_dir=snapshot_dir or None)
    print(f"replay-{shard_id}: serving on port {server.port} "
          f"(capacity={cfg.replay.capacity}, warmup={core.warmup}/shard, "
          f"strict={core.strict_order}, device={core.device})", flush=True)
    try:
        return server.run(stop_event=stop_event, max_seconds=max_seconds)
    finally:
        server.close()
