"""Learner-side fleet membership: the heartbeat registry + status surface.

Counterpart of :mod:`apex_tpu.fleet.registry`: the same machine, metrics,
snapshot, table and status wire, so a port learner answers the JAX
``status_request`` and the other way round.  ``zmq`` is imported lazily,
by the status server and its clients only.

The registry replaces the passive ``RemotePool.silent_peers(60.0)`` report
with an explicit per-peer state machine driven by config thresholds
(:class:`~apex_tpu_torch.config.CommsConfig`):

    JOINING --beat--> ALIVE --silence > suspect_after_s--> SUSPECT
    SUSPECT --activity--> ALIVE     (recovery, not counted)
    SUSPECT --silence > dead_after_s--> DEAD
    DEAD    --activity--> ALIVE     (a REJOIN — counted)

Two observation kinds feed it: :class:`~apex_tpu_torch.fleet.heartbeat.Heartbeat`
messages off the stat channel (rich: fps, counters, self-reported park
state) and bare message-arrival times off the chunk socket
(``observe_seen`` — keeps a backpressured-but-flowing actor ALIVE even
when its stat puts drop).  ``fleet_rejoins`` sums registry-observed
DEAD→ALIVE transitions with the fleet's self-reported park→resume cycles,
so a learner restarted from checkpoint still credits the rejoins its
predecessor's registry never saw.

Thread contract: observations and ticks come from the trainer thread; the
status server thread only calls :meth:`snapshot`, which takes the same
lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from apex_tpu_torch.config import CommsConfig
from apex_tpu_torch.fleet.heartbeat import Heartbeat

JOINING, ALIVE, SUSPECT, DEAD = "JOINING", "ALIVE", "SUSPECT", "DEAD"


def _min_transit_offset(samples) -> float:
    """Per-peer clock offset from recent heartbeat samples: the median of
    the smallest half (min-transit selection).  Each sample is
    ``skew + transit_i`` with ``transit_i >= 0``, so the smallest samples
    bound the skew most tightly; the median over that low half keeps one
    anomalous beat (queue dwell spike, clock step mid-window) from owning
    the estimate the way last-beat sampling did."""
    s = sorted(samples)
    low = s[:max(1, len(s) // 2)]
    mid = len(low) // 2
    med = (low[mid] if len(low) % 2
           else (low[mid - 1] + low[mid]) / 2.0)
    return round(med, 4)


@dataclass
class PeerState:
    identity: str
    role: str = "?"
    # owning tenant, parsed from the (possibly tenant-qualified) wire
    # identity at first sight (tenancy/namespace.py); unqualified peers
    # belong to the default tenant — every single-tenant fleet unchanged
    tenant: str = ""
    pid: int = 0
    host: str = ""
    state: str = JOINING
    fps: float = 0.0
    param_version: int = 0
    chunks_sent: int = 0
    acks_received: int = 0
    resends: int = 0
    rerouted: int = 0
    rejoins_reported: int = 0
    parked: bool = False
    beats: int = 0
    joined_at: float = 0.0
    last_any: float = 0.0           # newest activity of either kind
    last_beat: float | None = None  # newest heartbeat (gap statistics)
    deaths: int = 0                 # ALIVE/SUSPECT -> DEAD transitions
    # learner wall at receive - peer wall at send (skew + one transit),
    # from the heartbeat wall_ts; the obs.merge trace aligner consumes it
    # via fleet_summary.json.  None until a wall-stamped beat arrives.
    # Each sample overestimates the true skew by that beat's transit (+
    # any stat-queue dwell), so the published offset is NOT the last beat
    # but a min-transit median over the recent sample window: transit is
    # strictly additive, so the smallest samples are the closest to pure
    # skew, and the median over that low half rides out one lucky/broken
    # outlier (NTP's clock-filter idea, scaled down).
    clock_offset_s: float | None = None
    clock_offset_n: int = 0         # samples behind the estimate
    offset_samples: deque = field(default_factory=lambda: deque(maxlen=16))
    # latest role-specific serving gauges off the peer's heartbeats
    # (infer server: queue depth / batch percentiles; remote-policy
    # actors: fallback counts / round-trip percentiles)
    gauges: dict = field(default_factory=dict)


class FleetRegistry:
    """Per-peer membership for one learner process."""

    def __init__(self, comms: CommsConfig | None = None,
                 clock=time.monotonic, wall_clock=time.time):
        self.comms = comms or CommsConfig()
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self.peers: dict[str, PeerState] = {}
        self.dead_to_alive = 0          # registry-observed rejoins
        self.transitions: list[tuple[str, str, str]] = []
        self._gaps: deque[float] = deque(maxlen=512)   # beat-to-beat, s

    # -- observations ------------------------------------------------------

    def _peer(self, identity: str) -> PeerState:
        p = self.peers.get(identity)
        if p is None:
            from apex_tpu_torch.tenancy import namespace as tenancy_ns
            now = self._clock()
            p = self.peers[identity] = PeerState(
                identity=identity,
                tenant=tenancy_ns.tenant_of(identity),
                joined_at=now, last_any=now)
        return p

    def _revive(self, p: PeerState) -> None:
        """Activity from a non-ALIVE peer: recovery (SUSPECT) or rejoin
        (DEAD, counted)."""
        if p.state == DEAD:
            self.dead_to_alive += 1
            self.transitions.append((p.identity, DEAD, ALIVE))
            p.state = ALIVE
        elif p.state == SUSPECT:
            self.transitions.append((p.identity, SUSPECT, ALIVE))
            p.state = ALIVE

    def observe(self, hb: Heartbeat) -> None:
        """One heartbeat arrived (trainer thread, off the stat drain)."""
        now = self._clock()
        with self._lock:
            p = self._peer(hb.identity)
            if p.last_beat is not None:
                self._gaps.append(now - p.last_beat)
            if p.state == JOINING:
                self.transitions.append((p.identity, JOINING, ALIVE))
                p.state = ALIVE
            else:
                self._revive(p)
            p.role, p.pid, p.host = hb.role, hb.pid, hb.host
            p.fps, p.param_version = hb.fps, hb.param_version
            p.chunks_sent, p.acks_received = hb.chunks_sent, hb.acks_received
            p.resends = getattr(hb, "resends", 0)
            p.rerouted = getattr(hb, "rerouted", 0)
            p.rejoins_reported = max(p.rejoins_reported, hb.rejoins)
            p.parked = hb.parked
            gauges = getattr(hb, "gauges", None)
            if gauges:
                p.gauges = dict(gauges)
            wall_ts = getattr(hb, "wall_ts", 0.0)
            if wall_ts:
                p.offset_samples.append(self._wall() - wall_ts)
                p.clock_offset_s = _min_transit_offset(p.offset_samples)
                p.clock_offset_n = len(p.offset_samples)
            p.beats += 1
            p.last_beat = p.last_any = now

    def observe_seen(self, seen: dict[str, float]) -> None:
        """Message-arrival liveness from the chunk socket
        (``RemotePool.peer_seen`` monotonic times): refreshes ``last_any``
        without touching heartbeat gap statistics."""
        with self._lock:
            for identity, t in seen.items():
                p = self._peer(identity)
                if t > p.last_any:
                    p.last_any = t
                    self._revive(p)

    # -- the clock-driven half of the machine ------------------------------

    def tick(self) -> list[tuple[str, str, str]]:
        """Apply the silence thresholds; returns the transitions taken
        SINCE the last tick (observation-driven ones included)."""
        now = self._clock()
        c = self.comms
        with self._lock:
            for p in self.peers.values():
                silent = now - p.last_any
                if p.state in (ALIVE, JOINING) and silent > c.suspect_after_s:
                    self.transitions.append((p.identity, p.state, SUSPECT))
                    p.state = SUSPECT
                if p.state == SUSPECT and silent > c.dead_after_s:
                    self.transitions.append((p.identity, SUSPECT, DEAD))
                    p.state = DEAD
                    p.deaths += 1
            out, self.transitions = self.transitions, []
            return out

    # -- read surface ------------------------------------------------------

    def _counts(self) -> dict[str, int]:
        out = {JOINING: 0, ALIVE: 0, SUSPECT: 0, DEAD: 0}
        for p in self.peers.values():
            out[p.state] += 1
        return out

    def rejoins(self) -> int:
        with self._lock:
            return self.dead_to_alive + sum(p.rejoins_reported
                                            for p in self.peers.values())

    def dead_fraction(self, roles: tuple[str, ...] = ("actor",)) -> float:
        """Fraction of the peers in ``roles`` currently DEAD — the input
        to the learner's replay-ratio-floor reaction (0.0 while no such
        peer has ever registered: an empty fleet is not a dead one)."""
        with self._lock:
            peers = [p for p in self.peers.values() if p.role in roles]
            if not peers:
                return 0.0
            return sum(p.state == DEAD for p in peers) / len(peers)

    def _gap_percentiles(self) -> tuple[float | None, float | None]:
        if not self._gaps:
            return None, None
        s = sorted(self._gaps)

        def pct(q: float) -> float:
            return round(s[min(len(s) - 1, int(q * len(s)))], 3)

        return pct(0.50), pct(0.99)

    def metrics(self) -> dict:
        """The ``fleet_*`` scalar set (MetricLogger + bench ``fleet``)."""
        with self._lock:
            counts = self._counts()
            p50, p99 = self._gap_percentiles()
            return {
                "peers": len(self.peers),
                "alive": counts[ALIVE],
                "joining": counts[JOINING],
                "suspect": counts[SUSPECT],
                "dead": counts[DEAD],
                "parked": sum(p.parked for p in self.peers.values()),
                "rejoins": self.dead_to_alive
                + sum(p.rejoins_reported for p in self.peers.values()),
                "dead_to_alive": self.dead_to_alive,
                "deaths": sum(p.deaths for p in self.peers.values()),
                "hb_gap_p50_s": p50,
                "hb_gap_p99_s": p99,
            }

    def snapshot(self) -> dict:
        """Serializable fleet view (status server, fleet_summary.json):
        plain builtins only, so the restricted wire carries it."""
        now = self._clock()
        with self._lock:
            peers = [{
                "identity": p.identity, "tenant": p.tenant,
                "role": p.role, "state": p.state,
                "pid": p.pid, "host": p.host, "fps": p.fps,
                "param_version": p.param_version,
                "chunks_sent": p.chunks_sent,
                "acks_received": p.acks_received,
                "resends": p.resends, "rerouted": p.rerouted,
                "rejoins": p.rejoins_reported, "parked": p.parked,
                "beats": p.beats, "deaths": p.deaths,
                "silent_s": round(now - p.last_any, 1),
                "clock_offset_s": p.clock_offset_s,
                "clock_offset_n": p.clock_offset_n,
                "gauges": dict(p.gauges),
            } for _, p in sorted(self.peers.items())]
        return {"peers": peers, "metrics": self.metrics()}


def format_fleet_table(snapshot: dict) -> str:
    """Human fleet table for ``--role status``.  Peers group by tenant
    (multi-tenant fleets get one block per tenant, default first); a
    single-tenant fleet renders one block."""
    from apex_tpu_torch.tenancy import namespace as tenancy_ns

    cols = ("identity", "role", "state", "pid", "host", "fps",
            "param_version", "chunks_sent", "rejoins", "parked", "silent_s")
    peers = list(snapshot["peers"])
    tenants = sorted({p.get("tenant") or tenancy_ns.DEFAULT_TENANT
                      for p in peers},
                     key=lambda t: (not tenancy_ns.is_default(t), t))
    rows = [[str(p.get(c, "")) for c in cols] for p in peers]
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for tenant in tenants:
        if len(tenants) > 1:
            lines.append(f"-- tenant {tenant} --")
        for p, r in zip(peers, rows):
            if (p.get("tenant") or tenancy_ns.DEFAULT_TENANT) != tenant:
                continue
            lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    m = snapshot.get("metrics", {})
    lines.append("")
    lines.append(
        f"alive={m.get('alive')} suspect={m.get('suspect')} "
        f"dead={m.get('dead')} parked={m.get('parked')} "
        f"rejoins={m.get('rejoins')} "
        f"hb_gap_p50={m.get('hb_gap_p50_s')}s "
        f"p99={m.get('hb_gap_p99_s')}s")
    # role-specific serving gauges (the inference plane's queue depth /
    # batch percentiles, remote-policy actors' fallback counts) — one
    # line per peer that reported any, so new roles are never a blind
    # spot on the operator surface
    for p in snapshot["peers"]:
        g = p.get("gauges")
        if g:
            lines.append(f"{p['identity']}: " + " ".join(
                f"{k}={g[k]}" for k in sorted(g)))
    # wire codec plane (runtime/codec.py): learner-side decode counts +
    # the param-delta publisher's byte counters — the operator table
    # answers "is compression on, and is anything being rejected"
    wire = m.get("wire")
    if wire:
        lines.append("wire: " + " ".join(
            f"{k}={wire[k]}" for k in sorted(wire)))
    # fleet SLO objectives (apex_tpu_torch/obs/slo): one line per judged/
    # observed objective when the learner runs the engine — the operator
    # table answers "is the fleet in objective" without a scrape stack
    slo = snapshot.get("slo")
    if slo:
        from apex_tpu_torch.obs.slo import format_slo_lines
        lines.extend(format_slo_lines(slo))
    # the controllers' sections (serve-ctl, tenant-ctl, pbt-ctl): each
    # machine's state and the tail of its timeline, when the learner has
    # heard from it
    serving = snapshot.get("serving")
    if serving:
        from apex_tpu_torch.serving.deploy import format_serving_lines
        lines.extend(format_serving_lines(serving))
    tenancy = snapshot.get("tenancy")
    if tenancy:
        from apex_tpu_torch.tenancy.scheduler import format_tenancy_lines
        lines.extend(format_tenancy_lines(tenancy))
    population = snapshot.get("population")
    if population:
        from apex_tpu_torch.population.controller import (
            format_population_lines)
        lines.extend(format_population_lines(population))
    return "\n".join(lines)


class FleetStatusServer:
    """REP socket serving registry snapshots on ``comms.status_port``.

    Its own socket and its own thread — the ChunkReceiver's ROUTER stays
    single-threaded, and a status query can never block the data plane.
    zmq imports lazily so in-host trainers work without the comms extra.

    Three request kinds on the one socket: any plain frame returns the
    pickled registry snapshot (``--role status``); the frame
    ``b"metrics"`` returns Prometheus text exposition from
    ``metrics_fn`` (the trainer's live scalars/rates/latency histograms
    — :mod:`apex_tpu_torch.obs.metrics`), so the fleet is pollable by
    standard tooling; a pickled ``("ctl", {...})`` tuple (the PBT
    controller's exploit/explore commands, :mod:`apex_tpu_torch.population`)
    is handed to ``ctl_fn`` and acked ``("ctl_ok", info)`` — the hook
    ENQUEUES only (the trainer thread applies at its next health tick;
    a command must never touch learner state from this thread).
    Without a ``metrics_fn`` the metrics request degrades to a
    fleet-only exposition rendered from the registry itself; without a
    ``ctl_fn`` ctl frames degrade to status replies (old servers keep
    answering new controllers harmlessly).
    """

    def __init__(self, comms: CommsConfig, registry: FleetRegistry,
                 bind_ip: str = "*", metrics_fn=None, snapshot_fn=None,
                 ctl_fn=None):
        import zmq

        self._zmq = zmq
        self.registry = registry
        self.metrics_fn = metrics_fn
        self.ctl_fn = ctl_fn
        # optional richer status payload (the trainer's fleet_summary —
        # registry snapshot PLUS reaction/replay-service/drain metrics);
        # scale supervisors key off those extras, so the trainer passes it
        self.snapshot_fn = snapshot_fn
        self.sock = zmq.Context.instance().socket(zmq.REP)
        self.sock.bind(f"tcp://{bind_ip}:{comms.status_port}")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _metrics_text(self) -> str:
        from apex_tpu_torch.obs import metrics as obs_metrics
        if self.metrics_fn is not None:
            return self.metrics_fn()
        gauges, labeled = obs_metrics.render_fleet(self.registry.snapshot())
        return obs_metrics.render(gauges=gauges, labeled=labeled)

    def _run(self) -> None:
        from apex_tpu_torch.runtime import wire
        while not self._stop.is_set():
            if not self.sock.poll(200, self._zmq.POLLIN):
                continue
            req = self.sock.recv()
            if req == b"metrics":
                try:
                    text = self._metrics_text()
                except Exception as e:      # a scrape must never wedge REP
                    text = f"# metrics unavailable: {type(e).__name__}\n"
                self.sock.send(text.encode("utf-8", errors="replace"))
            else:
                reply = None
                if self.ctl_fn is not None and req != b"status":
                    try:
                        msg = wire.restricted_loads(req)
                    except Exception:
                        msg = None          # not a ctl frame: status
                    if (isinstance(msg, tuple) and len(msg) == 2
                            and msg[0] == "ctl"
                            and isinstance(msg[1], dict)):
                        try:
                            info = self.ctl_fn(dict(msg[1]))
                        except Exception as e:  # never wedge the REP
                            info = {"accepted": False,
                                    "error": type(e).__name__}
                        reply = wire.dumps(("ctl_ok", info))
                if reply is None:       # any other frame means "status"
                    try:
                        snap = (self.snapshot_fn()
                                if self.snapshot_fn is not None
                                else self.registry.snapshot())
                    except Exception:   # a status query must never wedge
                        snap = self.registry.snapshot()
                    reply = wire.dumps(snap)
                self.sock.send(reply)

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=5)
        self.sock.close(linger=0)


def ctl_request(comms: CommsConfig, cmd: dict,
                learner_ip: str | None = None,
                timeout_s: float = 5.0) -> dict | None:
    """Client half of the learner ctl surface (the PBT controller's
    exploit/explore commands): one REQ round-trip carrying
    ``("ctl", cmd)``; the server's ack info dict, or None when nothing
    answers (or an old server replied with a status snapshot)."""
    import zmq

    from apex_tpu_torch.runtime import wire

    sock = zmq.Context.instance().socket(zmq.REQ)
    ip = learner_ip or comms.learner_ip
    sock.connect(f"tcp://{ip}:{comms.status_port}")
    try:
        sock.send(wire.dumps(("ctl", dict(cmd))))
        if not sock.poll(int(timeout_s * 1000), zmq.POLLIN):
            return None
        try:
            got = wire.restricted_loads(sock.recv())
        except wire.WireRejected:
            return None
        if isinstance(got, tuple) and len(got) == 2 \
                and got[0] == "ctl_ok" and isinstance(got[1], dict):
            return got[1]
        return None
    finally:
        sock.close(linger=0)


def status_request(comms: CommsConfig, learner_ip: str | None = None,
                   timeout_s: float = 5.0) -> dict | None:
    """Client half of the status surface: one REQ round-trip to the
    learner's :class:`FleetStatusServer`; None when nothing answers."""
    import zmq

    from apex_tpu_torch.runtime import wire

    sock = zmq.Context.instance().socket(zmq.REQ)
    ip = learner_ip or comms.learner_ip
    sock.connect(f"tcp://{ip}:{comms.status_port}")
    try:
        sock.send(b"status")
        if sock.poll(int(timeout_s * 1000), zmq.POLLIN):
            return wire.restricted_loads(sock.recv())
        return None
    finally:
        sock.close(linger=0)
