"""The tenancy placement controller: admission, bands, rebalancing.

Counterpart of :mod:`apex_tpu.tenancy.scheduler`, a copy with the port's
import paths (stdlib at module level; ``zmq`` and the transport import
inside the socket wrapper).  ``--role tenant-ctl`` is the multi-tenant
plane's control loop: a socket-free, fake-clock-testable
:class:`PlacementScheduler` decides, and a one-thread socket wrapper
(:class:`TenantCtl`) feeds it observations and ships the evidence out.

* **Admission**: every :class:`~apex_tpu_torch.tenancy.namespace.
  TenantSpec` of the ``APEX_TENANTS`` roster (population lineages
  included) is admitted, recorded and counted.
* **Bands**: the replay and infer tiers split into weight-proportional
  contiguous shard bands (largest-remainder apportionment; every tenant
  gets at least one shard, and with more tenants than shards the bands
  share round-robin).  Bands are the capacity plan; the hash planes stay
  uniform until a tenant's roles opt into their band
  (:func:`apex_tpu_torch.tenancy.namespace.shard_in_band`).
* **Placement**: hosts learned from the shared fleet's heartbeat gauges
  (``backend_accel`` on infer and replay beats) rank card-backed hosts
  first for ``accel`` tenants and CPU spares first for toy tenants.
* **Eviction and rebalance**: a tenant whose learner status port stays
  silent past ``dead_after_s`` is EVICTED and its band redistributes to
  the survivors; a probe that answers again re-admits it.

The controller heartbeats like any role and ships its snapshot to the
host learner as a :class:`TenancyStat` (the ``tenancy`` section of
``fleet_summary.json``, the status lines and ``apex_tenancy_*`` rows).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from apex_tpu_torch.tenancy import namespace

PENDING, ACTIVE, EVICTED = "PENDING", "ACTIVE", "EVICTED"

#: state -> numeric code for gauges/exposition (the slo_state pattern)
STATE_CODE = {PENDING: 0, ACTIVE: 1, EVICTED: 2}


@dataclass
class TenancyStat:
    """The controller's state shipped to the host learner on the stat
    channel (wire-allowlisted): ``snapshot`` is
    :meth:`PlacementScheduler.snapshot` — plain builtins only."""

    identity: str
    snapshot: dict = field(default_factory=dict)


def assign_bands(weights: dict[str, float],
                 n_shards: int) -> dict[str, list[int]]:
    """Weight-proportional contiguous shard bands (largest-remainder
    apportionment, deterministic under sorted tenant order).  Every
    tenant gets at least one shard; with more tenants than shards the
    single-shard bands share round-robin."""
    names = sorted(weights)
    if not names:
        return {}
    n = max(1, int(n_shards))
    if len(names) >= n:
        return {t: [i % n] for i, t in enumerate(names)}
    total = sum(weights[t] for t in names)
    raw = {t: n * weights[t] / total for t in names}
    counts = {t: max(1, int(raw[t])) for t in names}
    while sum(counts.values()) < n:
        # most under-served first; sorted-name order breaks ties
        t = max(names, key=lambda x: (raw[x] - counts[x], x))
        counts[t] += 1
    while sum(counts.values()) > n:
        over = [t for t in names if counts[t] > 1]
        if not over:
            break
        t = min(over, key=lambda x: (raw[x] - counts[x], x))
        counts[t] -= 1
    out: dict[str, list[int]] = {}
    at = 0
    for t in names:
        out[t] = list(range(at, at + counts[t]))
        at += counts[t]
    return out


def place(spec: namespace.TenantSpec,
          host_backends: dict[str, bool]) -> str | None:
    """Preferred host for a tenant's heavy roles: ``accel`` tenants
    rank accelerator-backed hosts first, toy tenants rank CPU spares
    first (do not spend a card-backed host on CartPole); sorted-name order makes
    the pick deterministic.  None while no host has reported."""
    if not host_backends:
        return None
    ranked = sorted(host_backends.items(),
                    key=lambda kv: (kv[1] != spec.accel, kv[0]))
    return ranked[0][0]


@dataclass
class _TenantState:
    spec: namespace.TenantSpec
    state: str = PENDING
    last_seen: float | None = None      # newest successful learner probe
    severity: int | None = None         # tenant's own SLO severity
    steps: int | None = None            # tenant learner progress
    host: str | None = None             # placement pick
    evictions: int = 0


class PlacementScheduler:
    """The decision half of tenant-ctl (module docstring): socket-free,
    every clock injectable, every transition in a bounded timeline —
    the DeployController testing discipline."""

    def __init__(self, n_replay_shards: int, n_infer_shards: int,
                 dead_after_s: float = 15.0, clock=time.monotonic,
                 wall=time.time, timeline_cap: int = 128):
        self.n_replay_shards = max(1, int(n_replay_shards))
        self.n_infer_shards = max(1, int(n_infer_shards))
        self.dead_after_s = float(dead_after_s)
        self._clock = clock
        self._wall = wall
        self.tenants: dict[str, _TenantState] = {}
        self.replay_bands: dict[str, list[int]] = {}
        self.infer_bands: dict[str, list[int]] = {}
        self.admissions = 0
        self.evictions = 0
        self.rebalances = 0
        self.timeline: deque = deque(maxlen=timeline_cap)
        self._t0: float | None = None

    # -- the machine -------------------------------------------------------

    def _event(self, kind: str, tenant: str, reason: str) -> dict:
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        e = {"t_s": round(now - self._t0, 3),
             "wall": round(self._wall(), 3),
             "event": kind, "tenant": tenant, "reason": reason}
        self.timeline.append(e)
        return e

    def _active_weights(self) -> dict[str, float]:
        return {name: ts.spec.weight for name, ts in self.tenants.items()
                if ts.state == ACTIVE}

    def _rebalance(self, reason: str) -> None:
        weights = self._active_weights()
        replay = assign_bands(weights, self.n_replay_shards)
        infer = assign_bands(weights, self.n_infer_shards)
        if replay != self.replay_bands or infer != self.infer_bands:
            self.replay_bands, self.infer_bands = replay, infer
            self.rebalances += 1
            self._event("REBALANCED", ",".join(sorted(weights)) or "-",
                        reason)

    def admit(self, spec: namespace.TenantSpec) -> None:
        """Admit (or re-admit) one tenant and rebalance the bands.
        Idempotent for an already-ACTIVE tenant with the same spec —
        the controller reconciles the roster every tick."""
        ts = self.tenants.get(spec.name)
        if ts is not None and ts.state == ACTIVE and ts.spec == spec:
            return
        if ts is None:
            ts = self.tenants[spec.name] = _TenantState(spec)
        readmit = ts.state == EVICTED
        ts.spec, ts.state = spec, ACTIVE
        ts.last_seen = self._clock()
        self.admissions += 1
        self._event("ADMITTED", spec.name,
                    "re-admission" if readmit else
                    f"roster (weight={spec.weight:g}, "
                    f"quota={spec.replay_quota})")
        self._rebalance(f"admit {spec.name}")

    def evict(self, name: str, reason: str) -> bool:
        ts = self.tenants.get(name)
        if ts is None or ts.state != ACTIVE:
            return False
        ts.state = EVICTED
        ts.evictions += 1
        self.evictions += 1
        self._event("EVICTED", name, reason)
        self._rebalance(f"evict {name}")
        return True

    def observe(self, name: str, alive: bool, severity: int | None = None,
                steps: int | None = None) -> None:
        """One probe result for a tenant's learner.  A live probe
        re-admits an evicted tenant (its learner came back — the serve-
        ctl respawn-reconvergence discipline)."""
        ts = self.tenants.get(name)
        if ts is None:
            return
        if alive:
            ts.last_seen = self._clock()
            ts.severity, ts.steps = severity, steps
            if ts.state == EVICTED:
                self.admit(ts.spec)

    def tick(self, host_backends: dict[str, bool] | None = None
             ) -> list[dict]:
        """Apply the silence threshold + refresh placement; returns the
        timeline events appended this tick."""
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        before = len(self.timeline)
        for name, ts in sorted(self.tenants.items()):
            if ts.state != ACTIVE:
                continue
            if ts.last_seen is not None \
                    and now - ts.last_seen > self.dead_after_s:
                self.evict(name, f"learner silent "
                                 f"{now - ts.last_seen:.0f}s")
            elif host_backends:
                ts.host = place(ts.spec, host_backends)
        return list(self.timeline)[before:]

    # -- read surface ------------------------------------------------------

    def snapshot(self) -> dict:
        """Serializable controller view (TenancyStat payload, the
        ``tenancy`` section of fleet_summary.json): plain builtins
        only.  tests/test_torch_tenancy.py holds it
        equal to the JAX scheduler's."""
        now = self._clock()
        tenants = {}
        for name, ts in sorted(self.tenants.items()):
            tenants[name] = {
                "state": ts.state,
                "env_id": ts.spec.env_id,
                "family": ts.spec.family,
                "weight": ts.spec.weight,
                "replay_quota": ts.spec.replay_quota,
                "accel": ts.spec.accel,
                "replay_band": self.replay_bands.get(name, []),
                "infer_band": self.infer_bands.get(name, []),
                "host": ts.host,
                "severity": ts.severity,
                "steps": ts.steps,
                "silent_s": (None if ts.last_seen is None
                             else round(now - ts.last_seen, 1)),
                "evictions": ts.evictions,
            }
        return {
            "kind": "apex_tenancy",
            "version": 1,
            "n_replay_shards": self.n_replay_shards,
            "n_infer_shards": self.n_infer_shards,
            "tenants": tenants,
            "admissions": self.admissions,
            "evictions": self.evictions,
            "rebalances": self.rebalances,
            "timeline": list(self.timeline),
        }


# -- operator/exposition surfaces --------------------------------------------


def prometheus_sections(tenancy: dict) -> tuple[dict, dict]:
    """(gauges, labeled) — the ``apex_tenancy_*`` row family the
    learner's scrape surface serves next to the slo/serving rows."""
    tenants = tenancy.get("tenants") or {}
    gauges = {
        "tenancy_tenants": len(tenants),
        "tenancy_admissions": tenancy.get("admissions", 0),
        "tenancy_evictions": tenancy.get("evictions", 0),
        "tenancy_rebalances": tenancy.get("rebalances", 0),
    }
    labeled = {
        "tenancy_tenant_state": [({"tenant": t, "state": v.get("state")},
                                  STATE_CODE.get(v.get("state"), 0))
                                 for t, v in sorted(tenants.items())],
        "tenancy_tenant_shards": [({"tenant": t, "plane": plane},
                                   len(v.get(key) or []))
                                  for t, v in sorted(tenants.items())
                                  for plane, key in
                                  (("replay", "replay_band"),
                                   ("infer", "infer_band"))],
    }
    return gauges, labeled


def format_tenancy_lines(tenancy: dict) -> list[str]:
    """Human tenancy lines for the ``--role status`` table: one line per
    tenant plus the admission/eviction timeline tail."""
    tenants = tenancy.get("tenants") or {}
    lines = [
        f"tenancy: {len(tenants)} tenant(s) "
        f"admissions={tenancy.get('admissions', 0)} "
        f"evictions={tenancy.get('evictions', 0)} "
        f"rebalances={tenancy.get('rebalances', 0)}"]
    for t, v in sorted(tenants.items()):
        lines.append(
            f"tenant {t}: {v.get('state')} env={v.get('env_id')} "
            f"weight={v.get('weight')} quota={v.get('replay_quota')} "
            f"replay_band={v.get('replay_band')} "
            f"infer_band={v.get('infer_band')} "
            f"host={v.get('host') or '-'} "
            f"severity={v.get('severity') if v.get('severity') is not None else '-'}")
    for e in (tenancy.get("timeline") or [])[-4:]:
        lines.append(f"tenancy t={e['t_s']}s {e['event']} {e['tenant']} "
                     f"({e['reason']})")
    return lines


# -- the socket role ---------------------------------------------------------


class TenantCtl:
    """Socket wrapper around :class:`PlacementScheduler` — the
    ``--role tenant-ctl`` process body (serve-ctl's one-thread shape).

    Per tick: probe each roster tenant's OWN learner status port
    (liveness + its SLO severity + progress), probe the HOST fleet's
    status port once for host/backend gauges, feed the scheduler, and
    ship the snapshot to the host learner as a :class:`TenancyStat`.
    """

    def __init__(self, cfg, interval_s: float = 5.0,
                 roster: dict[str, namespace.TenantSpec] | None = None):
        from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
        from apex_tpu_torch.obs.slo import SloEngine, roster_slos
        from apex_tpu_torch.runtime import transport

        self.comms = cfg.comms
        self.interval_s = float(interval_s)
        self.roster = (roster if roster is not None
                       else namespace.load_roster())
        # per-tenant objective sets from the roster:
        # a progress-floor + eval-score objective PER tenant, judged off
        # this controller's own probe stream — the @tenant suffix only
        # covered peers the HOST registry sees; these cover every roster
        # tenant's learner directly
        self.slo = SloEngine(roster_slos(self.roster)) if self.roster \
            else None
        self._probe_marks: dict[str, tuple[float, int]] = {}
        self._probe_rates: dict[str, float | None] = {}
        self._probe_scores: dict[str, float | None] = {}
        # eviction needs SEVERAL missed probe rounds, not one slow
        # status reply: the scheduler's clock ticks at interval_s, so a
        # dead_after_s below ~3 ticks would evict on a single learner
        # GC/compile pause and thrash the bands
        self.sched = PlacementScheduler(
            max(1, cfg.comms.replay_shards),
            max(1, getattr(cfg.comms, "infer_shards", 1)),
            dead_after_s=max(cfg.comms.dead_after_s,
                             3.0 * self.interval_s))
        self.sender = transport.ChunkSender(cfg.comms, "tenant-ctl")
        self.beat = HeartbeatEmitter(
            "tenant-ctl", role="tenant-ctl",
            interval_s=cfg.comms.heartbeat_interval_s,
            gauges_fn=self._gauges)
        self.ticks = 0

    def _gauges(self) -> dict:
        return {"tenants": sum(ts.state == ACTIVE
                               for ts in self.sched.tenants.values())}

    def _probe_tenant(self, spec: namespace.TenantSpec) -> None:
        from apex_tpu_torch.fleet.registry import status_request
        from apex_tpu_torch.obs.slo import resolve_signal

        try:
            snap = status_request(
                namespace.tenant_comms(self.comms, spec),
                timeout_s=min(2.0, self.interval_s))
        except Exception:
            snap = None
        if not snap:
            self.sched.observe(spec.name, alive=False)
            self._probe_rates[spec.name] = None
            self._probe_scores[spec.name] = None
            return
        slo = snap.get("slo") or {}
        steps = snap.get("steps")
        self.sched.observe(spec.name, alive=True,
                           severity=slo.get("severity"),
                           steps=steps)
        # roster-SLO inputs: probe-differenced progress rate + the
        # tenant's eval-ladder mean off its own registry gauges
        self._probe_scores[spec.name] = resolve_signal(
            snap, "gauge:evaluator:eval_score_mean:min")
        now = time.monotonic()
        rate = None
        mark = self._probe_marks.get(spec.name)
        if steps is not None:
            if mark is not None and now > mark[0]:
                rate = max(0.0, (int(steps) - mark[1]) / (now - mark[0]))
            self._probe_marks[spec.name] = (now, int(steps))
        self._probe_rates[spec.name] = rate

    def _slo_summary(self) -> dict:
        """The probe-derived signal space the roster objectives walk
        (:func:`apex_tpu_torch.obs.slo.roster_slos`)."""
        return {"tenants": {
            name: {"steps_rate": self._probe_rates.get(name),
                   "eval_score": self._probe_scores.get(name)}
            for name in self.roster}}

    def _probe_hosts(self) -> dict[str, bool]:
        """Host -> accelerator-backed, from the shared fleet's
        heartbeat gauges (infer/replay roles ship ``backend_accel``)."""
        from apex_tpu_torch.fleet.registry import status_request

        try:
            snap = status_request(self.comms,
                                  timeout_s=min(2.0, self.interval_s))
        except Exception:
            return {}
        out: dict[str, bool] = {}
        for p in (snap or {}).get("peers") or []:
            host = p.get("host")
            if not host or p.get("state") == "DEAD":
                continue
            accel = bool((p.get("gauges") or {}).get("backend_accel"))
            out[host] = out.get(host, False) or accel
        return out

    def step(self) -> None:
        """One control round: reconcile roster -> probe -> tick ->
        report (new timeline events print like serve-ctl's do)."""
        for spec in self.roster.values():
            ts = self.sched.tenants.get(spec.name)
            if ts is None:
                self.sched.admit(spec)
        for spec in self.roster.values():
            self._probe_tenant(spec)
        for e in self.sched.tick(self._probe_hosts()):
            print(f"tenant-ctl: {e['event']} {e['tenant']} "
                  f"({e['reason']})", flush=True)
        if self.slo is not None:
            for tr in self.slo.sample(self._slo_summary()):
                print(f"tenant-ctl: slo {tr['objective']} {tr['from']} "
                      f"-> {tr['to']} (value={tr['value']})", flush=True)
        self.ticks += 1
        snap = self.sched.snapshot()
        if self.slo is not None:
            # per-tenant objective states ride the tenancy section so
            # fleet_summary.json answers "is each tenant in objective"
            snap["slo"] = self.slo.snapshot()
        self.sender.send_stat(TenancyStat("tenant-ctl", snap))
        hb = self.beat.maybe_beat()
        if hb is not None:
            self.sender.send_stat(hb)

    def run(self, stop_event=None, max_seconds: float | None = None):
        deadline = (None if max_seconds is None
                    else time.monotonic() + max_seconds)
        try:
            while True:
                if stop_event is not None and stop_event.is_set():
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                t0 = time.monotonic()
                self.step()
                rest = self.interval_s - (time.monotonic() - t0)
                if rest > 0:
                    if stop_event is not None:
                        stop_event.wait(rest)
                    else:
                        time.sleep(rest)
        finally:
            self.close()
        return self.sched.snapshot()

    def close(self) -> None:
        self.sender.close(drain_s=0.0)


def run_tenant_ctl(cfg, interval_s: float = 5.0, stop_event=None,
                   max_seconds: float | None = None) -> dict:
    """The ``--role tenant-ctl`` entry point.  Skips the startup barrier
    like the other controllers — useful the moment any tenant's status
    port answers.  Returns the final scheduler snapshot."""
    from apex_tpu_torch.obs.trace import get_ring, set_process_label

    set_process_label("tenant-ctl")
    get_ring()
    ctl = TenantCtl(cfg, interval_s=interval_s)
    print(f"tenant-ctl: {len(ctl.roster)} roster tenant(s) over "
          f"{ctl.sched.n_replay_shards} replay + "
          f"{ctl.sched.n_infer_shards} infer shard(s), "
          f"tick={interval_s:g}s", flush=True)
    return ctl.run(stop_event=stop_event, max_seconds=max_seconds)
