"""Epoch-fenced canary deployments for the sharded serving tier.

Counterpart of :mod:`apex_tpu.serving.deploy`, a copy with the port's
import paths (stdlib at module level; ``zmq`` and the transport import
inside the socket wrapper).  ``--role serve-ctl`` is the serving tier's
control plane: learner epochs (with their param-version minor key,
:mod:`apex_tpu_torch.serving.fence`) become model VERSIONS, and every new
version walks a canary lifecycle before the whole tier serves it::

    IDLE --new version--> CANARY --healthy soak_s--> PROMOTED
                             |
                             +--SLO/eval breach--> ROLLED_BACK

* **CANARY**: a configured fraction of infer shards (the lowest shard
  indices, so the canary band is the same worker population every
  deployment) tracks the live param stream; every other shard freezes
  the incumbent through the server's epoch-fenced param gate
  (:meth:`apex_tpu_torch.infer_service.service.InferServer.apply_ctl`).
* **PROMOTED**: the gate objectives (the learner's
  :class:`~apex_tpu_torch.obs.slo.SloEngine` states, read over one status
  round trip per tick) held for ``soak_s``.  All shards open the gate for
  ``gate_open_s``; the candidate becomes the incumbent.
* **ROLLED_BACK**: a gate objective BREACHED mid-canary.  Canary shards
  restore their stashed incumbent bit for bit and the whole tier pins
  it; the candidate is remembered as rejected and never canaried again.

The controller reconciles: every tick it re-asserts each shard's desired
gate state, so a respawned shard (which comes up unpinned) re-converges
within one tick.  It heartbeats like any role and ships its bounded
timeline to the learner as a :class:`ServingStat` on the stat channel, so
``fleet_summary.json``, the status table and the ``apex_serving_*``
Prometheus rows show the same machine.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

from apex_tpu_torch.serving import fence

IDLE, CANARY, PROMOTED, ROLLED_BACK = ("IDLE", "CANARY", "PROMOTED",
                                       "ROLLED_BACK")

#: state -> numeric code for gauges/exposition (the slo_state pattern)
STATE_CODE = {IDLE: 0, CANARY: 1, PROMOTED: 2, ROLLED_BACK: 3}

#: SLO objectives whose BREACHED state fails a canary (an unknown state
#: holds — promoting on a half-clear signal is how canaries lie)
GATE_OBJECTIVES = ("eval_score", "infer_rt_p99_ms")


@dataclass
class ServingStat:
    """The controller's state shipped to the learner on the stat channel
    (wire-allowlisted): ``snapshot`` is :meth:`DeployController.snapshot`
    — plain builtins only, so the restricted unpickler carries it."""

    identity: str
    snapshot: dict = field(default_factory=dict)


class DeployController:
    """The canary state machine, socket-free and fake-clock testable.

    :meth:`tick` consumes one observation — the learner's newest
    published model fence plus the SLO objective states — and returns
    the ``(shard, ctl command)`` list to send this tick (the reconcile
    set, plus rollback edges).  Everything time-like runs off the
    injected clock, so tests/test_torch_serving.py holds every
    transition against the JAX controller's.
    """

    def __init__(self, n_shards: int, canary_frac: float = 0.5,
                 soak_s: float = 60.0, version_every: int = 0,
                 gate: tuple = GATE_OBJECTIVES, gate_open_s: float = 10.0,
                 clock=time.monotonic, wall=time.time,
                 timeline_cap: int = 128):
        self.n_shards = max(1, int(n_shards))
        self.canary_frac = float(canary_frac)
        self.soak_s = float(soak_s)
        # minimum param-version spacing between deployments within one
        # learner epoch (0 = epoch changes only: a restarted learner's
        # params are always a new model, a long-lived learner's stream
        # is one); CI drills compress the cycle with small values
        self.version_every = int(version_every)
        self.gate = tuple(gate)
        # how long the param gate stays OPEN after a promotion before
        # the tier re-freezes — long enough for every shard to install
        # the newly judged version off the conflate stream (a couple of
        # publish periods), short enough that unjudged successors don't
        # ride in behind it
        self.gate_open_s = float(gate_open_s)
        # the canary band: the LOWEST shard indices, at least one, and
        # never the whole tier unless the tier is one shard (an
        # incumbent must keep serving somewhere for the rollback to
        # mean anything)
        k = max(1, int(math.ceil(self.canary_frac * self.n_shards)))
        if self.n_shards > 1:
            k = min(k, self.n_shards - 1)
        self.canary_shards = tuple(range(k))
        self._clock = clock
        self._wall = wall
        self.state = IDLE
        self.incumbent: tuple | None = None     # trusted model fence
        self.candidate: tuple | None = None     # fence under canary
        self.rejected: tuple | None = None      # newest rolled-back fence
        self.deployments = 0
        self.promotions = 0
        self.rollbacks = 0
        self.shard_view: dict[int, dict] = {}   # shard -> last ctl state
        self.timeline: deque = deque(maxlen=timeline_cap)
        self._t0: float | None = None
        self._healthy_since: float | None = None
        self._promoted_at: float | None = None  # gate-open window anchor

    # -- the machine -------------------------------------------------------

    def _event(self, now: float, frm: str, to: str, reason: str,
               version: tuple | None) -> dict:
        e = {"t_s": round(now - self._t0, 3),
             "wall": round(self._wall(), 3),
             "version": fence.fmt(version),
             "from": frm, "to": to, "reason": reason}
        self.timeline.append(e)
        return e

    def _deployable(self, f: tuple) -> bool:
        """Is ``f`` a NEW model version worth a deployment?  Anything at
        or behind the incumbent/rejected watermark is old news; a new
        learner epoch always deploys (restart = new model by
        definition); within an epoch, ``version_every`` spaces
        deployments (0 = never — epochs only)."""
        base = self.incumbent
        if self.rejected is not None and self.rejected > base:
            base = self.rejected        # a rejected fence is never re-run
        if not fence.beyond(f[0], f[1], base):
            return False
        if f[0] > base[0]:
            return True
        return self.version_every > 0 and f[1] >= base[1] + self.version_every

    def _health(self, slo_states: dict | None) -> bool | None:
        """True = every gate objective readable and un-breached, False =
        any BREACHED, None = unreadable (hold: neither soak credit nor
        rollback — the autoscaler's half-clear-signal discipline)."""
        if not slo_states:
            return None
        states = [slo_states.get(name) for name in self.gate]
        if any(s == "BREACHED" for s in states):
            return False
        if any(s is None for s in states):
            return None
        return True

    def _desired(self, now: float) -> dict[int, dict]:
        """Each shard's gate state for the CURRENT machine state — the
        per-tick reconcile (idempotent server-side), so a respawned
        shard re-converges within one tick.

        The tier serves FROZEN models: outside a deployment every shard
        is frozen at its own judged fence (``freeze`` — stash + pin at
        current), the gate opening only for ``gate_open_s`` after a
        promotion so shards take the newly judged version off the
        conflate stream, then re-freezing.  Without the freeze, the
        latest-wins stream would drift "incumbent" shards past the
        fence between deployments and a later rollback would have
        nothing judged to restore.
        """
        out: dict[int, dict] = {}
        inc = self.incumbent or (0, 0)
        for s in range(self.n_shards):
            if self.state == CANARY:
                out[s] = ({"cmd": "canary"} if s in self.canary_shards
                          else {"cmd": "freeze"})
            elif self.state == ROLLED_BACK:
                # rollback is the reconcile verb here: each shard
                # restores ITS OWN stashed incumbent (idempotent — a
                # restored/frozen shard no-ops), and a respawn that
                # picked up the candidate with no stash drops to dry
                out[s] = {"cmd": "rollback", "epoch": inc[0],
                          "version": inc[1]}
            elif self.state == PROMOTED and self._promoted_at is not None \
                    and now - self._promoted_at >= self.gate_open_s:
                out[s] = {"cmd": "freeze"}      # gate closed: re-freeze
            else:                       # IDLE bootstrap / open gate
                out[s] = {"cmd": "promote"}
        return out

    def tick(self, learner: dict | None,
             slo_states: dict | None) -> list[tuple[int, dict]]:
        """One control round.  ``learner`` is the newest published model
        (``{"epoch": E, "version": V}``) or None while the learner is
        unreachable; ``slo_states`` maps objective name -> alert state.
        Returns the ``(shard, command)`` sends for this tick."""
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        if learner is not None:
            f = fence.fence_key(learner.get("epoch"),
                                learner.get("version"))
            if self.incumbent is None:
                # bootstrap: the first model observed IS the incumbent —
                # there is nothing older to fall back to, so canarying
                # it would be theater
                self.incumbent = f
                self._event(now, IDLE, IDLE, "incumbent adopted", f)
            elif self.state != CANARY and self._deployable(f):
                self.candidate = f
                self.deployments += 1
                self._event(now, self.state, CANARY,
                            "new model version", f)
                self.state = CANARY
                self._healthy_since = None
            elif self.state == CANARY and f > self.candidate:
                # the canary band tracks the LIVE stream: the fence under
                # judgment advances with it (one deployment covers the
                # stream until verdict, not one frozen publish)
                self.candidate = f
        if self.state == CANARY:
            health = self._health(slo_states)
            if health is False:
                self.rollbacks += 1
                self.rejected = self.candidate
                bad = [n for n in self.gate
                       if (slo_states or {}).get(n) == "BREACHED"]
                self._event(now, CANARY, ROLLED_BACK,
                            f"breached: {','.join(bad)}", self.candidate)
                self.state = ROLLED_BACK
                self.candidate = None
                self._healthy_since = None
            elif health is True:
                if self._healthy_since is None:
                    self._healthy_since = now
                elif now - self._healthy_since >= self.soak_s:
                    self.promotions += 1
                    self.incumbent = self.candidate
                    self._event(now, CANARY, PROMOTED,
                                f"healthy for {self.soak_s:g}s",
                                self.candidate)
                    self.state = PROMOTED
                    self.candidate = None
                    self._promoted_at = now
            else:
                self._healthy_since = None      # unreadable: no credit
        return sorted(self._desired(now).items())

    # -- read surface ------------------------------------------------------

    def snapshot(self) -> dict:
        """Serializable controller view (ServingStat payload, the
        ``serving`` section of fleet_summary.json): plain builtins only.
        tests/test_torch_serving.py holds it
        equal to the JAX controller's."""
        def _fence_dict(f):
            if f is None:
                return None
            return {"epoch": f[0], "version": f[1], "id": fence.fmt(f)}

        return {
            "kind": "apex_serving",
            "version": 1,
            "state": self.state,
            "n_shards": self.n_shards,
            "canary_frac": self.canary_frac,
            "canary_shards": list(self.canary_shards),
            "soak_s": self.soak_s,
            "version_every": self.version_every,
            "incumbent": _fence_dict(self.incumbent),
            "candidate": _fence_dict(self.candidate),
            "rejected": _fence_dict(self.rejected),
            "deployments": self.deployments,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "shards": {str(s): dict(v)
                       for s, v in sorted(self.shard_view.items())},
            "timeline": list(self.timeline),
        }


# -- operator/exposition surfaces --------------------------------------------


def prometheus_sections(serving: dict) -> tuple[dict, dict]:
    """(gauges, labeled) — the ``apex_serving_*`` row family the
    learner's scrape surface serves next to the slo/fleet rows."""
    inc = serving.get("incumbent") or {}
    gauges = {
        "serving_deployments": serving.get("deployments", 0),
        "serving_promotions": serving.get("promotions", 0),
        "serving_rollbacks": serving.get("rollbacks", 0),
        "serving_canary_shards": len(serving.get("canary_shards", ())),
        "serving_incumbent_epoch": inc.get("epoch"),
        "serving_incumbent_version": inc.get("version"),
    }
    labeled = {
        "serving_state": [({"state": serving.get("state", IDLE)},
                           STATE_CODE.get(serving.get("state"), 0))],
        "serving_shard_pinned": [({"shard": s},
                                  1.0 if v.get("pinned") else 0.0)
                                 for s, v in sorted(
                                     (serving.get("shards") or {}).items())],
        "serving_shard_version": [({"shard": s}, v.get("version"))
                                  for s, v in sorted(
                                      (serving.get("shards") or {}).items())
                                  if v.get("version") is not None],
    }
    return gauges, labeled


def format_serving_lines(serving: dict) -> list[str]:
    """Human serving-tier lines for the ``--role status`` table."""
    inc = serving.get("incumbent") or {}
    cand = serving.get("candidate") or {}
    lines = [
        f"serving: {serving.get('state')} "
        f"incumbent={inc.get('id', '-')} "
        f"candidate={cand.get('id') or '-'} "
        f"canary_shards={serving.get('canary_shards')} "
        f"deployments={serving.get('deployments', 0)} "
        f"promotions={serving.get('promotions', 0)} "
        f"rollbacks={serving.get('rollbacks', 0)}"]
    for s, v in sorted((serving.get("shards") or {}).items()):
        lines.append(
            f"serving shard {s}: "
            f"{'PINNED' if v.get('pinned') else 'tracking'} "
            f"model={v.get('epoch')}:{v.get('version')} "
            f"held={v.get('held', 0)} rollbacks={v.get('rollbacks', 0)}")
    for e in (serving.get("timeline") or [])[-4:]:
        lines.append(f"serving t={e['t_s']}s {e['from']} -> {e['to']} "
                     f"({e['version']}; {e['reason']})")
    return lines


# -- the socket role ---------------------------------------------------------


class ServeCtl:
    """Socket wrapper around :class:`DeployController` — the
    ``--role serve-ctl`` process body.

    One thread owns everything: the status
    REQ round-trip to the learner, one ctl DEALER per shard (commands
    out, ``("ctl_ok", state)`` replies drained non-blocking into the
    controller's shard view), and the learner-channel ChunkSender
    carrying heartbeats + :class:`ServingStat` snapshots.
    """

    def __init__(self, cfg, learner_ip: str | None = None,
                 canary_frac: float = 0.5, soak_s: float = 60.0,
                 version_every: int = 0, interval_s: float = 5.0):
        import zmq

        from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
        from apex_tpu_torch.runtime import transport
        from apex_tpu_torch.serving.shard import shard_port

        self._zmq = zmq
        self.comms = cfg.comms
        self.learner_ip = learner_ip or cfg.comms.learner_ip
        self.interval_s = float(interval_s)
        n = max(1, getattr(cfg.comms, "infer_shards", 1))
        # gate stays open two reconcile rounds after promotion: enough
        # for every shard to see a publish, bounded drift behind it
        self.ctrl = DeployController(n, canary_frac=canary_frac,
                                     soak_s=soak_s,
                                     version_every=version_every,
                                     gate_open_s=max(2.0 * interval_s,
                                                     5.0))
        ip = cfg.comms.infer_ip
        self.ctl_socks = []
        for s in range(n):
            sock = zmq.Context.instance().socket(zmq.DEALER)
            sock.setsockopt(zmq.IDENTITY, f"serve-ctl-{s}".encode())
            sock.setsockopt(zmq.SNDHWM, 8)   # a dead shard must not
            sock.connect(f"tcp://{ip}:{shard_port(cfg.comms, s)}")  # wedge us
            self.ctl_socks.append(sock)
        self.sender = transport.ChunkSender(cfg.comms, "serve-ctl",
                                            learner_ip=self.learner_ip)
        self.beat = HeartbeatEmitter(
            "serve-ctl", role="serve-ctl",
            interval_s=cfg.comms.heartbeat_interval_s,
            gauges_fn=self._gauges)
        self.ticks = 0
        self._rid = 0
        self._events_seen = 0

    def _gauges(self) -> dict:
        c = self.ctrl
        return {"serve_state_code": STATE_CODE.get(c.state, 0),
                "serve_deployments": c.deployments,
                "serve_promotions": c.promotions,
                "serve_rollbacks": c.rollbacks}

    def _probe(self) -> tuple[dict | None, dict | None]:
        """One learner status round-trip -> (newest model fence, SLO
        objective states); (None, None) while nothing answers."""
        from apex_tpu_torch.fleet.registry import status_request

        try:
            snap = status_request(self.comms, learner_ip=self.learner_ip,
                                  timeout_s=min(2.0, self.interval_s))
        except Exception:
            return None, None
        if not snap:
            return None, None
        m = snap.get("metrics") or {}
        learner = None
        if m.get("param_version") is not None:
            learner = {"epoch": m.get("learner_epoch", 0),
                       "version": m.get("param_version", 0)}
        slo = {o["name"]: o["state"]
               for o in (snap.get("slo") or {}).get("objectives", [])}
        return learner, (slo or None)

    def _drain_ctl_replies(self) -> None:
        from apex_tpu_torch.runtime import wire

        for sock in self.ctl_socks:
            while sock.poll(0, self._zmq.POLLIN):
                try:
                    got = wire.restricted_loads(sock.recv())
                except wire.WireRejected:
                    continue
                if (isinstance(got, tuple) and len(got) == 2
                        and got[0] == "ctl_ok" and isinstance(got[1], dict)):
                    body = got[1]
                    self.ctrl.shard_view[int(body.get("shard", 0))] = body

    def step(self) -> None:
        """One control round: probe -> decide -> reconcile -> report."""
        from apex_tpu_torch.runtime import wire

        learner, slo = self._probe()
        before = len(self.ctrl.timeline)
        cmds = self.ctrl.tick(learner, slo)
        for e in list(self.ctrl.timeline)[before:]:
            print(f"serve-ctl: {e['from']} -> {e['to']} "
                  f"({e['version']}; {e['reason']})", flush=True)
        for s, cmd in cmds:
            self._rid += 1
            try:
                self.ctl_socks[s].send(
                    wire.dumps(("ctl", dict(cmd, rid=self._rid))),
                    self._zmq.DONTWAIT)
            except self._zmq.Again:
                pass            # dead shard: re-asserted next tick anyway
        self._drain_ctl_replies()
        self.ticks += 1
        # evidence out: the timeline must land in fleet_summary.json /
        # the status table / apex_serving_* rows, so every tick ships
        # the snapshot (small, bounded) — not just transitions
        self.sender.send_stat(ServingStat("serve-ctl",
                                          self.ctrl.snapshot()))
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
        return self.ctrl.snapshot()

    def close(self) -> None:
        for sock in self.ctl_socks:
            sock.close(linger=0)
        self.sender.close(drain_s=0.0)


def run_serve_ctl(cfg, identity=None, canary_frac: float = 0.5,
                  soak_s: float = 60.0, version_every: int = 0,
                  interval_s: float = 5.0, stop_event=None,
                  max_seconds: float | None = None) -> dict:
    """The ``--role serve-ctl`` entry point.  Skips the startup barrier
    like the replay/infer roles — the controller is useful the moment
    the learner's status port answers, and holds (no deployments, no
    pins) until then.  Returns the final controller snapshot."""
    from apex_tpu_torch.obs.trace import get_ring, set_process_label

    set_process_label("serve-ctl")
    get_ring()
    # the caller folds any explicit role-identity IPs into cfg.comms
    # (runtime.roles._with_ips) before handing the config over
    ctl = ServeCtl(cfg, canary_frac=canary_frac,
                   soak_s=soak_s, version_every=version_every,
                   interval_s=interval_s)
    print(f"serve-ctl: {ctl.ctrl.n_shards} shard(s), canary band "
          f"{list(ctl.ctrl.canary_shards)} (frac={canary_frac}), "
          f"soak={soak_s:g}s, version_every={version_every}, "
          f"tick={interval_s:g}s", flush=True)
    return ctl.run(stop_event=stop_event, max_seconds=max_seconds)
