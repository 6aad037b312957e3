"""Fleet SLO engine: declarative objectives judged by burn-rate windows.

Counterpart of :mod:`apex_tpu.obs.slo` (stdlib only): the same
objectives, knobs, alert machine, snapshot and regression differ.

The fleet has raw signals (lineage histograms, heartbeat gauges,
Prometheus exposition); this module is the objective layer that judges
them: a
declarative registry of SLOs (each = one signal path into the
fleet-summary/heartbeat-gauge space + a threshold + an error budget),
evaluated continuously by :class:`SloEngine` on the learner's health
tick with the classic SRE multi-window burn-rate scheme, and surfaced as
flap-damped alert state machines in ``fleet_summary.json``, the
``--role status`` table, and ``apex_slo_*`` Prometheus rows.

Burn-rate semantics (Google SRE workbook, scaled to our tick):

* every health tick the engine resolves each objective's signal and
  records one GOOD/BAD verdict against the threshold;
* burn rate over a window = (bad fraction over the window) / budget —
  1.0 means the error budget is being spent exactly at the sustainable
  rate, 14.4 means a 30-day budget would be gone in 2 days;
* PAGE-grade firing needs BOTH fast windows (default 1m/5m) above
  ``page_burn`` — the short window gives speed, the long one keeps a
  single bad tick from paging;
* WARN-grade firing needs both slow windows (default 30m/6h) above
  ``warn_burn`` — slow leaks that never trip the page pair.

Windows are SCALED TO RUN LENGTH for free: verdicts only exist after
engine start, so a 6h window over a 3-minute run is simply "the whole
run" (``min_samples`` keeps one lonely verdict from judging anything).
The engine takes injectable clocks, so every transition below is
deterministic under the fake-clock tests.

Alert machine, flap-damped (per objective)::

    OK --page burn--> BURNING --sustained breach_after_s--> BREACHED
    BURNING --burn clears--> OK            (transient spike: no page)
    BREACHED --quiet resolve_after_s--> RESOLVED --quiet ok_after_s--> OK
    RESOLVED --page burn--> BREACHED       (re-breach, counted)

BREACHED is the page: entering it needs SUSTAINED burn, leaving it needs
SUSTAINED quiet — a flapping signal parks in BURNING/BREACHED instead of
strobing alerts.  Severity maps OK/RESOLVED -> 0, BURNING/warn -> 1,
BREACHED -> 2; :func:`apex_tpu_torch.fleet.supervise.scale_decision_slo` sizes
the fleet from exactly that number (``--scale-signal slo``).

The module doubles as the perf-regression gate the bench trajectory has
owed::

    python -m apex_tpu_torch.obs.slo --check BASE.json CAND.json [--tol 0.15]

compares two bench/soak JSONs lane-by-lane (numeric leaves under common
dotted paths, direction classified from the leaf name: percentiles/ages/
lags are lower-better, rates/throughputs higher-better) and exits
nonzero on a regression beyond the tolerance band.

Pure stdlib: the engine runs on the learner's health tick (host clocks
and dict walks only, never a device wait) and the CLI runs on a
stock interpreter.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

OK, BURNING, BREACHED, RESOLVED = "OK", "BURNING", "BREACHED", "RESOLVED"

#: state -> severity (the autoscaler's input; warn-grade firing lifts an
#: otherwise-OK objective to 1)
SEVERITY = {OK: 0, RESOLVED: 0, BURNING: 1, BREACHED: 2}


# -- objectives --------------------------------------------------------------


@dataclass(frozen=True)
class SloObjective:
    """One declarative objective.

    ``signal`` addresses the fleet-summary signal space:

    * ``"metrics.dead_actor_frac"`` — dotted walk into the summary dict
      (``metrics`` / ``latency`` / ``rates`` sections);
    * ``"gauge:<role>:<key>:<agg>"`` — aggregate one heartbeat-gauge key
      over the non-DEAD peers of a role (agg: max/min/sum/mean);
    * ``"derived.dead_frac.<role|all>"`` — DEAD fraction of a role's
      peers (None while no such peer ever registered);
    * ``"derived.role_fps.<role>"`` — summed fps of a role's live peers.

    ``threshold`` is the objective's bound under ``op`` ("<=" or ">=");
    ``None`` makes the objective OBSERVE-ONLY (value tracked and
    exported, never judged — how the eval-score objective ships until an
    operator sets a bar).  ``budget`` is the allowed bad-verdict
    fraction (the error budget burn rates divide by).  ``grace_s``
    suppresses verdicts that soon after engine start (rates are honestly
    zero during warmup — alerting on them would page every cold start).

    ``knobs`` optionally overrides the
    engine-global burn windows/damping for THIS objective — a
    :class:`SloKnobOverrides` whose non-None fields win over the engine
    knobs.  The serving tier's canary gate is the motivating consumer:
    it wants a much tighter window on ``eval_score`` than on
    ``frame_age``.  Env twins: ``APEX_SLO_<NAME>_{FAST,SLOW,PAGE_BURN,
    WARN_BURN,BREACH_AFTER,RESOLVE_AFTER,OK_AFTER,MIN_SAMPLES}`` (name
    uppercased), parsed by :func:`objective_knobs_from_env`.
    """

    name: str
    signal: str
    threshold: float | None
    op: str = "<="
    budget: float = 0.01
    grace_s: float = 0.0
    description: str = ""
    knobs: "SloKnobOverrides | None" = None

    def judge(self, value) -> bool | None:
        """GOOD (True) / BAD (False) / no verdict (None: observe-only
        objective or unresolvable signal)."""
        if self.threshold is None or value is None:
            return None
        if self.op == "<=":
            return float(value) <= self.threshold
        return float(value) >= self.threshold


def _thr(environ, name: str, default: float | None) -> float | None:
    """Per-objective threshold env twin: unset/empty keeps the shipped
    default, ``off``/``none`` disables (observe-only), else a float."""
    v = environ.get(name, "")
    if not v:
        return default
    if v.lower() in ("off", "none"):
        return None
    return float(v)


def default_slos(actor_dead_thresh: float | None = None,
                 environ=None) -> list[SloObjective]:
    """The shipped objective set (every threshold has an env twin,
    ``APEX_SLO_<NAME>``; ``off`` disables an objective).

    ``actor_dead_thresh`` lets the trainer hand its
    ``comms.relax_floor_dead_frac`` in, so the actor-capacity SLO and
    the replay-ratio-floor reaction judge the SAME bar by construction —
    the two can disagree on timing (the SLO is flap-damped), never on
    the threshold.

    Every objective also reads its per-objective knob env twins
    (:func:`objective_knobs_from_env`) — unset twins leave the
    engine-global knobs in charge.
    """
    e = environ if environ is not None else os.environ

    def _obj(name, signal, threshold, op="<=", **kw):
        return SloObjective(name, signal, threshold, op,
                            knobs=objective_knobs_from_env(name, e), **kw)

    return [
        _obj(
            "infer_rt_p99_ms", "gauge:actor:infer_rt_ms_p99:max",
            _thr(e, "APEX_SLO_INFER_RT_MS", 250.0), "<=",
            description="worst actor-reported infer round-trip p99 "
                        "(timed-out requests counted at the fallback "
                        "wait — the ROADMAP serving-tier SLO)"),
        _obj(
            "frame_age_p99_s", "latency.frame_age_at_train_s.p99_s",
            _thr(e, "APEX_SLO_FRAME_AGE_S", 120.0), "<=",
            description="sealed-to-train frame age p99 (lineage "
                        "histogram)"),
        _obj(
            "param_lag_p99_s", "latency.param_propagation_lag_s.p99_s",
            _thr(e, "APEX_SLO_PARAM_LAG_S", 60.0), "<=",
            description="publish-to-trained-experience staleness loop "
                        "p99"),
        _obj(
            "learner_steps_rate", "rates.steps_per_s",
            _thr(e, "APEX_SLO_STEPS_RATE", 0.01), ">=", grace_s=90.0,
            description="learner update rate floor (a stalled learner "
                        "is an outage, not a quiet one)"),
        _obj(
            "fleet_frames_rate", "rates.frames_per_s",
            _thr(e, "APEX_SLO_FRAMES_RATE", 0.1), ">=", grace_s=90.0,
            description="fleet-wide ingested-transition rate floor"),
        _obj(
            "actor_fps", "derived.role_fps.actor",
            _thr(e, "APEX_SLO_ACTOR_FPS", None), ">=", grace_s=90.0,
            description="summed live-actor env fps (observe-only until "
                        "an operator sets the bar for the deployment)"),
        _obj(
            "dead_peer_frac", "derived.dead_frac.all",
            _thr(e, "APEX_SLO_DEAD_FRAC", 0.5), "<=",
            description="DEAD fraction of the whole registered fleet"),
        _obj(
            "actor_dead_frac", "metrics.dead_actor_frac",
            (actor_dead_thresh if actor_dead_thresh is not None
             else _thr(e, "APEX_SLO_ACTOR_DEAD_FRAC", 0.5)), "<=",
            description="DEAD fraction of actor capacity — shares its "
                        "threshold with the replay-ratio-floor "
                        "reaction (relax_floor_dead_frac)"),
        _obj(
            "infer_up", "derived.dead_frac.infer",
            _thr(e, "APEX_SLO_INFER_DEAD", 0.0), "<=",
            description="any DEAD infer server breaches (the serving "
                        "tier has no spare by default)"),
        _obj(
            "eval_score", "gauge:evaluator:eval_score_mean:min",
            _thr(e, "APEX_SLO_EVAL_SCORE", None), ">=",
            description="worst evaluator-band mean episode score — the "
                        "model-quality objective the serving tier's "
                        "canary gate keys off (observe-only until an "
                        "operator sets the bar)"),
        _obj(
            "serving_rollbacks", "serving.rollbacks",
            _thr(e, "APEX_SLO_SERVING_ROLLBACKS", None), "<=",
            description="cumulative serving-tier canary rollbacks "
                        "(serving/deploy.py) — observe-only by "
                        "default; set 0 to page on ANY rollback"),
    ]


def roster_slos(roster: dict, environ=None) -> list[SloObjective]:
    """Per-tenant objective SETS declared from the ``APEX_TENANTS`` /
    ``APEX_POPULATION`` roster: for every roster
    tenant/lineage, a progress-floor objective and an eval-score
    objective — judged by the CONTROLLER (tenant-ctl/pbt-ctl) off its
    per-tenant status probes, instead of only the default tenant's
    engine judging its own fleet.

    Signals walk the controller's probe-derived summary
    (``{"tenants": {<name>: {"steps_rate": ..., "eval_score": ...}}}``)
    via the ordinary dotted resolution, so the same
    :class:`SloEngine` machinery — burn windows, flap damping,
    timelines — judges them unchanged.  Objective names carry the
    ``@tenant`` suffix grammar (``steps_floor@rally``) so operators
    read them next to the existing per-tenant signal paths.

    Env twins: ``APEX_SLO_TENANT_STEPS_RATE`` (default 0.01; ``off``
    disables) and ``APEX_SLO_TENANT_EVAL_SCORE`` (default observe-only)
    set the bars for EVERY roster tenant at once.
    """
    e = environ if environ is not None else os.environ
    steps_thr = _thr(e, "APEX_SLO_TENANT_STEPS_RATE", 0.01)
    score_thr = _thr(e, "APEX_SLO_TENANT_EVAL_SCORE", None)
    out: list[SloObjective] = []
    for name in sorted(roster):
        out.append(SloObjective(
            f"steps_floor@{name}", f"tenants.{name}.steps_rate",
            steps_thr, ">=", grace_s=90.0,
            description=f"tenant {name}: learner progress floor off the "
                        f"controller's status probes (a stalled lineage "
                        f"is an outage, not a quiet one)"))
        out.append(SloObjective(
            f"eval_score@{name}", f"tenants.{name}.eval_score",
            score_thr, ">=",
            description=f"tenant {name}: eval-ladder recent-window mean "
                        f"(observe-only until an operator sets the "
                        f"bar)"))
    return out


# -- signal resolution -------------------------------------------------------


def _tenant_split(path: str) -> tuple[str, str | None]:
    """Peel an optional ``@tenant`` suffix off a peer-walking signal
    path: ``derived.dead_frac.actor@rally`` judges ONLY the
    rally tenant's actors — the per-tenant SLO dimension on a shared
    fleet's registry.  No suffix = all tenants, the single-tenant
    semantics."""
    if "@" in path:
        head, tenant = path.rsplit("@", 1)
        return head, tenant
    return path, None


def _tenant_match(peer: dict, tenant: str | None) -> bool:
    if tenant is None:
        return True
    return (peer.get("tenant") or "t0") == tenant


def resolve_signal(summary: dict, path: str):
    """Resolve one signal path against a fleet-summary-shaped dict;
    ``None`` for anything missing/non-numeric (a missing signal is a
    skipped verdict, never a crash — observability must not take the
    learner down).  Peer-walking paths (``gauge:``/``derived.``) accept
    an ``@tenant`` suffix restricting the walk to one tenant's peers."""
    try:
        path, tenant = _tenant_split(path)
        if path.startswith("gauge:"):
            _, role, gauge, agg = path.split(":")
            vals = []
            for p in summary.get("peers") or []:
                if p.get("role") != role or p.get("state") == "DEAD" \
                        or not _tenant_match(p, tenant):
                    continue
                v = (p.get("gauges") or {}).get(gauge)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    vals.append(float(v))
            if not vals:
                return None
            if agg == "max":
                return max(vals)
            if agg == "min":
                return min(vals)
            if agg == "sum":
                return sum(vals)
            return sum(vals) / len(vals)            # mean
        if path.startswith("derived.dead_frac."):
            role = path.rsplit(".", 1)[-1]
            peers = [p for p in summary.get("peers") or []
                     if (role == "all" or p.get("role") == role)
                     and _tenant_match(p, tenant)]
            if not peers:
                return None
            return sum(p.get("state") == "DEAD" for p in peers) / len(peers)
        if path.startswith("derived.role_fps."):
            role = path.rsplit(".", 1)[-1]
            peers = [p for p in summary.get("peers") or []
                     if p.get("role") == role
                     and _tenant_match(p, tenant)]
            if not peers:
                return None
            return sum(float(p.get("fps", 0.0)) for p in peers
                       if p.get("state") != "DEAD")
        node = summary
        for part in path.split("."):
            if not isinstance(node, dict):
                return None
            node = node.get(part)
        if isinstance(node, bool) or not isinstance(node, (int, float)):
            return None
        return float(node)
    except (TypeError, ValueError, KeyError):
        return None


# -- burn-rate knobs ---------------------------------------------------------


@dataclass(frozen=True)
class SloKnobs:
    """Window/damping parameters; every field has an ``APEX_SLO_*`` env
    twin so a CI drill can compress the whole alert cycle into a
    3-minute soak without touching the production defaults."""

    fast: tuple = (60.0, 300.0)         # page-grade window pair, s
    slow: tuple = (1800.0, 21600.0)     # warn-grade window pair, s
    page_burn: float = 14.4             # SRE 30d-budget "2% in 1h" rate
    warn_burn: float = 3.0
    breach_after_s: float = 10.0        # sustained burn before the page
    resolve_after_s: float = 30.0       # sustained quiet before resolve
    ok_after_s: float = 60.0            # resolved -> ok cooldown
    min_samples: int = 2                # verdicts before a window judges


def knobs_from_env(environ=None) -> SloKnobs:
    e = environ if environ is not None else os.environ

    def pair(name: str, default: tuple) -> tuple:
        v = e.get(name, "")
        if not v:
            return default
        parts = tuple(float(x) for x in v.split(","))
        return parts if len(parts) == 2 else (parts[0], parts[0])

    def num(name: str, default: float) -> float:
        v = e.get(name, "")
        return default if not v else float(v)

    return SloKnobs(
        fast=pair("APEX_SLO_FAST", SloKnobs.fast),
        slow=pair("APEX_SLO_SLOW", SloKnobs.slow),
        page_burn=num("APEX_SLO_PAGE_BURN", SloKnobs.page_burn),
        warn_burn=num("APEX_SLO_WARN_BURN", SloKnobs.warn_burn),
        breach_after_s=num("APEX_SLO_BREACH_AFTER",
                           SloKnobs.breach_after_s),
        resolve_after_s=num("APEX_SLO_RESOLVE_AFTER",
                            SloKnobs.resolve_after_s),
        ok_after_s=num("APEX_SLO_OK_AFTER", SloKnobs.ok_after_s),
        min_samples=int(num("APEX_SLO_MIN_SAMPLES",
                            SloKnobs.min_samples)))


@dataclass(frozen=True)
class SloKnobOverrides:
    """Per-objective window/damping overrides: non-None fields win over
    the engine-global :class:`SloKnobs`, everything else inherits — so
    "tighter eval_score windows for the canary gate" is one field, not a
    whole parallel knob set."""

    fast: tuple | None = None
    slow: tuple | None = None
    page_burn: float | None = None
    warn_burn: float | None = None
    breach_after_s: float | None = None
    resolve_after_s: float | None = None
    ok_after_s: float | None = None
    min_samples: int | None = None


def objective_knobs_from_env(name: str,
                             environ=None) -> SloKnobOverrides | None:
    """Parse ``APEX_SLO_<NAME>_*`` twins (name uppercased) into an
    overrides record; None when no twin is set (the engine-global knobs
    stay in charge — the common case)."""
    e = environ if environ is not None else os.environ
    prefix = f"APEX_SLO_{name.upper()}_"

    def pair(suffix):
        v = e.get(prefix + suffix, "")
        if not v:
            return None
        parts = tuple(float(x) for x in v.split(","))
        return parts if len(parts) == 2 else (parts[0], parts[0])

    def num(suffix):
        v = e.get(prefix + suffix, "")
        return None if not v else float(v)

    ms = num("MIN_SAMPLES")
    over = SloKnobOverrides(
        fast=pair("FAST"), slow=pair("SLOW"),
        page_burn=num("PAGE_BURN"), warn_burn=num("WARN_BURN"),
        breach_after_s=num("BREACH_AFTER"),
        resolve_after_s=num("RESOLVE_AFTER"),
        ok_after_s=num("OK_AFTER"),
        min_samples=None if ms is None else int(ms))
    if all(getattr(over, f.name) is None
           for f in over.__dataclass_fields__.values()):
        return None
    return over


def resolve_knobs(base: SloKnobs, objective: SloObjective) -> SloKnobs:
    """The knobs one objective is judged under: the engine-global base
    with the objective's non-None overrides applied."""
    over = objective.knobs
    if over is None:
        return base
    import dataclasses as _dc
    fields = {f.name: getattr(over, f.name)
              for f in over.__dataclass_fields__.values()
              if getattr(over, f.name) is not None}
    return _dc.replace(base, **fields) if fields else base


# -- the alert state machine -------------------------------------------------


class _Alert:
    """One objective's flap-damped machine (module docstring diagram)."""

    __slots__ = ("state", "burning_since", "clear_since", "resolved_at",
                 "breaches", "warn")

    def __init__(self):
        self.state = OK
        self.burning_since: float | None = None
        self.clear_since: float | None = None
        self.resolved_at: float | None = None
        self.breaches = 0
        self.warn = False

    def step(self, page: bool, warn: bool, now: float,
             k: SloKnobs) -> tuple[str, str] | None:
        self.warn = bool(warn)
        old = self.state
        if self.state == OK:
            if page:
                self.state = BURNING
                self.burning_since = now
        elif self.state == BURNING:
            if not page:
                self.state = OK                 # transient: damped, no page
            elif now - self.burning_since >= k.breach_after_s:
                self.state = BREACHED
                self.breaches += 1
                self.clear_since = None
        elif self.state == BREACHED:
            if page:
                self.clear_since = None         # still burning: hold
            elif self.clear_since is None:
                self.clear_since = now
            elif now - self.clear_since >= k.resolve_after_s:
                self.state = RESOLVED
                self.resolved_at = now
        elif self.state == RESOLVED:
            if page:                            # re-breach: counted
                self.state = BREACHED
                self.breaches += 1
                self.clear_since = None
            elif now - self.resolved_at >= k.ok_after_s:
                self.state = OK
        return (old, self.state) if self.state != old else None


# -- the engine --------------------------------------------------------------


class SloEngine:
    """Continuous objective evaluation over health-tick samples.

    Thread contract: :meth:`sample` runs on the trainer thread (once per
    health tick — NOT per status scrape, or burn windows would depend on
    scrape traffic); :meth:`snapshot`/:meth:`state_of`/:meth:`severity`
    take the same lock and are safe from the status-server thread.
    """

    def __init__(self, objectives: list[SloObjective] | None = None,
                 knobs: SloKnobs | None = None, clock=time.monotonic,
                 wall=time.time, timeline_cap: int = 128):
        self.objectives = list(objectives if objectives is not None
                               else default_slos())
        self.knobs = knobs if knobs is not None else knobs_from_env()
        # per-objective knobs resolved once: engine-global base + the
        # objective's non-None overrides (SloObjective.knobs)
        self._knobs_by: dict[str, SloKnobs] = {
            o.name: resolve_knobs(self.knobs, o) for o in self.objectives}
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._t0: float | None = None
        self._verdicts: dict[str, deque] = {
            o.name: deque(maxlen=8192) for o in self.objectives}
        self._alerts: dict[str, _Alert] = {
            o.name: _Alert() for o in self.objectives}
        self._value: dict[str, float | None] = {}
        self._good: dict[str, int] = {o.name: 0 for o in self.objectives}
        self._total: dict[str, int] = {o.name: 0 for o in self.objectives}
        self.timeline: deque = deque(maxlen=timeline_cap)
        self.ticks = 0

    # -- the clock-driven half --------------------------------------------

    def _burn(self, name: str, now: float, window: float, budget: float,
              min_samples: int | None = None) -> float | None:
        """Burn rate over the trailing window (run-length-scaled for
        free: verdicts only exist after start), or None below
        ``min_samples``."""
        if min_samples is None:
            min_samples = self._knobs_by[name].min_samples
        cut = now - window
        sel = [bad for (t, bad) in self._verdicts[name] if t >= cut]
        if len(sel) < min_samples:
            return None
        return (sum(sel) / len(sel)) / max(budget, 1e-9)

    def _firing(self, o: SloObjective, now: float) -> tuple[bool, bool]:
        k = self._knobs_by[o.name]      # per-objective windows/damping
        fast = [self._burn(o.name, now, w, o.budget, k.min_samples)
                for w in k.fast]
        slow = [self._burn(o.name, now, w, o.budget, k.min_samples)
                for w in k.slow]
        page = all(b is not None and b >= k.page_burn for b in fast)
        warn = all(b is not None and b >= k.warn_burn for b in slow)
        return page, warn

    def sample(self, summary: dict) -> list[dict]:
        """One health-tick evaluation round; returns the transitions
        taken (also appended to the bounded alert timeline)."""
        now = self._clock()
        out: list[dict] = []
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            for o in self.objectives:
                v = resolve_signal(summary, o.signal)
                self._value[o.name] = v
                verdict = o.judge(v)
                if verdict is not None and now - self._t0 >= o.grace_s:
                    self._verdicts[o.name].append(
                        (now, 0 if verdict else 1))
                    self._good[o.name] += int(verdict)
                    self._total[o.name] += 1
                page, warn = self._firing(o, now)
                tr = self._alerts[o.name].step(page, warn, now,
                                               self._knobs_by[o.name])
                if tr is not None:
                    event = {"t_s": round(now - self._t0, 3),
                             "wall": round(self._wall(), 3),
                             "objective": o.name,
                             "from": tr[0], "to": tr[1],
                             "value": v}
                    self.timeline.append(event)
                    out.append(event)
            self.ticks += 1
        return out

    # -- read surface ------------------------------------------------------

    def state_of(self, name: str) -> str | None:
        with self._lock:
            a = self._alerts.get(name)
            return None if a is None else a.state

    def severity(self) -> int:
        with self._lock:
            return self._severity_locked()

    def _severity_locked(self) -> int:
        sev = 0
        for a in self._alerts.values():
            sev = max(sev, SEVERITY[a.state], 1 if a.warn else 0)
        return sev

    def _idle_locked(self, now: float) -> bool:
        """True when no enabled objective has burned ANY budget over the
        slow-long window (and none is alerting) — the scale-down hint:
        capacity is comfortably above objective."""
        judged = 0
        for o in self.objectives:
            k = self._knobs_by[o.name]
            cut = now - k.slow[-1]
            a = self._alerts[o.name]
            if a.state != OK or a.warn:
                return False
            sel = [bad for (t, bad) in self._verdicts[o.name] if t >= cut]
            if len(sel) >= k.min_samples:
                judged += 1
                if any(sel):
                    return False
        return judged > 0

    def compliance(self) -> dict:
        """Lifetime GOOD percentage per judged objective (the soak
        artifact's headline number)."""
        with self._lock:
            return {name: round(100.0 * self._good[name] / total, 2)
                    for name, total in self._total.items() if total}

    def snapshot(self) -> dict:
        """Serializable engine view (fleet_summary.json ``slo`` section,
        status table, soak artifact): plain builtins only."""
        now = self._clock()
        with self._lock:
            objectives = []
            for o in self.objectives:
                a = self._alerts[o.name]
                k = self._knobs_by[o.name]
                bf = self._burn(o.name, now, k.fast[-1], o.budget)
                bs = self._burn(o.name, now, k.slow[-1], o.budget)
                total = self._total[o.name]
                objectives.append({
                    "name": o.name, "signal": o.signal, "op": o.op,
                    "threshold": o.threshold,
                    "enabled": o.threshold is not None,
                    "value": self._value.get(o.name),
                    "state": a.state, "warn": a.warn,
                    "breaches": a.breaches,
                    "burn_fast": None if bf is None else round(bf, 3),
                    "burn_slow": None if bs is None else round(bs, 3),
                    "verdicts": total,
                    "compliance_pct": (round(100.0 * self._good[o.name]
                                             / total, 2) if total
                                       else None),
                })
            return {
                "objectives": objectives,
                "severity": self._severity_locked(),
                "idle": self._idle_locked(now),
                "ticks": self.ticks,
                "elapsed_s": (round(now - self._t0, 3)
                              if self._t0 is not None else 0.0),
                "timeline": list(self.timeline),
            }


# -- prometheus rows ---------------------------------------------------------


def prometheus_sections(slo_snap: dict) -> tuple[dict, dict]:
    """(gauges, labeled) sections for :func:`apex_tpu_torch.obs.metrics.render`
    — the ``apex_slo_*`` row family the scrape surface serves."""
    gauges = {"slo_severity": slo_snap.get("severity", 0),
              "slo_ticks": slo_snap.get("ticks", 0)}
    objectives = slo_snap.get("objectives", [])
    labeled = {
        "slo_state": [({"objective": o["name"], "state": o["state"]},
                       SEVERITY.get(o["state"], 0)) for o in objectives],
        "slo_value": [({"objective": o["name"]}, o["value"])
                      for o in objectives if o.get("value") is not None],
        "slo_burn_fast": [({"objective": o["name"]}, o["burn_fast"])
                          for o in objectives
                          if o.get("burn_fast") is not None],
        "slo_breaches": [({"objective": o["name"]}, o.get("breaches", 0))
                         for o in objectives],
        "slo_compliance_pct": [({"objective": o["name"]},
                                o["compliance_pct"]) for o in objectives
                               if o.get("compliance_pct") is not None],
    }
    return gauges, labeled


def format_slo_lines(slo_snap: dict) -> list[str]:
    """Human objective lines for the ``--role status`` table."""
    lines = []
    for o in slo_snap.get("objectives", []):
        if not o.get("enabled") and o.get("value") is None:
            continue
        v = o.get("value")
        bf = o.get("burn_fast")
        bar = ("observe-only" if o.get("threshold") is None
               else f"{o['op']}{o['threshold']}")
        lines.append(
            f"slo {o['name']}: {o['state']}"
            f"{' (warn)' if o.get('warn') else ''} "
            f"value={'-' if v is None else round(v, 3)} {bar}"
            f" burn={'-' if bf is None else bf}"
            f" breaches={o.get('breaches', 0)}")
    if lines:
        lines.append(
            f"slo severity={slo_snap.get('severity', 0)} "
            f"idle={slo_snap.get('idle', False)} "
            f"ticks={slo_snap.get('ticks', 0)}")
    return lines


# -- the regression differ (--check) ----------------------------------------

#: leaf-name tokens classifying comparison direction.  Lower-better wins
#: ties on purpose: "frame_age_p99_s" contains both "age" and "_s"-ish
#: rate lookalikes, and a latency leaf misclassified as a throughput
#: would invert the gate.
_LOWER_TOKENS = ("p50", "p90", "p99", "mean_s", "max_s", "_ms", "lag",
                 "age", "gap", "wait", "coalesce", "fallback", "drop",
                 "dead", "breach", "stale", "resend", "reroute",
                 # wire-codec lanes (bench part-1g): bytes shipped per
                 # transition/chunk — an improved (smaller) byte count
                 # must never read as a regression
                 "bytes")
_HIGHER_TOKENS = ("per_sec", "per_s", "rate", "throughput", "frames",
                  "steps", "chunks", "compliance", "effective_cores",
                  "score", "bps", "fps",
                  # compression ratios (raw/encoded): bigger is better;
                  # lower tokens win ties, so "bytes_ratio"-style leaves
                  # would classify lower-better — part-1g names its
                  # ratio lanes "*_ratio" with no byte token on purpose
                  "_ratio")


def _direction(path: str) -> int:
    """+1 higher-better, -1 lower-better, 0 informational (skipped)."""
    leaf = path.rsplit(".", 1)[-1].lower()
    for t in _LOWER_TOKENS:
        if t in leaf:
            return -1
    for t in _HIGHER_TOKENS:
        if t in leaf:
            return 1
    return 0


def _flatten(obj, prefix: str = "") -> dict[str, float]:
    """Numeric leaves by dotted path.  Lists are skipped on purpose —
    positional entries (soak sample arrays, shard-size vectors) are not
    comparable lane-for-lane across runs; the gate compares named
    lanes."""
    out: dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            out.update(_flatten(v, key))
    elif isinstance(obj, bool):
        pass
    elif isinstance(obj, (int, float)):
        out[prefix] = float(obj)
    return out


def check_regression(base: dict, cand: dict,
                     tol: float = 0.15) -> list[dict]:
    """Lane-by-lane comparison of two bench/soak JSONs.  Returns one row
    per compared leaf with a verdict: ``REGRESSED`` when the candidate
    is worse than base by more than ``tol`` (relative), ``improved``
    when better by the same margin, ``ok`` inside the band.  Leaves
    present in only one file are ignored (new lanes are not
    regressions); near-zero pairs are skipped (relative change on noise
    floors gates nothing)."""
    fa, fb = _flatten(base), _flatten(cand)
    rows: list[dict] = []
    for path in sorted(set(fa) & set(fb)):
        d = _direction(path)
        if d == 0:
            continue
        a, b = fa[path], fb[path]
        if max(abs(a), abs(b)) < 1e-9 or a == 0:
            continue
        change = (b - a) / abs(a)
        if d < 0:
            verdict = ("REGRESSED" if change > tol
                       else "improved" if change < -tol else "ok")
        else:
            verdict = ("REGRESSED" if change < -tol
                       else "improved" if change > tol else "ok")
        rows.append({"path": path, "base": a, "cand": b,
                     "change_pct": round(100.0 * change, 1),
                     "direction": "lower" if d < 0 else "higher",
                     "verdict": verdict})
    return rows


# -- CLI ---------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.obs.slo",
        description="fleet SLO objective table / bench-vs-bench "
                    "regression gate")
    p.add_argument("--check", nargs=2, metavar=("BASE", "CAND"),
                   help="compare two bench/soak JSONs lane-by-lane; "
                        "exit 1 on any regression beyond --tol")
    p.add_argument("--tol", type=float, default=0.15,
                   help="relative tolerance band (default 0.15)")
    p.add_argument("--json", action="store_true",
                   help="--check: machine-readable row dump")
    args = p.parse_args(argv)
    if args.check:
        with open(args.check[0], "r", encoding="utf-8") as fh:
            base = json.load(fh)
        with open(args.check[1], "r", encoding="utf-8") as fh:
            cand = json.load(fh)
        rows = check_regression(base, cand, tol=args.tol)
        regressed = [r for r in rows if r["verdict"] == "REGRESSED"]
        if args.json:
            print(json.dumps({"rows": rows,
                              "regressed": len(regressed),
                              "compared": len(rows),
                              "tol": args.tol}))
        else:
            for r in rows:
                if r["verdict"] == "ok":
                    continue
                print(f"{r['verdict']:9s} {r['path']}  "
                      f"{r['base']:.6g} -> {r['cand']:.6g}  "
                      f"({r['change_pct']:+.1f}%, "
                      f"{r['direction']}-better)")
            print(f"compared {len(rows)} lanes, "
                  f"{len(regressed)} regressed (tol {args.tol:.0%})")
        return 1 if regressed else 0
    # no --check: print the shipped objective table (docs aid)
    k = knobs_from_env()
    print(f"burn windows: fast={k.fast} slow={k.slow} "
          f"page_burn={k.page_burn} warn_burn={k.warn_burn}")
    for o in default_slos():
        bar = ("observe-only" if o.threshold is None
               else f"{o.op} {o.threshold}")
        print(f"{o.name:20s} {o.signal:45s} {bar}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
