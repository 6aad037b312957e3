"""The PBT control plane: task ladders, exploit/explore, lineage record.

Counterpart of :mod:`apex_tpu.population.controller`, a copy with the
port's import paths (stdlib at module level; ``zmq`` and the transport
import inside the socket wrapper).  ``--role pbt-ctl`` is the
population's control loop: a socket-free, fake-clock-testable
:class:`PopulationController` decides, and a one-thread socket wrapper
(:class:`PbtCtl`) feeds it observations and ships the evidence out.

* **Task ladders**: lineages group by env id; scores rank only within a
  ladder.  A single-lineage ladder never exploits: a population of one
  is a plain run.
* **Exploit**: truncation selection per ladder; the bottom-k lineages
  restore the top-k's newest checkpoint.  The copy is applied to the
  live losing learner through its status port's ctl surface
  (:meth:`apex_tpu_torch.training.apex.ConcurrentTrainer.restore_weights`,
  which reads the port's own checkpoint bundle), and bumps that
  lineage's learner epoch, so the pre-copy life's params and replay
  write-backs are fenced out as a restart's would be.
* **Explore**: perturb/resample on the donor's vector (x0.8/x1.2,
  integer fields step by one, ``resample_prob`` draws from the band;
  clamped to :data:`~apex_tpu_torch.population.lineage.HPARAM_BANDS`).
  The draws come from stdlib ``random.Random(seed)``, so one seed gives
  the JAX controller's vectors.  The live half
  (:data:`~apex_tpu_torch.population.lineage.LIVE_HPARAMS`) applies at
  once; the rest at the lineage's next worker generation.

Every decision lands in a bounded timeline, shipped to the host learner
as a :class:`PopulationStat` (the ``population`` section of
``fleet_summary.json``, the status lines and ``apex_population_*`` rows).
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass, field

from apex_tpu_torch.population.lineage import (HPARAM_BANDS, LineageSpec,
                                         load_population)
from apex_tpu_torch.tenancy import namespace

EXPLOIT, EXPLORE, SKIPPED = "EXPLOIT", "EXPLORE", "SKIPPED"

#: integer-valued vector fields: explore steps them by +-1, not a factor
_INT_HPARAMS = ("n_steps",)


@dataclass
class PopulationStat:
    """The controller's state shipped to the host learner on the stat
    channel (wire-allowlisted): ``snapshot`` is
    :meth:`PopulationController.snapshot` — plain builtins only."""

    identity: str
    snapshot: dict = field(default_factory=dict)


@dataclass
class _LineageState:
    spec: LineageSpec
    hparams: dict               # the live vector the controller owns
    generation: int = 0
    parent: str = ""
    alive: bool = False
    score: float | None = None  # eval-ladder recent-window mean
    episodes: int = 0           # eval episodes behind the score
    steps: int | None = None    # lineage learner progress
    checkpoint: str | None = None   # newest donor-able ckpt path
    last_change: float | None = None
    exploits_taken: int = 0     # times this lineage copied a donor
    exploits_donated: int = 0   # times this lineage was the donor


def resolve_vector(spec: LineageSpec) -> dict:
    """The concrete vector explore mutates: spec overrides where set,
    band midpoints otherwise (geometric midpoint for the log-scaled
    lr).  Deterministic — two controllers over one roster agree."""
    out: dict = {}
    for name, (lo, hi) in HPARAM_BANDS.items():
        v = getattr(spec, name)
        if v is None:
            if name == "lr":
                v = (lo * hi) ** 0.5
            elif name in _INT_HPARAMS:
                v = int(round((lo + hi) / 2))
            else:
                v = (lo + hi) / 2
        out[name] = int(v) if name in _INT_HPARAMS else float(v)
    return out


class PopulationController:
    """The decision half of pbt-ctl (module docstring): socket-free,
    every clock injectable, every transition in a bounded timeline —
    the DeployController/PlacementScheduler testing discipline.

    ``decide_every_s`` paces decision rounds; ``frac`` is the
    truncation fraction (bottom-k copies top-k, k >= 1);
    ``min_episodes`` keeps a lineage from being judged off one lucky
    episode; ``min_delta`` is the strict score gap an exploit needs;
    ``cooldown_s`` (default two decision periods) keeps a just-exploited
    lineage from thrashing before its new weights have scored.
    """

    def __init__(self, population: dict[str, LineageSpec], *,
                 decide_every_s: float = 30.0, frac: float = 0.25,
                 resample_prob: float = 0.25, min_episodes: int = 4,
                 min_delta: float = 1e-9, cooldown_s: float | None = None,
                 seed: int = 0, clock=time.monotonic, wall=time.time,
                 timeline_cap: int = 128):
        self.decide_every_s = float(decide_every_s)
        self.frac = float(frac)
        self.resample_prob = float(resample_prob)
        self.min_episodes = int(min_episodes)
        self.min_delta = float(min_delta)
        self.cooldown_s = (2.0 * self.decide_every_s
                           if cooldown_s is None else float(cooldown_s))
        self._rng = random.Random(seed)
        self._clock = clock
        self._wall = wall
        self.lineages: dict[str, _LineageState] = {
            name: _LineageState(spec=spec, hparams=resolve_vector(spec),
                                generation=spec.generation,
                                parent=spec.parent)
            for name, spec in population.items()}
        self.decisions = 0
        self.exploits = 0
        self.explores = 0
        self.timeline: deque = deque(maxlen=timeline_cap)
        self._t0: float | None = None
        self._last_decide: float | None = None

    # -- observations ------------------------------------------------------

    def observe(self, name: str, *, alive: bool,
                score: float | None = None, episodes: int = 0,
                steps: int | None = None,
                checkpoint: str | None = None) -> None:
        """One probe result for a lineage's learner fleet: liveness,
        its eval-ladder score (recent-window mean + episode count off
        the registry gauges), progress, and its newest checkpoint path
        (the donor-able artifact)."""
        ls = self.lineages.get(name)
        if ls is None:
            return
        ls.alive = bool(alive)
        if alive:
            if score is not None:
                ls.score = float(score)
            ls.episodes = int(episodes)
            if steps is not None:
                ls.steps = int(steps)
            if checkpoint:
                ls.checkpoint = str(checkpoint)

    # -- the machine -------------------------------------------------------

    def _event(self, kind: str, lineage: str, reason: str,
               **extra) -> dict:
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        e = {"t_s": round(now - self._t0, 3),
             "wall": round(self._wall(), 3),
             "event": kind, "lineage": lineage, "reason": reason}
        e.update(extra)
        self.timeline.append(e)
        return e

    def ladders(self) -> dict[str, list[str]]:
        """Task ladders: lineage names grouped by env id (an inherited
        env groups under ``""`` — its launcher's env, one ladder)."""
        out: dict[str, list[str]] = {}
        for name, ls in sorted(self.lineages.items()):
            out.setdefault(ls.spec.env_id, []).append(name)
        return out

    def mutate(self, hparams: dict) -> tuple[dict, list[str]]:
        """Perturb/resample explore on one vector: per field, resample
        uniformly from the band with ``resample_prob``, else perturb
        x0.8/x1.2 (integer fields step +-1); everything clamps to the
        band.  Returns ``(mutated, human notes)``."""
        out, notes = {}, []
        for name, (lo, hi) in HPARAM_BANDS.items():
            v = hparams.get(name)
            if v is None:
                continue
            if self._rng.random() < self.resample_prob:
                nv = self._rng.uniform(lo, hi)
                how = "resample"
            elif name in _INT_HPARAMS:
                nv = v + self._rng.choice((-1, 1))
                how = "step"
            else:
                nv = v * self._rng.choice((0.8, 1.2))
                how = "perturb"
            nv = min(max(nv, lo), hi)
            nv = int(round(nv)) if name in _INT_HPARAMS else float(nv)
            if nv != v:
                notes.append(f"{name}: {v:g} -> {nv:g} ({how})")
            out[name] = nv
        return out, notes

    def _eligible(self, name: str, now: float) -> bool:
        ls = self.lineages[name]
        if not ls.alive or ls.score is None:
            return False
        if ls.episodes < self.min_episodes:
            return False
        if ls.last_change is not None \
                and now - ls.last_change < self.cooldown_s:
            return False
        return True

    def _exploit(self, loser: str, donor: str, now: float) -> dict:
        ll, dl = self.lineages[loser], self.lineages[donor]
        mutated, notes = self.mutate(dict(dl.hparams))
        ll.hparams = mutated
        # monotone per exploit AND >= the donor's depth: the count reads
        # as "how many selection events shaped this lineage's weights"
        ll.generation = max(ll.generation, dl.generation) + 1
        ll.parent = donor
        ll.last_change = now
        ll.exploits_taken += 1
        dl.exploits_donated += 1
        self.exploits += 1
        self.explores += 1
        self._event(
            EXPLOIT, loser,
            f"score {ll.score:g} < {donor} {dl.score:g}; restoring "
            f"{dl.checkpoint}",
            donor=donor, generation=ll.generation)
        self._event(EXPLORE, loser,
                    "; ".join(notes) or "vector unchanged (clamped)",
                    donor=donor)
        return {"op": "exploit", "restore_from": dl.checkpoint,
                "hparams": dict(mutated), "donor": donor,
                "generation": ll.generation}

    def tick(self) -> list[tuple[str, dict]]:
        """One decision round (paced to ``decide_every_s``; off-cadence
        calls are free).  Returns the ``(lineage, ctl command)`` sends
        for this round — at most one exploit per losing lineage."""
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        if self._last_decide is not None \
                and now - self._last_decide < self.decide_every_s:
            return []
        self._last_decide = now
        self.decisions += 1
        commands: list[tuple[str, dict]] = []
        for _task, names in sorted(self.ladders().items()):
            ranked = sorted(
                (n for n in names if self._eligible(n, now)),
                key=lambda n: (-self.lineages[n].score, n))
            if len(ranked) < 2:
                continue        # population-of-1 ladder: a plain run
            k = max(1, int(self.frac * len(ranked)))
            k = min(k, len(ranked) // 2)    # top and bottom disjoint
            tops, bottoms = ranked[:k], ranked[-k:]
            for i, loser in enumerate(bottoms):
                donor = tops[i % len(tops)]
                ll, dl = self.lineages[loser], self.lineages[donor]
                if dl.score - ll.score <= self.min_delta:
                    continue    # ladder is flat: nothing to copy
                if not dl.checkpoint:
                    self._event(SKIPPED, loser,
                                f"donor {donor} has no checkpoint yet",
                                donor=donor)
                    continue
                commands.append((loser, self._exploit(loser, donor, now)))
        return commands

    # -- read surface ------------------------------------------------------

    def snapshot(self) -> dict:
        """Serializable controller view (PopulationStat payload, the
        ``population`` section of fleet_summary.json): plain builtins
        only.  tests/test_torch_population.py holds it
        equal to the JAX controller's."""
        lineages = {}
        for name, ls in sorted(self.lineages.items()):
            lineages[name] = {
                "task": ls.spec.env_id,
                "alive": ls.alive,
                "score": ls.score,
                "episodes": ls.episodes,
                "steps": ls.steps,
                "generation": ls.generation,
                "parent": ls.parent,
                "exploits_taken": ls.exploits_taken,
                "exploits_donated": ls.exploits_donated,
                "checkpoint": ls.checkpoint,
                "hparams": dict(ls.hparams),
            }
        return {
            "kind": "apex_population",
            "version": 1,
            "decide_every_s": self.decide_every_s,
            "frac": self.frac,
            "lineages": lineages,
            "decisions": self.decisions,
            "exploits": self.exploits,
            "explores": self.explores,
            "timeline": list(self.timeline),
        }


# -- operator/exposition surfaces --------------------------------------------


def prometheus_sections(population: dict) -> tuple[dict, dict]:
    """(gauges, labeled) — the ``apex_population_*`` row family the
    learner's scrape surface serves next to the slo/tenancy rows."""
    lineages = population.get("lineages") or {}
    gauges = {
        "population_lineages": len(lineages),
        "population_decisions": population.get("decisions", 0),
        "population_exploits": population.get("exploits", 0),
        "population_explores": population.get("explores", 0),
    }
    labeled = {
        "population_lineage_state": [
            ({"lineage": n, "task": v.get("task") or "inherit"},
             1.0 if v.get("alive") else 0.0)
            for n, v in sorted(lineages.items())],
        "population_lineage_generation": [
            ({"lineage": n}, v.get("generation", 0))
            for n, v in sorted(lineages.items())],
        "population_lineage_score": [
            ({"lineage": n}, v.get("score"))
            for n, v in sorted(lineages.items())
            if v.get("score") is not None],
    }
    return gauges, labeled


def format_population_lines(population: dict) -> list[str]:
    """Human population lines for the ``--role status`` table: one line
    per lineage plus the exploit/explore timeline tail."""
    lineages = population.get("lineages") or {}
    lines = [
        f"population: {len(lineages)} lineage(s) "
        f"decisions={population.get('decisions', 0)} "
        f"exploits={population.get('exploits', 0)} "
        f"explores={population.get('explores', 0)}"]
    for n, v in sorted(lineages.items()):
        score = v.get("score")
        lines.append(
            f"lineage {n}: {'ALIVE' if v.get('alive') else 'SILENT'} "
            f"task={v.get('task') or 'inherit'} "
            f"gen={v.get('generation', 0)} "
            f"parent={v.get('parent') or '-'} "
            f"score={'-' if score is None else round(score, 3)} "
            f"eps={v.get('episodes', 0)} "
            f"taken={v.get('exploits_taken', 0)} "
            f"donated={v.get('exploits_donated', 0)}")
    for e in (population.get("timeline") or [])[-4:]:
        lines.append(f"population t={e['t_s']}s {e['event']} "
                     f"{e['lineage']} ({e['reason']})")
    return lines


# -- the socket role ---------------------------------------------------------


class PbtCtl:
    """Socket wrapper around :class:`PopulationController` — the
    ``--role pbt-ctl`` process body (tenant-ctl's one-thread shape).

    Per tick: probe each lineage's OWN learner status port (liveness +
    eval-ladder score off the registry gauges + progress + its newest
    checkpoint path), feed the controller, send any exploit/explore
    commands to the losing lineages' learner ctl surfaces, judge the
    per-lineage roster SLOs, and ship the snapshot to the host learner
    as a :class:`PopulationStat`.
    """

    def __init__(self, cfg, interval_s: float = 5.0,
                 decide_every_s: float = 30.0, frac: float = 0.25,
                 resample_prob: float = 0.25, min_episodes: int = 4,
                 population: dict[str, LineageSpec] | None = None):
        from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
        from apex_tpu_torch.obs.slo import SloEngine, roster_slos
        from apex_tpu_torch.runtime import transport

        self.comms = cfg.comms
        self.interval_s = float(interval_s)
        self.population = (population if population is not None
                           else load_population())
        self.ctrl = PopulationController(
            self.population, decide_every_s=decide_every_s, frac=frac,
            resample_prob=resample_prob, min_episodes=min_episodes,
            seed=cfg.env.seed)
        # per-lineage roster SLOs: progress-floor
        # + eval-score objectives declared from the roster, judged off
        # the controller's own probe stream
        self.slo = (SloEngine(roster_slos(self.population))
                    if self.population else None)
        self._probe_marks: dict[str, tuple[float, int]] = {}
        self._probe_rates: dict[str, float | None] = {}
        self.sender = transport.ChunkSender(cfg.comms, "pbt-ctl")
        self.beat = HeartbeatEmitter(
            "pbt-ctl", role="pbt-ctl",
            interval_s=cfg.comms.heartbeat_interval_s,
            gauges_fn=self._gauges)
        self.ticks = 0
        self.commands_sent = 0

    def _gauges(self) -> dict:
        return {"lineages": sum(ls.alive
                                for ls in self.ctrl.lineages.values())}

    def _probe_lineage(self, spec: LineageSpec) -> None:
        from apex_tpu_torch.fleet.registry import status_request
        from apex_tpu_torch.obs.slo import resolve_signal

        try:
            snap = status_request(
                namespace.tenant_comms(self.comms, spec),
                timeout_s=min(2.0, self.interval_s))
        except Exception:
            snap = None
        if not snap:
            self.ctrl.observe(spec.name, alive=False)
            self._probe_rates[spec.name] = None
            return
        steps = snap.get("steps")
        score = resolve_signal(snap, "gauge:evaluator:eval_score_mean:min")
        episodes = resolve_signal(snap, "gauge:evaluator:eval_episodes:max")
        m = snap.get("metrics") or {}
        self.ctrl.observe(
            spec.name, alive=True, score=score,
            episodes=int(episodes or 0), steps=steps,
            checkpoint=m.get("checkpoint_latest"))
        # probe-derived progress rate for the roster SLOs: steps
        # differenced against the previous probe of THIS lineage
        now = time.monotonic()
        rate = None
        mark = self._probe_marks.get(spec.name)
        if steps is not None:
            if mark is not None and now > mark[0]:
                rate = max(0.0, (int(steps) - mark[1]) / (now - mark[0]))
            self._probe_marks[spec.name] = (now, int(steps))
        self._probe_rates[spec.name] = rate

    def _slo_summary(self) -> dict:
        """The probe-derived signal space the roster objectives walk:
        ``tenants.<lineage>.steps_rate`` / ``.eval_score``."""
        tenants = {}
        for name, ls in self.ctrl.lineages.items():
            tenants[name] = {"steps_rate": self._probe_rates.get(name),
                             "eval_score": ls.score}
        return {"tenants": tenants}

    def _send_command(self, lineage: str, cmd: dict) -> None:
        from apex_tpu_torch.fleet.registry import ctl_request

        spec = self.population[lineage]
        info = ctl_request(namespace.tenant_comms(self.comms, spec), cmd,
                           timeout_s=min(2.0, self.interval_s))
        self.commands_sent += 1
        print(f"pbt-ctl: {cmd['op']} -> {lineage} "
              f"(donor={cmd.get('donor')}, "
              f"{'accepted' if info and info.get('accepted') else 'no ack'})",
              flush=True)

    def step(self) -> None:
        """One control round: probe -> decide -> command -> judge ->
        report (new timeline events print like serve-ctl's do)."""
        for spec in self.population.values():
            self._probe_lineage(spec)
        before = len(self.ctrl.timeline)
        commands = self.ctrl.tick()
        for e in list(self.ctrl.timeline)[before:]:
            print(f"pbt-ctl: {e['event']} {e['lineage']} ({e['reason']})",
                  flush=True)
        for lineage, cmd in commands:
            self._send_command(lineage, cmd)
        if self.slo is not None:
            for tr in self.slo.sample(self._slo_summary()):
                print(f"pbt-ctl: slo {tr['objective']} {tr['from']} -> "
                      f"{tr['to']} (value={tr['value']})", flush=True)
        self.ticks += 1
        snap = self.ctrl.snapshot()
        if self.slo is not None:
            snap["slo"] = self.slo.snapshot()
        self.sender.send_stat(PopulationStat("pbt-ctl", snap))
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
        self.sender.close(drain_s=0.0)


def run_pbt_ctl(cfg, interval_s: float = 5.0, decide_every_s: float = 30.0,
                frac: float = 0.25, resample_prob: float = 0.25,
                min_episodes: int = 4, stop_event=None,
                max_seconds: float | None = None) -> dict:
    """The ``--role pbt-ctl`` entry point.  Skips the startup barrier
    like the other controllers — useful the moment any lineage's status
    port answers.  Returns the final controller snapshot."""
    from apex_tpu_torch.obs.trace import get_ring, set_process_label

    set_process_label("pbt-ctl")
    get_ring()
    ctl = PbtCtl(cfg, interval_s=interval_s, decide_every_s=decide_every_s,
                 frac=frac, resample_prob=resample_prob,
                 min_episodes=min_episodes)
    ladders = {task or "inherit": names
               for task, names in ctl.ctrl.ladders().items()}
    print(f"pbt-ctl: {len(ctl.population)} lineage(s) over "
          f"{len(ladders)} task ladder(s) {ladders}, "
          f"decide={decide_every_s:g}s, frac={frac:g}, "
          f"tick={interval_s:g}s", flush=True)
    return ctl.run(stop_event=stop_event, max_seconds=max_seconds)
