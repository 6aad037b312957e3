"""Host supervisor: rate-limited, respawn-budgeted role relauncher.

Replaces the bare ``while true; do python -m apex_tpu_torch.runtime ...; sleep 5``
loops the deploy bootstraps used to inline (``deploy/actor.sh``,
``deploy/evaluator.sh``) with the SAME semantics the in-host pool applies
to its workers (``apex_tpu_torch.actors.pool.ActorPool``): respawns are a RATE,
not a lifetime cap — ``--max-respawns`` per ``--window`` seconds anchored
at the last respawn, so sporadic crashes over a long run never retire a
healthy role, while a crash loop (child dying under ``--min-uptime``)
backs off exponentially and eventually halts loudly.

The child's rejoin path is the role's own (:mod:`apex_tpu_torch.fleet.park` +
the ``barrier_wait`` rejoin race), so a respawned process reattaches to a
running learner in seconds.  ``APEX_RESPAWN_COUNT`` is exported to each
life so the chaos harness (:mod:`apex_tpu_torch.fleet.chaos`) can arm
deterministic kills on the first life only.

Pure stdlib — the supervisor must come up on a stock interpreter before
the baked env, JAX, or zmq are importable.  (The OPTIONAL elastic mode
below lazily imports the zmq status client only when ``--scale-max`` is
given.)

Elastic mode (registry reactions): ``--scale-max N`` turns the
supervisor into a fleet-sized one — it keeps between ``--scale-min`` and
``--scale-max`` copies of the role command alive (the ``{slot}``
placeholder in the command becomes each child's slot index, i.e. its
actor id), and every ``--scale-interval`` seconds probes the learner's
status port for a scaling signal.  Two signals (``--scale-signal``):

* ``drain`` (default): the aggregate actor drain-bound fraction
  (the actors' ``ActorTimingStat``, surfaced in the trainer's fleet
  summary).  A drain-BOUND fleet is backpressured by the learner — more
  actors buy nothing, scale down; a fleet that barely drains means the
  learner is starving for data — scale up.
* ``slo``: the fleet SLO engine's alert snapshot
  (:mod:`apex_tpu_torch.obs.slo`, the ROADMAP serving-tier item verbatim): a
  page-grade BREACH means the tier is out of objective — add capacity;
  a fleet whose every judged objective has burned ZERO error budget
  over the slow window ("idle") can retire a replica; everything
  between (BURNING, warn, RESOLVED cooldown) holds.  The round-trip
  p99 objective makes this exactly "autoscale the infer tier on its
  latency SLO".

One step per tick, clamped, either signal.

Usage::

    python -m apex_tpu_torch.fleet.supervise [--max-respawns N] [--window S]
        [--min-uptime S] [--backoff S] [--backoff-max S] -- CMD [ARG...]
    python -m apex_tpu_torch.fleet.supervise --scale-min 1 --scale-max 8 \
        [--scale-signal drain|slo] [--scale-interval S] \
        [--learner-ip IP] [--status-port P] \
        -- CMD --actor-id {slot} [ARG...]
"""

from __future__ import annotations

import argparse
import random
import subprocess
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.fleet.supervise",
        description="rate-limited role supervisor (ActorPool respawn "
                    "semantics for whole processes)")
    p.add_argument("--max-respawns", type=int, default=10,
                   help="respawn budget per window (default 10)")
    p.add_argument("--window", type=float, default=600.0,
                   help="budget window seconds, anchored at the last "
                        "respawn (default 600)")
    p.add_argument("--min-uptime", type=float, default=60.0,
                   help="a life shorter than this counts against the "
                        "budget and doubles the backoff (default 60)")
    p.add_argument("--backoff", type=float, default=5.0,
                   help="initial respawn delay seconds (default 5)")
    p.add_argument("--backoff-max", type=float, default=60.0,
                   help="backoff ceiling seconds (default 60)")
    p.add_argument("--scale-max", type=int, default=0,
                   help="elastic mode: keep up to this many copies of the "
                        "command alive, scaled by learner backpressure "
                        "(0 = classic single-child supervision)")
    p.add_argument("--scale-min", type=int, default=1,
                   help="elastic mode floor (default 1)")
    p.add_argument("--scale-interval", type=float, default=30.0,
                   help="seconds between backpressure probes (default 30)")
    p.add_argument("--scale-signal", choices=["drain", "slo"],
                   default="drain",
                   help="elastic mode sizing signal: 'drain' = actor "
                        "drain-bound fraction (backpressure), "
                        "'slo' = the fleet SLO engine's alert severity "
                        "(apex_tpu_torch/obs/slo — breach adds capacity, a "
                        "zero-burn fleet retires one)")
    p.add_argument("--learner-ip", default="127.0.0.1",
                   help="elastic mode: learner host for the status probe")
    p.add_argument("--status-port", type=int, default=52003,
                   help="elastic mode: learner fleet-status port")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- then the role command to supervise")
    return p


# -- elastic fleet supervision ----------------------------------------------

def scale_decision(drain_frac: float | None, n_now: int, n_min: int,
                   n_max: int, high: float = 0.5, low: float = 0.15) -> int:
    """Target child count from the actor drain-bound fraction.

    ``drain_frac`` is the share of actor wall time spent blocked shipping
    chunks (the learner's aggregate of the actors' ``ActorTimingStat``): at or
    above ``high`` the learner is the bottleneck and an actor can be
    retired; at or below ``low`` the learner is starving and one more
    actor helps.  One step per tick, clamped to [n_min, n_max]; an
    unreadable signal (None — learner unreachable or no worker reporting
    yet) holds steady."""
    if drain_frac is None:
        target = n_now
    elif drain_frac >= high:
        target = n_now - 1
    elif drain_frac <= low:
        target = n_now + 1
    else:
        target = n_now
    return max(n_min, min(n_max, target))


def scale_decision_slo(slo: dict | None, n_now: int, n_min: int,
                       n_max: int) -> int:
    """Target child count from the SLO engine's snapshot (the
    ``--scale-signal slo`` decision, fed by :func:`fleet_slo`).

    A page-grade breach (``severity >= 2``) means the tier is failing
    its objective — one more replica; an ``idle`` fleet (every judged
    objective at ZERO budget burn over the slow window) is provably
    over-provisioned — one fewer.  BURNING/warn/RESOLVED-cooldown and an
    unreadable snapshot (None — learner unreachable, engine not up yet)
    hold: scaling on a half-clear signal is how autoscalers flap.  One
    step per tick, clamped, like :func:`scale_decision`."""
    if not slo:
        target = n_now
    elif int(slo.get("severity", 0)) >= 2:
        target = n_now + 1
    elif slo.get("idle"):
        target = n_now - 1
    else:
        target = n_now
    return max(n_min, min(n_max, target))


def fleet_slo(learner_ip: str = "127.0.0.1", status_port: int = 52003,
              timeout_s: float = 5.0) -> dict | None:
    """One status round-trip for the trainer's SLO snapshot (the ``slo``
    section of the fleet summary), or None when nothing answers / no
    engine is running.  Lazy zmq, like :func:`fleet_drain_frac`."""
    import dataclasses

    from apex_tpu_torch.config import CommsConfig
    from apex_tpu_torch.fleet.registry import status_request

    comms = dataclasses.replace(CommsConfig(), status_port=status_port)
    try:
        snap = status_request(comms, learner_ip=learner_ip,
                              timeout_s=timeout_s)
    except Exception:
        return None
    if not snap:
        return None
    return snap.get("slo")


def fleet_drain_frac(learner_ip: str = "127.0.0.1",
                     status_port: int = 52003,
                     timeout_s: float = 5.0) -> float | None:
    """One status round-trip to the learner for the aggregate actor
    drain-bound fraction (``metrics.actor_drain_frac`` in the trainer's
    fleet summary), or None when nothing answers / nothing reported.
    zmq imports lazily — the classic supervision path stays stdlib."""
    import dataclasses

    from apex_tpu_torch.config import CommsConfig
    from apex_tpu_torch.fleet.registry import status_request

    comms = dataclasses.replace(CommsConfig(), status_port=status_port)
    try:
        snap = status_request(comms, learner_ip=learner_ip,
                              timeout_s=timeout_s)
    except Exception:
        return None
    if not snap:
        return None
    return snap.get("metrics", {}).get("actor_drain_frac")


class ScaleSupervisor:
    """Backpressure-scaled multi-child supervisor.

    Keeps ``target`` copies of ``cmd`` alive — slot ``i``'s command has
    every ``{slot}`` placeholder replaced by ``i``, so a fleet of
    ``--actor-id {slot}`` children lands on distinct epsilon-ladder
    slots.  Dead children respawn on their own slot (APEX_RESPAWN_COUNT
    exported per life, so chaos kills stay first-life-only); scale-down
    retires the HIGHEST slots first (the greediest end of the ladder).

    ``spawn(cmd, env) -> handle`` and ``probe() -> signal`` inject for
    tests; a handle needs ``poll()`` and ``terminate()``.  ``decide``
    maps ``(signal, n_now, n_min, n_max) -> target`` — default is the
    drain-frac :func:`scale_decision`; ``--scale-signal slo`` swaps in
    :func:`scale_decision_slo` with :func:`fleet_slo` as the probe.
    """

    def __init__(self, cmd: list[str], n_min: int, n_max: int,
                 interval_s: float = 30.0, probe=None, spawn=None,
                 clock=time.monotonic, sleep=time.sleep,
                 high: float = 0.5, low: float = 0.15, decide=None):
        import os

        self.cmd = list(cmd)
        self.n_min = max(1, int(n_min))
        self.n_max = max(self.n_min, int(n_max))
        self.interval_s = float(interval_s)
        self.probe = probe or (lambda: None)
        self._environ = os.environ
        self.spawn = spawn or (lambda c, env: subprocess.Popen(c, env=env))
        self._clock = clock
        self._sleep = sleep
        self.high, self.low = float(high), float(low)
        self.decide = decide or (
            lambda sig, n, lo, hi: scale_decision(sig, n, lo, hi,
                                                  high=self.high,
                                                  low=self.low))
        self.children: dict[int, object] = {}       # slot -> handle
        self._lives: dict[int, int] = {}            # slot -> spawn count
        self.target = self.n_min
        self.scale_ups = 0
        self.scale_downs = 0

    def _cmd_for(self, slot: int) -> list[str]:
        return [a.replace("{slot}", str(slot)) for a in self.cmd]

    def _spawn(self, slot: int) -> None:
        env = dict(self._environ,
                   APEX_RESPAWN_COUNT=str(self._lives.get(slot, 0)))
        self.children[slot] = self.spawn(self._cmd_for(slot), env)
        self._lives[slot] = self._lives.get(slot, 0) + 1

    def _apply_target(self) -> None:
        for slot in range(self.target):
            if slot not in self.children:
                self._spawn(slot)
        for slot in sorted(self.children, reverse=True):
            if slot >= self.target:
                self.children.pop(slot).terminate()

    def tick(self) -> None:
        """One supervision round: reap/respawn dead children inside the
        target, then re-decide the target from the backpressure probe."""
        for slot, h in list(self.children.items()):
            if h.poll() is not None:
                del self.children[slot]
                if slot < self.target:
                    self._spawn(slot)
        new = self.decide(self.probe(), self.target, self.n_min,
                          self.n_max)
        if new > self.target:
            self.scale_ups += 1
            print(f"supervise: scale up {self.target} -> {new}",
                  flush=True)
        elif new < self.target:
            self.scale_downs += 1
            print(f"supervise: scale down {self.target} -> {new}",
                  flush=True)
        self.target = new
        self._apply_target()

    def run(self, max_seconds: float | None = None) -> int:
        import signal

        def _term(signum, frame):   # teardown must reap the whole fleet
            raise SystemExit(128 + signum)

        try:
            signal.signal(signal.SIGTERM, _term)
        except ValueError:
            pass                    # not the main thread
        deadline = (None if max_seconds is None
                    else self._clock() + max_seconds)
        self._apply_target()
        next_probe = self._clock() + self.interval_s
        try:
            while deadline is None or self._clock() < deadline:
                # reap/respawn every beat; probe at the slower cadence
                for slot, h in list(self.children.items()):
                    if h.poll() is not None:
                        del self.children[slot]
                        if slot < self.target:
                            self._spawn(slot)
                if self._clock() >= next_probe:
                    self.tick()
                    next_probe = self._clock() + self.interval_s
                self._sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            for h in self.children.values():
                h.terminate()
            self.children.clear()
        return 0


def supervise(cmd: list[str], max_respawns: int = 10, window_s: float = 600.0,
              min_uptime_s: float = 60.0, backoff_s: float = 5.0,
              backoff_max_s: float = 60.0, sleep=time.sleep,
              clock=time.monotonic, run=None) -> int:
    """Run ``cmd`` until it exits 0 or the respawn budget is spent.
    Returns the supervisor's exit code (0 = child finished cleanly,
    1 = budget exhausted, last child rc otherwise on interrupt).

    A SIGTERM/SIGINT to the supervisor TERMINATES the current child
    before exiting — without the forwarding, killing a supervisor
    (topology teardown, `kill $pid` in run_local.sh's trap) leaked its
    child as an orphan still bound to the role's ports, which then
    shadowed the next fleet launched on the same host."""
    import os
    import signal

    if run is None:
        child: dict = {"p": None}

        def run(c, env):
            p = subprocess.Popen(c, env=env)
            child["p"] = p
            try:
                return p.wait()
            finally:
                child["p"] = None

        def _forward(signum, frame):
            p = child["p"]
            if p is not None:
                p.terminate()
            raise SystemExit(128 + signum)

        try:
            signal.signal(signal.SIGTERM, _forward)
            signal.signal(signal.SIGINT, _forward)
        except ValueError:
            pass                    # not the main thread: no forwarding
    rng = random.Random()
    lives = 0
    window_respawns = 0
    last_respawn = 0.0
    backoff = backoff_s
    while True:
        env = dict(os.environ, APEX_RESPAWN_COUNT=str(lives))
        start = clock()
        rc = run(cmd, env)
        uptime = clock() - start
        lives += 1
        if rc == 0:
            print(f"supervise: {cmd[0]} exited cleanly after "
                  f"{uptime:.0f}s", flush=True)
            return 0
        # a full quiet window since the LAST respawn restores the budget
        # (rate limit, not lifetime cap — ActorPool._refresh_budget)
        if window_respawns and clock() - last_respawn > window_s:
            window_respawns = 0
        if uptime >= min_uptime_s:
            backoff = backoff_s          # long life: crash was sporadic
        else:
            backoff = min(2 * backoff, backoff_max_s)
        if window_respawns >= max_respawns:
            print(f"supervise: {window_respawns} respawns inside "
                  f"{window_s:.0f}s — crash loop, halting (rc={rc})",
                  flush=True)
            return 1
        window_respawns += 1
        last_respawn = clock()
        delay = backoff * (0.5 + rng.random())   # jitter: no fleet lockstep
        print(f"supervise: {cmd[0]} exited rc={rc} after {uptime:.0f}s; "
              f"respawn {window_respawns}/{max_respawns} in {delay:.1f}s",
              flush=True)
        sleep(delay)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("supervise: no command given (… -- CMD ARG...)",
              file=sys.stderr)
        return 2
    if args.scale_max > 0:
        if args.scale_signal == "slo":
            probe = (lambda: fleet_slo(args.learner_ip,
                                       args.status_port))
            decide = scale_decision_slo
        else:
            probe = (lambda: fleet_drain_frac(args.learner_ip,
                                              args.status_port))
            decide = None           # the drain-frac default
        sup = ScaleSupervisor(
            cmd, n_min=args.scale_min, n_max=args.scale_max,
            interval_s=args.scale_interval, probe=probe, decide=decide)
        return sup.run()
    return supervise(cmd, max_respawns=args.max_respawns,
                     window_s=args.window, min_uptime_s=args.min_uptime,
                     backoff_s=args.backoff, backoff_max_s=args.backoff_max)


if __name__ == "__main__":
    # whole lines on an output shared with the fleet's other processes
    # (apex_tpu_torch/runtime/__main__.py)
    sys.stdout.reconfigure(line_buffering=True, write_through=False)
    raise SystemExit(main())
