"""One run of one cell: build the trainer, capture its first steps, measure
a window inside one ``train()`` call, read the trace, judge the result.

The run builds the cell's trainer from its configuration and traffic
files (the configuration's family, ``families/<family>.py``, over the
traffic's pool, ``pools/<pool>.py``), loads weights drawn from the seed
on the device, and calls ``train()`` once.  Wrappers on the trainer's
instances (never its code) record what the run needs:

* the first ``CAPTURE_STEPS`` learner steps: the chunk messages polled, the
  replay cursor, uniforms and IS exponent of each sample, the rows drawn,
  the batch gathered, the priorities written back, the loss, the
  optimizer's moments after the first step and the weights and trees
  after the last; and what the pool records of its acting.  The family's
  and the pool's judges follow these once the window has closed;
* the completion time of every learner step and every ingest, from the
  trainer's own counters, and the param versions published.

A sampler thread opens the window once the learner is warm and past its
first steps, measures ``seconds``, and asks ``train()`` to stop.  With
``trace``, the learner thread runs ``torch.profiler`` over the end of the
window, with a range around every learner dispatch, and ``TRACE_SECONDS``
of it (the traffic's ``trace_seconds``, if it gives one) are read from
the trace; the untraced head of the window gives the rates that
per-layer metrics scale by.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from portbench import devtrace
from portbench.spec import Cell, metric_reader

CAPTURE_STEPS = 3          # learner steps the reference follows
TRACE_SECONDS = 3.0        # profiled part of a traced window, by default
OPEN_TIMEOUT_S = 240.0     # set-up longer than this fails the run
TRACE_WAIT_S = 120.0       # a traced run's wait for its profile to close
SEED_SPAN = 2 ** 31 - 2 ** 24   # the program's seeds, with room for offsets


def program_seed(seed: int) -> int:
    return int(seed) % SEED_SPAN


# -- building --------------------------------------------------------------

def make_config(cell: Cell, seed: int):
    """The cell's ``ApexConfig``: the configuration file's sections, then
    the traffic's (``settings``), over the port's defaults, and the
    seed."""
    from apex_tpu_torch.config import ApexConfig

    cfg = ApexConfig()
    sections = {name: dict(values)
                for name, values in cell.config["settings"].items()}
    for name, values in cell.traffic.get("settings", {}).items():
        sections.setdefault(name, {}).update(values)
    sections.setdefault("env", {})["seed"] = program_seed(seed)
    for name, values in sections.items():
        cur = getattr(cfg, name)
        values = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items()}
        cfg = cfg.replace(**{name: dataclasses.replace(cur, **values)})
    return cfg


def build_trainer(cell: Cell, seed: int, device):
    """The configuration's family's trainer over the traffic's pool."""
    cfg = make_config(cell, seed)
    pool = cell.pool().build(cfg, cell.traffic, device)
    return cell.family().build_trainer(cfg, pool, device)


def seeded_weights(trainer, seed: int) -> dict:
    """Weights for every parameter, drawn on the trainer's device from the
    seed in one call and loaded into the online and target nets.  Matrix
    and filter leaves are normal with variance ``2 / fan_in``, bias leaves
    normal at 0.01.  Returns a host copy."""
    model = trainer.train_state.params
    named = list(model.named_parameters())
    dev = named[0][1].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(p.numel() for _, p in named), generator=gen,
                       device=dev)
    off = 0
    with torch.no_grad():
        for _, p in named:
            x = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            scale = (0.01 if p.dim() == 1
                     else (2.0 / float(p[0].numel())) ** 0.5)
            p.copy_(x * scale)
        trainer.train_state.target_params.load_state_dict(model.state_dict())
        return {name: p.detach().cpu().clone() for name, p in named}


def host_copy(payload):
    if isinstance(payload, dict):
        return {k: host_copy(v) for k, v in payload.items()}
    if isinstance(payload, torch.Tensor):
        return payload.detach().cpu().clone()
    if isinstance(payload, np.ndarray):
        return payload.copy()
    return payload


# -- probes ----------------------------------------------------------------

class Probe:
    """Instance wrappers on the trainer, its core, replay and pool (module
    docstring); the pool's module adds its own (``install``).  Wrappers
    stay installed for the whole run; past the capture they only record
    times."""

    def __init__(self, trainer, pool_module, traffic: dict,
                 capture_steps: int = CAPTURE_STEPS):
        self.trainer = trainer
        self.n_capture = capture_steps
        self.messages: list = []         # (payload, priorities), captured
        self.message_meta: list = []     # {actor, pv} of each
        self.steps: list = []
        self.writes: list = []
        self.mu1: list | None = None
        self.params: dict | None = None
        self.trees: tuple | None = None
        self.names = [n for n, _ in trainer.train_state.params
                      .named_parameters()]
        self.captured = threading.Event()
        self.step_ticks: list = []       # (perf_counter, steps total)
        self.frame_ticks: list = []      # (perf_counter, ingested total)
        self.acting_ticks: list = []     # (perf_counter, frames acted on card)
        self.publishes: list = []        # param versions published
        self.sender: dict = {}           # id(message) -> worker, if known
        self.pool_record: dict = {}
        self._pending: dict | None = None
        self._install()
        pool_module.install(self, traffic)

    def _set(self, obj, name: str, fn) -> None:
        object.__setattr__(obj, name, fn)

    def _install(self) -> None:
        from apex_tpu_torch.obs.spans import spans_of

        tr, core, replay, pool = (self.trainer, self.trainer.core,
                                  self.trainer.replay, self.trainer.pool)
        for counter, ticks in ((tr.steps_rate, self.step_ticks),
                               (tr.frames_rate, self.frame_ticks)):
            self._tick_wrapper(counter, ticks)
        poll, publish = pool.poll_chunks, pool.publish_params

        def publish_params(version, params):
            self.publishes.append(int(version))
            return publish(version, params)

        def poll_chunks(max_chunks, timeout=0.0):
            msgs = poll(max_chunks, timeout=timeout)
            for m in msgs:
                actor = self.sender.pop(id(m), None)
                if not self.captured.is_set():
                    spans = spans_of(m)
                    pv = int(spans[0]["pv"]) if spans else None
                    self.messages.append((host_copy(m["payload"]),
                                          np.asarray(m["priorities"],
                                                     np.float32).copy()))
                    self.message_meta.append({"actor": actor, "pv": pv})
            return msgs

        self._set(pool, "publish_params", publish_params)
        self._set(pool, "poll_chunks", poll_chunks)

        train_step, sample = core.train_step, replay.sample
        update = replay.update_priorities

        def wrapped_train_step(train_state, replay_state, offsets, beta):
            if self.captured.is_set():
                return train_step(train_state, replay_state, offsets, beta)
            self._pending = dict(ingested=int(replay_state.pos),
                                 size=int(replay_state.size),
                                 offsets=offsets.detach().cpu().clone(),
                                 beta=float(beta))
            out = train_step(train_state, replay_state, offsets, beta)
            st = self._pending
            self._pending = None
            st["loss"] = float(out[2]["loss"])
            self.steps.append(st)
            k = len(self.steps)
            if k == 1:
                self.mu1 = [m.detach().cpu().clone()
                            for m in train_state.opt_state.mu]
            if k == self.n_capture:
                self.params = {n: p.detach().cpu().clone() for n, p in
                               train_state.params.named_parameters()}
                self.trees = (replay_state.sum_tree.detach().cpu().clone(),
                              replay_state.min_tree.detach().cpu().clone())
                self.captured.set()
            return out

        def wrapped_sample(state, offsets, beta, group=None):
            batch, weights, idx = sample(state, offsets, beta, group)
            st = self._pending
            if st is not None:
                st["idx"] = idx.detach().cpu().clone()
                st["batch"] = {k: v.detach().cpu().clone()
                               for k, v in batch.items() if k != "obs_pair"}
            return batch, weights, idx

        def wrapped_update(state, idx, priorities):
            if self._pending is not None:
                self.writes.append((idx.detach().cpu().clone(),
                                    priorities.detach().cpu().clone()))
            return update(state, idx, priorities)

        self._set(core, "train_step", wrapped_train_step)
        self._set(replay, "sample", wrapped_sample)
        self._set(replay, "update_priorities", wrapped_update)

    @staticmethod
    def _tick_wrapper(counter, ticks: list) -> None:
        tick = counter.tick

        def wrapped(n=1):
            tick(n)
            ticks.append((time.perf_counter(), counter.total))

        counter.tick = wrapped

    def run_record(self) -> dict:
        """What the learner's reference needs, in its own terms."""
        cfg = self.trainer.cfg
        lc, rp = cfg.learner, cfg.replay
        hp = dict(capacity=rp.capacity, alpha=rp.alpha, eps=rp.eps,
                  lr=lc.lr, lr_decay_steps=lc.lr_decay_steps,
                  lr_decay_rate=lc.lr_decay_rate,
                  rmsprop_decay=lc.rmsprop_decay, rmsprop_eps=lc.rmsprop_eps,
                  max_grad_norm=lc.max_grad_norm,
                  target_update_interval=lc.target_update_interval,
                  n_steps=lc.n_steps)
        return dict(hp=hp, frame_shape=tuple(self.trainer.replay.frame_shape),
                    messages=self.messages, steps=self.steps)


class Ranges:
    """Traced runs: a ``portbench.learner`` range around every learner
    dispatch, and the profiler driven by the learner thread at dispatch
    boundaries.  The profiler starts ``LEAD_S`` + ``seconds`` before the
    measured window's close (starting it costs seconds and slows the first
    traced steps), and the traced window opens ``WARM_STEPS`` steps later;
    its open and close are marked in the trace and reading keeps to what
    lies between.  Stopping the profiler stalls the process for about as
    long as it recorded, so it comes at the traced window's close, near
    the measured window's end, and the untraced head of the measured
    window (its open to the profiler's start) is left whole.  Starting it
    stalls too, for seconds, so a traced run's measured window stays open
    until the profiler has stopped (``done``)."""

    WARM_STEPS = 5             # traced steps before the traced window opens
    LEAD_S = 8.0               # the profiler's start and warm-up, and room

    def __init__(self, trainer, probe: "Probe", seconds: float,
                 window_seconds: float):
        self.seconds = seconds
        self.lead = max(0.0, window_seconds - seconds - self.LEAD_S)
        self.probe = probe
        self.want = threading.Event()
        self.t_open = None         # the measured window's open
        self.prof = None
        self.steps_traced = None
        self.t_prof = None         # the profiler's start
        self.t_start = self.t_stop = None
        self.done = threading.Event()
        self.steps_start = self.steps_stop = None
        self.trainer = trainer
        self._depth = 0
        self._stopped = False
        core = trainer.core
        for name in ("fused_step", "train_step", "ingest",
                     "fused_multi_step"):
            self._wrap(core, name)

    def _wrap(self, core, name: str) -> None:
        fn = getattr(core, name)

        def wrapped(*args, **kwargs):
            if self._depth == 0:
                self._edge()
            self._depth += 1
            try:
                with torch.profiler.record_function("portbench.learner"):
                    return fn(*args, **kwargs)
            finally:
                self._depth -= 1

        object.__setattr__(core, name, wrapped)

    def open(self, t_open: float) -> None:
        """The measured window opened at ``t_open``."""
        self.t_open = t_open
        self.want.set()

    def _edge(self) -> None:
        now = time.perf_counter()
        if self.prof is None:
            if (self.want.is_set() and not self._stopped
                    and now >= self.t_open + self.lead):
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self.t_prof = now
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.start()
                self.steps_traced = self.trainer.steps
            return
        if self.t_start is None:
            if self.trainer.steps >= self.steps_traced + self.WARM_STEPS:
                self._mark(devtrace.OPEN)
                self.t_start, self.steps_start = now, self.trainer.steps
        elif self.t_stop is None and now - self.t_start >= self.seconds:
            self.stop()

    @staticmethod
    def _mark(name: str) -> None:
        with torch.profiler.record_function(name):
            pass

    def stop(self) -> None:
        """Close the window's trace (if it opened) and stop the profiler;
        once."""
        if self._stopped:
            return
        self._stopped = True
        if self.prof is None:
            self.done.set()
            return
        if self.t_start is not None:
            self._mark(devtrace.CLOSE)
            self.t_stop = time.perf_counter()
            self.steps_stop = self.trainer.steps
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.done.set()


class HostTimers:
    """Traced runs: wall time of the staging thread's slot builds, by
    wrapping the pipeline class, and the pool module's own timers
    (``timers(pool, note)``, if it has one)."""

    def __init__(self, trainer, ranges: Ranges, pool_module):
        from apex_tpu_torch.training.ingest_pipeline import IngestPipeline
        self.ranges = ranges
        self.samples: dict[str, list] = defaultdict(list)
        self.intervals: dict[str, list] = defaultdict(list)
        self._cls = IngestPipeline
        self._build = IngestPipeline._build_slot
        build, timers = self._build, self

        def timed_build(pipe, first, st):
            t0 = time.perf_counter()
            slot = build(pipe, first, st)
            timers._note("ingest.stage", t0)
            return slot

        IngestPipeline._build_slot = timed_build
        if hasattr(pool_module, "timers"):
            pool_module.timers(trainer.pool, self._note)

    def _note(self, name: str, t0: float) -> None:
        r = self.ranges
        if r.t_start is not None and r.t_stop is None and t0 >= r.t_start:
            self.samples[name].append(time.perf_counter() - t0)
            self.intervals[name].append((t0, time.perf_counter()))

    def close(self) -> None:
        self._cls._build_slot = self._build


class Window:
    """The sampler: opens the window once the capture is done and the
    learner has taken ``open_after`` steps, measures ``seconds``, then asks
    ``train()`` to stop; a traced run's ``ranges`` learn the open, and its
    window closes once they have stopped the profiler."""

    def __init__(self, trainer, probe: Probe, seconds: float,
                 open_after: int, ranges: Ranges | None):
        self.trainer, self.probe = trainer, probe
        self.seconds, self.open_after = seconds, open_after
        self.ranges = ranges
        self.t_open = self.t_close = None
        self.failed: str | None = None
        self._done = threading.Event()

    def run(self) -> None:
        deadline = time.perf_counter() + OPEN_TIMEOUT_S
        while not self._done.is_set():
            if (self.probe.captured.is_set()
                    and self.trainer.steps >= self.open_after):
                self.t_open = time.perf_counter()
                break
            if time.perf_counter() > deadline:
                self.failed = (f"the window never opened: {self.trainer.steps}"
                               f" steps, {self.trainer.ingested} ingested in "
                               f"{OPEN_TIMEOUT_S} s")
                self.trainer.request_stop()
                return
            time.sleep(0.005)
        if self.t_open is None:
            return
        if self.ranges is not None:
            self.ranges.open(self.t_open)
        self._done.wait(max(0.0, self.t_open + self.seconds
                            - time.perf_counter()))
        if self.ranges is not None:
            wait_end = time.perf_counter() + TRACE_WAIT_S
            while (not self.ranges.done.is_set() and not self._done.is_set()
                   and time.perf_counter() < wait_end):
                time.sleep(0.05)
        self.t_close = time.perf_counter()
        self.trainer.request_stop()

    def abort(self) -> None:
        self._done.set()


def rate(ticks: list, t0: float, t1: float) -> float | None:
    """Count per second between the first and last completions inside
    ``[t0, t1]``; None with fewer than two."""
    inside = [(t, n) for t, n in ticks if t0 <= t <= t1]
    if len(inside) < 2 or inside[-1][0] <= inside[0][0]:
        return None
    return (inside[-1][1] - inside[0][1]) / (inside[-1][0] - inside[0][0])


# -- the run ---------------------------------------------------------------

@dataclasses.dataclass
class TraceView:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    cell: Cell
    trainer: object
    trace: devtrace.DeviceTrace | None
    timers: dict
    steps: int                 # learner steps inside the traced window
    window_s: float            # the traced window's length
    flops: object              # the configuration's FLOP module
    card: str | None = None    # the card's name; None on the CPU
    # the untraced head of the window, from its open to the profiler's
    # start: learner steps per second and frames acted on the card per
    # second
    untraced_steps_per_s: float | None = None
    untraced_frames_per_s: float | None = None
    # host intervals of the traced window (perf_counter seconds), by timer
    intervals: dict = dataclasses.field(default_factory=dict)
    open_perf: float = 0.0     # perf_counter at the window's open mark

    def to_trace_ns(self, t: float) -> int:
        """A host perf_counter time on the trace's clock, paired at the
        window's open mark."""
        return int(self.trace.open_ns + (t - self.open_perf) * 1e9)


def leftovers(trainer) -> list[str]:
    """Actor processes alive and ring segments of this process left in
    ``/dev/shm`` after ``train()``."""
    from apex_tpu_torch.native.ring import SEGMENT_PREFIX
    out = [f"actor pid {p.pid} alive"
           for p in getattr(trainer.pool, "procs", []) if p.is_alive()]
    if os.path.isdir("/dev/shm"):
        out += [f"/dev/shm/{f}" for f in os.listdir("/dev/shm")
                if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-")]
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", process_start: float | None = None,
             variants: tuple = ("program",), plant=None,
             measure: bool = True) -> dict:
    """One run; returns the result's fields and the judged numbers.
    ``measure=False`` stops right after the capture (the readings of the
    control script); ``plant(trainer)`` breaks the program for a test."""
    t_proc = (process_start if process_start is not None
              else time.perf_counter())
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if "torch_threads" in cell.traffic:
        torch.set_num_threads(int(cell.traffic["torch_threads"]))
    family, pool_module = cell.family(), cell.pool()
    trainer = build_trainer(cell, seed, device)
    init = seeded_weights(trainer, seed)
    if plant is not None:
        plant(trainer)
    probe = Probe(trainer, pool_module, cell.traffic)
    traced = float(cell.traffic.get("trace_seconds", TRACE_SECONDS))
    ranges = (Ranges(trainer, probe, min(traced, seconds), seconds)
              if trace else None)
    timers = HostTimers(trainer, ranges, pool_module) if trace else None
    open_after = int(cell.traffic.get("open_after_steps", 20)) if measure \
        else CAPTURE_STEPS
    window = Window(trainer, probe, seconds if measure else 0.0, open_after,
                    ranges)
    sampler = threading.Thread(target=window.run, name="portbench-window",
                               daemon=True)
    sampler.start()
    try:
        trainer.train(total_steps=10 ** 9,
                      max_seconds=OPEN_TIMEOUT_S + seconds + 60.0,
                      log_every=10 ** 9)
    finally:
        window.abort()
        sampler.join(timeout=30.0)
        if ranges is not None:
            ranges.stop()
        if timers is not None:
            timers.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if window.failed or window.t_open is None:
        raise RuntimeError(window.failed or "train() returned before the "
                           "window opened")
    if not probe.captured.is_set():
        raise RuntimeError("the first learner steps were not captured")
    left = leftovers(trainer)
    if left:
        raise RuntimeError(f"left behind by train(): {left}")

    result: dict = {"metrics": {}, "numbers": {}}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if measure:
        t0 = window.t_open
        t1 = window.t_close if window.t_close is not None else t0
        values = {
            "setup_s": t0 - t_proc,
            "learner_steps_per_s": rate(probe.step_ticks, t0, t1),
            "env_frames_per_s": rate(probe.frame_ticks, t0, t1),
        }
        result["steps_in_window"] = sum(1 for t, _ in probe.step_ticks
                                        if t0 <= t <= t1)
        result["window_rates"] = [
            rate(probe.step_ticks, a, a + 5.0)
            for a in np.arange(t0, t1 - 4.999, 5.0)]
        result["window_s"] = t1 - t0
        if trace:
            head = (t0, ranges.t_prof if ranges.t_prof is not None else t1)
            result.update(_read_trace(cell, trainer, ranges, timers, probe,
                                      head))
        else:
            for m in cell.end_to_end:
                v = values.get(m["name"])
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
    result["memory_peak_bytes"] = int(peak)
    record = probe.run_record()
    record["init"] = init
    acting = pool_module.record(probe)
    program = dict(loss=[s["loss"] for s in probe.steps], mu1=probe.mu1,
                   names=probe.names, params=probe.params, trees=probe.trees,
                   writes=probe.writes)
    del trainer, probe, window, ranges, timers
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = family.judge(record, program, dev, variants)
    for name, nums in pool_module.judge(acting, init, dev, variants).items():
        numbers.setdefault(name, {}).update(nums)
    result["numbers"] = numbers
    return result


def _read_trace(cell: Cell, trainer, ranges: Ranges, timers: HostTimers,
                probe: Probe, head: tuple):
    """The traced window's device numbers, breakdown and per-layer
    metrics."""
    if ranges.prof is None or ranges.t_stop is None:
        raise RuntimeError("the profiler never covered the window")
    trace = devtrace.DeviceTrace.from_profiler(ranges.prof)
    window_s = trace.window_s
    view = TraceView(cell=cell, trainer=trainer, trace=trace,
                     timers=timers.samples, intervals=timers.intervals,
                     open_perf=ranges.t_start,
                     steps=ranges.steps_stop - ranges.steps_start,
                     window_s=window_s, flops=cell.flops(),
                     card=(torch.cuda.get_device_name(0)
                           if torch.cuda.is_available() else None))
    if head[1] - head[0] >= 2.0:
        view.untraced_steps_per_s = rate(probe.step_ticks, *head)
        if probe.acting_ticks:
            view.untraced_frames_per_s = rate(probe.acting_ticks, *head)
    metrics = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"metrics": metrics,
            "busy_s": trace.busy_s(), "trace_window_s": window_s,
            "breakdown": {"device_ops": trace.top_ops(10),
                          "idle_gaps": trace.idle_gaps(10)}}
