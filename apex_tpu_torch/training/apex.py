"""Ape-X driver: actor processes feeding the learner on the card.

Counterpart of :mod:`apex_tpu.training.apex` (reference ``ApeX.py``):

* N spawned worker processes act on the CPU with the Ape-X epsilon ladder
  and ship fixed-shape frame chunks with acting-time priorities over the
  shared-memory chunk ring (:mod:`apex_tpu_torch.actors.pool`,
  :mod:`apex_tpu_torch.actors.vector`).
* :meth:`ConcurrentTrainer.train` drains the chunks into the frame-pool
  replay on the card: the fused ingest+train step whenever a chunk is
  pending, warm and under the replay-ratio cap, else ingest only; a
  train-only step when no chunk is pending.  ``min_train_ratio`` pauses
  draining while the learner is behind, so the bounded chunk queue
  backpressures the actors.
* Params publish version-stamped every ``publish_interval`` learner steps
  with a wall-clock floor (``publish_min_seconds``), as host numpy arrays.
* No training until ``replay.warmup`` transitions are resident.
* With a ``checkpoint_dir``, the whole learner is saved every
  ``save_interval`` learner steps (:mod:`apex_tpu_torch.training.checkpoint`).

``train()`` runs the JAX trainer's default path (``apex.py:307-348``,
``:389-407``): with ``LearnerConfig.ingest_pipeline`` (the default) it
consumes slots that the staging thread of
:mod:`apex_tpu_torch.training.ingest_pipeline` has already polled, merged
and put on the device, and publishes through that thread; with
``ingest_pipeline=False`` it is the serial drain (``apex.py:392-467``).
Both dispatch ``scan_steps`` chunks over
:meth:`~apex_tpu_torch.training.learner.LearnerCore.fused_multi_step`.
:meth:`ApexTrainer.consume` is the serial drain's single-chunk half, for
callers that bring their own chunk messages.

Not ported yet: the fleet, heartbeat, obs, SLO and ctl planes, the status
server, the sharded plan and remote policy.  Where the JAX trainer splits
a PRNG key per dispatch, this one draws the PER sample's uniforms from a
``torch.Generator`` on the learner's device, on the learner thread, in
the same order on both paths.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.actors.pool import ActorPool, ActorTimingStat, EpisodeStat
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.registry import (make_env, make_eval_env,
                                          num_actions, unstacked_env_spec)
from apex_tpu_torch.models.dueling import (DuelingDQN, host_params,
                                           make_policy_fn)
from apex_tpu_torch.ops.losses import make_optimizer
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.base import check_hbm_budget
from apex_tpu_torch.replay.frame_chunks import FRAME_MARGIN
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.checkpoint import (CheckpointableTrainer,
                                                Checkpointer,
                                                run_policy_episodes)
from apex_tpu_torch.training.ingest_pipeline import (IngestPipeline,
                                                     PipelineState,
                                                     _pow2_floor)
from apex_tpu_torch.training.learner import LearnerCore
from apex_tpu_torch.training.state import create_train_state
from apex_tpu_torch.utils.metrics import MetricLogger, RateCounter
from apex_tpu_torch.utils.profiling import DispatchGapTimer


def dqn_env_specs(cfg: ApexConfig):
    """(model_spec, frame_shape, frame_dtype, frame_stack) from a probe env.
    The model spec carries ``obs_shape`` (the stacked observation), which
    torch layers need up front."""
    probe = make_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed)
    frame_shape, frame_dtype, frame_stack = unstacked_env_spec(probe, cfg.env)
    model_spec = dict(
        num_actions=num_actions(probe),
        obs_shape=frame_shape[:-1] + (frame_stack * frame_shape[-1],),
        obs_is_image=len(frame_shape) == 3,
        compute_dtype=getattr(torch, cfg.learner.compute_dtype),
        scale_uint8=np.dtype(frame_dtype) == np.uint8)
    probe.close()
    return model_spec, frame_shape, frame_dtype, frame_stack


class ConcurrentTrainer(CheckpointableTrainer):
    """The concurrent learner loop: drain worker chunk messages, fuse
    ingest+train, enforce the replay-ratio band, publish versioned params.

    Chunk messages are ``{"payload": chunk, "priorities": f32[K],
    "n_trans": int}`` (:func:`~apex_tpu_torch.replay.frame_chunks.drain_builder_chunks`,
    or a sequence message of :mod:`apex_tpu_torch.actors.r2d2`).
    Subclasses construct ``cfg, device, pool, replay, replay_state,
    train_state, core, scan_steps`` and call :meth:`_init_loop` for the
    rest (see :class:`ApexTrainer`).  ``dispatches`` counts learner calls
    by kind: ``fused`` (ingest+train), ``train`` (train only), ``ingest``
    (ingest only, a merged slot's included) and ``scan`` (one
    fused_multi_step of several fused steps).
    """

    _stop_requested: threading.Event | None = None
    # log and save cadence persist across train() calls
    _last_log = 0
    _last_save = 0
    _episode_idx = 0
    _pipeline: IngestPipeline | None = None
    _pipeline_base = 0              # ingested count the pipeline began at
    _pipeline_last_stats: dict | None = None

    def _init_loop(self, train_ratio, min_train_ratio, publish_min_seconds,
                   respawn_workers, logdir, verbose, checkpoint_dir) -> None:
        """The loop's knobs, counters, logger, checkpointer and sample
        generator, set by each subclass once ``cfg`` and ``device`` are."""
        if (train_ratio is not None and min_train_ratio is not None
                and min_train_ratio > train_ratio):
            raise ValueError("min_train_ratio must be <= train_ratio")
        self.train_ratio = train_ratio
        self.min_train_ratio = min_train_ratio
        self.publish_min_seconds = publish_min_seconds
        self.respawn_workers = respawn_workers
        # the PER sample's uniforms; the JAX trainer's key chain
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.env.seed + 1)
        self.log = MetricLogger("learner", logdir, verbose=verbose)
        self.steps_rate = RateCounter()
        self.frames_rate = RateCounter()
        self.ingested = 0
        self.param_version = 0
        self.learner_epoch = 1
        self.checkpointer = (Checkpointer(checkpoint_dir)
                             if checkpoint_dir else None)
        self.dispatches = {"fused": 0, "train": 0, "ingest": 0, "scan": 0}
        self._dispatch_gap = DispatchGapTimer()    # train() starts a fresh one
        self.actor_timing: dict = {}
        self.stat_drops = 0

    @property
    def steps(self) -> int:
        """Learner updates taken so far."""
        return self.steps_rate.total

    # -- param plane -------------------------------------------------------

    def _publish(self) -> None:
        """Hand the online weights to the pool under the next version.
        Pipelined: a copy made on the learner's stream (the optimizer
        updates the weights in place) goes to the staging thread, which
        waits for it and makes the device-to-host copy, or, for a pool
        that ``accepts_device_params`` (on-device rollouts,
        :class:`~apex_tpu_torch.training.anakin.AnakinPool`), hands the
        copy on as it is.  Serial: such a pool gets the device copy, any
        other the device-to-host copy, made here."""
        self.param_version += 1
        params = self.train_state.params
        if (self._pipeline is not None
                or getattr(self.pool, "accepts_device_params", False)):
            copy = {name: t.detach().clone()
                    for name, t in params.state_dict().items()}
            if self._pipeline is not None:
                self._pipeline.publish(self.param_version, copy)
            else:
                self.pool.publish_params(self.param_version, copy)
            return
        self.pool.publish_params(self.param_version, host_params(params))

    def request_stop(self) -> None:
        """Ask a running :meth:`train` (possibly in another thread) to
        return at its next loop iteration."""
        if self._stop_requested is None:
            self._stop_requested = threading.Event()
        self._stop_requested.set()

    def _beta(self, ingested: int | None = None) -> float:
        n = self.ingested if ingested is None else ingested
        frac = min(1.0, n / max(1, self.cfg.replay.beta_anneal))
        return self.cfg.replay.beta + (1.0 - self.cfg.replay.beta) * frac

    def _budget(self) -> float:
        """Learner steps the replay-ratio cap allows so far."""
        if self.train_ratio is None:
            return float("inf")
        return self.ingested * self.train_ratio / self.core.batch_size

    # -- main loop ---------------------------------------------------------

    def train(self, total_steps: int, max_seconds: float = 3600.0,
              log_every: int = 200):
        """Run ``total_steps`` more learner updates, or until
        ``max_seconds`` of wall clock or :meth:`request_stop`.  On a
        restored trainer the step counter continues from the checkpoint.
        The pool's workers (and the staging thread) are started here and
        stopped, with the chunk segment released, before this returns or
        raises."""
        cfg = self.cfg
        pool = self.pool
        target_steps = self.steps_rate.total + total_steps
        gap = self._dispatch_gap = DispatchGapTimer()
        pipeline = None
        if cfg.learner.ingest_pipeline:
            pipeline = self._pipeline = IngestPipeline(
                pool, device=self.device, depth=cfg.learner.pipeline_depth,
                scan_steps=self.scan_steps,
                merge_max=cfg.learner.pipeline_merge,
                state_fn=self._pipeline_state,
                capacity=self.replay.capacity,
                frame_capacity=getattr(self.replay, "f_capacity", None))
            self._pipeline_base = self.ingested
        try:
            pool.start()
        except BaseException:
            self._pipeline = None      # never started; publish serially
            raise
        try:
            if pipeline is not None:
                # the staging thread owns every poll_chunks call from here
                # to stop()
                pipeline.start()
            self._publish()
            last_publish = time.monotonic()
            t_end = last_publish + max_seconds
            self._episode_idx = 0
            last_pub_step = self.steps_rate.total
            last_health = last_publish
            metrics = None
            while self.steps_rate.total < target_steps:
                now = time.monotonic()
                stop = self._stop_requested
                if now > t_end or (stop is not None and stop.is_set()):
                    break
                warm = self.ingested >= cfg.replay.warmup
                steps = self.steps_rate.total
                budget = self._budget()
                # replay-ratio floor: a learner behind stops draining so
                # the bounded chunk queue backpressures the actors
                floor = self.min_train_ratio
                behind = (warm and floor is not None
                          and steps * self.core.batch_size
                          < self.ingested * floor)
                got_data = False
                if pipeline is not None:
                    slot = None
                    if not behind:
                        slot = pipeline.poll_slot(timeout=0 if warm else 0.05)
                    if slot is not None:
                        got_data = True
                        m = self._consume_slot(slot, warm, budget,
                                               target_steps)
                        if m is not None:
                            metrics = m
                else:
                    # scan dispatch: K chunks only when all K steps fit
                    # both the ratio budget and the remaining total_steps
                    want = 1
                    if (self.scan_steps > 1 and warm
                            and target_steps - steps >= self.scan_steps
                            and steps + self.scan_steps - 1 < budget):
                        want = self.scan_steps
                    msgs = []
                    if not behind:
                        msgs = pool.poll_chunks(want,
                                                timeout=0 if warm else 0.05)
                    if msgs:
                        got_data = True
                        m = self._drain_serial(msgs, want, warm, budget)
                        if m is not None:
                            metrics = m
                if not got_data and warm and steps < budget:
                    gap.about_to_dispatch()
                    self.train_state, self.replay_state, metrics = \
                        self.core.train_step(self.train_state,
                                             self.replay_state,
                                             self._offsets(), self._beta())
                    gap.dispatch_returned()
                    self.dispatches["train"] += 1
                    self.steps_rate.tick()
                elif not got_data and warm:
                    time.sleep(0.002)   # replay-ratio cap reached

                steps = self.steps_rate.total
                # interval since the last save: a scan dispatch can step
                # over any exact multiple
                if (self.checkpointer is not None
                        and steps - self._last_save
                        >= cfg.learner.save_interval):
                    self.save_checkpoint()
                    self._last_save = steps
                # in-host queues exist before the first publish, so it
                # cannot be lost: no republish before the first step
                due = (steps > 0
                       and now - last_publish >= self.publish_min_seconds
                       and (steps - last_pub_step
                            >= cfg.learner.publish_interval
                            or now - last_publish
                            > 10 * self.publish_min_seconds))
                if due:
                    self._publish()
                    last_publish = now
                    last_pub_step = steps

                if self.respawn_workers and now - last_health >= 5.0:
                    self._health_tick(steps)
                    last_health = now
                self._drain_stats(steps)

                if metrics is not None and steps - self._last_log >= log_every:
                    extra = gap.snapshot()
                    if pipeline is not None:
                        extra |= {f"pipeline_{k}": v
                                  for k, v in pipeline.stats.items()}
                    self.log.scalars(
                        {k: float(v) for k, v in metrics.items()}
                        | {"bps": self.steps_rate.rate,
                           "fps": self.frames_rate.rate,
                           "param_version": self.param_version,
                           "ingested": self.ingested} | extra,
                        steps)
                    self._last_log = steps
        finally:
            if pipeline is not None:
                # stop staging before the pool's teardown: the staging
                # thread is the pool's only chunk consumer while it lives
                self._pipeline_last_stats = dict(pipeline.stats)
                pipeline.stop()
                self._pipeline = None
            pool.cleanup()
            stop = self._stop_requested
            if stop is not None:
                stop.clear()       # a request is honoured once, at exit
        return self

    def _health_tick(self, steps: int) -> None:
        """Respawn crashed workers on their slots
        (``apex_tpu/training/apex.py:567-575``)."""
        pool = self.pool
        if hasattr(pool, "dead_workers"):
            for dead in pool.dead_workers():
                self.log.scalars({"worker_respawn": dead}, steps)
                pool.respawn_worker(dead)

    def _drain_stats(self, steps: int) -> None:
        """Timing stats into ``actor_timing`` and the scalar log, episode
        stats into the episode log; count the drops they carry."""
        for stat in self.pool.poll_stats():
            self.stat_drops += stat.dropped_stats
            if isinstance(stat, ActorTimingStat):
                self.actor_timing[stat.actor_id] = stat
                self.log.scalars(
                    {"actor_fps": stat.frames_per_sec,
                     "actor_policy_wait_frac": stat.policy_wait_frac,
                     "actor_env_step_frac": stat.env_step_frac,
                     "actor_drain_frac": stat.drain_frac,
                     "actor_dispatch_gap_ms_p50": stat.dispatch_gap_ms_p50},
                    steps)
            elif isinstance(stat, EpisodeStat):
                self.log.scalars(
                    {"episode_reward": stat.reward,
                     "episode_length": stat.length,
                     "episode_param_version": stat.param_version,
                     "actor_id": stat.actor_id}, self._episode_idx)
                self._episode_idx += 1

    def actor_plane(self) -> dict | None:
        """The latest ActorTimingStat of each worker, aggregated; None
        before any worker reported."""
        if not self.actor_timing:
            return None
        ts = list(self.actor_timing.values())

        def mean(vals):
            return float(np.mean(vals))

        return {
            "workers_reporting": len(ts),
            "double_buffer": all(t.double_buffer for t in ts),
            "frames_per_sec_sum": sum(t.frames_per_sec for t in ts),
            "policy_wait_frac": mean([t.policy_wait_frac for t in ts]),
            "env_step_frac": mean([t.env_step_frac for t in ts]),
            "drain_frac": mean([t.drain_frac for t in ts]),
            "dispatch_gap_ms_p50": mean([t.dispatch_gap_ms_p50 for t in ts]),
            "stat_drops": self.stat_drops,
        }

    # -- dispatch ----------------------------------------------------------

    def _offsets(self, k: int | None = None) -> torch.Tensor:
        """The PER sample's per-stratum uniforms, ``[B]`` or ``[k, B]``."""
        b = self.core.batch_size
        if k is None:
            return stratified_offsets(b, self.generator, self.device)
        return torch.rand((k, b), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def _dispatch_scan(self, payloads: list, prios: list, n_per) -> dict:
        """One fused_multi_step over j chunks; each step's beta sees the
        ingestion through the chunk before it.  Returns the mean metrics."""
        starts = np.concatenate([[0], np.cumsum(n_per)[:-1]])
        betas = [self._beta(self.ingested + int(o)) for o in starts]
        gap = self._dispatch_gap
        gap.about_to_dispatch()
        self.train_state, self.replay_state, stacked = \
            self.core.fused_multi_step(
                self.train_state, self.replay_state, payloads, prios,
                self._offsets(len(payloads)), betas)
        gap.dispatch_returned()
        self.dispatches["scan"] += 1
        self.steps_rate.tick(len(payloads))
        self.ingested += sum(n_per)
        self.frames_rate.tick(sum(n_per))
        return {name: v.mean() for name, v in stacked.items()}

    def _dispatch_one(self, payload, prios, n_trans: int, train: bool):
        """The fused step (``train``) or ingest only, of one payload.
        Returns the step's metrics or None."""
        gap = self._dispatch_gap
        metrics = None
        gap.about_to_dispatch()
        if train:
            self.train_state, self.replay_state, metrics = \
                self.core.fused_step(
                    self.train_state, self.replay_state, payload, prios,
                    self._offsets(), self._beta())
            self.dispatches["fused"] += 1
            self.steps_rate.tick()
        else:
            self.replay_state = self.core.ingest(self.replay_state, payload,
                                                 prios)
            self.dispatches["ingest"] += 1
        gap.dispatch_returned()
        self.ingested += n_trans
        self.frames_rate.tick(n_trans)
        return metrics

    def _drain_serial(self, msgs: list, want: int, warm: bool,
                      budget: float):
        """One poll's chunk messages, in order (``apex.py:1392-1467``).
        With ``want > 1``, the largest power-of-two prefix runs as one
        fused_multi_step and the rest one by one.  Each single chunk runs
        the fused step when warm and under the ratio cap, else ingest
        only.  Returns the last metrics (device scalars) or None."""
        metrics = None
        if want > 1 and len(msgs) > 1:
            j = _pow2_floor(len(msgs))
            take, msgs = msgs[:j], msgs[j:]
            metrics = self._dispatch_scan(
                [m["payload"] for m in take], [m["priorities"] for m in take],
                [int(m["n_trans"]) for m in take])
        for msg in msgs:
            m = self._dispatch_one(
                msg["payload"], msg["priorities"], int(msg["n_trans"]),
                warm and self.steps_rate.total < budget)
            if m is not None:
                metrics = m
        return metrics

    def consume(self, msgs: list[dict]):
        """Chunk messages brought by the caller, one at a time: the
        single-chunk half of the serial drain, under the current warm-up
        and replay-ratio state.  Returns the last step's metrics or None."""
        return self._drain_serial(msgs, 1,
                                  self.ingested >= self.cfg.replay.warmup,
                                  self._budget())

    # -- the ingest pipeline -----------------------------------------------

    def _pipeline_state(self) -> PipelineState:
        """Counter snapshot for the staging thread's grouping
        (``apex.py:1177-1217``).  ``train_eligible`` is predicted from the
        pipeline's monotone polled total: when the chunk under
        consideration reaches the front of the pipeline, ``ingested`` will
        be exactly that, so the prediction reproduces the serial drain's
        warm-up gate and a merge group never straddles it.  The budget
        side counts the train steps already staged ahead of the chunk."""
        cfg = self.cfg
        pipe = self._pipeline
        effective = self._pipeline_base + (0 if pipe is None
                                           else pipe.polled_total())
        steps = self.steps_rate.total
        floor = self.min_train_ratio
        behind = (self.ingested >= cfg.replay.warmup and floor is not None
                  and steps * self.core.batch_size < self.ingested * floor)
        steps_at_front = steps + (0 if pipe is None
                                  else pipe.staged_train_steps())
        budget_ok = (self.train_ratio is None
                     or steps_at_front
                     < effective * self.train_ratio / self.core.batch_size)
        return PipelineState(
            behind=behind,
            train_eligible=effective >= cfg.replay.warmup and budget_ok)

    def _consume_slot(self, slot, warm: bool, budget: float,
                      target_steps: int):
        """Dispatch one staged slot (``apex.py:1317-1390``), gated chunk
        for chunk as the serial drain gates: an eligible scan slot runs
        fused_multi_step, an eligible single the fused step, the rest is
        ingested.  Warm-up and the ratio cap are checked again here, so a
        stale staging prediction can only under-train.  Returns metrics
        or None."""
        if slot.kind == "scan":
            j = slot.chunks
            if (warm and self.steps_rate.total + j - 1 < budget
                    and target_steps - self.steps_rate.total >= j):
                return self._dispatch_scan(slot.payload, slot.prios,
                                           slot.n_per)
            for payload, prios, n in zip(slot.payload, slot.prios,
                                         slot.n_per):
                self._dispatch_one(payload, prios, n, False)
            return None
        train = (slot.kind == "single" and warm
                 and self.steps_rate.total < budget)
        return self._dispatch_one(slot.payload, slot.prios, slot.n_trans,
                                  train)

    # -- checkpointing (apex.py:1473-1489) ---------------------------------

    def _counters(self) -> dict:
        return dict(ingested=self.ingested, steps=self.steps_rate.total,
                    param_version=self.param_version,
                    learner_epoch=self.learner_epoch)

    def _apply_counters(self, meta: dict) -> None:
        self.ingested = meta["ingested"]
        self.steps_rate.total = meta["steps"]
        self.param_version = meta["param_version"]
        # restoring starts a new learner life (the JAX trainer's fencing
        # epoch; nothing in the port reads it yet)
        self.learner_epoch = int(meta.get("learner_epoch", 1)) + 1
        # a restored trainer owes no immediate save or log
        self._last_save = self._last_log = meta["steps"]


class ApexTrainer(ConcurrentTrainer):
    """The frame-pool Ape-X trainer (``ApeX.py:13-82``).

    Replay-ratio control, in samples consumed per transition ingested:
    ``train_ratio`` caps it (the learner idles when it has consumed too
    much per ingested transition) and ``min_train_ratio`` floors it
    (chunk draining pauses while the learner is behind, which
    backpressures the actors).  ``None`` leaves that side open.

    ``pool`` defaults to an :class:`~apex_tpu_torch.actors.pool.ActorPool`
    of ``cfg.actor.n_actors`` workers, started by :meth:`train`.
    ``device`` defaults to the card and raises without one unless
    ``"cpu"`` is asked for; the actors always act on the CPU.
    ``respawn_workers`` restarts crashed workers every 5 s; ``logdir``
    and ``verbose`` go to the :class:`MetricLogger`; ``checkpoint_dir``
    turns on the saves of :meth:`train` and names where
    :meth:`save_checkpoint` writes.
    """

    def __init__(self, config: ApexConfig | None = None, pool=None,
                 train_ratio: float | None = None,
                 device: str | torch.device = "cuda",
                 logdir: str | None = None, verbose: bool = False,
                 publish_min_seconds: float = 0.2,
                 min_train_ratio: float | None = None,
                 respawn_workers: bool = True,
                 checkpoint_dir: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg = config or ApexConfig()
        self.model_spec, frame_shape, frame_dtype, frame_stack = \
            dqn_env_specs(cfg)
        self.replay = FramePoolReplay(
            capacity=cfg.replay.capacity, frame_shape=frame_shape,
            frame_stack=frame_stack, frame_dtype=np.dtype(frame_dtype).name,
            alpha=cfg.replay.alpha, eps=cfg.replay.eps)
        check_hbm_budget(self.replay.hbm_bytes(), cfg.replay.hbm_budget_gb,
                         "frame-pool replay", cfg.replay.capacity,
                         self.device)
        lc = cfg.learner
        optimizer = make_optimizer(
            lr=lc.lr, decay=lc.rmsprop_decay, eps=lc.rmsprop_eps,
            centered=lc.rmsprop_centered, max_grad_norm=lc.max_grad_norm,
            lr_decay_steps=lc.lr_decay_steps, lr_decay_rate=lc.lr_decay_rate)
        init_gen = torch.Generator().manual_seed(cfg.env.seed)
        self.model = DuelingDQN(**self.model_spec,
                                generator=init_gen).to(self.device)
        self.train_state = create_train_state(self.model, optimizer)
        self.core = LearnerCore(
            replay=self.replay, optimizer=optimizer,
            batch_size=lc.batch_size,
            target_update_interval=lc.target_update_interval)
        self.scan_steps = lc.scan_steps
        self.policy = make_policy_fn(self.model)

        if pool is None:
            from apex_tpu_torch.native.ring import chunk_slot_bytes
            slot = chunk_slot_bytes(
                frame_dim=int(np.prod(frame_shape)),
                frame_dtype_size=np.dtype(frame_dtype).itemsize,
                kf=cfg.actor.send_interval + FRAME_MARGIN,
                k=cfg.actor.send_interval, stack=frame_stack)
            pool = ActorPool(cfg, self.model_spec,
                             chunk_transitions=cfg.actor.send_interval,
                             shm_slot_bytes=slot)
        self.pool = pool
        self.replay_state = self.replay.init(self.device)
        self._init_loop(train_ratio, min_train_ratio, publish_min_seconds,
                        respawn_workers, logdir, verbose, checkpoint_dir)

    def evaluate(self, episodes: int = 10, epsilon: float = 0.0,
                 max_steps: int = 10_000) -> float:
        """Mean score over full episodes of the evaluation env
        (``eval.py:49-87``), acting with the learner's current weights on
        its device."""
        if not hasattr(self, "_eval_env"):
            self._eval_env = make_eval_env(self.cfg.env.env_id, self.cfg.env,
                                           seed=self.cfg.env.seed + 999)
        rewards = run_policy_episodes(
            self._eval_env, self.policy, self.generator, episodes, epsilon,
            max_steps, seed_base=self.cfg.env.seed + 1000)
        return float(np.mean(rewards))
