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
  with a wall-clock floor (``publish_min_seconds``), as host numpy arrays;
  a socket pool (:class:`~apex_tpu_torch.runtime.transport.RemotePool`)
  is also republished every ``10 * publish_min_seconds`` before the first
  step.
* No training until ``replay.warmup`` transitions are resident.
* With a ``checkpoint_dir``, the whole learner is saved every
  ``save_interval`` learner steps (:mod:`apex_tpu_torch.training.checkpoint`).

:meth:`ConcurrentTrainer.train` is the one loop of the concurrent
trainers, :class:`~apex_tpu_torch.ondevice.fused.FusedApexTrainer`
included: its session, loop head and per-iteration cadence are written
once, and each iteration runs the class's body
(:meth:`ConcurrentTrainer._iteration`) over the feed the class opens
(:meth:`ConcurrentTrainer._open_feed`).  The body here is the JAX
trainer's default path (``apex.py:307-348``, ``:389-407``): with
``LearnerConfig.ingest_pipeline`` (the default) it consumes slots that
the staging thread of :mod:`apex_tpu_torch.training.ingest_pipeline` has
already polled, merged and put on the device, and publishes through that
thread; with ``ingest_pipeline=False`` it is the serial drain
(``apex.py:392-467``).  Both dispatch ``scan_steps`` chunks over
:meth:`~apex_tpu_torch.training.learner.LearnerCore.fused_multi_step`.
:meth:`ApexTrainer.consume` is the serial drain's single-chunk half, for
callers that bring their own chunk messages.

The pool is an in-host :class:`~apex_tpu_torch.actors.pool.ActorPool`, a
socket :class:`~apex_tpu_torch.runtime.transport.RemotePool` (the learner
role, :mod:`apex_tpu_torch.runtime.roles`) or an on-device
:class:`~apex_tpu_torch.training.anakin.AnakinPool`.

Replay service mode (``apex.py:129-138, 1219-1315``): with a
:class:`~apex_tpu_torch.replay_service.client.ReplayServiceClient` in
``replay_client``, sampling lives in the shard fleet.  The loop trains on
pre-sampled batches (the pipeline's ``"batch"`` slots, or the client's
polls on the serial path) with
:meth:`~apex_tpu_torch.training.learner.LearnerCore.update_from_batch`
and routes each batch's priorities back to its shard.  The chunk path
stays live: chunks that actors send the learner when their shard is
wedged ingest into the learner's own pool and train there once it is
warm.  The replay-ratio budget counts the shards' reported ingest.

The fleet and observability planes (``apex.py:294-343, 541-612,
672-979``): heartbeats and, on a socket pool, message arrivals feed a
:class:`~apex_tpu_torch.fleet.registry.FleetRegistry` on every health
tick, whose transitions, ``fleet_*`` scalars and SLO engine
(:mod:`apex_tpu_torch.obs.slo`) judge the fleet; when at least
``comms.relax_floor_dead_frac`` of the actors are DEAD the replay-ratio
floor relaxes until they rejoin (:meth:`ConcurrentTrainer._react_to_fleet`).
A socket pool's learner serves ``--role status`` and the Prometheus text
(:class:`~apex_tpu_torch.fleet.registry.FleetStatusServer`), and with a
``logdir`` the registry view lands in ``fleet_summary.json`` on every
health tick.  The chunks' lineage spans are stamped ``consume`` before
and ``prio_wb`` after each dispatch and joined into the frame-age and
param-lag histograms (:class:`~apex_tpu_torch.obs.spans.LearnerObs`,
:meth:`ConcurrentTrainer.latency_summary`).  Spans are metadata: the
learner's state is the same with them on or off.  The hot loop's
dispatches and polls are program spans (``apex.learner.*``,
:func:`~apex_tpu_torch.obs.trace.span`), and each
``train()`` call stamps its set-up milestones
(:class:`~apex_tpu_torch.obs.spans.SetupClock`, ``latency_summary()
["setup_s"]``).

The control planes (``apex.py:158-180, 552-601, 740-761, 879-895,
981-1150``): the snapshots that ``--role serve-ctl``, ``tenant-ctl`` and
``pbt-ctl`` ship on the stat channel land in the ``serving``,
``tenancy`` and ``population`` sections of :meth:`ConcurrentTrainer.
fleet_summary`, the status table and the Prometheus text.  The status
server's ctl frames (the PBT controller's exploit and explore) go into a
bounded queue that the trainer thread drains at each health tick
(:meth:`ConcurrentTrainer._apply_ctl`): :meth:`~ConcurrentTrainer.
restore_weights` imposes a donor checkpoint's ``train_state`` and bumps
the learner epoch, :meth:`~ConcurrentTrainer.apply_hparams` changes the
live lr and the IS beta.

The sharded plan (``apex.py:227-286``; ``learner.mesh_shape`` above 1):
``train()`` runs ``prod(mesh_shape)`` ranks of
:mod:`apex_tpu_torch.parallel`.  This process is rank 0, the driver: it
polls the pool through a :class:`~apex_tpu_torch.parallel.aggregate.
ChunkAggregator` (one chunk per rank per group), publishes, logs and
serves the ctl surface.  Ranks 1..N-1 are processes spawned by the first
``train()``, each with a trainer of the same class and config, its own
replay shard and a :class:`~apex_tpu_torch.parallel.learner.NoActors`
pool; they run :meth:`ConcurrentTrainer._follow`, taking each op (``fused``
/ ``train`` / ``ingest`` / ``batch`` / ``apply_hparams`` / ``restore`` /
``gather`` / ``scatter`` / ``park`` / ``stop``) with its chunk, beta and
uniforms from rank 0 over the host group and running the same body.
The paths it takes: host actors, on-device rollouts (an
:class:`~apex_tpu_torch.training.anakin.AnakinPool` acting on rank 0's
card with rank 0's live weights, its chunks aggregated like host actors'),
the replay service's batches (rank 0 pulls a batch and splits it into
contiguous per-rank blocks, every rank updates on its block, the
priorities come back in sample order and go to the owning shard), the
fused plane (:class:`~apex_tpu_torch.ondevice.fused.FusedApexTrainer`)
and checkpoints (the replay in JAX's stacked ``[dp, ...]`` layout with
every rank's generator state, gathered from and scattered to the ranks
over the host group).  The ranks live as long as the trainer: between
``train()`` calls they wait parked on the group's store (in no
collective), and :meth:`ConcurrentTrainer.close`, or a finalizer when the
trainer goes away or the interpreter exits, stops them.  A dead rank
makes the next op raise, and a trainer whose ranks were lost refuses to
train on without their shards.  ``dp_backend`` (``"nccl"``, one card per
rank, or ``"gloo"``, every rank on rank 0's card) is the dp group's.
What has not run is NCCL over several cards: the same code with the
backend swapped, run so far at world size 1 only (``chip_smoke.py`` 17c).

Where the JAX trainer splits a PRNG key per dispatch, this one draws the
PER sample's uniforms from a ``torch.Generator`` on the learner's device,
on the learner thread, in the same order on both paths (at dp > 1 from
one host generator per rank, :class:`~apex_tpu_torch.training.
ingest_pipeline.UniformPrefetcher`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
import weakref

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.actors.pool import ActorPool, ActorTimingStat, EpisodeStat
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.registry import (make_env, make_eval_env,
                                          num_actions, unstacked_env_spec)
from apex_tpu_torch.fleet.heartbeat import Heartbeat
from apex_tpu_torch.fleet.registry import FleetRegistry
from apex_tpu_torch.models.dueling import (DuelingDQN, host_params,
                                           make_policy_fn)
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.obs.trace import (LEARNER_TRACK, get_ring,
                                      set_process_label, span)
from apex_tpu_torch.ops import tree as tree_ops
from apex_tpu_torch.ops.gather import LAUNCH_COUNTS
from apex_tpu_torch.ops.losses import make_optimizer
from apex_tpu_torch.parallel.aggregate import ChunkAggregator, split_group
from apex_tpu_torch.parallel.learner import (NoActors, ShardedLearner,
                                             gather_shards, per_rank_batch,
                                             scatter_shards, shard_numbers,
                                             split_batch, tile_shard,
                                             unstack_shard)
from apex_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S, RankProcesses,
                                          check_backend, init_dp,
                                          per_rank_seed, rank_device)
from apex_tpu_torch.population import controller as population_ctl
from apex_tpu_torch.population.controller import PopulationStat
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.base import check_hbm_budget
from apex_tpu_torch.replay.frame_chunks import FRAME_MARGIN
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.runtime import wire
from apex_tpu_torch.runtime.codec import KeyframeRequest
from apex_tpu_torch.serving import deploy as serving_deploy
from apex_tpu_torch.serving.deploy import ServingStat
from apex_tpu_torch.tenancy import scheduler as tenancy_sched
from apex_tpu_torch.tenancy.scheduler import TenancyStat
from apex_tpu_torch.training.checkpoint import (CheckpointableTrainer,
                                                Checkpointer, _impose,
                                                _set_numbers, load_raw,
                                                run_policy_episodes)
from apex_tpu_torch.replay_service.shard import batch_from_wire
from apex_tpu_torch.training.ingest_pipeline import (IngestPipeline,
                                                     PipelineState,
                                                     StagedSlot,
                                                     UniformPrefetcher,
                                                     _pow2_floor)
from apex_tpu_torch.training.learner import LearnerCore
from apex_tpu_torch.training.state import create_train_state
from apex_tpu_torch.utils.metrics import MetricLogger, RateCounter
from apex_tpu_torch.utils.profiling import DispatchGapTimer


#: seconds of quiet after which rank 0 sends the other ranks a no-op (they
#: wait for its next op in a collective with a timeout)
DP_KEEPALIVE_S = 2.0
#: seconds rank 0 waits for the other ranks to build their learners
DP_START_TIMEOUT_S = 600.0


def _dp_follower_main(store, rank: int, world: int, cls, cfg: ApexConfig,
                      backend: str, device: str, timeout_s: float,
                      kwargs: dict, cudnn: tuple[bool, bool]) -> None:
    """A rank >= 1 of the sharded plan (spawned by
    :meth:`ConcurrentTrainer._start_ranks`): a trainer of rank 0's class
    and config (``kwargs``: rank 0's other constructor arguments, through
    :meth:`ConcurrentTrainer._dp_follower_kwargs`) on this rank's device
    with no actors and rank 0's cuDNN ``(deterministic, benchmark)``
    flags, joined to the dp group, following rank 0's ops until ``stop``;
    its counters go to the store as ``stats/<rank>``."""
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = cudnn
    one = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  mesh_shape=(1,)))
    trainer = cls(one, pool=NoActors(),
                  device=rank_device(rank, backend, device),
                  respawn_workers=False,
                  **cls._dp_follower_kwargs(kwargs, rank, world))
    store.set(f"ready/{rank}", "1")
    group = init_dp(world, rank, backend=backend, store=store,
                    timeout=timeout_s, device=device)
    trainer._join_dp(group)
    trainer._follow()
    store.set(f"stats/{rank}", json.dumps(trainer._dp_stats()))
    group.close()


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
    fused_multi_step of several fused steps); ``service_steps`` counts
    the updates on shard-sampled batches.
    """

    #: the trace track of the hot loop's dispatch gaps
    gap_track = LEARNER_TRACK
    _stop_requested: threading.Event | None = None
    # log and save cadence persist across train() calls
    _last_log = 0
    _last_save = 0
    _episode_idx = 0
    _pipeline: IngestPipeline | None = None
    _pipeline_base = 0              # ingested count the pipeline began at
    _pipeline_last_stats: dict | None = None
    # the replay service's client (run_learner attaches it); None keeps
    # replay in the learner
    replay_client = None
    service_steps = 0               # train steps on shard-served batches
    # the fleet plane: the membership registry (built by the first
    # train()), its status server (socket pools only) and the SLO engine
    # (built on the first health tick, so a drill's env knobs apply)
    fleet: FleetRegistry | None = None
    _fleet_status = None
    _slo = None
    # the replay-ratio floor's reaction to a dead actor fleet
    _floor_relaxed = False
    floor_relaxes = 0               # times the reaction engaged
    # the learner-side span join; persists across train() calls
    _obs = None
    # the set-up milestones of the latest train() call
    _setup: obs_spans.SetupClock | None = None
    # the controllers' latest snapshots off the stat channel (serve-ctl,
    # tenant-ctl, pbt-ctl): the serving, tenancy and population sections
    serving_state: dict | None = None
    tenancy_state: dict | None = None
    population_state: dict | None = None
    # the learner's ctl surface: the status thread enqueues, the trainer
    # thread applies at its health tick; the applied commands' record and
    # the hyperparameters applied so far
    _ctl_queue = None
    _population_ctl: dict | None = None
    hparams_live: dict | None = None
    # the sharded plan (learner.mesh_shape above 1): the dp degree and
    # backend; this rank's group and ShardedLearner steps while the ranks
    # live; rank 0's handle on the other ranks' processes (from the first
    # train() to close()) and its finalizer; the generation the ranks are
    # parked under between sessions (None while they follow ops); why the
    # ranks are gone when they are (their shards with them); a restored
    # checkpoint's stacked shards waiting for the ranks to start; the
    # other ranks' constructor arguments; the per-rank records of the
    # last session
    n_dp = 1
    dp_backend = "nccl"
    _dp = None
    _sharded = None
    _ranks = None
    _ranks_finalizer = None
    _uniforms: UniformPrefetcher | None = None
    _dp_last_op = 0.0
    _dp_gen = 0
    _dp_parked: int | None = None
    _dp_gone: str | None = None
    _dp_pending: dict | None = None
    _dp_kwargs: dict | None = None
    dp_rank_stats: dict | None = None

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
        if self._obs is not None:
            # the param-propagation-lag join key: when this version left
            self._obs.note_publish(self.param_version)
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

    def _ingested_effective(self) -> int:
        """Transitions ingested here plus, in service mode, what the
        shards report: the replay-ratio budget's count."""
        client = self.replay_client
        return self.ingested + (client.ingested_total()
                                if client is not None else 0)

    def _budget(self) -> float:
        """Learner steps the replay-ratio cap allows so far."""
        if self.train_ratio is None:
            return float("inf")
        return (self._ingested_effective() * self.train_ratio
                / self.core.batch_size)

    # -- the sharded plan (apex.py:227-286) ---------------------------------

    def _init_sharded(self, dp_backend: str) -> None:
        """dp > 1 (``prod(learner.mesh_shape)``): wrap the pool in a
        :class:`~apex_tpu_torch.parallel.aggregate.ChunkAggregator`, set up
        the per-rank uniform generators and check what can be checked
        before ``train()``: the backend and the cards it needs, the
        batch's divisibility by dp.  Each subclass calls it once its core,
        pool and loop are built."""
        n = int(np.prod(self.cfg.learner.mesh_shape))
        if n <= 1:
            return
        check_backend(n, dp_backend, self.device)
        per_rank = per_rank_batch(self.core.batch_size, n)
        self.n_dp, self.dp_backend = n, dp_backend
        self.scan_steps = 1        # no multi-step dispatch on the dp plan
        self.pool = ChunkAggregator(self.pool, n)
        seed = self.cfg.env.seed + 1
        self._uniforms = UniformPrefetcher(
            [torch.Generator().manual_seed(per_rank_seed(seed, r))
             for r in range(n)], per_rank)

    @classmethod
    def _dp_follower_kwargs(cls, kwargs: dict, rank: int,
                            world: int) -> dict:
        """The constructor arguments of rank ``rank``'s trainer, from rank
        0's ``kwargs`` (``_dp_kwargs``)."""
        return dict(kwargs)

    def _start_ranks(self) -> None:
        """Spawn ranks 1..N-1, wait until each has built its learner, join
        the groups as rank 0, hand every rank rank 0's train state and
        counters and, after a restore, each rank its shard.  The caller
        stops them if this raises."""
        ranks = self._ranks = RankProcesses(
            self.n_dp, _dp_follower_main,
            (type(self), self.cfg, self.dp_backend, str(self.device),
             DEFAULT_TIMEOUT_S, dict(self._dp_kwargs or {}),
             (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)))
        # the ranks go with the trainer, or at the latest with the
        # interpreter
        self._ranks_finalizer = weakref.finalize(self, ranks.stop, 0.0)
        ranks.wait_ready(DP_START_TIMEOUT_S)
        group = init_dp(self.n_dp, 0, backend=self.dp_backend,
                        store=ranks.store, device=self.device)
        self._join_dp(group)
        self._dp_sync(counters=True)
        if self._dp_pending is not None:
            self._dp_scatter_pending()

    def _stop_ranks(self, graceful: bool) -> None:
        """Stop the other ranks (a ``stop`` op first when ``graceful`` and
        all are alive), collect their records into ``dp_rank_stats`` and
        leave no rank process behind.  Their shards go with them."""
        ranks = self._ranks
        if ranks is None:
            return
        try:
            if (graceful and self._dp is not None and not ranks.failures()
                    and self._dp_parked is None):
                self._dp_send("stop")
        finally:
            ranks.stop(timeout_s=30.0 if graceful else 2.0)
            if self._ranks_finalizer is not None:
                self._ranks_finalizer.detach()
            own = self._dp_stats() if self._dp is not None else {}
            self.dp_rank_stats = {0: own, **ranks.rank_stats()}
            if self._dp is not None:
                self._dp.close()
            self._ranks = self._dp = self._sharded = None
            self._ranks_finalizer = None
            self._dp_parked = None
            self._dp_gone = ("its other ranks were stopped by close()"
                             if graceful else "a rank failed or train() "
                             "raised, and the other ranks were stopped")

    def _dp_open(self) -> None:
        """Rank 0: the other ranks in their op loop, spawned by the first
        call and woken from their park by the later ones."""
        if self._dp_gone is not None:
            raise RuntimeError(
                f"this sharded trainer has lost its other ranks' replay "
                f"shards ({self._dp_gone}); restore a checkpoint into a new "
                f"trainer")
        if self._ranks is None and self._dp is None:
            try:
                self._start_ranks()
            except BaseException:
                self._stop_ranks(graceful=False)
                self._dp_gone = None        # no rank held data yet
                raise
        elif self._dp_parked is not None:
            self._dp.wake(self._dp_parked)
            self._dp_parked = None
            self._dp_last_op = time.monotonic()

    def _dp_end(self, graceful: bool) -> None:
        """Rank 0, at the end of a session: park the other ranks (their
        records into ``dp_rank_stats``), or stop them after a failure."""
        ranks = self._ranks
        if ranks is None:
            return
        if graceful and not ranks.failures():
            try:
                self._dp_park()
                return
            except BaseException:
                self._stop_ranks(graceful=False)
                raise
        self._stop_ranks(graceful=False)

    def _start_pool(self) -> None:
        """``pool.start()``, which a socket pool's startup barrier can hold
        for as long as its timeout: the other ranks wait for it parked, in
        no collective."""
        if self._ranks is None or self._dp_parked is not None:
            self.pool.start()
            return
        self._dp_park()
        self.pool.start()
        self._dp_open()

    def _dp_park(self) -> None:
        """Send the other ranks to wait on the store until the next session
        (no collective, so no timeout), and collect the records they leave
        there."""
        self._dp_gen += 1
        gen = self._dp_gen
        self._dp_send("park", gen=gen)
        records = self._dp.parked_records(gen, DEFAULT_TIMEOUT_S,
                                          check=self._ranks.check)
        self.dp_rank_stats = {0: self._dp_stats(),
                              **{r: json.loads(v)
                                 for r, v in records.items()}}
        self._dp_parked = gen

    @contextlib.contextmanager
    def _dp_session(self):
        """The other ranks listening for the body's ops: a no-op at dp 1,
        inside ``train()`` and before the ranks start; between ``train()``
        calls, wake them and park them again after."""
        if (self.n_dp == 1 or self._ranks is None
                or self._dp_parked is None):
            yield
            return
        self._dp_open()
        done = False
        try:
            yield
            done = True
        finally:
            self._dp_end(graceful=done)

    def close(self) -> None:
        """Stop the sharded plan's other ranks, which live from the first
        ``train()`` on, and collect their records into ``dp_rank_stats``.
        Their replay shards go with them: the trainer trains no more (save
        a checkpoint first to keep them).  A no-op at dp 1 and when the
        ranks never started."""
        ranks = self._ranks
        if ranks is None:
            return
        if self._dp_parked is not None and not ranks.failures():
            self._dp.wake(self._dp_parked)
            self._dp_parked = None
        self._stop_ranks(graceful=True)

    def _join_dp(self, group) -> None:
        """Take ``group`` as this rank's; ranks >= 1 reseed the learner's
        generator (AQL's NoisyNet draws, the fused plane's uniforms) from
        the run's seed and rank."""
        self._dp = group
        if group.rank != 0:
            self.generator.manual_seed(
                per_rank_seed(self.cfg.env.seed + 1, group.rank))
        self._make_sharded_fns()

    def _make_sharded_fns(self) -> None:
        """(Re)build this rank's sharded steps over the current core."""
        sl = self._sharded = ShardedLearner(self.core, self._dp)
        self._sl_fused = sl.make_fused_step()
        self._sl_train = sl.make_train_step()
        self._sl_ingest = sl.make_ingest()
        self._sl_batch = sl.make_batch_train()

    def _dp_send(self, op: str, per_rank=None, **fields) -> None:
        """Rank 0: one op to every other rank (``per_rank[r - 1]`` merged
        into rank r's message)."""
        if self._dp_parked is not None:
            raise RuntimeError(f"dp op {op!r} while the other ranks are "
                               f"parked")
        msgs = [None]
        for r in range(1, self.n_dp):
            msg = {"op": op, **fields}
            if per_rank is not None:
                msg.update(per_rank[r - 1])
            msgs.append(msg)
        self._dp.send_ops(msgs)
        self._dp_last_op = time.monotonic()

    def _dp_dispatch(self, op: str, payload=None, prios=None, remote=(),
                     n_trans: int = 0):
        """Rank 0's half of one sharded dispatch: the op, beta, the
        group's transition count and each rank's uniforms and chunk to the
        other ranks, then the same body here.  Returns the step's metrics
        (meaned over the ranks) or None."""
        if self._dp is None:
            raise RuntimeError("the dp ranks start with the first train()")
        beta = self._beta()
        offsets = self._uniforms.take() if op != "ingest" else None
        self._dp_send(op, beta=beta, n_trans=int(n_trans), per_rank=[
            {"offsets": None if offsets is None else offsets[r],
             "chunk": remote[r - 1] if remote else None}
            for r in range(1, self.n_dp)])
        return self._dp_body(op, payload, prios,
                             None if offsets is None else offsets[0], beta)

    def _dp_body(self, op: str, payload, prios, offsets, beta: float):
        """One rank's body of a sharded dispatch."""
        if op == "fused":
            self.train_state, self.replay_state, metrics = self._sl_fused(
                self.train_state, self.replay_state, payload, prios,
                offsets, beta)
            return metrics
        if op == "train":
            self.train_state, self.replay_state, metrics = self._sl_train(
                self.train_state, self.replay_state, offsets, beta)
            return metrics
        self.replay_state = self._sl_ingest(self.replay_state, payload,
                                            prios)
        return None

    def _dp_sync(self, counters: bool = False) -> None:
        """Rank 0: every rank takes this rank's train state, and with
        ``counters`` its ingest and step counts (a start or a restore)."""
        numbers = self._sharded.train_state_numbers(self.train_state)
        fields = {"numbers": numbers}
        if counters:
            fields["counters"] = {"ingested": self.ingested,
                                  "steps": self.steps_rate.total}
        self._dp_send("restore", **fields)
        self._sharded.sync_train_state_(self.train_state)

    def _apply_dp_counters(self, counters: dict) -> None:
        """A rank >= 1 takes rank 0's counters (:meth:`_dp_sync`)."""
        self.ingested = int(counters["ingested"])
        self.steps_rate.total = int(counters["steps"])

    def _follow(self) -> None:
        """A rank >= 1's loop: rank 0's ops until ``stop``; a ``park`` op
        waits on the store until rank 0 wakes it."""
        while True:
            msg = self._dp.recv_op()
            op = msg["op"]
            if op == "stop":
                return
            if op == "park":
                self._dp.park(msg["gen"], json.dumps(self._dp_stats()))
                continue
            self._follow_op(msg)

    def _follow_op(self, msg: dict) -> None:
        """One op of rank 0's on this rank (:meth:`_follow`)."""
        op = msg["op"]
        if op == "noop":
            return
        if op == "restore":
            self._sharded.sync_train_state_(self.train_state,
                                            msg["numbers"])
            if "counters" in msg:
                self._apply_dp_counters(msg["counters"])
            return
        if op == "apply_hparams":
            self.apply_hparams(msg["hparams"])
            return
        if op == "gather":
            gather_shards(self._dp, self.replay_state,
                          (self.generator.get_state(),))
            return
        if op == "scatter":
            gen = torch.empty_like(self.generator.get_state())
            scatter_shards(self._dp, self.replay_state, extra=(gen,),
                           numbers=msg["numbers"])
            self.generator.set_state(gen)
            return
        chunk = msg.get("chunk")
        if isinstance(chunk, bytes):
            chunk = wire.restricted_loads(chunk)
        if op == "batch":
            payload, weights = chunk
            dev = self.device
            self.train_state, _, _ = self._sl_batch(
                self.train_state,
                batch_from_wire({k: torch.as_tensor(v).to(dev)
                                 for k, v in payload.items()}), weights)
            self.service_steps += 1
            self.steps_rate.tick()
            return
        payload, prios = chunk if chunk is not None else (None, None)
        self._dp_body(op, payload, prios, msg.get("offsets"), msg["beta"])
        self.dispatches[op] += 1
        if op != "ingest":
            self.steps_rate.tick()

    def _dp_stats(self) -> dict:
        """This rank's record: its gather and tree launches, steps,
        dispatches, shard size, collective counters and the device's peak
        bytes."""
        dev = self._dp.device
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        return {"rank": self._dp.rank,
                "gather_launches": dict(LAUNCH_COUNTS),
                "tree_launches": dict(tree_ops.LAUNCH_COUNTS),
                "steps": self.steps_rate.total,
                "service_steps": self.service_steps,
                "dispatches": dict(self.dispatches),
                "replay_size": int(self.replay_state.size),
                "collectives": dict(self._dp.stats),
                "peak_bytes": int(peak)}

    # -- checkpoints of the sharded plan ------------------------------------

    def _dp_scatter_pending(self) -> None:
        """Rank 0: a restored checkpoint's rows 1..N-1 (shards and
        generators) to their ranks."""
        pending = self._dp_pending
        stacked = pending["replay"]
        self._dp_send("scatter", per_rank=[
            {"numbers": shard_numbers(stacked, self.replay_state, r)}
            for r in range(1, self.n_dp)])
        scatter_shards(self._dp, self.replay_state, stacked,
                       extra=(self.generator.get_state(),),
                       extra_stacked=(pending["generators"],))
        self._dp_pending = None

    def _sharded_bundle(self) -> dict:
        """The sharded learner's checkpoint: the train state once (it is
        replicated), the replay in JAX's stacked layout (every field
        ``[dp, ...]`` in rank order, the host numbers ``int64[dp]``), rank
        0's generator as ``generator`` and under ``dp`` every rank's
        generator state and the per-rank uniforms' generators and queue.
        The ranks' shards stream to the host here (no rank's replay is
        skipped: a trainer that lost them raises)."""
        base = self._bundle()
        if self._dp_gone is not None:
            raise RuntimeError(
                f"no checkpoint of a sharded trainer without its other "
                f"ranks' replay shards ({self._dp_gone})")
        own = self.generator.get_state()
        if self._ranks is not None or self._dp is not None:
            with self._dp_session():
                self._dp_send("gather")
                stacked, (gens,) = gather_shards(self._dp, self.replay_state,
                                                 (own,))
        elif self._dp_pending is not None:
            # restored, ranks not started: the file's rows are the shards
            stacked = self._dp_pending["replay"]
            gens = self._dp_pending["generators"].clone()
            gens[0] = own
        else:
            # never started: every rank holds a fresh shard and a
            # generator seeded from its rank
            stacked = tile_shard(self.replay_state, self.n_dp)
            seed = self.cfg.env.seed + 1
            gens = torch.stack([own] + [
                torch.Generator(device=self.device).manual_seed(
                    per_rank_seed(seed, r)).get_state()
                for r in range(1, self.n_dp)])
        return dict(train_state=base["train_state"], replay_state=stacked,
                    generator=own,
                    dp=dict(generators=gens, **self._uniforms.state()))

    def save_checkpoint(self) -> str:
        if self.n_dp == 1:
            return super().save_checkpoint()
        if self.checkpointer is None:
            raise ValueError("no checkpoint directory configured "
                             "(pass checkpoint_dir)")
        return self.checkpointer.save(self.steps_rate.total,
                                      self._sharded_bundle(),
                                      self._meta() | {"dp": self.n_dp})

    def restore(self, path: str | None = None):
        """At dp 1, :meth:`CheckpointableTrainer.restore`.  At dp > 1 a
        checkpoint of the same dp degree: the train state and rank 0's row
        of the stacked replay and generators here; the other rows go to
        their ranks when they start (or at once, when they live).  The
        file is read memory-mapped, so the other ranks' rows are never
        held in memory twice."""
        if self.n_dp == 1:
            return super().restore(path)
        path = self._checkpoint_path(path)
        raw, meta = load_raw(path, mmap=True)
        saved_dp = int(meta.get("dp", 1))
        if saved_dp != self.n_dp or "dp" not in raw:
            raise ValueError(f"checkpoint {path} holds a learner of dp "
                             f"{saved_dp}; this trainer's is {self.n_dp}")
        ts = self.train_state
        saved = _impose(self._bundle()["train_state"], raw["train_state"],
                        "train_state")
        _set_numbers(ts.opt_state, saved["opt_state"])
        ts.step = saved["step"]
        unstack_shard(self.replay_state, raw["replay_state"], 0)
        self.generator.set_state(raw["dp"]["generators"][0].clone())
        self._uniforms.set_state(raw["dp"])
        self._apply_counters(meta)
        self._dp_pending = {"replay": raw["replay_state"],
                            "generators": raw["dp"]["generators"]}
        if self._dp is not None:
            with self._dp_session():
                self._dp_sync(counters=True)
                self._dp_scatter_pending()
        return self

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
        client = self.replay_client
        target_steps = self.steps_rate.total + total_steps
        set_process_label("learner")
        ring = get_ring()
        setup = self._setup = obs_spans.SetupClock(ring=ring,
                                                   track=LEARNER_TRACK)
        steps0, ingested0 = self.steps_rate.total, self.ingested
        if self._obs is None:
            self._obs = obs_spans.LearnerObs(ring=ring)
        gap = self._dispatch_gap = DispatchGapTimer(ring=ring,
                                                    track=self.gap_track)
        if self.fleet is None:
            self.fleet = FleetRegistry(cfg.comms)
        pipeline = self._open_feed()
        try:
            if self.n_dp > 1:
                # the ranks first: a rank that cannot start fails train()
                # before any actor is spawned
                self._dp_open()
            self._start_pool()
        except BaseException:
            self._pipeline = None      # never started; publish serially
            self._dp_end(graceful=False)
            raise
        setup.stamp("pool_started")
        # a socket pool stamps its publishes with this life's epoch, so a
        # parked actor tells a restarted learner from a stalled one
        set_epoch = getattr(pool, "set_learner_epoch", None)
        if set_epoch is not None:
            set_epoch(self.learner_epoch)
        if client is not None:
            # pulls and write-backs carry it: the shards drop a dead
            # life's write-backs and forgive its outstanding batches
            client.learner_epoch = self.learner_epoch
        self._start_status_server()
        finished = False
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
            last_rank_check = last_publish
            while self.steps_rate.total < target_steps:
                now = time.monotonic()
                stop = self._stop_requested
                if now > t_end or (stop is not None and stop.is_set()):
                    break
                if self._ranks is not None and now - last_rank_check >= 0.5:
                    # a dead rank fails train() here, not in a collective
                    # that waits out its timeout
                    self._ranks.check()
                    last_rank_check = now
                m = self._iteration(target_steps)
                if m is not None:
                    metrics = m
                if setup.pending:
                    setup.observe(
                        ingested=self.ingested > ingested0,
                        warm=self.ingested >= cfg.replay.warmup,
                        stepped=self.steps_rate.total > steps0)

                steps = self.steps_rate.total
                # interval since the last save: a scan or fused dispatch
                # can step over any exact multiple
                if (self.checkpointer is not None
                        and steps - self._last_save
                        >= cfg.learner.save_interval):
                    self.save_checkpoint()
                    self._last_save = steps
                stale = now - last_publish > 10 * self.publish_min_seconds
                if steps:
                    due = (now - last_publish >= self.publish_min_seconds
                           and (steps - last_pub_step
                                >= cfg.learner.publish_interval or stale))
                else:
                    # before the first step only a socket pool republishes
                    # (apex.py:465-483): a SUB socket that joined after
                    # the first publish never sees it (the zmq slow
                    # joiner), and actors without params send no chunks.
                    # In-host queues exist before the first publish.
                    due = stale and getattr(pool, "needs_warmup_republish",
                                            False)
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
                    extra |= self._obs.scalars()
                    if client is not None:
                        extra |= {"service_batches": client.batches,
                                  "service_steps": self.service_steps,
                                  "service_ingested":
                                      client.ingested_total()}
                    self.log.scalars(
                        {k: float(v) for k, v in metrics.items()}
                        | {"bps": self.steps_rate.rate,
                           "fps": self.frames_rate.rate,
                           "param_version": self.param_version,
                           "ingested": self._ingested_effective()} | extra,
                        steps)
                    self._last_log = steps
                if (self._dp is not None
                        and now - self._dp_last_op >= DP_KEEPALIVE_S):
                    # the other ranks wait in a collective with a timeout
                    self._dp_send("noop")
            finished = True
        finally:
            if pipeline is not None:
                # stop staging before the pool's teardown: the staging
                # thread is the pool's only chunk consumer while it lives
                self._pipeline_last_stats = dict(pipeline.stats)
                pipeline.stop()
                self._pipeline = None
            if self._fleet_status is not None:
                self._fleet_status.stop()
                self._fleet_status = None
            self._dump_fleet_summary()      # the final registry view
            pool.cleanup()
            # the other ranks park until the next session (or stop, after
            # a failure)
            self._dp_end(graceful=finished)
            stop = self._stop_requested
            if stop is not None:
                stop.clear()       # a request is honoured once, at exit
        return self

    def _open_feed(self) -> IngestPipeline | None:
        """The feed of one :meth:`train` call, before the pool starts:
        with ``learner.ingest_pipeline`` the staging thread's pipeline
        (started once the pool is), else None, the serial drain."""
        if not self.cfg.learner.ingest_pipeline:
            return None
        self._pipeline = IngestPipeline(
            self.pool, device=self.device,
            depth=self.cfg.learner.pipeline_depth,
            scan_steps=self.scan_steps,
            merge_max=self.cfg.learner.pipeline_merge,
            state_fn=self._pipeline_state,
            capacity=self.replay.capacity,
            frame_capacity=getattr(self.replay, "f_capacity", None),
            replay_client=self.replay_client, n_dp=self.n_dp,
            uniforms=self._uniforms)
        self._pipeline_base = self.ingested
        return self._pipeline

    def _iteration(self, target_steps: int) -> dict | None:
        """One iteration's work of :meth:`train`: a slot from the staging
        thread, or the serial drain's pre-sampled batch and chunks, and
        failing those a train-only step when warm and under the ratio
        cap.  Returns the metrics of its last update, or None."""
        cfg = self.cfg
        pipeline, client = self._pipeline, self.replay_client
        # warm gates the learner's own pool; in service mode it fills only
        # through the actors' fallback chunks
        warm = self.ingested >= cfg.replay.warmup
        steps = self.steps_rate.total
        budget = self._budget()
        # replay-ratio floor: a learner behind stops draining so the
        # bounded chunk queue backpressures the actors; None while the
        # dead-fleet reaction has relaxed it
        floor = self._min_ratio_effective()
        behind = (warm and floor is not None
                  and steps * self.core.batch_size
                  < self._ingested_effective() * floor)
        got_data = False
        metrics = None
        if pipeline is not None:
            # service mode consumes while behind too: a batch slot is the
            # training a learner behind owes
            slot = None
            if not behind or client is not None:
                with span("apex.learner.poll", LEARNER_TRACK):
                    slot = pipeline.poll_slot(
                        timeout=0 if (warm or client is not None)
                        else 0.05)
            if slot is not None:
                got_data = True
                metrics = self._consume_slot(slot, warm, budget,
                                             target_steps)
        else:
            if client is not None and steps < budget:
                # serial service path: one pre-sampled batch per
                # iteration, its write-back sent inline
                with span("apex.learner.poll", LEARNER_TRACK):
                    item = client.poll_batch(timeout=0.02)
                if item is not None:
                    got_data = True
                    metrics = self._consume_batch_slot(
                        self._host_batch_slot(item))
            # scan dispatch: K chunks only when all K steps fit both the
            # ratio budget and the remaining total_steps
            want = 1
            if (self.scan_steps > 1 and warm
                    and target_steps - steps >= self.scan_steps
                    and steps + self.scan_steps - 1 < budget):
                want = self.scan_steps
            msgs = []
            if not behind:
                with span("apex.learner.poll", LEARNER_TRACK):
                    msgs = self.pool.poll_chunks(
                        want, timeout=0 if warm else 0.05)
            if msgs:
                got_data = True
                m = self._drain_serial(msgs, want, warm, budget)
                if m is not None:
                    metrics = m
        if not got_data and warm and steps < budget:
            gap = self._dispatch_gap
            gap.about_to_dispatch()
            with span("apex.learner.dispatch", LEARNER_TRACK):
                if self.n_dp > 1:
                    metrics = self._dp_dispatch("train")
                else:
                    self.train_state, self.replay_state, metrics = \
                        self.core.train_step(self.train_state,
                                             self.replay_state,
                                             self._offsets(), self._beta())
            gap.dispatch_returned()
            self.dispatches["train"] += 1
            self.steps_rate.tick()
        elif not got_data and warm:
            time.sleep(0.002)   # replay-ratio cap reached
        return metrics

    def _start_status_server(self) -> None:
        """A socket pool's learner serves registry snapshots
        (``--role status``) and the Prometheus text on its own REP socket
        and thread (``apex.py:541-565``).  A bind failure (two learners
        on one host) is printed and leaves the learner without a status
        surface, never dead."""
        if (not hasattr(self.pool, "peer_seen")
                or self._fleet_status is not None):
            return
        from apex_tpu_torch.fleet.registry import FleetStatusServer
        if self._ctl_queue is None:
            # built before the server's thread starts (its ctl hook runs
            # there); bounded, so a runaway controller parks 8 commands
            import queue as queue_lib
            self._ctl_queue = queue_lib.Queue(maxsize=8)
        try:
            self._fleet_status = FleetStatusServer(
                self.cfg.comms, self.fleet, metrics_fn=self._metrics_text,
                snapshot_fn=self.fleet_summary, ctl_fn=self._enqueue_ctl)
        except Exception as exc:
            print(f"fleet: no status server on port "
                  f"{self.cfg.comms.status_port} ({exc!r})", flush=True)
            return
        self._fleet_status.start()

    def _health_tick(self, steps: int) -> None:
        """One health tick (``apex.py:567-602``): respawn crashed workers
        on their slots, run the registry's machine (a socket pool's
        message arrivals count as liveness), log its transitions and
        ``fleet_*`` scalars, judge the SLOs, react to a dead actor fleet,
        apply the parked ctl commands and dump ``fleet_summary.json``."""
        pool = self.pool
        if hasattr(pool, "dead_workers"):
            for dead in pool.dead_workers():
                self.log.scalars({"worker_respawn": dead}, steps)
                pool.respawn_worker(dead)
        if hasattr(pool, "peer_seen"):
            self.fleet.observe_seen(pool.peer_seen())
        for ident, old, new in self.fleet.tick():
            self.log.scalars({f"fleet_{new.lower()}_transition": 1.0}, steps)
            if self.log.verbose or new in ("SUSPECT", "DEAD"):
                print(f"fleet: {ident} {old} -> {new}", flush=True)
        fm = self.fleet.metrics()
        if fm["peers"]:
            self.log.scalars(
                {"fleet_alive": fm["alive"], "fleet_suspect": fm["suspect"],
                 "fleet_dead": fm["dead"], "fleet_parked": fm["parked"],
                 "fleet_rejoins": fm["rejoins"]}, steps)
        # judge before reacting: the floor reaction reads the
        # actor-capacity alert this sample just advanced
        self._slo_tick(steps)
        self._react_to_fleet(steps)
        # the ctl commands apply here, on the trainer thread: the status
        # thread only enqueued them
        self._drain_ctl(steps)
        self._dump_fleet_summary()

    def _drain_stats(self, steps: int) -> None:
        """Heartbeats into the registry, the controllers' snapshots into
        their sections, timing stats into ``actor_timing`` and the scalar
        log, episode stats into the episode log; a keyframe request forces
        the pool's next publish dense.  Count the drops the stats carry
        (``apex.py:604-628``)."""
        for stat in self.pool.poll_stats():
            self.stat_drops += getattr(stat, "dropped_stats", 0)
            if isinstance(stat, Heartbeat):
                self.fleet.observe(stat)
            elif isinstance(stat, ServingStat):
                self.serving_state = dict(stat.snapshot)
            elif isinstance(stat, TenancyStat):
                self.tenancy_state = dict(stat.snapshot)
            elif isinstance(stat, PopulationStat):
                self.population_state = dict(stat.snapshot)
            elif isinstance(stat, KeyframeRequest):
                force = getattr(self.pool, "force_keyframe", None)
                if force is not None:
                    force()
            elif isinstance(stat, ActorTimingStat):
                self.actor_timing[stat.actor_id] = stat
                self.log.scalars(
                    {"actor_fps": stat.frames_per_sec,
                     "actor_policy_wait_frac": stat.policy_wait_frac,
                     "actor_env_step_frac": stat.env_step_frac,
                     "actor_drain_frac": stat.drain_frac,
                     "actor_dispatch_gap_ms_p50": stat.dispatch_gap_ms_p50},
                    steps)
            elif isinstance(stat, EpisodeStat):
                self._log_episode(stat)

    def _log_episode(self, stat: EpisodeStat) -> None:
        """One episode's stat into the episode log."""
        self.log.scalars({"episode_reward": stat.reward,
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

    # -- the fleet and obs planes (apex.py:672-979) ------------------------

    def latency_summary(self, between: tuple[float, float] | None = None
                        ) -> dict | None:
        """The chunk-lineage histograms (frame age at train,
        param-propagation lag, each hop pair's ``hops_s``: with
        ``between``, of the chunks consumed within those wall seconds
        only), the hot loop's dispatch-gap percentiles and, where
        :meth:`train` stamps them, its latest call's set-up durations
        (``setup_s``), or None before :meth:`train`."""
        if self._obs is None:
            return None
        out = self._obs.summary(between)
        out["dispatch_gap_ms"] = self._dispatch_gap.snapshot()
        if self._setup is not None:
            out["setup_s"] = self._setup.durations()
        return out

    def _metrics_text(self) -> str:
        """Prometheus text for the status server's ``b"metrics"`` request.
        Runs on the server thread: every read is a locked snapshot or a
        GIL-atomic tail read."""
        from apex_tpu_torch.obs import metrics as obs_metrics

        gauges = dict(obs_metrics.scalar_tails(self.log.history))
        gauges["learner_steps_per_sec"] = self.steps_rate.rate
        gauges["learner_frames_per_sec"] = self.frames_rate.rate
        counters = {
            "learner_steps_total": self.steps_rate.total,
            "transitions_ingested_total": self.ingested,
            "param_version": self.param_version,
            "stat_drops_total": self.stat_drops,
        }
        wire_fn = getattr(self.pool, "wire_summary", None)
        if callable(wire_fn):
            w = wire_fn()
            counters.update({
                "wire_codec_chunks": w.get("codec_chunks"),
                "wire_codec_rejected": w.get("codec_rejected"),
                "wire_param_publishes": w.get("param_publishes"),
                "wire_param_keyframes": w.get("param_keyframes"),
                "wire_param_deltas": w.get("param_deltas"),
                "wire_param_delta_bytes": w.get("param_delta_bytes"),
                "wire_param_bytes_out": w.get("param_bytes_out"),
                "wire_param_bytes_raw": w.get("param_bytes_raw"),
                "wire_keyframes_forced": w.get("keyframes_forced"),
            })
        labeled: dict = {}
        if self.fleet is not None:
            fleet_gauges, labeled = obs_metrics.render_fleet(
                self.fleet.snapshot())
            gauges.update(fleet_gauges)
        histograms = {}
        if self._obs is not None:
            s = self._obs.summary()
            histograms = {
                "frame_age_at_train_seconds": s["frame_age_at_train_s"],
                "param_propagation_lag_seconds":
                    s["param_propagation_lag_s"],
            }
            gauges.update({f"learner_{k}": v for k, v in
                           self._dispatch_gap.snapshot().items()})
        if self._slo is not None:
            from apex_tpu_torch.obs import slo as obs_slo
            slo_gauges, slo_labeled = obs_slo.prometheus_sections(
                self._slo.snapshot())
            gauges.update(slo_gauges)
            labeled.update(slo_labeled)
        # the controllers' row families: apex_serving_*, apex_tenancy_*,
        # apex_population_*
        for state, sections in (
                (self.serving_state, serving_deploy.prometheus_sections),
                (self.tenancy_state, tenancy_sched.prometheus_sections),
                (self.population_state, population_ctl.prometheus_sections)):
            if state is not None:
                more_gauges, more_labeled = sections(state)
                gauges.update(more_gauges)
                labeled.update(more_labeled)
        return obs_metrics.render(gauges=gauges, counters=counters,
                                  histograms=histograms, labeled=labeled)

    def _slo_signals(self) -> dict:
        """The signal space one engine sample judges: the sections
        :meth:`fleet_summary` publishes, so an objective's path reads the
        same off the live engine and the persisted JSON."""
        snap = self.fleet.snapshot()
        m = snap["metrics"]
        m["dead_actor_frac"] = round(
            self.fleet.dead_fraction(roles=("actor",)), 4)
        return {
            "peers": snap["peers"], "metrics": m,
            "latency": (self._obs.summary()
                        if self._obs is not None else {}),
            "rates": {"steps_per_s": self.steps_rate.rate,
                      "frames_per_s": self.frames_rate.rate},
            # the serving_rollbacks objective reads the controller's
            # reported machine
            "serving": self.serving_state or {},
        }

    def _slo_tick(self, steps: int) -> None:
        """One engine sample per health tick, on the trainer thread only
        (sampling per scrape would make the burn windows a function of
        scrape traffic).  Transitions print and land in the scalar log."""
        if self.fleet is None:
            return
        if self._slo is None:
            from apex_tpu_torch.obs.slo import SloEngine, default_slos
            self._slo = SloEngine(default_slos(
                actor_dead_thresh=self.cfg.comms.relax_floor_dead_frac))
        for tr in self._slo.sample(self._slo_signals()):
            print(f"slo: {tr['objective']} {tr['from']} -> {tr['to']} "
                  f"(value={tr['value']})", flush=True)
            self.log.scalars(
                {f"slo_{tr['to'].lower()}_transition": 1.0}, steps)

    def fleet_summary(self) -> dict | None:
        """Registry snapshot, the reaction's state, wire counters, rates,
        latency and SLO sections (``--role status``'s reply and
        ``fleet_summary.json``), or None before the first :meth:`train`."""
        if self.fleet is None:
            return None
        snap = self.fleet.snapshot()
        pool = self.pool
        m = snap["metrics"]
        rejected = getattr(pool, "wire_rejected", None)
        m["wire_rejected"] = rejected() if callable(rejected) else 0
        m["learner_epoch"] = self.learner_epoch
        m["param_version"] = self.param_version
        m["floor_relaxed"] = self._floor_relaxed
        m["floor_relaxes"] = self.floor_relaxes
        m["dead_actor_frac"] = round(
            self.fleet.dead_fraction(roles=("actor",)), 4)
        plane = self.actor_plane()
        m["actor_drain_frac"] = (plane["drain_frac"]
                                 if plane is not None else None)
        admitted = getattr(pool, "rejoin_admitted", None)
        m["barrier_admitted"] = admitted() if callable(admitted) else 0
        # the PBT controller's donor path, the hyperparameters applied live
        # and the applied ctl commands' record
        m["checkpoint_latest"] = (self.checkpointer.latest_path()
                                  if self.checkpointer is not None else None)
        if self.hparams_live:
            m["hparams_live"] = dict(self.hparams_live)
        if self._population_ctl is not None:
            m["population_ctl"] = dict(self._population_ctl)
        withheld = getattr(pool, "acks_withheld", None)
        m["acks_withheld"] = withheld() if callable(withheld) else 0
        wire_fn = getattr(pool, "wire_summary", None)
        if callable(wire_fn):
            m["wire"] = wire_fn()
        ondevice = getattr(pool, "ondevice_counters", None)
        if callable(ondevice):
            m["ondevice"] = ondevice()
        snap["steps"] = self.steps_rate.total
        snap["ingested"] = self.ingested
        snap["rates"] = {"steps_per_s": self.steps_rate.rate,
                         "frames_per_s": self.frames_rate.rate}
        lat = self.latency_summary()
        if lat is not None:
            snap["latency"] = lat
        if self._slo is not None:
            snap["slo"] = self._slo.snapshot()
        for key, state in (("serving", self.serving_state),
                           ("tenancy", self.tenancy_state),
                           ("population", self.population_state)):
            if state is not None:
                snap[key] = state
        client = self.replay_client
        if client is not None:
            m["replay_service"] = {
                "shards": client.n_shards,
                "batches_pulled": client.batches,
                "service_steps": self.service_steps,
                "ingested_total": client.ingested_total(),
                "prio_sent": client.prio_sent,
                "prio_dropped": client.prio_dropped,
                "rejected": client.rejected,
                "shard_status": client.shard_status(),
            }
        return snap

    def _dump_fleet_summary(self) -> None:
        """Write :meth:`fleet_summary` to ``<logdir>/fleet_summary.json``,
        atomically: the part of the control plane that outlives the
        learner.  A failed write is printed, never raised."""
        logdir = self.log.logdir
        if logdir is None or self.fleet is None:
            return
        import json
        import os
        path = os.path.join(logdir, "fleet_summary.json")
        try:
            os.makedirs(logdir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self.fleet_summary(), fh, indent=2)
            os.replace(tmp, path)
        except OSError as exc:
            print(f"fleet: fleet_summary.json not written ({exc!r})",
                  flush=True)

    def _min_ratio_effective(self) -> float | None:
        """The replay-ratio floor the loop enforces: ``min_train_ratio``,
        or None while the dead-fleet reaction has relaxed it."""
        return None if self._floor_relaxed else self.min_train_ratio

    def _react_to_fleet(self, steps: int) -> None:
        """Relax the replay-ratio floor while at least
        ``comms.relax_floor_dead_frac`` of the actors are DEAD (the
        survivors must not be throttled against a target the dead
        capacity was part of), and restore it as they rejoin.  A BREACHED
        ``actor_dead_frac`` SLO (the same threshold, flap-damped) holds
        the floor relaxed through a flap (``apex.py:939-979``)."""
        thresh = self.cfg.comms.relax_floor_dead_frac
        if (thresh is None or self.fleet is None
                or self.min_train_ratio is None):
            return
        frac = self.fleet.dead_fraction(roles=("actor",))
        slo_breached = (self._slo is not None
                        and self._slo.state_of("actor_dead_frac")
                        == "BREACHED")
        fire = frac >= thresh or slo_breached
        if not self._floor_relaxed and fire:
            self._floor_relaxed = True
            self.floor_relaxes += 1
            why = (f"{frac:.0%} of actor capacity DEAD" if frac >= thresh
                   else "actor-capacity SLO BREACHED")
            print(f"fleet reaction: {why} — relaxing the replay-ratio "
                  f"floor (min_train_ratio={self.min_train_ratio})",
                  flush=True)
        elif self._floor_relaxed and not fire:
            self._floor_relaxed = False
            print(f"fleet reaction: actor capacity back "
                  f"({frac:.0%} DEAD) — replay-ratio floor restored",
                  flush=True)
        self.log.scalars({"fleet_dead_actor_frac": frac,
                          "fleet_floor_relaxed":
                              float(self._floor_relaxed)}, steps)

    # -- the learner's ctl surface (apex.py:981-1150) ----------------------

    def _enqueue_ctl(self, cmd: dict) -> dict:
        """The status thread's half: enqueue only (learner state is
        touched by the trainer thread alone)."""
        import queue as queue_lib
        q = self._ctl_queue
        if q is None:
            return {"accepted": False, "error": "no ctl queue"}
        try:
            q.put_nowait(dict(cmd))
        except queue_lib.Full:
            return {"accepted": False, "error": "ctl queue full"}
        return {"accepted": True, "pending": q.qsize()}

    def _drain_ctl(self, steps: int) -> None:
        """The trainer thread's half: apply every parked command."""
        import queue as queue_lib
        q = self._ctl_queue
        if q is None:
            return
        while True:
            try:
                cmd = q.get_nowait()
            except queue_lib.Empty:
                return
            self._apply_ctl(cmd, steps)

    def _apply_ctl(self, cmd: dict, steps: int) -> None:
        """One PBT command.  ``exploit``: the donor checkpoint's weights
        (:meth:`restore_weights`, the epoch bumped), the fleet re-fenced on
        the new epoch, the explore half's hyperparameters and a publish;
        ``hparams``: the hyperparameters alone.  A failed copy is counted
        in the record and printed; the learner keeps training."""
        op = str(cmd.get("op") or "")
        rec = self._population_ctl or {"applied": 0, "exploits": 0,
                                       "explores": 0, "errors": 0}
        event: dict = {"op": op, "donor": cmd.get("donor"), "step": steps}
        if op == "exploit":
            import os
            path = str(cmd.get("restore_from") or "")
            if (path and not os.path.exists(path)
                    and os.path.isdir(os.path.dirname(path))):
                # the donor's Checkpointer keeps its newest few files and
                # the command waited up to one health tick: a pruned path
                # means a newer checkpoint of the same lineage exists
                newer = Checkpointer(os.path.dirname(path)).latest_path()
                if newer is not None:
                    path = newer
            try:
                self.restore_weights(path)
            except Exception as exc:
                rec["errors"] += 1
                event["error"] = f"{type(exc).__name__}: {exc}"
                rec["last"] = event
                self._population_ctl = rec
                print(f"population: exploit failed ({event['error']})",
                      flush=True)
                return
            rec["exploits"] += 1
            event["restored_from"] = path
            event["learner_epoch"] = self.learner_epoch
            # re-fence on the new epoch, then publish the copied weights:
            # actors and infer shards fence out the pre-copy life's
            # params, the replay shards its write-backs
            set_epoch = getattr(self.pool, "set_learner_epoch", None)
            if set_epoch is not None:
                set_epoch(self.learner_epoch)
            if self.replay_client is not None:
                self.replay_client.learner_epoch = self.learner_epoch
            applied = self.apply_hparams(cmd.get("hparams") or {})
            if applied or cmd.get("hparams"):
                rec["explores"] += 1
                event["applied"] = applied
            self._publish()
        elif op == "hparams":
            event["applied"] = self.apply_hparams(cmd.get("hparams") or {})
            rec["explores"] += 1
        else:
            rec["errors"] += 1
            event["error"] = f"unknown op {op!r}"
        rec["applied"] += 1
        rec["last"] = event
        self._population_ctl = rec
        print(f"population: applied {op} (donor="
              f"{cmd.get('donor') or '-'}, epoch={self.learner_epoch})",
              flush=True)
        self.log.scalars({"population_ctl_applied": rec["applied"]}, steps)

    def restore_weights(self, path: str) -> dict:
        """The PBT exploit's weight copy: impose the donor checkpoint's
        ``train_state`` (online and target weights, the optimizer's moments
        and counts, the step) onto this live learner, in place on its
        device; replay, the generator and the host counters stay as they
        are, and the learner epoch goes up by one, so the pre-copy life's
        params and write-backs are fenced out as a restart's would be.
        Returns the donor checkpoint's metadata."""
        from apex_tpu_torch.training.checkpoint import (_impose,
                                                        _set_numbers,
                                                        load_raw)
        raw, meta = load_raw(path)
        ts = self.train_state
        saved = _impose(self._bundle()["train_state"], raw["train_state"],
                        "train_state")
        _set_numbers(ts.opt_state, saved["opt_state"])
        ts.step = saved["step"]
        self.learner_epoch += 1
        if self._dp is not None:
            with self._dp_session():
                self._dp_sync()       # every rank takes the donor's state
        return meta

    def apply_hparams(self, h: dict) -> dict:
        """The live half of a lineage's hyperparameter vector
        (:data:`~apex_tpu_torch.population.lineage.LIVE_HPARAMS`): ``lr``
        swaps the optimizer's base rate (DQN core only, as in the
        reference), keeping its moments and count, so the StepLR decay
        already taken still holds; ``prio_beta`` moves the IS-weight
        anneal the next :meth:`_beta` reads.  Every field given is
        recorded in ``hparams_live``; the acting-side ones apply to the
        lineage's next workers.  Returns the fields applied live."""
        applied: dict = {}
        lr = h.get("lr")
        if lr is not None and type(self.core) is LearnerCore:
            self.core = dataclasses.replace(
                self.core, optimizer=dataclasses.replace(
                    self.core.optimizer, lr=float(lr)))
            self.cfg = self.cfg.replace(learner=dataclasses.replace(
                self.cfg.learner, lr=float(lr)))
            applied["lr"] = float(lr)
            if self._dp is not None:
                # the sharded steps closed over the old core
                self._make_sharded_fns()
        beta = h.get("prio_beta")
        if beta is not None:
            self.cfg = self.cfg.replace(replay=dataclasses.replace(
                self.cfg.replay, beta=float(beta)))
            applied["prio_beta"] = float(beta)
        recorded = {k: v for k, v in h.items() if v is not None}
        if recorded:
            self.hparams_live = {**(self.hparams_live or {}), **recorded}
        if self._dp is not None and self._dp.rank == 0:
            # every rank rebuilds its optimizer (apex.py:1118-1122)
            with self._dp_session():
                self._dp_send("apply_hparams", hparams=dict(h))
        return applied

    # -- dispatch ----------------------------------------------------------

    def _offsets(self, k: int | None = None,
                 b: int | None = None) -> torch.Tensor:
        """The PER sample's per-stratum uniforms, ``[b]`` or ``[k, b]``
        (``b`` defaults to the batch size)."""
        b = self.core.batch_size if b is None else b
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
        with span("apex.learner.dispatch", LEARNER_TRACK):
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

    def _dispatch_one(self, payload, prios, n_trans: int, train: bool,
                      remote=None):
        """The fused step (``train``) or ingest only, of one payload.  At
        dp > 1 the payload is a group (or, staged, rank 0's part of one
        with ``remote`` the others'), dispatched on every rank.  Returns
        the step's metrics or None."""
        gap = self._dispatch_gap
        metrics = None
        gap.about_to_dispatch()
        with span("apex.learner.dispatch", LEARNER_TRACK):
            if self.n_dp > 1:
                if remote is None:
                    parts = split_group(payload, prios, self.n_dp)
                    (payload, prios), remote = parts[0], parts[1:]
                metrics = self._dp_dispatch("fused" if train else "ingest",
                                            payload, prios, remote, n_trans)
                self.dispatches["fused" if train else "ingest"] += 1
                if train:
                    self.steps_rate.tick()
            elif train:
                self.train_state, self.replay_state, metrics = \
                    self.core.fused_step(
                        self.train_state, self.replay_state, payload, prios,
                        self._offsets(), self._beta())
                self.dispatches["fused"] += 1
                self.steps_rate.tick()
            else:
                self.replay_state = self.core.ingest(self.replay_state,
                                                     payload, prios)
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
        only.  The chunks' spans are stamped ``recv`` here (no staging
        thread: the poll is the receive), then ``consume``/``prio_wb``
        around each dispatch.  Returns the last metrics (device scalars)
        or None."""
        obs = self._obs
        if obs is not None:
            for m in msgs:
                obs_spans.stamp(m, "recv")
        metrics = None
        if want > 1 and len(msgs) > 1:
            j = _pow2_floor(len(msgs))
            take, msgs = msgs[:j], msgs[j:]
            spans = obs_spans.merge_spans(take) if obs is not None else ()
            if spans:
                obs.pre_consume(spans)
            metrics = self._dispatch_scan(
                [m["payload"] for m in take], [m["priorities"] for m in take],
                [int(m["n_trans"]) for m in take])
            if spans:
                obs.post_consume(spans)
        for msg in msgs:
            spans = obs_spans.spans_of(msg) if obs is not None else ()
            if spans:
                obs.pre_consume(spans)
            m = self._dispatch_one(
                msg["payload"], msg["priorities"], int(msg["n_trans"]),
                warm and self.steps_rate.total < budget)
            if spans:
                obs.post_consume(spans)
            if m is not None:
                metrics = m
        return metrics

    def consume(self, msgs: list[dict]):
        """Chunk messages brought by the caller, one at a time: the
        single-chunk half of the serial drain, under the current warm-up
        and replay-ratio state.  Returns the last step's metrics or None."""
        with self._dp_session():
            return self._drain_serial(
                msgs, 1, self.ingested >= self.cfg.replay.warmup,
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
        # service mode: the shards' ingest counts toward the ratio budget
        # (pulls are training), not toward the local warm-up
        client = self.replay_client
        client_tot = client.ingested_total() if client is not None else 0
        steps = self.steps_rate.total
        floor = self._min_ratio_effective()
        behind = (self.ingested >= cfg.replay.warmup and floor is not None
                  and steps * self.core.batch_size
                  < (self.ingested + client_tot) * floor)
        steps_at_front = steps + (0 if pipe is None
                                  else pipe.staged_train_steps())
        budget_ok = (self.train_ratio is None
                     or steps_at_front
                     < (effective + client_tot) * self.train_ratio
                     / self.core.batch_size)
        return PipelineState(
            behind=behind,
            train_eligible=effective >= cfg.replay.warmup and budget_ok,
            pull_eligible=budget_ok)

    def _consume_slot(self, slot, warm: bool, budget: float,
                      target_steps: int):
        """:meth:`_dispatch_slot` between the ``consume`` and ``prio_wb``
        stamps of the slot's spans, which feed the latency histograms."""
        obs = self._obs
        if obs is not None and slot.spans:
            obs.pre_consume(slot.spans)
        metrics = self._dispatch_slot(slot, warm, budget, target_steps)
        if obs is not None and slot.spans:
            obs.post_consume(slot.spans)
        return metrics

    def _dispatch_slot(self, slot, warm: bool, budget: float,
                       target_steps: int):
        """Dispatch one staged slot (``apex.py:1317-1390``), gated chunk
        for chunk as the serial drain gates: an eligible scan slot runs
        fused_multi_step, an eligible single the fused step, the rest is
        ingested.  Warm-up and the ratio cap are checked again here, so a
        stale staging prediction can only under-train.  A shard-sampled
        ``"batch"`` slot always trains: skipping it would leave its strict
        shard waiting on a write-back that never comes.  Returns metrics
        or None."""
        if slot.kind == "batch":
            return self._consume_batch_slot(slot)
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
                                  train,
                                  slot.remote if self.n_dp > 1 else None)

    # -- the replay service (apex.py:1219-1315) ----------------------------

    def _host_batch_slot(self, item: dict) -> StagedSlot:
        """The serial path's twin of the pipeline's batch slot: the pulled
        batch and its IS weights copied to the device here (at dp > 1 rank
        0's block of them, the other ranks' blocks pickled for the host
        group, :func:`~apex_tpu_torch.parallel.learner.split_batch`)."""
        dev = self.device
        spans = obs_spans.spans_of(item)
        obs_spans.stamp_spans(spans, "stage")
        batch, weights, remote = item["batch"], item["weights"], ()
        if self.n_dp > 1:
            blocks = split_batch(batch, weights, self.n_dp)
            (batch, weights), remote = blocks[0], tuple(
                wire.dumps(b) for b in blocks[1:])
        return StagedSlot(
            kind="batch",
            payload={k: torch.as_tensor(v).to(dev)
                     for k, v in batch.items()},
            prios=torch.as_tensor(np.asarray(weights, np.float32)).to(dev),
            n_trans=0, planned_steps=1, idx=np.asarray(item["idx"]),
            shard=int(item.get("shard", 0)), seq=int(item["seq"]),
            spans=tuple(spans), remote=remote)

    def _consume_batch_slot(self, slot: StagedSlot) -> dict:
        """Train on one shard-sampled batch (the update half of the fused
        step) and route its priorities to the shard: through the staging
        thread when the pipeline runs, which makes the device-to-host
        copy off this loop, else inline.  At dp > 1 each other rank gets
        its block of the batch under a ``batch`` op, every rank updates
        with the gradients meaned over the group, and the priorities come
        back ``[batch]`` in sample order (``apex.py:1221-1273``)."""
        gap = self._dispatch_gap
        gap.about_to_dispatch()
        with span("apex.learner.dispatch", LEARNER_TRACK):
            if self.n_dp > 1:
                self._dp_send("batch", per_rank=[{"chunk": blob}
                                                 for blob in slot.remote])
                self.train_state, prios, metrics = self._sl_batch(
                    self.train_state, batch_from_wire(slot.payload),
                    slot.prios)
            else:
                self.train_state, prios, metrics = \
                    self.core.update_from_batch(
                        self.train_state, batch_from_wire(slot.payload),
                        slot.prios)
        gap.dispatch_returned()
        self.steps_rate.tick()
        self.service_steps += 1
        if self._pipeline is not None:
            self._pipeline.write_back(slot.shard, slot.seq, slot.idx, prios)
        else:
            self.replay_client.push_priorities(
                slot.shard, slot.seq, slot.idx,
                prios.detach().cpu().numpy())
        return metrics

    # -- checkpointing (apex.py:1473-1489) ---------------------------------

    def _counters(self) -> dict:
        return dict(ingested=self.ingested, steps=self.steps_rate.total,
                    param_version=self.param_version,
                    learner_epoch=self.learner_epoch)

    def _apply_counters(self, meta: dict) -> None:
        self.ingested = meta["ingested"]
        self.steps_rate.total = meta["steps"]
        self.param_version = meta["param_version"]
        # restoring starts a new learner life: a socket pool stamps the
        # publishes with it, so parked actors see the restart
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
    ``respawn_workers`` runs the health tick every 5 s (crashed workers
    respawned, the fleet registry and SLOs judged); ``logdir``
    and ``verbose`` go to the :class:`MetricLogger`; ``checkpoint_dir``
    turns on the saves of :meth:`train` and names where
    :meth:`save_checkpoint` writes.  With ``learner.mesh_shape`` above 1
    :meth:`train` runs the sharded plan (module docstring) with
    ``dp_backend`` for the dp group: ``"nccl"`` needs a card per rank,
    ``"gloo"`` runs every rank on this trainer's device.
    """

    def __init__(self, config: ApexConfig | None = None, pool=None,
                 train_ratio: float | None = None,
                 device: str | torch.device = "cuda",
                 logdir: str | None = None, verbose: bool = False,
                 publish_min_seconds: float = 0.2,
                 min_train_ratio: float | None = None,
                 respawn_workers: bool = True,
                 checkpoint_dir: str | None = None,
                 dp_backend: str = "nccl"):
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
        self._init_sharded(dp_backend)

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
