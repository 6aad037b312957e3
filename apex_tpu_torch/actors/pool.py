"""In-host actor pool: worker processes feeding the learner's replay.

Counterpart of :mod:`apex_tpu.actors.pool` (reference ``BatchRecorder`` /
``Worker``, ``batchrecorder.py:79-152``):

* Each worker is a process with its own env(s), its own CPU copy of the
  model and a :class:`~apex_tpu_torch.replay.frame_chunks.FrameChunkBuilder`
  per env slot; transitions ship as fixed-shape frame chunks with
  priorities computed from the acting-time Q-values.
* Per-slot exploration ladder ``eps_base ** (1 + i/(N-1) * eps_alpha)``
  (``batchrecorder.py:121``).
* Workers run continuously; the learner drains a bounded chunk queue (the
  shared-memory ring of :mod:`apex_tpu_torch.native` when it builds, else
  ``multiprocessing.Queue``), so acting and learning overlap.
* Params are latest-wins and version-stamped: the learner puts
  ``(version, host params)`` on per-worker depth-2 queues and workers keep
  the newest, polled every ``update_interval`` env steps
  (``actor.py:97-103``).

Workers act on the CPU, as the JAX workers do
(``apex_tpu/actors/pool.py:21-25``): the pool starts them with the
``spawn`` method (the learner's process holds a CUDA context, which a
forked child must not inherit) and with ``CUDA_VISIBLE_DEVICES=""`` in
their environment, so no child can reach the card.  Each child gets ``OMP_NUM_THREADS`` =
:func:`worker_threads`, so N children do not oversubscribe the host's
cores with torch's default intra-op threads.

Left out against the JAX pool: heartbeats, observability spans and
tenancy identity.  Where the JAX workers take a PRNG key, these take a
``torch.Generator`` seeded from the slot's seed.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import queue as queue_lib
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from apex_tpu_torch.config import ApexConfig


def actor_epsilons(n: int, eps_base: float = 0.4,
                   eps_alpha: float = 7.0) -> np.ndarray:
    """The Ape-X per-actor exploration ladder (``batchrecorder.py:121``)."""
    if n == 1:
        return np.asarray([eps_base], np.float64)
    i = np.arange(n, dtype=np.float64)
    return eps_base ** (1.0 + i / (n - 1) * eps_alpha)


@dataclass
class EpisodeStat:
    actor_id: int
    reward: float
    length: int
    param_version: int = 0          # params the episode's last step acted on
    # stats the worker dropped on a full stat queue since its last
    # successful put (the loss is counted, not silent)
    dropped_stats: int = 0


@dataclass
class ActorTimingStat:
    """Where a vector worker's wall time went over its last
    ``ActorConfig.timing_interval`` vector steps, with its env frames/s."""

    actor_id: int                   # worker index (process), not env slot
    frames_per_sec: float           # env frames/s over the window
    policy_wait_frac: float         # policy forward, or waiting for it
    env_step_frac: float            # env.step + builder recording
    drain_frac: float               # chunk poll + queue put (backpressure)
    dispatch_gap_ms_p50: float      # host gap between policy calls
    vector_steps: int               # window length in vector steps
    double_buffer: bool             # mode the worker is running
    dropped_stats: int = 0          # as in EpisodeStat


def host_cores() -> int:
    """Cores this process may run on: the affinity mask, capped by a
    cgroup v2 CPU quota where one is set."""
    cores = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max", encoding="ascii") as f:
            quota, period = f.read().split()
        if quota != "max":
            cores = min(cores, max(1, int(quota) // int(period)))
    except (OSError, ValueError):
        pass
    return cores


def worker_threads(n_workers: int) -> int:
    """torch intra-op threads per worker: the host's cores shared by the
    workers and the learner's own process."""
    return max(1, host_cores() // (n_workers + 1))


class DQNWorkerFamily:
    """DQN acting and recording for :func:`worker_loop` (reference
    ``Worker.run``, ``batchrecorder.py:79-98``): epsilon-greedy over the
    builder's acting stack on a CPU copy of the model, frame chunks out."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seed: int,
                 chunk_transitions: int):
        from apex_tpu_torch.envs.registry import make_env, unstacked_env_spec
        from apex_tpu_torch.models.dueling import DuelingDQN, make_policy_fn
        from apex_tpu_torch.replay.frame_chunks import FrameChunkBuilder

        self.seed = seed
        self.env = make_env(cfg.env.env_id, cfg.env, seed=seed,
                            max_episode_steps=cfg.actor.max_episode_length)
        frame_shape, frame_dtype, frame_stack = unstacked_env_spec(
            self.env, cfg.env)
        self.model = DuelingDQN(
            **model_spec, generator=torch.Generator().manual_seed(seed)
        ).to("cpu").requires_grad_(False)
        self.policy = make_policy_fn(self.model)
        self.builder = FrameChunkBuilder(
            cfg.learner.n_steps, cfg.learner.gamma, frame_stack, frame_shape,
            chunk_transitions=chunk_transitions, frame_dtype=frame_dtype)

    def load_params(self, params) -> None:
        from apex_tpu_torch.models.dueling import load_host_params
        load_host_params(self.model, params)

    def begin_episode(self, obs) -> None:
        self.builder.begin_episode(obs)

    def step(self, epsilon: float, generator: torch.Generator):
        """One env step on the builder's acting stack; returns
        ``(next_obs, reward, terminated, truncated)``."""
        stack = self.builder.current_stack()
        actions, q = self.policy(torch.from_numpy(stack[None]), epsilon,
                                 generator)
        action = int(actions[0])
        next_obs, reward, term, trunc, _ = self.env.step(action)
        self.builder.add_step(action, float(reward), q[0].numpy(), next_obs,
                              bool(term), bool(trunc))
        return next_obs, float(reward), bool(term), bool(trunc)

    def poll_msgs(self) -> list[dict]:
        from apex_tpu_torch.replay.frame_chunks import drain_builder_chunks
        return drain_builder_chunks(self.builder)


def _latest_params(param_queue, version: int, family) -> int:
    """Drain the param queue, keep the last entry, load it into the
    family when it is newer than ``version``; returns the version held.
    An entry older than the one held is never loaded."""
    newest = None
    try:
        while True:
            newest = param_queue.get_nowait()
    except queue_lib.Empty:
        pass
    if newest is not None and newest[0] > version:
        version = newest[0]
        family.load_params(newest[1])
    return version


def _first_params(param_queue, stop_event, family) -> int | None:
    """Block until the first publish (interruptibly); returns its version,
    or None when the pool stopped first."""
    while not stop_event.is_set():
        try:
            version, params = param_queue.get(timeout=0.5)
        except queue_lib.Empty:
            continue
        family.load_params(params)
        return version
    return None


def worker_loop(actor_id: int, cfg: ApexConfig, family, chunk_queue,
                param_queue, stat_queue, stop_event, epsilon: float) -> None:
    """The scalar worker's lifecycle: interruptible wait for the first
    publish, latest-wins param polls every ``update_interval`` steps, the
    epsilon anneal, chunk shipping with backpressure, episode stats, clean
    shutdown."""
    generator = torch.Generator().manual_seed(family.seed)
    env = family.env
    version = _first_params(param_queue, stop_event, family)
    if version is None:
        env.close()
        return

    anneal = cfg.actor.eps_anneal_steps
    total_steps = 0

    def current_eps() -> float:
        if not anneal:
            return epsilon
        return epsilon + (1.0 - epsilon) * math.exp(-total_steps / anneal)

    steps_since_poll = 0
    family.begin_episode(env.reset(seed=family.seed)[0])
    ep_reward, ep_len = 0.0, 0
    dropped = 0
    while not stop_event.is_set():
        steps_since_poll += 1
        if steps_since_poll >= cfg.actor.update_interval:
            steps_since_poll = 0
            version = _latest_params(param_queue, version, family)
        _, reward, terminated, truncated = family.step(current_eps(),
                                                       generator)
        total_steps += 1
        ep_reward += reward
        ep_len += 1
        for msg in family.poll_msgs():
            chunk_queue.put(("chunk", actor_id, msg))    # blocks when full
        if terminated or truncated:
            try:
                stat_queue.put_nowait(EpisodeStat(
                    actor_id, ep_reward, ep_len, version,
                    dropped_stats=dropped))
                dropped = 0
            except queue_lib.Full:
                dropped += 1
            ep_reward, ep_len = 0.0, 0
            family.begin_episode(env.reset()[0])
    env.close()


def _worker_main(actor_id: int, cfg: ApexConfig, model_spec: dict,
                 chunk_queue, param_queue, stat_queue, stop_event,
                 epsilon: float, chunk_transitions: int) -> None:
    """Scalar worker process body."""
    family = DQNWorkerFamily(cfg, model_spec,
                             seed=cfg.env.seed + 1000 * (actor_id + 1),
                             chunk_transitions=chunk_transitions)
    worker_loop(actor_id, cfg, family, chunk_queue, param_queue, stat_queue,
                stop_event, epsilon)


class ActorPool:
    """Fan-out/fan-in around N continuously running actor workers
    (reference ``BatchRecorder``, ``batchrecorder.py:100-152``).

    Queues, the chunk plane and the processes are made by :meth:`start`
    and released by :meth:`cleanup`, so a pool that is never started
    holds no shared-memory segment.  ``chunk_plane`` says which transport
    the last start took (``"shm"`` or ``"mp.Queue"``).
    """

    def __init__(self, cfg: ApexConfig, model_spec: dict,
                 chunk_transitions: int, chunk_queue_depth: int = 64,
                 worker_fn=None, shm_slot_bytes: int | None = None):
        self.cfg = cfg
        self.model_spec = model_spec
        self.chunk_transitions = chunk_transitions
        self.chunk_queue_depth = chunk_queue_depth
        self.shm_slot_bytes = shm_slot_bytes
        n = cfg.actor.n_actors
        if cfg.actor.n_envs_per_actor > 1:
            if worker_fn is not None and not getattr(worker_fn, "is_vector",
                                                     False):
                # a scalar body would run a 1/B-rate fleet with the wrong
                # exploration spectrum
                raise ValueError(
                    "n_envs_per_actor > 1 requires a vectorized worker body "
                    f"(vector_worker_main); got "
                    f"{getattr(worker_fn, '__name__', worker_fn)}")
            if worker_fn is None:
                from apex_tpu_torch.actors.vector import vector_worker_main
                worker_fn = vector_worker_main
        self._worker_fn = worker_fn or _worker_main
        self._ctx = mp.get_context("spawn")
        self.threads = worker_threads(n)
        self.chunk_plane: str | None = None
        self.procs: list = []
        self._started = False
        # publishes (from the learner or its staging thread) and the
        # respawn's handover of the newest params queue under one lock, so
        # a respawned worker is never handed a version older than a publish
        self._param_lock = threading.Lock()
        self._last_params: tuple | None = None
        self.worker_deaths = 0          # cumulative respawn count
        # a slot that keeps dying is a systemic fault (bad env, import
        # error in the child): respawns are rate-limited per slot, the
        # window anchored at the slot's last respawn
        self.max_respawns_per_slot = 5
        self.respawn_window_s = 600.0
        self._slot_respawns = [0] * n
        self._slot_last_respawn = [0.0] * n

    def _make_chunk_queue(self):
        """The native shared-memory ring when it builds, else
        ``multiprocessing.Queue``; the same bounded backpressure."""
        from apex_tpu_torch import native
        depth = self.chunk_queue_depth
        if self.cfg.actor.shm_data_plane and native.shm_available():
            from apex_tpu_torch.native.ring import (ShmChunkQueue,
                                                    ShmRingError,
                                                    segment_name)
            slot = (self.cfg.actor.shm_slot_bytes or self.shm_slot_bytes
                    or 4 * 1024 * 1024)
            try:
                return ShmChunkQueue(segment_name(), slot_bytes=slot,
                                     depth=depth), "shm"
            except ShmRingError:
                pass          # /dev/shm full or not writable: host queue
        return self._ctx.Queue(maxsize=depth), "mp.Queue"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Make the queues and the chunk plane and spawn the workers."""
        n = self.cfg.actor.n_actors
        ctx = self._ctx
        self.chunk_queue, self.chunk_plane = self._make_chunk_queue()
        self.stat_queue = ctx.Queue(maxsize=1024)
        self.param_queues = [ctx.Queue(maxsize=2) for _ in range(n)]
        self.stop_event = ctx.Event()
        eps = actor_epsilons(n, self.cfg.actor.eps_base,
                             self.cfg.actor.eps_alpha)
        self._worker_args = [
            (i, self.cfg, self.model_spec, self.chunk_queue,
             self.param_queues[i], self.stat_queue, self.stop_event,
             float(eps[i]), self.chunk_transitions)
            for i in range(n)]
        self.procs = [self._process(i) for i in range(n)]
        self._started = True
        try:
            self._spawn(self.procs)
        except BaseException:
            self.cleanup()         # the workers already started, the ring
            raise

    def _process(self, i: int):
        return self._ctx.Process(target=self._worker_fn,
                                 args=self._worker_args[i], daemon=True)

    def _spawn(self, procs) -> None:
        """Start ``procs`` with no CUDA device visible and
        :attr:`threads` intra-op threads: the child inherits the
        environment its interpreter boots with."""
        env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": str(self.threads)}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    # -- failure detection -------------------------------------------------

    def _refresh_budget(self, i: int) -> None:
        """A full window since the slot's last respawn restores its
        respawn budget."""
        if (self._slot_respawns[i]
                and time.monotonic() - self._slot_last_respawn[i]
                > self.respawn_window_s):
            self._slot_respawns[i] = 0

    def dead_workers(self) -> list[int]:
        """Slots whose worker exited while the pool is live and that may
        still be respawned."""
        if not self._started or self.stop_event.is_set():
            return []
        out = []
        for i, p in enumerate(self.procs):
            if p.is_alive():
                continue
            self._refresh_budget(i)
            if self._slot_respawns[i] < self.max_respawns_per_slot:
                out.append(i)
        return out

    def respawn_worker(self, i: int) -> bool:
        """Replace a dead worker with a fresh process on the same slot
        (same actor id, epsilon and seed) and hand it the newest params.
        Returns False while the slot's respawn budget is spent."""
        old = self.procs[i]
        if old.is_alive():
            return True
        self._refresh_budget(i)
        if self._slot_respawns[i] >= self.max_respawns_per_slot:
            return False
        old.join(timeout=0)            # reap the zombie
        self.procs[i] = self._process(i)
        self._spawn([self.procs[i]])
        self.worker_deaths += 1
        self._slot_respawns[i] += 1
        self._slot_last_respawn[i] = time.monotonic()
        if self._slot_respawns[i] >= self.max_respawns_per_slot:
            print(f"apex_tpu_torch: actor slot {i} died "
                  f"{self._slot_respawns[i]}x within "
                  f"{self.respawn_window_s:.0f}s; pausing its respawns, "
                  f"running with a reduced fleet", flush=True)
        with self._param_lock:
            if self._last_params is not None:
                self._put_latest(self.param_queues[i], *self._last_params)
        return True

    def cleanup(self, grace_seconds: float = 10.0) -> None:
        """Stop the workers and release the queues and the segment
        (reference ``BatchRecorder.cleanup``, ``batchrecorder.py:148-152``).

        The chunk and stat queues are drained while joining: a worker can
        be blocked in a chunk ``put`` on a full queue, or exiting behind
        its stat queue's feeder thread, until the learner reads.  Workers
        still alive after the grace window are terminated."""
        if not self._started:
            return
        self.stop_event.set()
        deadline = time.monotonic() + grace_seconds
        pending = [p for p in self.procs if p.pid is not None]   # started
        while pending and time.monotonic() < deadline:
            for q in (self.chunk_queue, self.stat_queue):
                try:
                    while True:
                        q.get_nowait()
                except queue_lib.Empty:
                    pass
            for p in pending:
                p.join(timeout=0.05)
            pending = [p for p in pending if p.is_alive()]
        for p in pending:
            p.terminate()
            p.join(timeout=5)
        # a dead child never drains its pipe: detach the feeder threads
        # so the parent's exit does not wait on them
        for q in (self.chunk_queue, self.stat_queue, *self.param_queues):
            q.cancel_join_thread()
            q.close()
        self._started = False

    # -- data and param planes ---------------------------------------------

    def publish_params(self, version: int, params: Any) -> None:
        """Latest-wins broadcast of host params (reference
        ``set_worker_weights``, ``batchrecorder.py:140-146``); safe to call
        from another thread than :meth:`respawn_worker`."""
        with self._param_lock:
            self._last_params = (version, params)
            for q in self.param_queues:
                self._put_latest(q, version, params)

    @staticmethod
    def _put_latest(q, version: int, params: Any) -> None:
        while True:      # drop the stalest entry while the queue is full
            try:
                q.put_nowait((version, params))
                return
            except queue_lib.Full:
                try:
                    q.get_nowait()
                except queue_lib.Empty:
                    pass

    def poll_chunks(self, max_chunks: int, timeout: float = 0.0) -> list:
        """Up to ``max_chunks`` chunk messages."""
        out = []
        for _ in range(max_chunks):
            try:
                msg = (self.chunk_queue.get(timeout=timeout) if timeout
                       else self.chunk_queue.get_nowait())
            except queue_lib.Empty:
                break
            out.append(msg[2])
        return out

    def poll_stats(self) -> list:
        out = []
        try:
            while True:
                out.append(self.stat_queue.get_nowait())
        except queue_lib.Empty:
            pass
        return out
