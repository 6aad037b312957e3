"""Process roles of the multi-host topology (reference L6 role scripts).

Counterpart of :mod:`apex_tpu.runtime.roles`.  The reference runs its
roles as scripts (``origin_repo/{learner,actor,eval}.py``) wired by env
vars (``actor.py:18-25``):

* :func:`run_learner` -- :class:`~apex_tpu_torch.training.apex.ApexTrainer`,
  :class:`~apex_tpu_torch.training.aql.AQLApexTrainer` or
  :class:`~apex_tpu_torch.training.r2d2.R2D2ApexTrainer` on the card over
  a socket :class:`~apex_tpu_torch.runtime.transport.RemotePool`: the
  same learner loop, with chunks arriving over TCP instead of the shm
  ring.  For the DQN family, ``rollout="ondevice"`` adds the on-device
  rollout engine beside the socket fleet, ``rollout="fused"`` runs the
  fused trainer serving it, and ``comms.replay_shards > 0`` pulls batches
  from replay shards (:mod:`apex_tpu_torch.replay_service`).
* :func:`run_actor` -- the same worker bodies as the in-host pool
  (:mod:`apex_tpu_torch.actors`), acting on the CPU, with the queues
  swapped for socket adapters: SUB (CONFLATE) params, DEALER chunks with
  the credit window (hashed over the replay shards when there are any),
  stats on the learner's socket.  ``ActorConfig.remote_policy`` sends the
  DQN policy calls to the infer server (:mod:`apex_tpu_torch.infer_service`).
* :func:`run_evaluator` -- greedy episodes on the unclipped env, params
  refreshed once per episode (``origin_repo/eval.py:49-87``); scores go
  to the learner's log as stats with a negative ``actor_id``.
* :func:`run_loadgen` -- the on-device rollout engine as a standalone
  traffic source for the chunk plane.

The replay shards and the infer servers have their own entry points,
:func:`~apex_tpu_torch.replay_service.service.run_replay_shard` and
:func:`~apex_tpu_torch.infer_service.service.run_infer_server`.  Each
role takes the shared :class:`~apex_tpu_torch.config.ApexConfig` and its
:class:`~apex_tpu_torch.config.RoleIdentity`.

The fleet and observability hooks of the JAX roles
(``apex_tpu/runtime/roles.py:308, 421-486, 516, 550-642``): under
``CHAOS_SEED`` the actor, loadgen and evaluator senders run their
identity's seeded schedule (:func:`~apex_tpu_torch.fleet.chaos.
maybe_wrap_sender`), each chunk is stamped ``send``
(:func:`~apex_tpu_torch.obs.spans.mark_send`), each process labels its
trace ring by its identity, and the evaluator records its episodes there
and applies the chaos score bias.  Under ``APEX_TENANT`` every role's
wire identity is tenant-qualified (:func:`apex_tpu_torch.tenancy.
namespace.qualify`): two tenants' ``actor-0`` never collide on a shared
ROUTER, and the tenant prefix partitions their chunk ids.  The default
tenant qualifies to the bare name.
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib
import threading
import uuid
from collections import deque

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.config import ApexConfig, CommsConfig, RoleIdentity
from apex_tpu_torch.fleet.chaos import chaos_from_env, maybe_wrap_sender
from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
from apex_tpu_torch.obs import spans as obs_spans
from apex_tpu_torch.obs.trace import get_ring, set_process_label
from apex_tpu_torch.runtime import transport
from apex_tpu_torch.runtime.codec import KeyframeRequest
from apex_tpu_torch.tenancy import namespace as tenancy_ns

FAMILIES = ("dqn", "aql", "r2d2")


# -- socket adapters with the mp.Queue interface ---------------------------

class _Beats:
    """The socket role's heartbeat, fed by its queue adapters: the chunk
    adapter ticks it with each chunk's transitions, and both adapters ask
    it for a beat at most every ``comms.heartbeat_interval_s``, so beats
    flow while the worker waits for its first params and while it acts.
    (The JAX worker bodies beat themselves; the port's leave that to the
    role that owns the socket.)"""

    def __init__(self, emitter: HeartbeatEmitter, sender):
        self.emitter = emitter
        self.sender = sender
        self.version = 0            # params the worker holds

    def maybe_send(self) -> None:
        hb = self.emitter.maybe_beat(self.version)
        if hb is not None:
            self.sender.send_stat(hb)


class _ParamQueueAdapter:
    """:class:`~apex_tpu_torch.runtime.transport.ParamSubscriber` as the
    worker body's param queue.  The CONFLATE socket holds at most the
    newest message, so the body's drain-to-latest loop ends after one hit.

    With a :class:`~apex_tpu_torch.fleet.park.ParkController`, a stale
    param stream PARKS the worker here (blocked inside its routine poll,
    env and chunk-builder state intact) until the rejoin race reattaches
    it."""

    def __init__(self, sub: transport.ParamSubscriber, park=None,
                 beats: _Beats | None = None):
        self.sub = sub
        self.park = park
        self.beats = beats

    def _got(self, got):
        if self.beats is not None:
            self.beats.maybe_send()
        if got is None:
            if self.park is not None and self.park.stale():
                got = self.park.park_and_rejoin(self.sub)
                if got is not None:
                    self.park.take_pending()    # consumed here, not twice
            if got is None:
                raise queue_lib.Empty
        elif self.park is not None:
            self.park.note_params()
        return self._held(got)

    def _held(self, got):
        if self.beats is not None:
            self.beats.version = int(got[0])
        return got

    def get(self, timeout: float = 0.5):
        pending = self.park.take_pending() if self.park is not None else None
        if pending is not None:
            return self._held(pending)
        return self._got(self.sub.poll(int(timeout * 1000)))

    def get_nowait(self):
        return self.get(timeout=0.0)

    def park_state(self):
        """HeartbeatEmitter ``park_fn`` hook: (parked, rejoins)."""
        if self.park is None:
            return (False, 0)
        return self.park.park_state()


class _ChunkQueueAdapter:
    """:class:`~apex_tpu_torch.runtime.transport.ChunkSender` as the
    worker body's chunk queue; ``put`` blocks on the ack-credit window as
    a bounded queue blocks on depth.

    With a park controller, a WEDGED send (no credit for a second) probes
    the param stream: a live learner that backpressures keeps publishing
    and the send keeps waiting; a dead one parks the worker here, and the
    rejoin resets the credit window before this chunk goes again."""

    def __init__(self, sender: transport.ChunkSender, stop_event,
                 park=None, beats: _Beats | None = None):
        self.sender = sender
        self.stop_event = stop_event
        self.park = park
        self.beats = beats
        self._gauges: list = []     # the worker body's own gauge sources

    def add_gauges(self, fn) -> None:
        """A worker body adds its own heartbeat gauges (the infer client's
        remote-policy counters)."""
        self._gauges.append(fn)

    def put(self, item) -> None:
        _kind, _actor_id, msg = item
        self._send(msg)
        if self.beats is not None:
            self.beats.emitter.tick(int(msg["n_trans"]))
            self.beats.maybe_send()

    def _send(self, msg) -> None:
        if self.park is None:
            self.sender.send_chunk(msg, self.stop_event)
            return
        while not self.stop_event.is_set():
            if self.sender.send_chunk(msg, self.stop_event, max_wait_s=1.0):
                return
            # no credit for a second: count the retry (the chunk never hit
            # the wire, so retrying loses nothing), then let the park
            # controller probe the param stream; it parks only when that
            # is stale too
            self.sender.note_resend()
            self.park.park_and_rejoin()

    def wire_counters(self) -> dict:
        """HeartbeatEmitter ``counters_fn`` hook."""
        return {"chunks_sent": self.sender.chunks_sent,
                "acks_received": self.sender.acks_received,
                "resends": self.sender.resends}

    def wire_gauges(self) -> dict:
        """HeartbeatEmitter ``gauges_fn`` hook: the sender's codec byte
        counters and realised compression ratio, and the gauges the
        worker body added."""
        out = dict(self.sender.wire_gauges())
        for fn in self._gauges:
            out.update(fn())
        return out


class _StatQueueAdapter:
    def __init__(self, sender: transport.ChunkSender):
        self.sender = sender

    def put_nowait(self, stat) -> None:
        self.sender.send_stat(stat)


# -- roles -----------------------------------------------------------------

def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}: expected one of "
                         f"{FAMILIES}")


def run_learner(cfg: ApexConfig, n_peers: int, total_steps: int,
                max_seconds: float = 3600.0, family: str = "dqn",
                logdir: str | None = None, verbose: bool = False,
                checkpoint_dir: str | None = None, train_ratio=None,
                min_train_ratio=None, queue_depth: int = 64,
                barrier_timeout_s: float = 120.0, restore: bool = False,
                rollout: str = "host", device: str | torch.device = "cuda",
                publish_min_seconds: float = 0.2, log_every: int = 200,
                rollout_len: int | None = None,
                steps_per_dispatch: int = 4, stop_event=None,
                dp_backend: str = "nccl"):
    """Learner role: barrier, publish, then the concurrent learner loop
    over socket-delivered chunks.  ``n_peers`` = actors + evaluators
    expected at the startup barrier (``learner.py:48-49``).  Returns the
    trainer (weights, counters, metric history).

    ``device`` defaults to the card and raises without one unless
    ``"cpu"`` is asked for.  ``publish_min_seconds`` is the trainer's
    publish floor; before the first step it republishes every ten of
    them, for actors whose SUB socket joined late.  ``log_every``: learner
    steps between metric logs.

    ``rollout`` (the DQN family): ``"ondevice"`` wraps the socket pool in
    an :class:`~apex_tpu_torch.training.anakin.AnakinPool`, whose engine
    acts on the card beside the socket fleet (``rollout_len`` env steps
    per dispatch); ``"fused"`` runs a
    :class:`~apex_tpu_torch.ondevice.fused.FusedApexTrainer` that serves
    the socket pool (``steps_per_dispatch`` macro steps per dispatch) and
    owns replay, so it refuses ``replay_shards > 0``.  With
    ``comms.replay_shards > 0`` the trainer samples from the replay shards
    through a :class:`~apex_tpu_torch.replay_service.client.
    ReplayServiceClient`; the chunk socket stays bound for stats,
    heartbeats and the actors' fallback chunks.

    ``stop_event``: setting it makes ``train()`` return at its next loop
    iteration (the CLI sets it on SIGTERM, so the role exits 0).

    With ``learner.mesh_shape`` above 1 this process is rank 0 of the
    sharded learner, on every rollout and with the replay shards alike:
    its ``train()`` spawns the other ranks (``dp_backend`` for the dp
    group), which stop when it returns (the trainer is closed).  The
    trainer refuses a batch (or, fused, an env fleet) the dp degree does
    not divide, when it is built."""
    if rollout not in ("host", "ondevice", "fused"):
        raise ValueError(f"unknown rollout {rollout!r}")
    _check_family(family)
    shards = cfg.comms.replay_shards
    if family != "dqn" and (rollout != "host" or shards > 0):
        what = f"--rollout {rollout}" if rollout != "host" else \
            "--replay-shards"
        raise NotImplementedError(
            f"{what} serves the dqn family only (got {family!r}); aql/r2d2 "
            f"keep host rollouts and replay in the learner")
    if rollout == "fused" and shards > 0:
        raise ValueError(
            "--rollout fused owns replay on the card: run with "
            "--replay-shards 0 (APEX_REPLAY_SHARDS=0); the shards serve "
            "the host topologies")
    if rollout != "host":
        # an env without a device port refuses, naming its id, before any
        # socket binds
        from apex_tpu_torch.envs.device_envs import make_device_env
        make_device_env(cfg.env.env_id, cfg.env, device="cpu")
    device = resolve_device(device)
    pool = transport.RemotePool(cfg.comms, n_peers, queue_depth=queue_depth,
                                barrier_timeout_s=barrier_timeout_s)
    client = None
    try:
        kw = dict(device=device, logdir=logdir, verbose=verbose,
                  checkpoint_dir=checkpoint_dir, train_ratio=train_ratio,
                  min_train_ratio=min_train_ratio,
                  publish_min_seconds=publish_min_seconds)
        if rollout == "fused":
            from apex_tpu_torch.ondevice.fused import FusedApexTrainer as cls
            kw |= dict(rollout_len=rollout_len,
                       steps_per_dispatch=steps_per_dispatch)
        elif family == "dqn":
            from apex_tpu_torch.training.apex import ApexTrainer as cls
            if rollout == "ondevice":
                from apex_tpu_torch.training.anakin import (
                    AnakinPool, make_anakin_engine)
                pool = AnakinPool(cfg, make_anakin_engine(
                    cfg, rollout_len=rollout_len, device=device), inner=pool)
        elif family == "aql":
            from apex_tpu_torch.training.aql import AQLApexTrainer as cls
        else:
            from apex_tpu_torch.training.r2d2 import R2D2ApexTrainer as cls
        kw["dp_backend"] = dp_backend
        trainer = cls(cfg, pool=pool, **kw)
        if stop_event is not None:
            trainer._stop_requested = stop_event
        if restore:
            trainer.restore()        # newest checkpoint in checkpoint_dir
        if shards > 0:
            from apex_tpu_torch.replay_service.client import (
                ReplayServiceClient)
            client = trainer.replay_client = ReplayServiceClient(cfg.comms)
    except BaseException:
        # the pool binds its ROUTER at construction: unwind it when the
        # trainer never gets to train(), whose finally would
        pool.cleanup()
        raise
    try:
        return trainer.train(total_steps=total_steps,
                             max_seconds=max_seconds, log_every=log_every)
    finally:
        trainer.close()          # the sharded plan's other ranks
        if client is not None:
            client.close()


def _join_fleet(comms: CommsConfig, name: str, stop_event,
                timeout_s: float) -> transport.ParamSubscriber | None:
    """The actor's and the evaluator's fleet join: connect the param SUB
    first, then race the one-shot startup barrier against the param stream
    (:func:`~apex_tpu_torch.runtime.transport.barrier_wait`): a fresh fleet
    is released by the barrier, a restarted peer by the first republish.
    Returns the connected subscriber, or None when ``stop_event`` was set
    first; raises (and closes it) when neither signal comes."""
    sub = transport.ParamSubscriber(comms)
    if not transport.barrier_wait(comms, name, stop_event=stop_event,
                                  timeout_s=timeout_s, rejoin_sub=sub):
        sub.close()
        if stop_event.is_set():
            return None
        raise TimeoutError(f"{name}: startup barrier timed out and no "
                           f"params flowing (learner not running)")
    return sub


def _actor_body(cfg: ApexConfig, family: str, n_actors: int):
    """``(cfg, worker_fn, model_spec, chunk_arg)`` of one actor role: the
    in-host pool's worker bodies and the learners' own spec helpers
    (``dqn_env_specs``, ``aql_env_specs``, ``r2d2_env_specs``), so actor
    and learner cannot drift.  A vector body re-derives its slots'
    epsilons from the ladder over ``cfg.actor.n_actors`` x
    ``n_envs_per_actor``, so the config takes the fleet's size from the
    identity."""
    # remote policy lives on the vector family's half-groups, so it takes
    # the vector body even at B = 1
    vector = cfg.actor.n_envs_per_actor > 1 or (
        family == "dqn" and cfg.actor.remote_policy)
    if vector:
        cfg = cfg.replace(actor=dataclasses.replace(cfg.actor,
                                                    n_actors=n_actors))
    chunk_arg = cfg.actor.send_interval
    if family == "dqn":
        from apex_tpu_torch.actors.pool import _worker_main
        from apex_tpu_torch.actors.vector import vector_worker_main
        from apex_tpu_torch.training.apex import dqn_env_specs
        spec = dqn_env_specs(cfg)[0]
        worker = vector_worker_main if vector else _worker_main
    elif family == "aql":
        from apex_tpu_torch.actors.aql import (aql_worker_main,
                                               vector_aql_worker_main)
        from apex_tpu_torch.training.aql import aql_env_specs
        spec = aql_env_specs(cfg)[0]
        worker = vector_aql_worker_main if vector else aql_worker_main
    else:
        from apex_tpu_torch.actors.r2d2 import (r2d2_worker_main,
                                                vector_r2d2_worker_main)
        from apex_tpu_torch.training.r2d2 import r2d2_env_specs
        # single frames (the LSTM is the memory); the sequence group per
        # message is the one shared cfg.r2d2 constant
        cfg = cfg.replace(env=dataclasses.replace(cfg.env, frame_stack=1))
        spec = r2d2_env_specs(cfg)[0]
        worker = vector_r2d2_worker_main if vector else r2d2_worker_main
        chunk_arg = cfg.r2d2.sequence_group
    return cfg, worker, spec, chunk_arg


def run_actor(cfg: ApexConfig, identity: RoleIdentity,
              family: str = "dqn", stop_event=None,
              barrier_timeout_s: float = 120.0) -> None:
    """Actor role: barrier, SUB params, explore, DEALER chunks, until
    ``stop_event`` is set.  Acts on the CPU, as the in-host pool's workers
    do, or through the infer server with ``cfg.actor.remote_policy`` (DQN).
    Epsilon comes from the fleet-wide ladder position (``actor.py:69``):
    ``eps_base ** (1 + id/(N-1) * eps_alpha)`` over the identity's
    ``n_actors``."""
    from apex_tpu_torch.actors.pool import actor_epsilons
    from apex_tpu_torch.fleet.park import ParkController

    _check_family(family)
    if cfg.actor.remote_policy and family != "dqn":
        # before the fleet join: a fleet acting on local policies while
        # the operator believes inference is centralized must not start
        raise NotImplementedError(
            f"--remote-policy serves the dqn family only (got {family!r}); "
            f"aql/r2d2 actors keep their local policies")
    # the body and its spec first: a bad env id fails before any wait
    cfg, worker_fn, model_spec, chunk_arg = _actor_body(cfg, family,
                                                        identity.n_actors)
    stop_event = stop_event or threading.Event()
    name = tenancy_ns.qualify(tenancy_ns.current_tenant(),
                              f"actor-{identity.actor_id}")
    comms = _with_ips(cfg.comms, identity)
    sub = _join_fleet(comms, name, stop_event, barrier_timeout_s)
    if sub is None:
        return
    eps = actor_epsilons(identity.n_actors, cfg.actor.eps_base,
                         cfg.actor.eps_alpha)[identity.actor_id]
    sender = transport.ChunkSender(comms, name)
    if comms.replay_shards > 0:
        # chunks hash to the shards; the learner channel carries stats and
        # heartbeats, answers the park probe and takes the fallback chunks
        from apex_tpu_torch.replay_service.sender import ShardedChunkSender
        sender = ShardedChunkSender(comms, name, direct=sender)
    sender = maybe_wrap_sender(sender, name)
    try:
        park = ParkController(comms, name, stop_event, sub=sub,
                              sender=sender)
        # a delta this subscriber cannot apply asks the trainer for a
        # dense publish over the stat plane (best effort, like any stat)
        sub.on_mismatch = lambda v: sender.send_stat(
            KeyframeRequest(name, int(v)))
        chunks = _ChunkQueueAdapter(sender, stop_event, park=park)
        params = _ParamQueueAdapter(sub, park=park)
        chunks.beats = params.beats = _Beats(HeartbeatEmitter(
            name, role="actor", interval_s=comms.heartbeat_interval_s,
            counters_fn=chunks.wire_counters, park_fn=params.park_state,
            gauges_fn=chunks.wire_gauges), sender)
        worker_fn(identity.actor_id, cfg, model_spec, chunks, params,
                  _StatQueueAdapter(sender), stop_event, float(eps),
                  chunk_arg)
    finally:
        sender.close()
        sub.close()


def run_loadgen(cfg: ApexConfig, identity: RoleIdentity,
                family: str = "dqn", stop_event=None,
                max_seconds: float = 86400.0,
                rollout_len: int | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Loadgen role (``apex_tpu/runtime/roles.py:402-493``): the on-device
    rollout engine as a standalone traffic source.  It subscribes to the
    params like an actor, then ships sealed chunks down the chunk plane
    (hashed over the replay shards when ``comms.replay_shards > 0``, to
    the learner otherwise) with heartbeats (role ``loadgen``) and episode
    stats on the learner's stat channel.  The credit window is its only
    throttle.  It skips the startup barrier.  Its engine owns ladder band
    ``identity.actor_id`` of ``identity.n_actors`` bands of
    ``n_envs_per_actor`` lanes, on ``device`` (the card by default).
    Returns its counters."""
    import time as time_lib

    from apex_tpu_torch.training.anakin import make_anakin_engine

    if family != "dqn":
        raise NotImplementedError(
            f"--role loadgen serves the dqn family only (got {family!r})")
    stop_event = stop_event or threading.Event()
    name = tenancy_ns.qualify(tenancy_ns.current_tenant(),
                              f"loadgen-{identity.actor_id}")
    set_process_label(name)
    get_ring()                      # arm the trace ring's dump triggers
    comms = _with_ips(cfg.comms, identity)
    # the engine first: an env without a device port fails before any
    # socket waits
    lanes = max(1, cfg.actor.n_envs_per_actor)
    engine = make_anakin_engine(
        cfg, rollout_len=rollout_len, device=resolve_device(device),
        n_envs=lanes, slot_band=identity.actor_id,
        total_slots=max(identity.n_actors, 1) * lanes)
    sub = transport.ParamSubscriber(comms)
    sender = transport.ChunkSender(comms, name)
    if comms.replay_shards > 0:
        from apex_tpu_torch.replay_service.sender import ShardedChunkSender
        sender = ShardedChunkSender(comms, name, direct=sender)
    sender = maybe_wrap_sender(sender, name)
    sub.on_mismatch = lambda v: sender.send_stat(
        KeyframeRequest(name, int(v)))
    beat = HeartbeatEmitter(
        name, role="loadgen", interval_s=comms.heartbeat_interval_s,
        counters_fn=lambda: {
            "chunks_sent": sender.chunks_sent,
            "acks_received": sender.acks_received,
            "resends": sender.resends,
            "rerouted": getattr(sender, "rerouted", 0)},
        gauges_fn=lambda: {"ondevice_chunks": engine.chunks,
                           "ondevice_frames": engine.frames,
                           "ondevice_dispatches": engine.dispatches,
                           **sender.wire_gauges()})

    t_first = None                  # the first params' arrival

    def counters() -> dict:
        dev = engine.device
        acting = (0.0 if t_first is None
                  else time_lib.monotonic() - t_first)
        return {"chunks": engine.chunks, "frames": engine.frames,
                "dispatches": engine.dispatches,
                "chunks_sent": sender.chunks_sent,
                "acting_s": round(acting, 3),
                "peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                               if dev.type == "cuda" else 0)}

    print(f"{name}: {lanes} lanes on {engine.device} (ladder band "
          f"{identity.actor_id} of {max(identity.n_actors, 1)}), waiting "
          f"for params", flush=True)
    try:
        got = sub.wait_first(stop_event)
        if got is None:
            return counters()
        version, params = got
        acting = None
        t_first = time_lib.monotonic()
        t_end = t_first + max_seconds
        while not stop_event.is_set() and time_lib.monotonic() < t_end:
            fresh = sub.poll(0)
            if fresh is not None:
                version, params = fresh
            if acting != version:
                from apex_tpu_torch.models.dueling import load_host_params
                load_host_params(engine.model, params)
                acting = version
            msgs, stats = engine.rollout()
            beat.tick(engine.T * engine.B)
            for stat in stats:
                stat.param_version = version
                sender.send_stat(stat)
            hb = beat.maybe_beat(version)
            if hb is not None:
                sender.send_stat(hb)
            for msg in msgs:
                obs_spans.mark_send(msg, version)
                if not sender.send_chunk(msg, stop_event):  # credit
                    break                                   # backpressure
        return counters()
    finally:
        sender.close()
        sub.close()


def run_evaluator(cfg: ApexConfig, identity: RoleIdentity | None = None,
                  family: str = "dqn", stop_event=None, episodes: int = 0,
                  max_steps: int = 10_000, logdir: str | None = None,
                  verbose: bool = False, barrier_timeout_s: float = 120.0,
                  device: str | torch.device = "cuda") -> list[float]:
    """Evaluator role (``eval.py:49-87``): greedy episodes on the unclipped
    env, params refreshed once per episode, forever (or ``episodes`` if >
    0).  Scores are logged locally and shipped to the learner with
    ``actor_id = -(id+1)``.  Acts on ``device``, the card by default."""
    from apex_tpu_torch.envs.registry import make_eval_env
    from apex_tpu_torch.fleet.park import ParkController
    from apex_tpu_torch.utils.metrics import MetricLogger

    _check_family(family)
    device = resolve_device(device)
    stop_event = stop_event or threading.Event()
    identity = identity or RoleIdentity(role="evaluator")
    if family == "r2d2":        # single frames: the LSTM is the memory
        cfg = cfg.replace(env=dataclasses.replace(cfg.env, frame_stack=1))
    # a unique socket and barrier identity: duplicates dedup at the
    # barrier (a deadlock) and misroute on the ROUTER; evaluator ids carry
    # no ladder slot, so a random suffix makes N default evaluators safe
    name = tenancy_ns.qualify(
        tenancy_ns.current_tenant(),
        f"evaluator-{identity.actor_id}-{uuid.uuid4().hex[:6]}")
    comms = _with_ips(cfg.comms, identity)
    env = make_eval_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed + 7777)
    try:
        sub = _join_fleet(comms, name, stop_event, barrier_timeout_s)
        if sub is None:
            return []
        sender = maybe_wrap_sender(transport.ChunkSender(comms, name), name)
        try:
            park = ParkController(comms, name, stop_event, sub=sub,
                                  sender=sender, role="evaluator")
            sub.on_mismatch = lambda v: sender.send_stat(
                KeyframeRequest(name, int(v)))
            log = MetricLogger("evaluator", logdir, verbose=verbose)
            return _evaluator_body(cfg, identity, family, stop_event,
                                   episodes, max_steps, sub, sender, log,
                                   env, park=park, device=device)
        finally:
            sender.close()
            sub.close()
    finally:
        env.close()


def _greedy_actor(cfg: ApexConfig, family: str, device: torch.device):
    """``(load, act, reset)`` of the evaluator: ``load(params)`` copies a
    host state dict into the model on ``device``, ``act(obs)`` is one
    greedy step on a batch of one (the env's action), ``reset()`` runs at
    each episode's start (the recurrent carry).  The exploration draws of
    the policies come from a generator seeded ``seed + 31337`` (the JAX
    evaluator's key)."""
    from apex_tpu_torch.models.dueling import load_host_params

    generator = torch.Generator(device=device).manual_seed(
        cfg.env.seed + 31337)
    init = torch.Generator().manual_seed(cfg.env.seed)
    reset = None
    if family == "dqn":
        from apex_tpu_torch.models.dueling import DuelingDQN, make_policy_fn
        from apex_tpu_torch.training.apex import dqn_env_specs
        model = DuelingDQN(**dqn_env_specs(cfg)[0], generator=init)
        policy = make_policy_fn(model)
    elif family == "aql":
        from apex_tpu_torch.models.aql import (AQLDraws, AQLNetwork,
                                               make_aql_policy_fn)
        from apex_tpu_torch.training.aql import aql_env_specs
        model = AQLNetwork(**aql_env_specs(cfg)[0], generator=init)
        mu_only = make_aql_policy_fn(model, deterministic=True)
        draws = AQLDraws(generator)

        def policy(obs, epsilon, _generator):
            return mu_only(obs, epsilon, draws)[::3]
    else:
        from apex_tpu_torch.models.recurrent import (RecurrentDuelingDQN,
                                                     episodic_policy)
        from apex_tpu_torch.training.r2d2 import r2d2_env_specs
        model = RecurrentDuelingDQN(**r2d2_env_specs(cfg)[0], generator=init)
        policy, reset = episodic_policy(model)
    model.to(device).requires_grad_(False)

    def load(params) -> None:
        load_host_params(model, params)

    def act(obs):
        actions, _ = policy(torch.as_tensor(np.asarray(obs)[None]).to(device),
                            0.0, generator)
        action = actions[0]
        return (action.cpu().numpy() if action.is_floating_point()
                else int(action))

    return load, act, reset


def _evaluator_body(cfg, identity, family, stop_event, episodes, max_steps,
                    sub, sender, log, env, park=None,
                    device: str | torch.device = "cuda") -> list[float]:
    """The evaluator's episode loop over a connected subscriber and sender
    (``apex_tpu/runtime/roles.py:542-692``): each evaluator is one band of
    the eval ladder (its ``actor_id`` slot), and its last and recent-mean
    scores ride the heartbeat gauges.  Each episode and param refresh is
    an event on the ``eval-episodes`` track of the trace ring, and a chaos
    ``score_bias`` shifts the reported scores after its ``after_s``."""
    import time as time_lib

    from apex_tpu_torch.actors.pool import EpisodeStat

    set_process_label(park.identity if park is not None
                      else f"evaluator-{identity.actor_id}")
    ring = get_ring()

    load, act, reset_act = _greedy_actor(cfg, family, resolve_device(device))
    got = sub.wait_first(stop_event)
    if got is None:
        return []
    version, params = got
    load(params)
    if park is not None:
        park.note_params()
    recent_scores: deque = deque(maxlen=16)
    scores: list[float] = []

    def _eval_gauges() -> dict:
        return {
            "eval_band": identity.actor_id,
            "eval_episodes": len(scores),
            "eval_score_last": (round(scores[-1], 3) if scores else 0.0),
            "eval_score_mean": (round(sum(recent_scores)
                                      / len(recent_scores), 3)
                                if recent_scores else 0.0)}

    emitter = HeartbeatEmitter(
        park.identity if park is not None
        else f"evaluator-{identity.actor_id}",
        role="evaluator", interval_s=cfg.comms.heartbeat_interval_s,
        counters_fn=(lambda: {
            "chunks_sent": getattr(sender, "chunks_sent", 0),
            "acks_received": getattr(sender, "acks_received", 0)}),
        park_fn=park.park_state if park is not None else None,
        gauges_fn=_eval_gauges)
    # a scheduled model-quality regression: after after_s of this run
    # every reported score shifts by delta
    chaos = chaos_from_env()
    plan = (chaos.plan_for(emitter.identity) if chaos is not None
            else None)
    bias_t0 = time_lib.monotonic()
    ep = 0
    while not stop_event.is_set() and (episodes <= 0 or ep < episodes):
        obs, _ = env.reset()
        if reset_act is not None:       # recurrent: fresh carry per episode
            reset_act()
        total, done, steps = 0.0, False, 0
        ep_t0 = time_lib.perf_counter()
        while not done and steps < max_steps and not stop_event.is_set():
            obs, r, term, trunc, _ = env.step(act(obs))
            total += float(r)
            done = term or trunc
            steps += 1
            emitter.tick()
            hb = emitter.maybe_beat(version)
            if hb is not None:
                sender.send_stat(hb)
        if (plan is not None and plan.score_bias_after_s is not None
                and time_lib.monotonic() - bias_t0
                >= plan.score_bias_after_s):
            total += plan.score_bias_delta
        scores.append(total)
        recent_scores.append(total)
        ring.complete("episode", ep_t0, time_lib.perf_counter() - ep_t0,
                      track="eval-episodes",
                      args={"reward": round(total, 3), "steps": steps,
                            "param_version": version})
        log.scalars({"episode_reward": total, "episode_length": steps,
                     "param_version": version}, ep)
        sender.send_stat(EpisodeStat(-(identity.actor_id + 1), total, steps,
                                     version))
        got = sub.poll(0)               # param refresh per episode
        if got is None and park is not None and park.stale():
            # the stream died mid-run: park between episodes, resume on
            # the restarted learner's first publish
            got = park.park_and_rejoin()
            if got is not None:
                park.take_pending()
        if got is not None:
            version, params = got
            load(params)
            if park is not None:
                park.note_params()
            ring.instant("param_refresh", track="eval-episodes",
                         args={"version": version})
        ep += 1
    return scores


def _with_ips(comms: CommsConfig, identity: RoleIdentity) -> CommsConfig:
    """An explicit learner/replay IP on the role identity wins over the
    config (``actor.py:18-25``); a default identity does not overwrite a
    configured ``comms.learner_ip`` (or ``replay_ip``) with localhost."""
    default = RoleIdentity()
    overrides = {}
    if identity.learner_ip != default.learner_ip:
        overrides["learner_ip"] = identity.learner_ip
    if identity.replay_ip != default.replay_ip:
        overrides["replay_ip"] = identity.replay_ip
    return dataclasses.replace(comms, **overrides) if overrides else comms
