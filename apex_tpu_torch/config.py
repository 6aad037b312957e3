"""Configuration dataclasses read by the port.

A copy of the sections of :mod:`apex_tpu.config` the port's drivers read
(the concurrent Ape-X trainer with its ingest pipeline, the single-process
DQN driver, checkpointing, the R2D2 and AQL families, and the socket
roles' comms plane with the replay and inference services and the
fleet registry, its status port and its reaction, and their
:class:`RoleIdentity`), with the same defaults (reference
hyperparameters: ``origin_repo/arguments.py:9-74``), and of
:func:`~apex_tpu.config.small_test_config`.  Fields that no part of the
port reads yet (the mesh's axis names, the tenancy and serve-ctl knobs
of the comms plane) are not copied.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ReplayConfig:
    """Prioritized replay hyperparameters (reference: arguments.py:41-50)."""

    capacity: int = 2 ** 19          # per-device transition capacity
    alpha: float = 0.6               # priority exponent
    beta: float = 0.4                # IS-weight exponent, annealed toward 1
    beta_anneal: int = 500_000       # transitions over which beta reaches 1
    warmup: int = 50_000             # learner gated until this many transitions
    eps: float = 1e-6                # clamp floor for priorities (pre-alpha)
    # the R2D2 family's pixel sequences go to the frame-dedup sequence
    # pool (replay/seq_pool.py) instead of stacked sequence windows
    frame_pool: bool = False
    # Constructors refuse a replay whose estimated footprint exceeds this
    # (and, on a card, the card's own memory).
    hbm_budget_gb: float = 12.0

    def __post_init__(self) -> None:
        if self.capacity <= 0 or self.capacity & (self.capacity - 1):
            raise ValueError(f"capacity must be a power of 2, got {self.capacity}")


@dataclass(frozen=True)
class LearnerConfig:
    """Learner hyperparameters (reference: arguments.py:49-66, ApeX.py:37)."""

    batch_size: int = 512
    lr: float = 6.25e-5
    lr_decay_steps: int = 1000       # StepLR(step_size=1000, gamma=0.99); 0 = constant
    lr_decay_rate: float = 0.99
    rmsprop_decay: float = 0.95
    rmsprop_eps: float = 1.5e-7
    rmsprop_centered: bool = True
    gamma: float = 0.99
    n_steps: int = 3
    max_grad_norm: float = 40.0
    # the update rule after the clip: "rmsprop" (the rmsprop_* fields) or
    # "adam" (optax.adam with b1 0.9, b2 0.999 and adam_eps; the R2D2
    # family only)
    optimizer: str = "rmsprop"
    adam_eps: float = 1e-8
    target_update_interval: int = 2500
    publish_interval: int = 25       # param publish period, learner steps
    save_interval: int = 5000        # learner steps between checkpoints
    compute_dtype: str = "bfloat16"  # conv/matmul dtype; params stay f32
    # transitions the DQN driver folds into each replay ingest (fixed shape)
    ingest_chunk: int = 512
    # the learner's dp degree is prod(mesh_shape): that many ranks, each
    # with its own replay shard of replay.capacity, mean their gradients
    # (apex_tpu_torch.parallel); (1,) is the one-card learner
    mesh_shape: tuple[int, ...] = (1,)
    # >1: when at least this many chunks are queued and the replay-ratio
    # budget allows, drain them into one fused_multi_step call of
    # scan_steps fused steps
    scan_steps: int = 1
    # the staging thread of training/ingest_pipeline.py polls, merges and
    # copies the next dispatch's chunks to the device while the current
    # step runs; False keeps the serial drain
    ingest_pipeline: bool = True
    pipeline_depth: int = 2          # staged-slot ring depth
    # max chunks merged into one ingest payload while the learner is not
    # train-eligible (warm-up fill, replay-ratio cap)
    pipeline_merge: int = 8


@dataclass(frozen=True)
class ActorConfig:
    """Actor-fleet hyperparameters (reference: arguments.py:9-40,
    batchrecorder.py:121)."""

    n_actors: int = 8
    # env slots driven by each worker process through one batched policy
    # call per step; the exploration ladder spans all
    # n_actors * n_envs_per_actor slots
    n_envs_per_actor: int = 1
    send_interval: int = 50          # transitions per shipped chunk
    update_interval: int = 400       # env steps between param refresh polls
    eps_base: float = 0.4            # ladder eps_base^(1 + i/(N-1)*eps_alpha)
    eps_alpha: float = 7.0
    # anneal each slot's epsilon 1.0 -> its ladder value over this many of
    # its own env steps (exp decay); 0 = the fixed reference ladder
    eps_anneal_steps: int = 0
    max_episode_length: int | None = None   # None = the env's own limit
    # chunk transport: the native shared-memory ring when it builds, else
    # multiprocessing.Queue
    shm_data_plane: bool = True
    shm_slot_bytes: int = 0          # 0 = drivers size it from the frame spec
    # the JAX workers' overlap of one half-group's env steps with the
    # other's inference; the port's vector workers run the serial
    # interleave in both modes (actors/vector.py) and report the flag
    double_buffer: bool = True
    # vector steps between ActorTimingStat emissions; 0 = off
    timing_interval: int = 256
    # ship each half-group's policy call to the `--role infer` server
    # (infer_service/), which batches requests across actor processes
    # into one forward on the card; the local policy stays the fallback
    # (CommsConfig.infer_wait_s).  DQN vector families only.
    remote_policy: bool = False


@dataclass(frozen=True)
class EnvConfig:
    env_id: str = "SeaquestNoFrameskip-v4"   # reference default (arguments.py:9-10)
    frame_stack: int = 4
    seed: int = 1122                 # reference default seed (arguments.py:14)


@dataclass(frozen=True)
class R2D2Config:
    """Recurrent-family hyperparameters (``apex_tpu/config.py:185-207``).
    A stored sequence is ``burn_in + unroll + n_steps`` steps."""

    burn_in: int = 8            # state-warmup prefix, no loss or gradient
    unroll: int = 16            # loss positions per sequence
    stride: int | None = None   # sequence start spacing; None = unroll // 2
    lstm_features: int = 128    # recurrent width
    head_width: int = 128       # units of each dueling head's hidden layer
    # feed the LSTM the previous action (one-hot) and the previous reward
    # beside the trunk's features (R2D2's appendix)
    prev_action_reward: bool = False
    # epsilon of the value rescaling h(x) = sign(x)(sqrt(|x|+1)-1) + eps x
    # on the targets and the acting priorities; 0 = no rescaling
    value_rescale_eps: float = 0.0
    # sequences per ingest batch and per actor message: one fixed message
    # shape for the drivers and the shm slot sizing
    sequence_group: int = 4


@dataclass(frozen=True)
class AQLConfig:
    """Proposal-action Q-learning knobs (``apex_tpu/config.py:208-221``;
    reference ``model.py:170``, ``AQL.py:41-42``)."""

    propose_sample: int = 100
    uniform_sample: int = 400
    action_var: float = 0.25
    proposal_lr: float = 1e-4
    q_lr: float = 1e-4
    entropy_coef: float = 0.01
    # CosineAnnealingLR(T_max=max_step, eta_min=lr/1000) horizon of the
    # single-process driver (AQL.py:18,48-49); the concurrent driver
    # ignores it (AQL_dis constructs no schedulers)
    cosine_lr_steps: int = 1_000_000


@dataclass(frozen=True)
class CommsConfig:
    """The socket plane of :mod:`apex_tpu_torch.runtime`
    (``apex_tpu/config.py:225-316``; reference ``replay.py:48-74``,
    ``learner.py:57-68``, ``actor.py:110-114``): the fields the learner,
    actor and evaluator roles read, with the JAX names and defaults."""

    replay_ip: str = "127.0.0.1"
    learner_ip: str = "127.0.0.1"
    batch_port: int = 51001          # actor -> learner chunk stream
    param_port: int = 52001          # learner PUB param broadcast
    barrier_port: int = 52002        # startup handshake ROUTER
    max_outstanding_sends: int = 3   # actor credit window (actor.py:110-112)
    param_hwm: int = 3               # PUB high-water mark (learner.py:60)
    status_port: int = 52003         # fleet-status REP (--role status)
    # learner-side decoder threads unpickling chunk payloads off the
    # socket thread (learner.py:71-114, count arguments.py:73-74)
    n_recv_batch_procs: int = 4
    # every role beats at this cadence; the learner's FleetRegistry marks
    # a peer silent this long SUSPECT, then DEAD (a replay shard also
    # forgives the batches outstanding to a learner silent dead_after_s)
    heartbeat_interval_s: float = 2.0
    suspect_after_s: float = 6.0
    dead_after_s: float = 15.0
    # actor/evaluator park threshold: no param publish for this long means
    # the learner is gone (a live one republishes at least every
    # ~10 * publish_min_seconds)
    park_after_s: float = 10.0
    rejoin_backoff_s: float = 1.0    # first retry delay (doubles per miss)
    rejoin_backoff_max_s: float = 8.0
    rejoin_attempt_s: float = 5.0    # per-attempt barrier/param race window
    # at least this DEAD fraction of the actor peers relaxes the learner's
    # replay-ratio floor (min_train_ratio) until they rejoin; None = never
    relax_floor_dead_frac: float | None = 0.5
    # chunk wire codec of every ChunkSender ("raw", "delta", "dict"; empty
    # = the APEX_WIRE_CODEC env twin, else raw); receivers negotiate per
    # chunk off the wire tag
    wire_codec: str = ""
    # sparse param-delta publishes with a dense keyframe at least every
    # param_keyframe_every publishes (runtime/codec.py)
    param_delta: bool = False
    param_keyframe_every: int = 16
    # -- sharded replay service (replay_service/) --------------------------
    # a wedged shard's chunks fall back to the learner; the actor
    # re-probes the shard (credit reset + one real send) this often
    shard_reprobe_s: float = 10.0
    # 0 = replay in the learner.  N > 0: N `--role replay` shard
    # processes, each one FramePoolReplay; actors hash chunks to shards,
    # the learner pulls pre-sampled batches and writes priorities back
    replay_shards: int = 0
    replay_port_base: int = 53001    # shard s binds replay_port_base + s
    # strict: a shard samples batch j+1 only after batch j's write-back
    # and defers ingest behind it (N = 1 is bit-identical to replay in
    # the learner); False pre-samples up to replay_presample batches
    replay_strict_order: bool = True
    replay_presample: int = 2
    # seconds between shard snapshots into --replay-snapshot-dir; 0 = off
    replay_snapshot_s: float = 0.0
    # -- batched inference (infer_service/, serving/) ----------------------
    infer_port: int = 54001          # shard s binds infer_port + s
    infer_ip: str = "127.0.0.1"
    # the server coalesces requests until infer_batch_max are queued or
    # infer_window_ms passed since the first, then runs one forward
    infer_batch_max: int = 16
    infer_window_ms: float = 2.0
    # an actor waits this long for a reply, then acts locally and marks
    # the server down, re-probing it every infer_reprobe_s
    infer_wait_s: float = 1.0
    infer_reprobe_s: float = 5.0
    # load each publish into the server's model on the card when it
    # arrives; False loads it at the next dispatch that needs it
    infer_device_params: bool = False
    infer_shards: int = 1            # workers route by identity hash


@dataclass(frozen=True)
class ApexConfig:
    """Top-level bundle of the sections the port reads."""

    env: EnvConfig = field(default_factory=EnvConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    learner: LearnerConfig = field(default_factory=LearnerConfig)
    actor: ActorConfig = field(default_factory=ActorConfig)
    aql: AQLConfig = field(default_factory=AQLConfig)
    r2d2: R2D2Config = field(default_factory=R2D2Config)
    comms: CommsConfig = field(default_factory=CommsConfig)

    def replace(self, **sections: Any) -> "ApexConfig":
        return dataclasses.replace(self, **sections)


@dataclass(frozen=True)
class RoleIdentity:
    """A process's role identity, injected through env vars by the deploy
    scripts (``apex_tpu/config.py:376-395``; reference
    ``deploy/actor.sh:4-9``, ``actor.py:18-25``)."""

    role: str = "learner"            # learner | actor | evaluator | ...
    actor_id: int = 0
    n_actors: int = 1
    replay_ip: str = "127.0.0.1"
    learner_ip: str = "127.0.0.1"

    @classmethod
    def from_env(cls, environ=None) -> "RoleIdentity":
        e = dict(environ if environ is not None else os.environ)
        return cls(
            role=e.get("APEX_ROLE", "learner"),
            actor_id=int(e.get("ACTOR_ID", 0)),
            n_actors=int(e.get("N_ACTORS", 1)),
            replay_ip=e.get("REPLAY_IP", "127.0.0.1"),
            learner_ip=e.get("LEARNER_IP", "127.0.0.1"),
        )


def small_test_config(capacity: int = 1024, batch_size: int = 32,
                      n_actors: int = 2,
                      env_id: str = "ApexCartPole-v0") -> ApexConfig:
    """A config sized for CI: tiny buffer, tiny batch, numpy-native env
    (``apex_tpu/config.py:398-412``)."""
    return ApexConfig(
        env=EnvConfig(env_id=env_id, frame_stack=1),
        replay=ReplayConfig(capacity=capacity,
                            warmup=max(2 * batch_size, 64)),
        learner=LearnerConfig(batch_size=batch_size, ingest_chunk=batch_size,
                              target_update_interval=100,
                              compute_dtype="float32"),
        actor=ActorConfig(n_actors=n_actors, send_interval=16),
    )
