"""CLI entry points: ``python -m apex_tpu_torch.runtime --role ...``.

Counterpart of :mod:`apex_tpu.runtime.cli`.  The reference is launched as
role scripts sharing one argparse (``origin_repo/arguments.py:5-83``),
with the role identity injected through env vars by the deploy scripts
(``deploy/actor.sh:4-9``).  The same scheme here: every flag has an env
twin (the flag wins), ``--role`` defaults to ``$APEX_ROLE``, and one
command serves every role, so a localhost topology and a cluster launch
the same commands.  ``--device`` (env twin ``APEX_DEVICE``, default
``cuda``) is where the learner, the single-host drivers, the evaluator,
``enjoy``, the replay shards, the infer server and loadgen run; it is the
port's counterpart of ``JAX_PLATFORMS``.  Actors act on the CPU, or
through the infer server with ``--remote-policy``.

Examples::

    # learner expecting 2 actors + 1 evaluator on this host
    python -m apex_tpu_torch.runtime --role learner --n-actors 2 \\
        --env-id ApexCartPole-v0 --total-steps 5000

    APEX_ROLE=actor ACTOR_ID=0 N_ACTORS=2 LEARNER_IP=10.0.0.2 \\
        python -m apex_tpu_torch.runtime --env-id ApexCartPole-v0

    python -m apex_tpu_torch.runtime --role evaluator --learner-ip 10.0.0.2

    # single-process drivers (no sockets)
    python -m apex_tpu_torch.runtime --role dqn --total-frames 20000
    python -m apex_tpu_torch.runtime --role enjoy --checkpoint ckpt.pt

    # the services: two replay shards and one infer server on the card,
    # then the learner and actors with --replay-shards 2 --remote-policy
    python -m apex_tpu_torch.runtime --role replay --replay-shards 2 \
        --shard-id 0 --env-id ApexCatch-v0
    python -m apex_tpu_torch.runtime --role infer --env-id ApexCatch-v0
    python -m apex_tpu_torch.runtime --role loadgen --env-id ApexCatch-v0 \
        --n-envs-per-actor 32

    # the live fleet table of a running learner, or its Prometheus text
    python -m apex_tpu_torch.runtime --role status
    python -m apex_tpu_torch.runtime --role status --metrics [--http 9100]

    # the control planes: canaries over 2 infer shards, tenant placement
    # over the APEX_TENANTS roster, PBT over the APEX_POPULATION lineages
    python -m apex_tpu_torch.runtime --role serve-ctl --infer-shards 2 \
        --serve-canary-frac 0.5 --serve-soak 60
    APEX_TENANTS='[{"name": "rally", "env_id": "ApexRally-v0"}]' \
        python -m apex_tpu_torch.runtime --role tenant-ctl --replay-shards 2
    APEX_POPULATION='[{"name": "la"}, {"name": "lb"}]' \
        python -m apex_tpu_torch.runtime --role pbt-ctl --pbt-decide 30

SIGTERM stops the learner role at its next loop iteration (exit 0), and
so does its first SIGINT; it prints its final counters (the gather
kernel's launches and, when it returned, its steps, transitions ingested
and steps trained on replay-shard batches) as one ``learner: stats
{...}`` line.
The replay, infer and loadgen roles skip the startup barrier and print
their final counters as one ``<identity>: stats {...}`` JSON line when
SIGTERM stops them.  ``--role status`` asks a running learner's status
server for the fleet table (``--metrics``: the Prometheus text, served
over HTTP with ``--http PORT``) and exits 1 when no learner answers.
``--trace-dir`` (env twin ``APEX_TRACE_DIR``) turns on every role's
trace ring (merge the dumps with ``python -m apex_tpu_torch.obs.merge
DIR``); ``--profile-dir`` runs the learning roles inside a
``torch.profiler`` trace (:func:`apex_tpu_torch.utils.profiling.trace`).

The three controllers (``serve-ctl``, ``tenant-ctl``, ``pbt-ctl``) skip
the barrier, run on the CPU (they hold no tensors) and tick every
``--serve-interval`` seconds until SIGTERM or ``--max-seconds``.
``--tenant`` (env twin ``APEX_TENANT``) makes every role of one tenant
qualify its identities, chunk ids and param topic; a tenant that names an
``APEX_POPULATION`` lineage adopts that lineage's env id and
hyperparameters.  ``--mesh-dp N`` runs the learner-side roles' learner
as N ranks of :mod:`apex_tpu_torch.parallel` (0: one per visible card,
at least one), with host actors, ``--rollout ondevice|fused``,
``--replay-shards`` and ``--checkpoint-dir`` / ``--restore`` alike; the
other ranks stop when the role's training ends.
The Atari wrapper switches are not in the
parser.  Beside ``--device`` the parser has two flags the JAX one lacks:
``--send-interval`` (env twin ``APEX_SEND_INTERVAL``), the actors' chunk
size, and ``--dp-backend`` (env twin ``APEX_DP_BACKEND``, ``nccl`` by
default: one card per rank; ``gloo`` runs every rank on the learner's
card), which one card forces.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import threading

from apex_tpu_torch.config import (ActorConfig, ApexConfig, AQLConfig,
                                   CommsConfig, EnvConfig, LearnerConfig,
                                   ReplayConfig, RoleIdentity)

#: roles that run inside --profile-dir's torch.profiler trace
PROFILED_ROLES = ("learner", "apex", "dqn", "aql", "r2d2")

ROLES = ["learner", "actor", "evaluator", "replay", "infer", "serve-ctl",
         "tenant-ctl", "pbt-ctl", "status", "loadgen", "dqn", "aql", "r2d2",
         "apex", "enjoy"]


def _env_bool(value: str) -> bool:
    """Env-var booleans: '0'/'false'/'no'/'' are off (bool(str) is not)."""
    return value.lower() not in ("", "0", "false", "no")


def build_parser() -> argparse.ArgumentParser:
    e = os.environ
    ident = RoleIdentity.from_env(e)
    p = argparse.ArgumentParser(
        prog="apex_tpu_torch",
        description="Ape-X/AQL/R2D2 roles on PyTorch (reference "
                    "arguments.py)")
    p.add_argument("--role", default=ident.role, choices=ROLES,
                   help="socket roles: learner/actor/evaluator; the "
                        "services: replay (one replay shard), infer (one "
                        "batched-inference shard), loadgen (on-device "
                        "rollouts as a chunk source); single-host drivers: "
                        "dqn/aql/r2d2/apex; enjoy: evaluate a checkpoint; "
                        "status: a running learner's fleet table; the "
                        "controllers: serve-ctl (canary deployments over "
                        "the infer shards), tenant-ctl (tenant placement), "
                        "pbt-ctl (population-based training)")
    p.add_argument("--family", default=e.get("APEX_FAMILY", "dqn"),
                   choices=["dqn", "aql", "r2d2"])
    p.add_argument("--rollout", default=e.get("APEX_ROLLOUT", "host"),
                   choices=["host", "ondevice", "fused"],
                   help="apex role: 'ondevice' acts on the card with the "
                        "rollout engine in place of actor processes "
                        "(on-device envs only: ApexCatch*/ApexRally*), "
                        "'fused' runs rollout, ingest, sample, train and "
                        "write-back as one step per dispatch (dqn family); "
                        "'host' (default) keeps the actor processes.  On "
                        "the learner role (dqn) the socket fleet rides "
                        "alongside")
    p.add_argument("--rollout-len", type=int,
                   default=int(e.get("APEX_ROLLOUT_LEN", 0)),
                   help="on-device env steps per slot per dispatch; 0 "
                        "derives it from the chunk size")
    p.add_argument("--steps-per-dispatch", type=int,
                   default=int(e.get("APEX_STEPS_PER_DISPATCH", 4)),
                   help="--rollout fused: macro steps per dispatch")
    # the tenant namespace: every role of one tenant opts in with this
    # flag or its env twin; APEX_TENANTS (a JSON roster) configures the
    # shared planes
    p.add_argument("--tenant", default=e.get("APEX_TENANT", ""),
                   help="this process's tenant name (env twin "
                        "APEX_TENANT; empty = the default tenant t0)")
    # env
    p.add_argument("--env-id", default=e.get("APEX_ENV_ID",
                                             "SeaquestNoFrameskip-v4"))
    p.add_argument("--seed", type=int, default=int(e.get("APEX_SEED", 1122)))
    p.add_argument("--frame-stack", type=int, default=4)
    # identity (env twins are the reference's names, actor.py:18-25;
    # RoleIdentity.from_env reads them, flags win)
    p.add_argument("--actor-id", type=int, default=ident.actor_id)
    p.add_argument("--n-actors", type=int, default=ident.n_actors)
    p.add_argument("--n-envs-per-actor", type=int,
                   default=int(e.get("N_ENVS_PER_ACTOR", 1)),
                   help="env slots per actor process, driven through one "
                        "batched policy call; the exploration ladder spans "
                        "n_actors * n_envs_per_actor slots")
    p.add_argument("--n-evaluators", type=int,
                   default=int(e.get("N_EVALUATORS", 1)))
    p.add_argument("--send-interval", type=int,
                   default=int(e.get("APEX_SEND_INTERVAL")
                               or ActorConfig().send_interval),
                   help="transitions per shipped chunk (env twin "
                        "APEX_SEND_INTERVAL; the JAX CLI fixes it at the "
                        "config default)")
    p.add_argument("--learner-ip", default=ident.learner_ip)
    p.add_argument("--replay-ip", default=ident.replay_ip,
                   help="host the replay shards run on (env twin "
                        "REPLAY_IP); defaults to localhost")
    # comms ports (env twins let a topology remap the plane)
    c = CommsConfig()
    p.add_argument("--batch-port", type=int,
                   default=int(e.get("APEX_BATCH_PORT", c.batch_port)))
    p.add_argument("--param-port", type=int,
                   default=int(e.get("APEX_PARAM_PORT", c.param_port)))
    p.add_argument("--barrier-port", type=int,
                   default=int(e.get("APEX_BARRIER_PORT", c.barrier_port)))
    p.add_argument("--status-port", type=int,
                   default=int(e.get("APEX_STATUS_PORT", c.status_port)),
                   help="the learner's fleet-status server (--role status)")
    # sharded replay service: the whole fleet must agree on these
    p.add_argument("--replay-shards", type=int,
                   default=int(e.get("APEX_REPLAY_SHARDS", c.replay_shards)),
                   help="N > 0: prioritized replay in N --role replay "
                        "shard processes; actors hash chunks to shards, "
                        "the learner pulls pre-sampled batches.  0 "
                        "(default): replay in the learner")
    p.add_argument("--replay-port-base", type=int,
                   default=int(e.get("APEX_REPLAY_PORT_BASE",
                                     c.replay_port_base)),
                   help="shard s binds replay_port_base + s")
    p.add_argument("--shard-id", type=int,
                   default=int(e.get("SHARD_ID", 0)),
                   help="replay role: this process's shard index in "
                        "[0, replay_shards)")
    p.add_argument("--replay-loose", action="store_true",
                   default=_env_bool(e.get("APEX_REPLAY_LOOSE", "")),
                   help="loose shard ordering (pre-sample ahead, apply "
                        "write-backs whenever they land) instead of the "
                        "strict lockstep, bit-identical to replay in the "
                        "learner at N = 1")
    p.add_argument("--replay-snapshot-dir",
                   default=e.get("APEX_REPLAY_SNAPSHOT_DIR"),
                   help="replay role: restore the shard's snapshot from "
                        "here on start and keep snapshotting at "
                        "--replay-snapshot-every")
    p.add_argument("--replay-snapshot-every", type=float,
                   default=float(e.get("APEX_REPLAY_SNAPSHOT_S")
                                 or c.replay_snapshot_s),
                   help="seconds between shard snapshots (quiescent "
                        "points only); 0 = off")
    # batched inference: the whole fleet must agree on the endpoint
    p.add_argument("--remote-policy", action="store_true",
                   default=_env_bool(e.get("APEX_REMOTE_POLICY", "")),
                   help="actors (dqn) send their half-group policy calls "
                        "to the --role infer server, one batched forward "
                        "on the card across actors; the local policy "
                        "stays as the fallback after --infer-wait")
    p.add_argument("--infer-port", type=int,
                   default=int(e.get("APEX_INFER_PORT", c.infer_port)))
    p.add_argument("--infer-ip", default=e.get("APEX_INFER_IP", c.infer_ip),
                   help="host the infer server runs on (env twin "
                        "APEX_INFER_IP)")
    p.add_argument("--infer-batch-max", type=int,
                   default=int(e.get("APEX_INFER_BATCH_MAX",
                                     c.infer_batch_max)),
                   help="max requests coalesced into one forward (also "
                        "the power-of-two padding cap)")
    p.add_argument("--infer-window-ms", type=float,
                   default=float(e.get("APEX_INFER_WINDOW_MS")
                                 or c.infer_window_ms),
                   help="coalescing window opened by the first request")
    p.add_argument("--infer-wait", type=float,
                   default=float(e.get("APEX_INFER_WAIT") or c.infer_wait_s),
                   help="actor-side reply timeout before the local "
                        "fallback")
    p.add_argument("--infer-reprobe", type=float,
                   default=float(e.get("APEX_INFER_REPROBE")
                                 or c.infer_reprobe_s))
    p.add_argument("--infer-device-params", action="store_true",
                   default=_env_bool(e.get("APEX_INFER_DEVICE_PARAMS", "")),
                   help="load each publish into the server's model on the "
                        "card when it arrives (else at the next dispatch)")
    p.add_argument("--infer-shards", type=int,
                   default=int(e.get("APEX_INFER_SHARDS", c.infer_shards)),
                   help="N infer servers, shard s binding infer_port + s; "
                        "workers route by a stable identity hash")
    p.add_argument("--infer-shard-id", type=int,
                   default=int(e.get("INFER_SHARD_ID", 0)),
                   help="infer role: this process's shard index in "
                        "[0, infer_shards)")
    # wire codec (runtime/codec.py); receivers negotiate per chunk, so a
    # mixed fleet is fine
    p.add_argument("--wire-codec", choices=["raw", "delta", "dict"],
                   default=(e.get("APEX_WIRE_CODEC") or "").strip()
                   or "raw",
                   help="chunk wire codec: raw = plain pickle (default), "
                        "delta = XOR frame delta + RLE (sparse Catch "
                        "frames), dict = per-chunk deflate dictionary "
                        "(pixel stacks); env twin APEX_WIRE_CODEC")
    p.add_argument("--param-delta", action="store_true",
                   default=_env_bool(e.get("APEX_PARAM_DELTA", "")),
                   help="publish sparse per-leaf param deltas with "
                        "periodic dense keyframes; env twin "
                        "APEX_PARAM_DELTA")
    p.add_argument("--param-keyframe-every", type=int,
                   default=int(e.get("APEX_PARAM_KEYFRAME_EVERY")
                               or c.param_keyframe_every),
                   help="dense keyframe at least every N publishes in "
                        "--param-delta mode")
    # the controllers' knobs (serving/deploy.py, population/controller.py;
    # the lineage roster itself rides APEX_POPULATION)
    p.add_argument("--serve-canary-frac", type=float,
                   default=float(e.get("APEX_SERVE_CANARY_FRAC") or 0.5),
                   help="serve-ctl: fraction of shards canarying a new "
                        "model version (lowest indices; the rest freeze "
                        "the incumbent)")
    p.add_argument("--serve-soak", type=float,
                   default=float(e.get("APEX_SERVE_SOAK_S") or 60.0),
                   help="serve-ctl: seconds the canary's gate objectives "
                        "must hold before promotion")
    p.add_argument("--serve-version-every", type=int,
                   default=int(e.get("APEX_SERVE_VERSION_EVERY") or 0),
                   help="serve-ctl: minimum param-version spacing between "
                        "deployments within one learner epoch (0 = deploy "
                        "on epoch changes only)")
    p.add_argument("--serve-interval", type=float,
                   default=float(e.get("APEX_SERVE_INTERVAL_S") or 5.0),
                   help="the controllers: seconds between control rounds")
    p.add_argument("--pbt-decide", type=float,
                   default=float(e.get("APEX_PBT_DECIDE_S") or 30.0),
                   help="pbt-ctl: seconds between exploit/explore rounds")
    p.add_argument("--pbt-frac", type=float,
                   default=float(e.get("APEX_PBT_FRAC") or 0.25),
                   help="pbt-ctl: truncation fraction (the bottom frac of "
                        "each task ladder restores the top frac's "
                        "checkpoint, at least one lineage each)")
    p.add_argument("--pbt-resample", type=float,
                   default=float(e.get("APEX_PBT_RESAMPLE") or 0.25),
                   help="pbt-ctl: per-field probability that explore "
                        "resamples from the band instead of perturbing")
    p.add_argument("--pbt-min-episodes", type=int,
                   default=int(e.get("APEX_PBT_MIN_EPISODES") or 4),
                   help="pbt-ctl: eval episodes behind a lineage's score "
                        "before selection judges it")
    # fleet plane: the heartbeat cadence, the registry's state-machine
    # windows and the park threshold
    p.add_argument("--heartbeat-interval", type=float,
                   default=float(e.get("APEX_HEARTBEAT_INTERVAL",
                                       c.heartbeat_interval_s)))
    p.add_argument("--suspect-after", type=float,
                   default=float(e.get("APEX_SUSPECT_AFTER",
                                       c.suspect_after_s)),
                   help="silence after which the learner's registry marks "
                        "a peer SUSPECT")
    p.add_argument("--dead-after", type=float,
                   default=float(e.get("APEX_DEAD_AFTER", c.dead_after_s)),
                   help="silence after which the registry marks a peer "
                        "DEAD, and write-back silence after which a replay "
                        "shard forgives its outstanding batches")
    p.add_argument("--park-after", type=float,
                   default=float(e.get("APEX_PARK_AFTER", c.park_after_s)))
    # learner
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=6.25e-5)
    p.add_argument("--lr-decay-steps", type=int,
                   default=int(e.get("APEX_LR_DECAY_STEPS", 1000)),
                   help="StepLR parity (DQN.py:39): lr *= rate every this "
                        "many learner steps; 0 = constant lr")
    p.add_argument("--lr-decay-rate", type=float,
                   default=float(e.get("APEX_LR_DECAY_RATE", 0.99)))
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--n-steps", type=int, default=3)
    p.add_argument("--target-update-interval", type=int, default=2500)
    p.add_argument("--save-interval", type=int,
                   default=int(e.get("APEX_SAVE_INTERVAL", 5000)),
                   help="learner steps between checkpoints (env twin "
                        "APEX_SAVE_INTERVAL)")
    p.add_argument("--mesh-dp", type=int,
                   default=int(e.get("APEX_MESH_DP", 0)),
                   help="learner dp degree: this many ranks, each with its "
                        "own replay shard, mean their gradients; 0 = one "
                        "per visible card (learner/apex roles), 1 = one "
                        "rank")
    p.add_argument("--dp-backend", choices=["nccl", "gloo"],
                   default=e.get("APEX_DP_BACKEND", "nccl"),
                   help="the dp group's backend (env twin APEX_DP_BACKEND): "
                        "nccl puts rank r on cuda:r and needs a card per "
                        "rank; gloo runs every rank on the learner's "
                        "device")
    p.add_argument("--total-steps", type=int, default=1_000_000)
    p.add_argument("--total-frames", type=int, default=1_000_000)
    p.add_argument("--max-seconds", type=float, default=86400.0)
    p.add_argument("--train-ratio", type=float, default=None)
    p.add_argument("--min-train-ratio", type=float, default=None)
    # replay
    p.add_argument("--capacity", type=int, default=2 ** 19)
    p.add_argument("--warmup", type=int, default=50_000)
    p.add_argument("--alpha", type=float, default=0.6)
    p.add_argument("--beta", type=float, default=0.4)
    # misc
    p.add_argument("--device", default=e.get("APEX_DEVICE", "cuda"),
                   help="torch device of the learner, the single-host "
                        "drivers, the evaluator, enjoy and the replay, "
                        "infer and loadgen roles (env twin APEX_DEVICE); "
                        "'cpu' runs the plain PyTorch path.  Actors act on "
                        "the CPU")
    p.add_argument("--metrics", action="store_true",
                   help="status role: print the learner's Prometheus text "
                        "(rates, fleet, latency histograms, SLOs) instead "
                        "of the fleet table")
    p.add_argument("--http", type=int,
                   default=int(e.get("APEX_METRICS_HTTP", 0)),
                   help="status role with --metrics: serve the text over "
                        "plain HTTP on this port (GET /metrics proxies one "
                        "round trip per scrape); 0 = print once")
    p.add_argument("--trace-dir", default=e.get("APEX_TRACE_DIR"),
                   help="turn on the per-role trace ring and dump Chrome "
                        "trace JSON here (at exit, every "
                        "APEX_TRACE_FLUSH_S and on SIGUSR2); merge a "
                        "fleet's dumps with "
                        "`python -m apex_tpu_torch.obs.merge DIR`")
    p.add_argument("--profile-dir", default=e.get("APEX_PROFILE_DIR"),
                   help="run the learner and the single-host drivers "
                        "inside a torch.profiler trace (CPU and CUDA) "
                        "written to this directory")
    p.add_argument("--logdir", default=e.get("APEX_LOGDIR"))
    p.add_argument("--checkpoint-dir", default=e.get("APEX_CKPT_DIR"))
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (enjoy role)")
    p.add_argument("--restore", action=argparse.BooleanOptionalAction,
                   default=_env_bool(e.get("APEX_RESTORE", "")),
                   help="resume the learner from the newest checkpoint in "
                        "--checkpoint-dir before training; --no-restore "
                        "overrides the APEX_RESTORE env var")
    p.add_argument("--episodes", type=int, default=0,
                   help="evaluator/enjoy episode budget (0 = forever)")
    p.add_argument("--render", choices=["ascii", "save"], default=None,
                   help="enjoy role: terminal ASCII rendering, or capture "
                        "observations to --render-dir as per-episode .npy "
                        "stacks (enjoy.py:29-48 on headless hosts)")
    p.add_argument("--render-dir", default=e.get("APEX_RENDER_DIR"))
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--barrier-timeout", type=float, default=120.0)
    return p


def _mesh_shape(args: argparse.Namespace) -> tuple[int, ...]:
    """The learner's dp degree; 0 = one rank per visible card on the
    learner-side roles (at least one), 1 elsewhere (``cli.py:396-406``)."""
    dp = args.mesh_dp
    if dp == 0:
        dp = 1
        if args.role in ("learner", "apex"):
            import torch
            dp = max(1, torch.cuda.device_count())
    return (dp,)


def config_from_args(args: argparse.Namespace) -> ApexConfig:
    return ApexConfig(
        env=EnvConfig(env_id=args.env_id, seed=args.seed,
                      frame_stack=args.frame_stack),
        replay=ReplayConfig(capacity=args.capacity, warmup=args.warmup,
                            alpha=args.alpha, beta=args.beta),
        learner=LearnerConfig(batch_size=args.batch_size, lr=args.lr,
                              lr_decay_steps=args.lr_decay_steps,
                              lr_decay_rate=args.lr_decay_rate,
                              gamma=args.gamma, n_steps=args.n_steps,
                              target_update_interval=
                              args.target_update_interval,
                              save_interval=args.save_interval,
                              mesh_shape=_mesh_shape(args)),
        actor=ActorConfig(n_actors=args.n_actors,
                          n_envs_per_actor=args.n_envs_per_actor,
                          send_interval=args.send_interval,
                          remote_policy=args.remote_policy),
        aql=AQLConfig(),
        comms=CommsConfig(batch_port=args.batch_port,
                          param_port=args.param_port,
                          barrier_port=args.barrier_port,
                          status_port=args.status_port,
                          heartbeat_interval_s=args.heartbeat_interval,
                          suspect_after_s=args.suspect_after,
                          dead_after_s=args.dead_after,
                          park_after_s=args.park_after,
                          replay_shards=args.replay_shards,
                          replay_port_base=args.replay_port_base,
                          replay_ip=args.replay_ip,
                          replay_strict_order=not args.replay_loose,
                          replay_snapshot_s=args.replay_snapshot_every,
                          infer_port=args.infer_port,
                          infer_ip=args.infer_ip,
                          infer_batch_max=args.infer_batch_max,
                          infer_window_ms=args.infer_window_ms,
                          infer_wait_s=args.infer_wait,
                          infer_reprobe_s=args.infer_reprobe,
                          infer_device_params=args.infer_device_params,
                          infer_shards=args.infer_shards,
                          wire_codec=args.wire_codec,
                          param_delta=args.param_delta,
                          param_keyframe_every=args.param_keyframe_every),
    )


def identity_from_args(args: argparse.Namespace) -> RoleIdentity:
    return RoleIdentity(role=args.role, actor_id=args.actor_id,
                        n_actors=args.n_actors, learner_ip=args.learner_ip,
                        replay_ip=args.replay_ip)


def _refuse(what: str) -> int:
    print(f"apex_tpu_torch: {what}", file=sys.stderr, flush=True)
    return 2


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.restore and not args.checkpoint_dir:
        raise SystemExit("--restore requires --checkpoint-dir")
    if args.trace_dir:
        # the trace ring reads the env when it is made; exporting here
        # covers the worker processes too, which inherit it
        os.environ["APEX_TRACE_DIR"] = args.trace_dir
    if args.tenant:
        # the namespace reads the env at each qualification site;
        # exporting here covers the worker processes too
        os.environ["APEX_TENANT"] = args.tenant
    cfg = config_from_args(args)
    # a tenant that names an APEX_POPULATION lineage adopts its env id and
    # hyperparameter vector; no entry (or one without overrides) leaves
    # the config as it is
    from apex_tpu_torch.population.lineage import (apply_lineage,
                                                   load_population)
    from apex_tpu_torch.tenancy import namespace as tenancy_ns
    lineage = load_population().get(tenancy_ns.current_tenant())
    if lineage is not None:
        cfg = apply_lineage(cfg, lineage)
    profile_ctx = contextlib.nullcontext()
    if args.profile_dir and args.role in PROFILED_ROLES:
        from apex_tpu_torch.utils.profiling import trace
        profile_ctx = trace(args.profile_dir)
    try:
        with profile_ctx:
            return _dispatch(args, cfg, identity_from_args(args))
    except NotImplementedError as exc:      # a path not ported yet
        return _refuse(str(exc))


def _stop_on_sigterm(sigint: bool = False) -> threading.Event:
    """A stop event that SIGTERM sets: a role asked to stop leaves its
    loop, drains its send window, closes its sockets and exits with
    status 0.  ``sigint`` (the learner role): the first SIGINT sets it
    too, so a Ctrl-C to the fleet's process group lets the learner finish
    its step and write ``fleet_summary.json``; a second SIGINT raises
    ``KeyboardInterrupt`` as usual."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    if sigint:
        def _first_sigint(signum, frame):
            signal.signal(signal.SIGINT, signal.default_int_handler)
            stop.set()
        signal.signal(signal.SIGINT, _first_sigint)
    return stop


def _dispatch(args: argparse.Namespace, cfg: ApexConfig,
              identity: RoleIdentity) -> int:
    if args.role == "learner":
        from apex_tpu_torch.ops.gather import LAUNCH_COUNTS
        from apex_tpu_torch.runtime.roles import run_learner
        trainer = None
        prev_sigint = signal.getsignal(signal.SIGINT)
        try:
            trainer = run_learner(
                cfg, n_peers=args.n_actors + args.n_evaluators,
                total_steps=args.total_steps,
                max_seconds=args.max_seconds, family=args.family,
                logdir=args.logdir, verbose=args.verbose,
                checkpoint_dir=args.checkpoint_dir,
                train_ratio=args.train_ratio,
                min_train_ratio=args.min_train_ratio,
                barrier_timeout_s=args.barrier_timeout,
                restore=args.restore, rollout=args.rollout,
                device=args.device,
                rollout_len=args.rollout_len or None,
                steps_per_dispatch=args.steps_per_dispatch,
                stop_event=_stop_on_sigterm(sigint=True),
                dp_backend=args.dp_backend)
        finally:
            signal.signal(signal.SIGINT, prev_sigint)
            stats = {"gather_launches": dict(LAUNCH_COUNTS)}
            if trainer is not None:
                stats |= {"steps": trainer.steps_rate.total,
                          "ingested": trainer.ingested,
                          "service_steps": getattr(trainer, "service_steps",
                                                   0)}
                if getattr(trainer, "dp_rank_stats", None):
                    stats["dp_ranks"] = {
                        str(r): {k: rec.get(k) for k in
                                 ("steps", "gather_launches",
                                  "replay_size")}
                        for r, rec in trainer.dp_rank_stats.items()}
            print(f"learner: stats {json.dumps(stats)}", flush=True)
    elif args.role in ("replay", "infer", "loadgen"):
        _run_service(args, cfg, identity)
    elif args.role in ("serve-ctl", "tenant-ctl", "pbt-ctl"):
        _run_controller(args, cfg, identity)
    elif args.role == "status":
        return _status(args, cfg)
    elif args.role == "actor":
        from apex_tpu_torch.runtime.roles import run_actor
        run_actor(cfg, identity, family=args.family,
                  stop_event=_stop_on_sigterm(),
                  barrier_timeout_s=args.barrier_timeout)
    elif args.role == "evaluator":
        from apex_tpu_torch.runtime.roles import run_evaluator
        run_evaluator(cfg, identity, family=args.family,
                      stop_event=_stop_on_sigterm(),
                      episodes=args.episodes, logdir=args.logdir,
                      verbose=args.verbose,
                      barrier_timeout_s=args.barrier_timeout,
                      device=args.device)
    elif args.role in ("dqn", "aql", "r2d2", "apex"):
        _run_driver(args, cfg)
    elif args.role == "enjoy":
        from apex_tpu_torch.training.checkpoint import evaluate_checkpoint
        if not args.checkpoint:
            raise SystemExit("--checkpoint required for enjoy")
        hook = None
        if args.render:
            if args.render == "save" and not args.render_dir:
                raise SystemExit("--render save requires --render-dir")
            from apex_tpu_torch.utils.render import make_render_hook
            hook = make_render_hook(args.render, args.render_dir)
        score = evaluate_checkpoint(args.checkpoint,
                                    episodes=args.episodes or 10,
                                    render_hook=hook, device=args.device)
        print(f"enjoy: mean episode reward {score:.2f}")
    return 0


def _status(args: argparse.Namespace, cfg: ApexConfig) -> int:
    """The operator's view of a running learner
    (``apex_tpu/runtime/cli.py:613-660``): one REQ round trip to its
    status server for the fleet table, or with ``--metrics`` the
    Prometheus text (with ``--http`` a sidecar proxying each scrape).
    Exits 1 when no learner answers."""
    where = (f"{args.learner_ip}:{cfg.comms.status_port} (learner not "
             f"running, or an in-host trainer with no status server)")
    if args.metrics:
        if args.http:
            from apex_tpu_torch.obs.metrics import make_http_sidecar
            server = make_http_sidecar(cfg.comms, port=args.http,
                                       learner_ip=args.learner_ip)
            print(f"metrics sidecar: http://0.0.0.0:{args.http}/metrics "
                  f"-> zmq {args.learner_ip}:{cfg.comms.status_port}",
                  flush=True)
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.server_close()
            return 0
        from apex_tpu_torch.obs.metrics import metrics_request
        text = metrics_request(cfg.comms, learner_ip=args.learner_ip)
        if text is None:
            print(f"no metrics from {where}")
            return 1
        print(text, end="")
        return 0
    from apex_tpu_torch.fleet.registry import (format_fleet_table,
                                               status_request)
    snap = status_request(cfg.comms, learner_ip=args.learner_ip)
    if snap is None:
        print(f"no fleet status from {where}")
        return 1
    print(format_fleet_table(snap))
    return 0


def _run_service(args: argparse.Namespace, cfg: ApexConfig,
                 identity: RoleIdentity) -> None:
    """The replay, infer and loadgen roles: no startup barrier, on
    ``--device``, until SIGTERM or ``--max-seconds``; their final
    counters go to stdout as one ``<identity>: stats {...}`` line."""
    from apex_tpu_torch.runtime.roles import _with_ips
    cfg = cfg.replace(comms=_with_ips(cfg.comms, identity))
    if args.role == "replay":
        if not 0 <= args.shard_id < max(1, cfg.comms.replay_shards):
            raise SystemExit(
                f"--shard-id {args.shard_id} outside [0, "
                f"{cfg.comms.replay_shards}): set --replay-shards/"
                f"APEX_REPLAY_SHARDS fleet-wide")
        from apex_tpu_torch.replay_service.service import run_replay_shard
        name = f"replay-{args.shard_id}"
        stats = run_replay_shard(
            cfg, args.shard_id, family=args.family,
            stop_event=_stop_on_sigterm(), max_seconds=args.max_seconds,
            snapshot_dir=args.replay_snapshot_dir, device=args.device)
    elif args.role == "infer":
        if not 0 <= args.infer_shard_id < max(1, cfg.comms.infer_shards):
            raise SystemExit(
                f"--infer-shard-id {args.infer_shard_id} outside [0, "
                f"{cfg.comms.infer_shards}): set --infer-shards/"
                f"APEX_INFER_SHARDS fleet-wide")
        from apex_tpu_torch.infer_service.service import run_infer_server
        name = f"infer-{args.infer_shard_id}"
        stats = run_infer_server(
            cfg, family=args.family, server_id=args.infer_shard_id,
            stop_event=_stop_on_sigterm(), max_seconds=args.max_seconds,
            device=args.device)
    else:
        from apex_tpu_torch.runtime.roles import run_loadgen
        name = f"loadgen-{identity.actor_id}"
        stats = run_loadgen(cfg, identity, family=args.family,
                            stop_event=_stop_on_sigterm(),
                            max_seconds=args.max_seconds,
                            rollout_len=args.rollout_len or None,
                            device=args.device)
    print(f"{name}: stats {json.dumps(stats)}", flush=True)


def _run_controller(args: argparse.Namespace, cfg: ApexConfig,
                    identity: RoleIdentity) -> None:
    """The three controllers: no barrier (each holds until the learners
    it probes answer), one control round every ``--serve-interval``
    seconds until SIGTERM or ``--max-seconds``; the final snapshot goes
    to stdout as one ``<role>: snapshot {...}`` line."""
    from apex_tpu_torch.runtime.roles import _with_ips
    cfg = cfg.replace(comms=_with_ips(cfg.comms, identity))
    stop = _stop_on_sigterm()
    if args.role == "serve-ctl":
        from apex_tpu_torch.serving.deploy import run_serve_ctl
        snap = run_serve_ctl(cfg, identity,
                             canary_frac=args.serve_canary_frac,
                             soak_s=args.serve_soak,
                             version_every=args.serve_version_every,
                             interval_s=args.serve_interval,
                             stop_event=stop, max_seconds=args.max_seconds)
    elif args.role == "tenant-ctl":
        from apex_tpu_torch.tenancy.scheduler import run_tenant_ctl
        snap = run_tenant_ctl(cfg, interval_s=args.serve_interval,
                              stop_event=stop, max_seconds=args.max_seconds)
    else:
        from apex_tpu_torch.population.controller import run_pbt_ctl
        snap = run_pbt_ctl(cfg, interval_s=args.serve_interval,
                           decide_every_s=args.pbt_decide,
                           frac=args.pbt_frac,
                           resample_prob=args.pbt_resample,
                           min_episodes=args.pbt_min_episodes,
                           stop_event=stop, max_seconds=args.max_seconds)
    print(f"{args.role}: snapshot {json.dumps(snap)}", flush=True)


def _run_driver(args: argparse.Namespace, cfg: ApexConfig) -> None:
    """The single-host drivers: construct, restore if asked, train."""
    kw = dict(logdir=args.logdir, verbose=args.verbose,
              checkpoint_dir=args.checkpoint_dir, device=args.device)
    if args.role in ("dqn", "aql", "r2d2"):
        if args.role == "dqn":
            from apex_tpu_torch.training.dqn import DQNTrainer as cls
        elif args.role == "aql":
            from apex_tpu_torch.training.aql import AQLTrainer as cls
        else:
            from apex_tpu_torch.training.r2d2 import R2D2Trainer as cls
        train_kw = dict(total_frames=args.total_frames)
    else:
        if args.rollout != "host" and args.family != "dqn":
            raise NotImplementedError(
                f"--rollout {args.rollout} serves the dqn family only (got "
                f"{args.family!r}); aql/r2d2 stay on the host pipeline")
        kw |= dict(train_ratio=args.train_ratio,
                   min_train_ratio=args.min_train_ratio,
                   dp_backend=args.dp_backend)
        if args.family == "aql":
            from apex_tpu_torch.training.aql import AQLApexTrainer as cls
        elif args.family == "r2d2":
            from apex_tpu_torch.training.r2d2 import R2D2ApexTrainer as cls
        elif args.rollout == "fused":
            from apex_tpu_torch.ondevice.fused import FusedApexTrainer as cls
            kw |= dict(rollout_len=args.rollout_len or None,
                       steps_per_dispatch=args.steps_per_dispatch)
        else:
            from apex_tpu_torch.training.apex import ApexTrainer as cls
            if args.rollout == "ondevice":
                from apex_tpu_torch.training.anakin import (
                    AnakinPool, make_anakin_engine)
                kw["pool"] = AnakinPool(cfg, make_anakin_engine(
                    cfg, rollout_len=args.rollout_len or None,
                    device=args.device))
        train_kw = dict(total_steps=args.total_steps,
                        max_seconds=args.max_seconds)
    trainer = cls(cfg, **kw)
    try:
        if args.restore:
            trainer.restore()
        trainer.train(**train_kw)
    finally:
        close = getattr(trainer, "close", None)
        if close is not None:
            close()            # the sharded plan's other ranks


if __name__ == "__main__":
    raise SystemExit(main())
