#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure before any result line:

1. build   -- compile the hand-written CUDA kernels from ``csrc/``.
2. kernels -- hold each kernel (``gather_rows``, ``gather_stacks``,
   ``tree_update``) bit-exact against its plain PyTorch version on the
   card over every copy path and caller's geometry, and time kernel,
   plain version and the library call (CUDA events, median) at the
   learner's shapes.
3. reference -- a small learner (42x42 Catch frames, f32, TF32 off) run
   on the card and on the CPU from the same weights, chunks and sample
   uniforms: batches bit-exact, losses and weights within tolerance.
4. slice   -- the Ape-X frame-pool learner (``ApexTrainer``) at full
   width on ``ApexCatch-v0``: 84x84x1 u8 frames, stack 4, batch 512,
   capacity 2^19, frame ring 2^20, 512-transition / 528-frame chunks
   made by an in-process acting loop.  Ingest until warm, then fused
   steps; checks losses, priorities, the sum tree, the target sync, that
   ``gather_stacks`` ran once per step (obs and next_obs together) and
   ``gather_rows`` not at all, and that ``tree_update`` ran once per
   chunk ingested and once per step's priority write-back.
5. train    -- the system as its users run it: ``ApexTrainer.train`` with
   4 spawned actor processes x 8 envs acting on the CPU (32 ladder
   slots, 64-transition chunks) feeding the learner on the card over the
   shared-memory chunk ring, at the geometry of phase 4 with a
   4096-transition warm-up, for 100 learner steps: first with its default
   ingest pipeline, then with the serial drain, printed side by side.
   Checks the steps, the ring, the param publishes the actors acted on,
   one ``gather_stacks`` launch per learner step and no ``gather_rows``,
   more ``tree_update`` launches than steps, finite metrics, the sum
   tree, that no actor process and no segment outlive ``train()`` and,
   pipelined, merged warm-up slots and publishes through the staging
   thread; prints the dispatch counts, learner
   steps/s, env frames/s, the actors' phase fractions and peak memory.
   Then, in this process at a worker's thread count, one worker's vector
   family times its serial interleave against a helper-thread overlap of
   its two half-groups, with a bf16 and an f32 policy.
6. pipeline -- phase 4's chunks through ``train()`` from a list pool,
   pipeline on and off in turns (on, off, off, on) under deterministic
   cuDNN: the same dispatches and bit-equal weights, optimizer, replay
   and generator; host ms per fused step, the staging thread's time per
   slot, and the host cost of the pieces of staging one chunk.
7. checkpoint -- a trainer at capacity 2^16 (a 2^17-row ring, to bound
   the disk) takes 4 steps and saves; a fresh trainer restores; both
   take 4 more steps, bit-equal; ``evaluate_checkpoint`` scores the file
   with no trainer.  Prints the file's bytes and the save and restore
   seconds, and removes the directory.
8. dqn      -- ``DQNTrainer`` on ``ApexCartPole-v0`` at the model spec's
   widths for 2048 frames (warm-up 512, an update every 4 frames, batch
   512, autosaves every 100 updates): finite metrics, the autosaves;
   prints frames/s and updates/s.
9. r2d2     -- the recurrent family.  A small recurrent learner (42x42,
   f32, TF32 off) on the card and on the CPU from the same weights,
   pooled sequence messages and uniforms: sampled sequences bit-exact,
   losses within rtol 1e-4.  Then ``R2D2ApexTrainer.train`` at full
   width: ``ApexCatch-v0`` single frames into the pooled sequence replay
   (capacity 2^16 sequences, a 1 277 952-row ring), the spec's widths
   (bf16 convs, LSTM 128), burn-in 8 + unroll 16 + n-step 3, batch 512
   sequences, 4 actor processes x 8 envs over the shm ring, warm-up 4096
   transitions, 50 learner steps with the default pipeline.  Checks the
   steps, one ``gather_rows`` launch of 13 824 rows per step and no
   ``gather_stacks``, finite metrics and priorities, the sum tree, the
   publishes the actors acted on, that no process or segment outlives
   ``train()``; prints learner steps/s, sequences/s, env frames/s, a
   synchronised fused step's ms and peak memory.  Last, ``R2D2Trainer``
   for 1024 frames on the same geometry.  Phase 2 times ``gather_rows``
   at this sample's shape.
10. ondevice -- the on-device planes, at phase 5's geometry
   (``ApexCatch-v0`` 84x84x1 u8, stack 4, batch 512, capacity 2^19, ring
   2^20, the 32-lane ladder, 64-transition chunks, rollout_len 64).
   Batched Catch and Rally, 32 lanes x 512 steps, bit-equal on the card
   and on the CPU from the same draws and actions.  The rollout engine on
   ``ApexRally-v0`` at eps 1, card against CPU from the same f32 weights
   and draws, TF32 off: chunks bit-equal, q-values and priorities within
   rtol 1e-4 plus 1e-4 x max |q|.  The engine alone on Catch and Rally:
   no host sync in its step loop (CUDA's sync-debug error mode), device
   launches per env step under the profiler, env frames/s over 8 warm
   dispatches.  ``ApexTrainer.train`` over ``AnakinPool`` for 100 steps,
   pipelined and serial; ``FusedApexTrainer.train`` (4 macro steps per
   dispatch, one learner step each) for 16 steps; each checks one
   ``gather_stacks`` launch per learner step, priority write-backs, the
   sum tree and finite metrics, and prints learner steps/s, env frames/s,
   ms per engine dispatch and peak memory beside phase 5's.  Last, a
   small ``FusedApexTrainer`` on the card under deterministic cuDNN:
   2 dispatches of 3 macro steps bit-equal to 6 of 1.
11. aql      -- the AQL family at its published widths (embed 128,
   proposal 128, Q feature 64-64, action embed 128-64, NoisyNet 64-1;
   100 proposal + 400 uniform candidates, batch 512, capacity 2^19, bf16
   compute).  11a: one AQL learner core on the card and on the CPU (f32,
   TF32 off, the same weights, messages, uniforms and draws), stacked
   continuous and frame-pool pixels: sampled batches and ``best_idx``
   equal, losses and leaves within rtol 1e-4, weights within rtol 1e-4
   plus 5% of one Adam step, tree roots equal their leaves.  11b/11c:
   ``AQLApexTrainer.train`` with 4 actor processes x 8 envs over the shm
   ring, pipelined, warm-up 4096, 50 learner steps, on
   ``ApexContinuousNav-v0`` (T = 500, a 2.1 GB stacked replay) and on
   pixel ``ApexCatch-v0`` (frame stack 4, T = 103, the frame pool with
   the ``a_mu`` sidecar): the steps, ``gather_stacks`` launches equal to
   the pixel path's learner steps and none on the continuous path, the
   candidate sets resident, finite metrics, the sum tree, publishes, no
   process or segment left; prints learner steps/s, env frames/s, the
   actors' phase fractions, a synchronised fused step's ms and peak
   memory.  11d: ``AQLTrainer`` on ``ApexContinuousNav-v0``, warm-up 512
   (cut from 50 000) then 1024 frames, an update every 4: frames/s and
   updates/s.  11e: a pixel ``AQLApexTrainer`` at capacity 2^16 (to
   bound the file) consumes 11c's messages, saves, restores bit-equal
   (both Adam groups, the sidecar), takes 4 more steps bit-equal, and
   ``evaluate_checkpoint`` scores the file with mu-only heads.

12. roles    -- the socket roles and the CLI, at phase 5's geometry
   (``ApexCatch-v0`` 84x84x1 u8, stack 4, batch 512, capacity 2^19, ring
   2^20, 64-transition chunks, warm-up 4096, target interval 500).  12a
   (``remote_train``): ``run_learner`` in this process on the card with
   its default ingest pipeline, 4 actor processes x 8 envs (CPU, the
   pool's thread count) and 1 evaluator (on the card) launched as
   ``python -m apex_tpu_torch.runtime --role actor|evaluator`` with the
   ``ACTOR_ID``/``N_ACTORS``/``LEARNER_IP`` env twins on free ports, for
   60 learner steps: one ``gather_stacks`` launch per step and no
   ``gather_rows``, publishes the actors acted on, actor and evaluator
   (``actor_id`` -1) episode stats, heartbeats from every role, no wire
   rejects, finite metrics, the sum tree; then SIGTERM, every role exits
   0 and every port binds again.  Prints learner steps/s, env frames/s,
   chunks, wire bytes per chunk and peak memory beside phase 5's.  12b
   (``remote_codec``): the same with 2 actors, 40 steps, ``--wire-codec
   dict`` and param deltas: coded chunks decoded, none rejected, deltas
   and keyframes published; prints the raw/wire byte ratios.  12c:
   ``--role dqn`` on ``ApexCartPole-v0`` for 1024 frames through the CLI
   with no ``--device``: exit 0 and logged metrics.
13. services -- the services at phase 12a's geometry, every role but the
   learner launched through the CLI on free ports.  13-ref: a strict
   ``ReplayShardCore`` on the card against ``ApexTrainer.consume`` over
   72 chunks from the same sample generator, under deterministic cuDNN:
   params, target, optimizer, every replay field and the generator
   bit-equal; the shard's ``gather_stacks`` against its plain version.
   13a (``replay_service``): ``run_learner`` with ``--replay-shards 2``,
   two ``--role replay`` shards on the card and 4 actors x 8 envs, 60
   steps: chunks at both shards, every step on a shard batch (local
   fallback steps counted apart and equal to the learner's launches),
   write-backs equal to the batches served less at most
   ``replay_presample`` per shard, no rejects, each shard's root equal to
   its leaves and its own ``gather_stacks`` launches equal to its
   batches (its stats line).  13b (``remote_policy``): one ``--role
   infer`` server on the card and 4 ``--remote-policy`` actors: remote
   steps, at most 10% fallbacks after the first reply, the server's
   requests, dispatches and batch sizes.  13c (``loadgen``): a 32-lane
   ``--role loadgen`` against the learner role, 40 steps.  13d
   (``ondevice_socket`` / ``fused_socket``): the learner role with
   ``--rollout ondevice`` and ``fused`` and one CLI evaluator, at least
   20 steps and an evaluator episode each.  Every run checks one learner
   ``gather_stacks`` per learner step (13a: per fallback step), finite
   metrics and each role's exit 0 on SIGTERM with its ports free after,
   and prints steps/s, env frames/s, wire bytes and peak memory per
   process.
14. fleet -- the fleet and observability planes at phase 12a's geometry.
   14-ref: phase 4's chunks through the pipelined ``train()`` twice,
   ``APEX_OBS_SPANS=1`` and ``=0``: the learners bit-equal, every chunk's
   span joined.  14a (``fleet_chaos``): the learner role with 4 actors
   under ``python -m apex_tpu_torch.fleet.supervise`` and 1 evaluator;
   ``CHAOS_SEED`` kills actor-0 and actor-1 at send 50 (registry
   windows cut to 2 s / 4 s, reaction bar 0.4, ``train_ratio`` 1,
   ``min_train_ratio`` 0.5): both walk SUSPECT, DEAD and ALIVE after the
   supervisor's respawn, the floor relaxes at 50% DEAD and is restored,
   the ``actor_dead_frac`` SLO's edges land in ``fleet_summary.json``,
   ``--role status`` prints 4 actors and the evaluator ALIVE and
   ``--metrics`` the ``apex_fleet_*`` / ``apex_slo_*`` rows; one
   ``gather_stacks`` per step, every role exits 0 on SIGTERM, no port
   bound.  14b (``fleet_trace`` / ``fleet_trace_nospans``): 12a's
   topology with ``--trace-dir``: one trace file per process, merged by
   ``python -m apex_tpu_torch.obs.merge`` into one timeline holding the
   lineage hops sealed to prio_wb; ``latency_summary()``; then spans
   off, steps/s and env frames/s beside.  14c (``fleet_shards``): two
   replay shards, the learner in its second life under
   ``{"epoch_skew": {"learner": -1}}``: each shard rejects and counts
   the stale write-backs, applies none and keeps its root equal to its
   leaves.  14d (``fleet_profile``): ``--role learner --profile-dir``:
   the trace names the gather kernel once per learner step.
15. control -- the control planes at phase 12a's geometry.  15-ref: an
   ``InferServer`` at full width through freeze, canary, rollback and
   promote with ``infer_device_params`` off and on (the rollback gives
   back the incumbent's tensors and replies bit for bit), and
   ``restore_weights`` of a donor's checkpoint into a live learner (its
   ``train_state`` bit-equal, its epoch up by one, its next update on a
   fixed batch equal to the donor's).  15a (``ctl_serve``): the learner
   role, 2 ``--role infer`` shards, 4 ``--remote-policy`` actors, 1
   evaluator and ``--role serve-ctl``: one version PROMOTED, then a
   second evaluator under a chaos ``score_bias`` breaches ``eval_score``
   and the next version is ROLLED_BACK, shard 0 pinned back on the
   weights it served before the canary.  15b (``ctl_tenant``): tenants
   ``t0`` and ``rally`` (``ApexRally-v0``, its learner through the CLI)
   on 2 shared replay shards with a partition each and rally's quota
   biting, and ``--role tenant-ctl``: rally's learner stopped, rally
   EVICTED and t0's band grown to both shards while t0 trains.  15c
   (``ctl_pbt``): lineages ``la`` (CLI) and ``lb`` (in the script) and
   ``--role pbt-ctl``: lb, ranked last by a chaos ``score_bias``, takes
   an exploit from la, its ``train_state`` bit-equal to la's checkpoint,
   its epoch on the param channel, the mutated lr live.  Every role exits
   0 and no port stays bound.
16. tools -- the port's launcher, soak and lint.  16a (``launch``):
   ``python -m apex_tpu_torch.runtime.launch ApexCatch-v0 2 40 2`` with
   ``APEX_REPLAY_SHARDS=2`` on free ports and ``APEX_DEVICE=cuda``: two
   replay shards, 2 actors x 2 envs, the evaluator and the learner
   (the launcher's own batch 64, capacity 8192, warm-up 500) run to the
   step target and exit 0; the learner's gather launches equal its local
   steps and each shard's equal its sampled batches; the trace dir holds
   ``merged_trace.json``; no process is left and no port bound; prints
   the seconds from launch to the barrier.  16b (``soak``): CI's
   ``slo-smoke`` drill: ``python -m apex_tpu_torch.obs.soak --loadgen 1``
   over the launcher with remote-policy actors and a supervised infer
   server that chaos kills at its 40th request, a ``fleet.supervise
   --scale-signal slo`` probe beside it, the SLO windows cut to a 180 s
   budget that ends (the learner's SIGINT) once ``infer_rt_p99_ms`` has
   RESOLVED: it walks OK, BURNING, BREACHED, RESOLVED; the
   artifact is an ``apex_soak`` with samples, compliance under 100 and a
   breach; the probe scales up; the learner's gather launches equal its
   steps; no process is left.  Prints steps/s, offered and ingested
   frames and the seconds from the kill to each edge.  16c (``lint``):
   ``python -m apex_tpu_torch.analysis --strict`` under ``-X importtime``
   exits 0 having imported none of torch, numpy, JAX, flax or msgpack.
17. dp -- the sharded learner (``apex_tpu_torch.parallel``) on the one
   card, at phase 4's width per rank (84x84x1 u8, stack 4, batch 512 =
   256 per rank, capacity 2^19 and ring 2^20 per rank).  17-build: two
   fresh rank processes use the gather kernels at once, building one
   empty library directory: each gathers exactly, one whole library is
   left, and it prints how many compiled.  17a (``dp_reference``): a
   2-rank ``ShardedLearner`` over gloo on ``cuda:0`` (this process and
   one spawned rank; rank 1's weights arrive by broadcast) for 8 fused
   steps of phase 4's chunks, one per rank per group, under
   deterministic cuDNN, against an in-process reference that computes
   each shard's loss and grads apart and steps once on their mean: the
   ranks' weights and metrics bit-identical after every step, each
   rank's IS weights those of the normalizer over both shards, the
   weights within 1e-6 of the reference (and whether bit-equal), one
   ``gather_stacks`` per rank per step; then the step's all-reduce timed
   alone.  17b (``dp_train``): ``ApexTrainer.train`` with
   ``mesh_shape=(2,)`` and ``dp_backend="gloo"`` on ``"cuda"``, phase
   5's actors and chunking on rank 0's pool, warm-up 4096, 60 learner
   steps: every rank's steps and gather launches, shard sizes adding up
   to the ingest, publishes, finite metrics, no rank, actor or segment
   left; prints steps/s beside phase 5's, the update all-reduce's ms per
   step and each rank's peak memory.  17c (``dp_nccl1``):
   ``ShardedLearner`` at world size 1 over NCCL, 4 fused steps bit-equal
   to the unsharded fused step.  17d (``dp_fused``):
   ``FusedApexTrainer.train`` with ``mesh_shape=(2,)`` over gloo, phase
   10's 32 lanes (16 per rank) at ``rollout_len`` 16, 16-transition
   chunks, capacity 2^16 per rank, warm-up 1024, one learner step per
   dispatch, under deterministic cuDNN (the spawned rank takes rank 0's
   flags): each rank's gather launches equal the steps; both shards,
   gathered to the host, and the weights bit-equal to an in-process
   reference (the two ranks' trainers in threads of this process over
   gloo, as many dispatches); prints env frames/s and learner steps/s
   beside phase 10's fused rate.  17e (``dp_anakin``):
   ``ApexTrainer.train`` at dp 2 over an ``AnakinPool`` (phase 10's
   engine on rank 0 acting with rank 0's published weights, its chunks
   aggregated one per rank), 40 steps: every rank's steps and launches,
   the shards adding up to the ingest.  17f (``dp_service``): 13a's two
   replay shards and 4 x 8 actors with ``run_learner`` at dp 2, 20
   steps: every service batch trains on both ranks and every write-back
   goes to its shard.  17g (``dp_checkpoint``): a dp 2 ``ApexTrainer``
   at capacity 2^16 per rank on phase 4's chunks (serial drain,
   deterministic cuDNN) trains 4 steps, saves, trains 4 more on the same
   ranks; a fresh trainer restores the file and trains 4: the two final
   bundles (train state, both shards, every generator) bit-equal; no
   rank process is left after ``close()``.

Then it prints the card's name and power limit, one ``{"kernels": ...}``
line (``launches`` counts each kernel's main path: phase 5's pipelined
``train()`` for ``gather_stacks`` and ``tree_update``, phase 9's for
``gather_rows``;
``launches_by_path`` adds the serial drain, phase 4's consume path,
phases 6-9, phase 10's ``anakin_train``, ``anakin_serial`` and
``fused_train``, phase 11's ``aql_continuous``, ``aql_pixel``,
``aql_single`` and ``aql_checkpoint``, phase 12's ``remote_train``
and ``remote_codec`` and phase 13's ``replay_service`` (the learner's),
``replay_service_shards`` (the shard processes' own launches),
``remote_policy``, ``loadgen``, ``ondevice_socket`` and
``fused_socket``, and phase 14's ``fleet_spans``, ``fleet_chaos``,
``fleet_trace``, ``fleet_trace_nospans``, ``fleet_shards``,
``fleet_shards_shards`` and ``fleet_profile``, and phase 15's
``ctl_serve``, ``ctl_tenant`` (the learner's), ``ctl_tenant_shards``
(the shard processes' own) and ``ctl_pbt``, phase 16's ``launch``
(the learner process's own count), ``launch_shards`` and ``soak``, and
phase 17's ``dp_reference``, ``dp_train``, ``dp_fused``, ``dp_anakin``,
``dp_service`` (the learner ranks'), ``dp_service_shards`` and
``dp_checkpoint``, summed over the ranks and per rank as
``dp_reference_rank0`` ... ``dp_checkpoint_rank1``, and ``dp_nccl1``) and, last, ``{"ok": true, "device": {...}}``.  It needs one card and exits
nonzero without one.  ``--profile DIR`` also traces a few more
fused steps of phases 4, 9 and 11 (continuous and pixels) with
``torch.profiler``, writes device time by op and by kernel to DIR and
prints the gather and copy kernels' device time.
``--parent DIR`` also builds the ``gather_rows`` kernel of an earlier
checkout unpacked at DIR and times it beside this one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1122
WARMUP_CHUNKS = 8            # ingest-only chunks before the first step
TRAIN_STEPS = 24             # fused steps timed on phase 4's path
CAPACITY = 2 ** 19           # transitions; the frame ring holds twice as many
BATCH = 512
TARGET_INTERVAL = 10         # target syncs at steps 10 and 20
N_ENVS = 32                  # acting envs batched into one policy call
PROFILE_STEPS = 8            # extra fused steps traced with --profile
# phase 5: bench.py part 2's topology
N_ACTORS, ENVS_PER_ACTOR, SEND_INTERVAL = 4, 8, 64
TRAIN_WARMUP = 4096          # transitions resident before the first step
LOOP_STEPS = 100             # learner steps of train()
LOOP_SECONDS = 120.0         # train()'s wall-clock bound


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def zero_launches(gather) -> None:
    """A path starts: zero the launch counters of the gather and tree
    kernels (``ops/gather.py``, ``ops/tree.py``)."""
    from apex_tpu_torch.ops import tree
    for counts in (gather.LAUNCH_COUNTS, tree.LAUNCH_COUNTS):
        for name in counts:
            counts[name] = 0


def read_launches(gather) -> dict:
    """A path ends: each hand-written kernel's launches in this process
    since :func:`zero_launches`."""
    from apex_tpu_torch.ops import tree
    return {**gather.LAUNCH_COUNTS, **tree.LAUNCH_COUNTS}


def gather_part(launches: dict) -> dict:
    """The gather kernels' part of a path's launches."""
    return {k: launches[k] for k in ("gather_rows", "gather_stacks")}


def stats_launches(st: dict) -> dict:
    """Another process's launches, from its stats record."""
    return {**st["gather_launches"], **st["tree_launches"]}


def summed(counts: list) -> dict:
    """Launches of several processes (shards, ranks) added up."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


# -- timing ----------------------------------------------------------------

# published device-memory rates (bytes/s) by card name, NVIDIA data sheets
_MEMORY_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                ("H200", 4.8e12), ("H100", 3.35e12))
FLUSH_BYTES = 128 * 2 ** 20     # over twice an H100's 50 MB L2


def memory_rate(name: str) -> float:
    """Published device-memory rate of the card called ``name``."""
    for key, rate in _MEMORY_RATE:
        if key in name:
            return rate
    raise SmokeFailure(f"no published memory rate for card {name!r}")


def time_ms(fns: dict, iters: int = 30, warmup: int = 3) -> dict:
    """Median device time of one call of each ``fns[name](i)`` (``i``
    indexes a fresh input per call, so the rows come cold from device
    memory).  The card first runs a sleep kernel long enough for the host
    to enqueue every timed call behind it, so each pair of events brackets
    device work only, not the host's launch gaps.  Calls are interleaved
    round-robin.  Before each call, outside its events, a read of
    ``FLUSH_BYTES`` evicts what the previous call left in the L2 cache
    (writing back its output) and leaves only clean lines there, so every
    call starts from the same cache state; without it a gather's time
    depended on which call ran before it."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for name, fn in fns.items():
        for i in range(warmup):
            fn(i)
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    torch.cuda._sleep(200_000_000)          # ~0.1 s at H100 clocks
    for it in range(iters):
        for name, fn in fns.items():
            flush.amax()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(warmup + it)
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: statistics.median(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in events.items()}


# -- phase 2: kernels ------------------------------------------------------

FRAME = (84, 84, 1)          # one ApexCatch frame: a 7056-byte ring row
STACK = 4
RING_ROWS = 2 ** 20          # the slice's frame ring
# phase 9's geometry: sequences of burn-in 8 + unroll 16 + n-step 3
R2D2_T = 8 + 16 + 3
R2D2_ROWS = BATCH * R2D2_T   # ring rows gathered per R2D2 learner step
R2D2_RING_ROWS = 1_277_952   # r2d2_frame_capacity at capacity 2^16


def parent_gather_rows(root: str, gather):
    """``gather_rows`` of the checkout at ``root`` (an earlier commit of
    this repo, whose ``gather.cu`` has the same ``apex_gather_rows`` C
    entry point), built beside this one's library."""
    import ctypes

    from apex_tpu_torch.ops import cuda_build

    lib_path = os.path.join(cuda_build.BUILD_DIR, "libapex_gather_parent.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    lib_path, os.path.join(root, "apex_tpu_torch", "ops",
                                           "csrc", "gather.cu")],
                   check=True, capture_output=True, text=True)
    entry = ctypes.CDLL(lib_path).apex_gather_rows
    entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    entry.restype = ctypes.c_int

    def run(frames, ids):
        out = torch.empty((ids.shape[0], frames.shape[1]), dtype=frames.dtype,
                          device=frames.device)
        err = entry(frames.data_ptr(), ids.data_ptr(), out.data_ptr(),
                    ids.shape[0], frames.shape[0],
                    frames.shape[1] * frames.element_size(),
                    torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"parent gather_rows launch failed: cudaError {err}")
        return out
    return run


def library_stacks(ring, ids, shape):
    """``gather_stacks`` as two torch calls: ``index_select``, then the
    movedim/reshape copy into the contiguous (N, H, W, S*C) layout."""
    n, s = ids.shape
    rows = torch.index_select(ring, 0, ids.view(-1)).view(n, s, *shape)
    return rows.movedim(1, -2).reshape(
        n, *shape[:-1], s * shape[-1]).contiguous()


def _exact(name: str, cases: list, kernel, plain) -> float:
    """Hold ``kernel`` bit-exact against ``plain`` on every case; returns
    the largest absolute difference seen (0 when all agree)."""
    max_err = 0.0
    for what, *args in cases:
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.is_contiguous(),
              f"{name}: shape or layout differs from plain version: {what}")
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name} != plain version: {what}")
        log(f"kernel {name} {what}: bit-exact")
    return max_err


def kernel_phase(dev, gather, card: str,
                 parent: str | None = None) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(SEED)
    d = math.prod(FRAME)
    rate = memory_rate(card)

    def u8(rows, width):
        return torch.empty((rows, width), dtype=torch.uint8,
                           device=dev).random_(0, 256, generator=g)

    def rand_ids(*shape, high=RING_ROWS):
        return torch.randint(0, high, shape, dtype=torch.int32, device=dev,
                             generator=g)

    ring = u8(RING_ROWS, d)
    ring3 = u8(4096, 3 * d)                                # 84x84x3 frames
    small = ring3[:, :42 * 42].contiguous()                # 1764-byte rows
    small3 = ring3[:, :42 * 42 * 3].contiguous()           # 5292-byte rows
    odd = ring3[:, :1763].contiguous()
    ring_f32 = torch.randn((4096, 1024), device=dev, generator=g)
    vec_f32 = ring_f32[:, :136].contiguous()
    off16 = u8(1, 512 * d + 16).view(-1)[4:4 + 512 * d].view(512, d)
    edge = torch.tensor([0, RING_ROWS - 1, RING_ROWS - 1, 7, 0, 0,
                         RING_ROWS - 1, 1], dtype=torch.int32, device=dev)
    n = 2 * 512 * STACK // 2                   # PR 1's per-call row count
    rows_err = _exact("gather_rows", [
        ("u8 D=7056, N=2048 over F=2^20 (bulk copies)", ring, rand_ids(n)),
        ("u8 D=7056, repeated + boundary ids", ring, edge),
        ("u8 D=1764 (4-byte path)", small, rand_ids(n, high=4096)),
        ("u8 D=1763 (byte path)", odd, rand_ids(n, high=4096)),
        ("f32 D=1024 (bulk copies)", ring_f32, rand_ids(n, high=4096)),
        ("u8 D=7056, ring base 4 bytes past 16 (4-byte path)", off16,
         rand_ids(n, high=512)),
    ], gather.gather_rows, gather.gather_rows_reference)
    if parent:
        parent_rows = parent_gather_rows(parent, gather)
        _exact("parent checkout's gather_rows",
               [("u8 D=7056, N=2048 over F=2^20", ring, rand_ids(n))],
               parent_rows, gather.gather_rows_reference)
    stacks_err = _exact("gather_stacks", [
        ("(84,84,1) S=4, ids [1024, 4] over F=2^20 (bulk, byte transpose)",
         ring, rand_ids(1024, STACK), FRAME),
        ("(84,84,1) S=4, repeated + boundary ids", ring, edge.view(2, 4),
         FRAME),
        ("(84,84,1) S=1 (bulk row copies)", ring, rand_ids(512, 1), FRAME),
        ("(84,84,3) S=4 (bulk, byte interleave)", ring3,
         rand_ids(512, 4, high=4096), (84, 84, 3)),
        ("(42,42,3) S=4 (byte path)", small3, rand_ids(512, 4, high=4096),
         (42, 42, 3)),
        ("(42,42,3) S=1 (4-byte row path)", small3,
         rand_ids(512, 1, high=4096), (42, 42, 3)),
        ("(42,42,1) S=4 (byte path)", small, rand_ids(512, 4, high=4096),
         (42, 42, 1)),
        ("f32 (32,32,1) S=4 (bulk, word interleave)", ring_f32,
         rand_ids(512, 4, high=4096), (32, 32, 1)),
        ("f32 (136,) S=4 (bulk row copies)", vec_f32,
         rand_ids(512, 4, high=4096), (136,)),
        ("(84,84,1) S=4, ring base 4 bytes past 16 (byte path)", off16,
         rand_ids(256, 4, high=512), FRAME),
    ], gather.gather_stacks, gather.gather_stacks_reference)
    del ring3, small, small3, odd, ring_f32, vec_f32, off16

    rows = {}
    for count in (n, 2 * n):
        sets = [rand_ids(count) for _ in range(33)]
        fns = {
            "kernel": lambda i: gather.gather_rows(ring, sets[i]),
            "plain": lambda i: gather.gather_rows_reference(ring, sets[i]),
            "library": lambda i: torch.index_select(ring, 0, sets[i]),
        }
        if parent:
            fns["parent"] = lambda i: parent_rows(ring, sets[i])
        rows[count] = time_ms(fns)
        moved = 2 * count * d + 4 * count     # rows read + written, ids read
        rows[count]["bound"] = moved / rate * 1e3
        log(f"gather_rows N={count} D={d}: kernel "
            f"{rows[count]['kernel']:.6f} ms, plain "
            f"{rows[count]['plain']:.6f} ms, index_select "
            f"{rows[count]['library']:.6f} ms, bound "
            f"{rows[count]['bound']:.6f} ms ({moved} B at {rate:.3g} B/s)"
            + (f", parent checkout's kernel {rows[count]['parent']:.6f} ms"
               if parent else ""))
    sets = [rand_ids(2 * BATCH, STACK) for _ in range(33)]
    st = time_ms({
        "kernel": lambda i: gather.gather_stacks(ring, sets[i], FRAME),
        "plain": lambda i: gather.gather_stacks_reference(ring, sets[i],
                                                          FRAME),
        "library": lambda i: library_stacks(ring, sets[i], FRAME),
    })
    moved = 2 * sets[0].numel() * d + 4 * sets[0].numel()
    st["bound"] = moved / rate * 1e3
    log(f"gather_stacks ids [{2 * BATCH}, {STACK}] D={d}: kernel "
        f"{st['kernel']:.6f} ms, plain {st['plain']:.6f} ms, index_select + "
        f"re-layout copy {st['library']:.6f} ms, bound {st['bound']:.6f} ms "
        f"({moved} B at {rate:.3g} B/s)")
    del ring, sets
    torch.cuda.empty_cache()

    # the R2D2 learner's sample (phase 9): B*T rows over the pooled ring
    ring = u8(R2D2_RING_ROWS, d)
    rows_err = max(rows_err, _exact("gather_rows", [
        (f"u8 D=7056, N={R2D2_ROWS} over F={R2D2_RING_ROWS} (the R2D2 "
         f"sample)", ring, rand_ids(R2D2_ROWS, high=R2D2_RING_ROWS))],
        gather.gather_rows, gather.gather_rows_reference))
    sets = [rand_ids(R2D2_ROWS, high=R2D2_RING_ROWS) for _ in range(33)]
    fns = {"kernel": lambda i: gather.gather_rows(ring, sets[i]),
           "plain": lambda i: gather.gather_rows_reference(ring, sets[i]),
           "library": lambda i: torch.index_select(ring, 0, sets[i])}
    if parent:
        fns["parent"] = lambda i: parent_rows(ring, sets[i])
    seq = time_ms(fns)
    moved = 2 * R2D2_ROWS * d + 4 * R2D2_ROWS
    seq["bound"] = moved / rate * 1e3
    log(f"gather_rows N={R2D2_ROWS} D={d} over F={R2D2_RING_ROWS} (the "
        f"R2D2 sample): kernel {seq['kernel']:.6f} ms, plain "
        f"{seq['plain']:.6f} ms, index_select {seq['library']:.6f} ms, "
        f"bound {seq['bound']:.6f} ms ({moved} B at {rate:.3g} B/s)"
        + (f", parent checkout's kernel {seq['parent']:.6f} ms"
           if parent else ""))
    del ring, sets
    torch.cuda.empty_cache()
    common = dict(route="cuda", source="apex_tpu_torch/ops/csrc/gather.cu",
                  replaces="apex_tpu/ops/gather.py:71", bound_by="bytes")
    # gather_rows' own path is the R2D2 learner's, at its sample's shape;
    # PR 1's N = 2048 over the DQN ring stays beside it
    return [dict(name="gather_rows", max_abs_err=rows_err,
                 ms=seq["kernel"], plain_ms=seq["plain"],
                 bound_ms=seq["bound"], library_ms=seq["library"],
                 at_n2048=dict(ms=rows[n]["kernel"],
                               plain_ms=rows[n]["plain"],
                               bound_ms=rows[n]["bound"],
                               library_ms=rows[n]["library"]),
                 **common),
            dict(name="gather_stacks", max_abs_err=stacks_err,
                 ms=st["kernel"], plain_ms=st["plain"], bound_ms=st["bound"],
                 library_ms=st["library"], **common),
            tree_row(dev, rate)]


def tree_row(dev, rate: float) -> dict:
    """``apex_tree_update`` (``ops/tree.py`` on card trees, one launch)
    held bit-exact against ``tree.update_plain`` (the CPU path's loop run
    on the same card tensors) at the callers' geometries, then timed
    against it on both trees at capacity 2^16: K = 512 sampled leaves with
    repeats (the learner's priority write-back) and K = 64 consecutive
    ones (an ingest).  The loop's ~260 launches are queued 3 updates at a
    time behind the sleep kernel, so its time is device time too; the
    host ms of each is a synchronised run of 50 updates.  The bytes bound
    reads the indices and leaves once and writes each distinct node of
    both trees once; the kernel is bound by its 17 dependent levels."""
    from apex_tpu_torch.ops import tree

    g = torch.Generator(device=dev).manual_seed(SEED + 18)

    def filled(capacity: int):
        s = tree.init_sum_tree(capacity, dev)
        m = tree.init_min_tree(capacity, dev)
        idx = torch.arange(capacity, device=dev)
        v = torch.rand(capacity, device=dev, generator=g) * 4
        return (tree.update_plain(s, idx, v, torch.add),
                tree.update_plain(m, idx, v, torch.minimum))

    def leaves(capacity: int, k: int, ingest: bool = False, pad: int = 0,
               dtype=torch.int64):
        """``k`` consecutive slots from a random start, the last ``pad``
        clamped to repeat the one before (an ingest, padded as SeqPool's
        chunks are), or ``k`` sampled slots with repeats (a write-back);
        values agree wherever indices do."""
        if ingest:
            start = torch.randint(0, capacity, (1,), device=dev, generator=g)
            idx = (start + torch.arange(k, device=dev).clamp_max(
                k - 1 - pad)) % capacity
        else:
            idx = torch.randint(0, capacity, (k,), device=dev, generator=g)
        table = torch.rand(capacity, device=dev, generator=g) + 0.01
        return idx.to(dtype), table[idx]

    def plain(which, s, m, idx, v):
        if which != "min":
            tree.update_plain(s, idx, v, torch.add)
        if which != "sum":
            tree.update_plain(m, idx, v, torch.minimum)

    def kernel(which, s, m, idx, v):
        {"both": lambda: tree.update_both(s, m, idx, v),
         "sum": lambda: tree.update_sum(s, idx, v),
         "min": lambda: tree.update_min(m, idx, v)}[which]()

    def on_copies(update):
        def run(which, s, m, idx, v):
            s, m = s.clone(), m.clone()
            update(which, s, m, idx, v)
            return torch.cat([s, m])
        return run

    t16, t19 = filled(2 ** 16), filled(2 ** 19)
    err = _exact("tree_update", [
        ("C=2^16 K=512 sampled with repeats (write-back)", "both", *t16,
         *leaves(2 ** 16, 512)),
        ("C=2^16 K=64 consecutive (ingest)", "both", *t16,
         *leaves(2 ** 16, 64, ingest=True)),
        ("C=2^19 K=512 (the smoke's DQN learner, a replay shard)", "both",
         *t19, *leaves(2 ** 19, 512)),
        ("C=2^19 K=64 consecutive", "both", *t19,
         *leaves(2 ** 19, 64, ingest=True)),
        ("C=2^16 K=32, the last 12 clamped to repeat (R2D2's padded "
         "sequences)", "both", *t16,
         *leaves(2 ** 16, 32, ingest=True, pad=12)),
        ("C=2^16 K=256 (a dp rank's half of the batch)", "both", *t16,
         *leaves(2 ** 16, 256)),
        ("C=2^16 K=512 int32 indices", "both", *t16,
         *leaves(2 ** 16, 512, dtype=torch.int32)),
        ("C=2^16 K=2049 (grid-stride past one block)", "both", *t16,
         *leaves(2 ** 16, 2049)),
        ("C=2^16 K=512 update_sum alone", "sum", *t16,
         *leaves(2 ** 16, 512)),
        ("C=2^16 K=512 update_min alone", "min", *t16,
         *leaves(2 ** 16, 512)),
    ], on_copies(kernel), on_copies(plain))
    del t19

    def nodes(idx, capacity: int) -> int:
        leaf = idx.long() + capacity
        return int(torch.cat([leaf >> level for level in range(
            capacity.bit_length())]).unique().numel())

    def host_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            fn(i % 33)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 50 * 1e3

    out = {}
    for k, ingest in ((512, False), (64, True)):
        sets = [leaves(2 ** 16, k, ingest) for _ in range(33)]

        def run_kernel(i):
            kernel("both", *t16, *sets[i])

        def run_plain(i):
            plain("both", *t16, *sets[i])
        res = time_ms({"kernel": run_kernel})
        res |= time_ms({"plain": run_plain}, iters=3, warmup=1)
        res["host"] = host_ms(run_kernel)
        res["plain_host"] = host_ms(run_plain)
        idx = sets[0][0]
        moved = k * (idx.element_size() + 4) + 2 * 4 * nodes(idx, 2 ** 16)
        res["bound"] = moved / rate * 1e3
        out[k] = res
        what = "ingest" if ingest else "write-back"
        log(f"tree_update C=2^16 K={k} ({what}), both trees: kernel "
            f"{res['kernel']:.6f} ms device, "
            f"{res['host']:.6f} ms host; plain loop {res['plain']:.6f} ms "
            f"device, {res['plain_host']:.6f} ms host; bound "
            f"{res['bound']:.6f} ms ({moved} B at {rate:.3g} B/s)")
    del t16
    torch.cuda.empty_cache()
    w, i = out[512], out[64]
    return dict(name="tree_update", max_abs_err=err, ms=w["kernel"],
                plain_ms=w["plain"], bound_ms=w["bound"], host_ms=w["host"],
                plain_host_ms=w["plain_host"],
                at_k64=dict(ms=i["kernel"], plain_ms=i["plain"],
                            bound_ms=i["bound"], host_ms=i["host"],
                            plain_host_ms=i["plain_host"]),
                route="cuda", source="apex_tpu_torch/ops/csrc/tree.cu",
                replaces="none (apex_tpu/ops/tree.py is jnp)",
                bound_by="latency")


# -- chunk streams ---------------------------------------------------------

def act(trainer, n_chunks: int, n_envs: int, seed: int) -> list[dict]:
    """In-process acting: ``n_envs`` Catch envs, one batched policy call on
    the card per vector step, each env slot feeding its own
    FrameChunkBuilder; returns the first ``n_chunks`` chunk messages."""
    from apex_tpu_torch.envs.registry import make_env
    from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                    drain_builder_chunks)

    cfg = trainer.cfg
    frame_shape = trainer.replay.frame_shape
    envs = [make_env(cfg.env.env_id, cfg.env, seed=seed + i)
            for i in range(n_envs)]
    builders = [FrameChunkBuilder(cfg.learner.n_steps, cfg.learner.gamma,
                                  trainer.replay.frame_stack, frame_shape,
                                  chunk_transitions=cfg.actor.send_interval)
                for _ in envs]
    stacked = builders[0].stacked_shape()
    view = np.zeros((n_envs,) + stacked, np.uint8)
    for i, (env, b) in enumerate(zip(envs, builders)):
        b.bind_acting_view(view[i])
        b.begin_episode(env.reset()[0])
    eps = cfg.actor.eps_base ** (
        1 + np.arange(n_envs) / max(1, n_envs - 1) * cfg.actor.eps_alpha)
    eps_t = torch.as_tensor(eps, dtype=torch.float32, device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    msgs: list[dict] = []
    while len(msgs) < n_chunks:
        obs = torch.as_tensor(view).to(trainer.device)
        actions, q = trainer.policy(obs, eps_t, gen)
        actions, q = actions.cpu().numpy(), q.cpu().numpy()
        for i, (env, b) in enumerate(zip(envs, builders)):
            frame, r, term, trunc, _ = env.step(int(actions[i]))
            b.add_step(int(actions[i]), r, q[i], frame, term, trunc)
            if term or trunc:
                b.begin_episode(env.reset()[0])
            msgs.extend(drain_builder_chunks(b))
    return msgs[:n_chunks]


# -- phase 3: small reference ---------------------------------------------

def reference_phase(dev) -> None:
    """The learner core on the card against the same core on the CPU."""
    import copy

    from apex_tpu_torch.models.dueling import DuelingDQN
    from apex_tpu_torch.ops.losses import make_optimizer
    from apex_tpu_torch.replay.frame_pool import FramePoolReplay
    from apex_tpu_torch.training.learner import LearnerCore
    from apex_tpu_torch.training.state import create_train_state

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    s, shape, b, k, kf = 4, (42, 42, 1), 32, 64, 80
    replay = FramePoolReplay(capacity=256, frame_shape=shape, frame_stack=s)
    model = DuelingDQN(3, (42, 42, s), compute_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(SEED))
    opt = make_optimizer(lr=1e-3)
    sides = {}
    for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        sides[name] = dict(
            core=LearnerCore(replay=replay, optimizer=opt, batch_size=b,
                             target_update_interval=2),
            ts=create_train_state(copy.deepcopy(model).to(device), opt),
            rs=replay.init(device), device=device)
    chunks = []
    for _ in range(4):
        refs = np.sort(rng.integers(0, kf - 1, (k, s)), axis=1).astype(np.int32)
        chunks.append((dict(
            frames=rng.integers(0, 255, (kf, 42 * 42), np.uint8),
            n_frames=np.int32(kf), n_trans=np.int32(k),
            action=rng.integers(0, 3, k).astype(np.int32),
            reward=rng.normal(size=k).astype(np.float32),
            discount=np.full(k, 0.97, np.float32),
            obs_ref=refs, next_ref=refs + 1),
            np.abs(rng.normal(size=k)).astype(np.float32) + 0.1,
            rng.random(b, dtype=np.float32)))
    out = {}
    for name, side in sides.items():
        side["core"].ingest(side["rs"], *chunks[0][:2])
        batch = replay.sample(
            side["rs"], torch.from_numpy(chunks[0][2]).to(side["device"]),
            0.4)[0]
        losses = []
        for chunk, prios, offsets in chunks[1:]:
            _, _, m = side["core"].fused_step(
                side["ts"], side["rs"], chunk, prios,
                torch.from_numpy(offsets).to(side["device"]), 0.4)
            losses.append(m["loss"].item())
        out[name] = (batch, losses, [p.detach().cpu() for p in
                                     side["ts"].params.parameters()])
    for key in ("obs", "next_obs", "action"):
        check(torch.equal(out["cuda"][0][key].cpu(), out["cpu"][0][key]),
              f"reference: sampled {key} differs between card and CPU")
    # f32 on both sides, TF32 off: conv/matmul summation order differs
    # between cuDNN/cuBLAS and the CPU kernels, so agreement is to f32
    # round-off carried through 3 updates, not bitwise
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               err_msg="reference: losses")
    for pg, pc in zip(out["cuda"][2], out["cpu"][2]):
        np.testing.assert_allclose(pg.numpy(), pc.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg="reference: weights")
    torch.backends.cudnn.allow_tf32 = tf32
    log(f"reference: card vs CPU learner agree over {len(chunks) - 1} fused "
        f"steps (losses {out['cuda'][1]})")


# -- phase 4: the slice ----------------------------------------------------

def profile_steps(trainer, msgs: list, out_dir: str,
                  name: str = "chip_smoke_profile.txt") -> None:
    """Run fused steps under ``torch.profiler`` and write the device time
    by op to ``out_dir``.  Device time is the sum of the kernels' and
    copies' durations; each op's share is the device time of what it
    launched itself; the busy share is device time over wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for msg in msgs:
            trainer.consume([msg])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    n = len(msgs)
    device_us = sum(a.self_device_time_total for a in avgs
                    if a.device_type == DeviceType.CUDA)
    launches = sum(a.count for a in avgs if a.device_type == DeviceType.CUDA)
    ops = sorted((a for a in avgs if a.device_type == DeviceType.CPU
                  and a.self_device_time_total > 0),
                 key=lambda a: a.self_device_time_total, reverse=True)
    lines = [f"{n} fused steps under the profiler: wall {wall_us / n:.1f} "
             f"us/step, device {device_us / n:.1f} us/step, busy "
             f"{device_us / wall_us:.3f}, {launches / n:.1f} device "
             f"launches/step",
             "self device us/step  calls/step  op"]
    lines += [f"{a.self_device_time_total / n:19.1f}  {a.count / n:10.1f}  "
              f"{a.key}" for a in ops]
    kernels = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                     key=lambda a: a.self_device_time_total, reverse=True)
    lines += ["device us/step  calls/step  kernel or copy"]
    lines += [f"{a.self_device_time_total / n:14.1f}  {a.count / n:10.1f}  "
              f"{a.key[:120]}" for a in kernels]
    # the stack rebuild and every copy that moves the batch's bytes again
    moves = [line for line in lines[len(lines) - len(kernels):]
             if any(k in line for k in ("gather", "bulk_kernel", "reg_kernel",
                                        "Cat", "copy", "Copy", "Memcpy"))]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    log("profile: " + "\nprofile: ".join(lines[:16]) + f"\nprofile: -> {path}")
    log("profile: gather and copy kernels, device us/step  calls/step\n"
        "profile: " + "\nprofile: ".join(moves))


def slice_phase(dev, gather, profile_dir: str | None = None) -> dict:
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, ReplayConfig)
    from apex_tpu_torch.training.apex import ApexTrainer

    chunk = 512
    cfg = ApexConfig(
        env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
        replay=ReplayConfig(capacity=CAPACITY, warmup=WARMUP_CHUNKS * chunk),
        learner=LearnerConfig(batch_size=BATCH,
                              target_update_interval=TARGET_INTERVAL),
        actor=ActorConfig(send_interval=chunk))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = ApexTrainer(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"slice: ApexTrainer built in {time.perf_counter() - t0:.3f} s "
        f"(ring {tuple(trainer.replay_state.frames.shape)} u8, capacity "
        f"{trainer.replay.capacity}, batch {trainer.core.batch_size})")
    t0 = time.perf_counter()
    n_profiled = PROFILE_STEPS if profile_dir else 0
    msgs = act(trainer, WARMUP_CHUNKS + TRAIN_STEPS + n_profiled, N_ENVS,
               SEED)
    msgs, profiled = msgs[:WARMUP_CHUNKS + TRAIN_STEPS], msgs[len(msgs) -
                                                              n_profiled:]
    log(f"slice: acting made {len(msgs)} chunks in "
        f"{time.perf_counter() - t0:.3f} s")
    check(all(int(m["payload"]["n_trans"]) == chunk for m in msgs),
          "slice: acting shipped a partial chunk")
    check(all(m["payload"]["frames"].shape == (chunk + 16, 84 * 84)
              for m in msgs), "slice: chunk frame rows are not 528 x 7056")

    ts = trainer.train_state
    step_ms, synced = [], 0
    zero_launches(gather)                             # main path starts
    for msg in msgs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps_before = trainer.steps
        metrics = trainer.consume([msg])
        torch.cuda.synchronize()
        if trainer.steps == steps_before:
            continue
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(math.isfinite(float(v)) for v in metrics.values()),
              f"slice: non-finite metrics at step {trainer.steps}: {metrics}")
        if ts.step % TARGET_INTERVAL == 0:
            for p, t in zip(ts.params.parameters(),
                            ts.target_params.parameters()):
                check(torch.equal(p, t), "slice: target != online after sync")
            synced += 1
    launches = read_launches(gather)                  # main path ends

    check(trainer.steps == TRAIN_STEPS == ts.step,
          f"slice: {trainer.steps} fused steps, train state at {ts.step}")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": TRAIN_STEPS},
          f"slice: gather launches {launches} in {TRAIN_STEPS} steps (want "
          f"one gather_stacks per step and no gather_rows)")
    check(launches["tree_update"] == len(msgs) + TRAIN_STEPS,
          f"slice: tree launches {launches} for {len(msgs)} chunks and "
          f"{TRAIN_STEPS} steps (want one per ingest, one per priority "
          f"write-back)")
    check(synced == TRAIN_STEPS // TARGET_INTERVAL,
          f"slice: {synced} target syncs")
    rs = trainer.replay_state
    c = trainer.replay.capacity
    leaves = rs.sum_tree[c:c + rs.size]
    check(bool(torch.isfinite(leaves).all()) and bool((leaves > 0).all()),
          "slice: non-finite or non-positive priorities")
    root, total = rs.sum_tree[1].item(), leaves.double().sum().item()
    check(abs(root - total) <= 1e-5 * total,
          f"slice: sum-tree root {root} != sum of leaves {total}")
    peak = torch.cuda.max_memory_allocated(dev)
    steady = step_ms[2:]
    ms = statistics.median(steady)
    log(f"slice: {TRAIN_STEPS} fused steps after {WARMUP_CHUNKS} ingest-only "
        f"chunks; ms/step median {ms:.3f} (mean {statistics.mean(steady):.3f}, "
        f"first {step_ms[0]:.3f}), steps/s {1e3 / ms:.2f}, last loss "
        f"{float(metrics['loss']):.6f}, peak memory {peak / 2**30:.3f} GiB, "
        f"gather launches {launches}, target syncs {synced}")
    if profiled:
        profile_steps(trainer, profiled, profile_dir)
    return dict(launches=launches, ms_per_step=ms, peak_bytes=peak,
                msgs=msgs)


# -- phase 5: train() with actor processes ---------------------------------

def _finite_logged(trainer, extra: tuple = ()) -> int:
    """Check every learner metric train() logged is finite (the DQN
    metrics and ``extra``); returns how many values were checked."""
    n = 0
    for name in ("loss", "grad_norm", "q_mean", "td_mean") + extra:
        values = [v for _, v in trainer.log.history.get(f"learner/{name}",
                                                        [])]
        check(all(math.isfinite(v) for v in values),
              f"train: non-finite {name} logged: {values}")
        n += len(values)
    return n


def train_phase(dev, gather, pipelined: bool) -> dict:
    """``ApexTrainer.train`` with actor processes, with the default ingest
    pipeline (``pipelined``) or the serial drain."""
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, ReplayConfig)
    from apex_tpu_torch.native.ring import SEGMENT_PREFIX
    from apex_tpu_torch.training.apex import ApexTrainer

    cfg = ApexConfig(
        env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
        replay=ReplayConfig(capacity=CAPACITY, warmup=TRAIN_WARMUP),
        learner=LearnerConfig(batch_size=BATCH, target_update_interval=500,
                              ingest_pipeline=pipelined),
        actor=ActorConfig(n_actors=N_ACTORS, n_envs_per_actor=ENVS_PER_ACTOR,
                          send_interval=SEND_INTERVAL, timing_interval=32))
    what = "train" if pipelined else "train (serial drain)"
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = ApexTrainer(cfg, publish_min_seconds=0.5)   # on "cuda"
    pool = trainer.pool
    log(f"{what}: {N_ACTORS} actor processes x {ENVS_PER_ACTOR} envs, "
        f"{pool.threads} torch threads each, chunks of {SEND_INTERVAL} "
        f"transitions, warm-up {TRAIN_WARMUP}, batch {BATCH}, capacity "
        f"{CAPACITY}, ring {trainer.replay.f_capacity} rows, ingest "
        f"pipeline {cfg.learner.ingest_pipeline}")
    zero_launches(gather)                             # main path starts
    t0 = time.perf_counter()
    trainer.train(total_steps=LOOP_STEPS, max_seconds=LOOP_SECONDS,
                  log_every=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(gather)                  # main path ends

    check(trainer.steps == LOOP_STEPS,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s, want "
          f"{LOOP_STEPS} within {LOOP_SECONDS} s")
    check(pool.chunk_plane == "shm",
          f"{what}: chunks rode {pool.chunk_plane}, not the shm ring")
    check(trainer.param_version >= 2,
          f"{what}: {trainer.param_version} param publishes")
    versions = [v for _, v in
                trainer.log.history.get("learner/episode_param_version", [])]
    check(bool(versions) and min(versions) > 0,
          f"{what}: episode stats' param versions {versions[:8]}")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    check(launches["tree_update"] > trainer.steps,
          f"{what}: tree launches {launches} in {trainer.steps} steps (want "
          f"one per priority write-back and more for the ingests)")
    stats = trainer._pipeline_last_stats
    if pipelined:
        # the warm-up's 64 ingest-only chunks merge; publishes ride the
        # staging thread
        check(stats is not None and stats["slots"] > 0
              and stats["merged_chunks"] >= 2 and stats["publishes"] >= 1,
              f"{what}: pipeline stats {stats}")
    else:
        check(stats is None, f"{what}: the serial drain staged {stats}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    rs, c = trainer.replay_state, trainer.replay.capacity
    leaves = rs.sum_tree[c:c + rs.size]
    root, total = rs.sum_tree[1].item(), leaves.double().sum().item()
    check(bool(torch.isfinite(leaves).all()) and bool((leaves > 0).all()),
          f"{what}: non-finite or non-positive priorities")
    check(abs(root - total) <= 1e-5 * total,
          f"{what}: sum-tree root {root} != sum of leaves {total}")
    alive = [p.pid for p in pool.procs if p.is_alive()]
    check(not alive, f"{what}: actor processes {alive} outlived train()")
    left = [f for f in os.listdir("/dev/shm")
            if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-")]
    check(not left, f"{what}: segments left in /dev/shm: {left}")

    peak = torch.cuda.max_memory_allocated(dev)
    plane = trainer.actor_plane()
    check(plane is not None, f"{what}: no actor reported its timing")
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s of train(); "
        f"dispatches {trainer.dispatches}; {trainer.ingested} transitions "
        f"ingested; param_version {trainer.param_version}; "
        f"{len(versions)} episodes drained, param versions "
        f"{min(versions)}..{max(versions)}; pipeline stats {stats}")
    log(f"{what}: learner steps/s {trainer.steps_rate.rate:.3f} (last "
        f"{min(100, trainer.steps)} steps), env frames/s ingested "
        f"{trainer.frames_rate.rate:.1f} (last 100 dispatches), "
        f"{trainer.ingested / wall:.1f} over train(); actors report "
        f"{plane['frames_per_sec_sum']:.1f} frames/s in all")
    log(f"{what}: actor phases policy_wait {plane['policy_wait_frac']:.4f} "
        f"env_step {plane['env_step_frac']:.4f} drain "
        f"{plane['drain_frac']:.4f} (mean of {plane['workers_reporting']} "
        f"workers, double_buffer {plane['double_buffer']}), stat drops "
        f"{plane['stat_drops']}; dispatch gap "
        f"{trainer._dispatch_gap.snapshot()}; peak memory "
        f"{peak / 2**30:.3f} GiB; {n_logged} logged metrics finite; "
        f"gather launches {launches}; no actor alive, no segment left")
    return dict(launches=launches, wall=wall, threads=pool.threads,
                steps_per_s=trainer.steps_rate.rate,
                frames_per_s=trainer.frames_rate.rate,
                frames_over_train=trainer.ingested / wall,
                dispatches=dict(trainer.dispatches))


def _overlapped_step(family, helper, seed: int) -> None:
    """One vector step of ``family`` with a helper thread running the
    second half-group's policy while this thread steps the first group's
    envs: the overlap the JAX workers' ``double_buffer`` buys, which the
    port's workers do not run (``apex_tpu_torch/actors/vector.py``)."""
    from apex_tpu_torch.actors.vector import group_generator

    (sl_a, sl_b), (eps_a, eps_b) = family.groups, family._group_eps()
    out_a = family._policy_group(sl_a, eps_a, group_generator(seed, 0))
    pending = helper.submit(family._policy_group, sl_b, eps_b,
                            group_generator(seed, 1))
    stats: list = []
    family._step_group(sl_a, out_a, stats)
    family._step_group(sl_b, pending.result(), stats)


def actor_phase(threads: int) -> None:
    """One worker's vector family (8 envs of ``ApexCatch-v0``) on the CPU
    at a worker's intra-op thread count: env frames/s of the serial
    interleave the workers run, and of a helper-thread overlap of the two
    half-groups, in turns (serial, overlap, overlap, serial), with the
    policy in bf16 (the model spec's dtype, which the workers keep) and
    in f32."""
    from concurrent.futures import ThreadPoolExecutor

    from apex_tpu_torch.actors.vector import (VectorDQNWorkerFamily,
                                              step_seed, worker_slots)
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig)
    from apex_tpu_torch.models.dueling import DuelingDQN, host_params
    from apex_tpu_torch.training.apex import dqn_env_specs

    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    helper = ThreadPoolExecutor(max_workers=1)
    try:
        for dtype in ("bfloat16", "float32"):
            cfg = ApexConfig(
                env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
                learner=LearnerConfig(compute_dtype=dtype),
                actor=ActorConfig(n_actors=N_ACTORS,
                                  n_envs_per_actor=ENVS_PER_ACTOR,
                                  send_interval=SEND_INTERVAL))
            spec = dqn_env_specs(cfg)[0]
            slots, seeds, eps = worker_slots(cfg, 0)
            rates = {"serial": [], "overlap": []}
            for mode in ("serial", "overlap", "overlap", "serial"):
                fam = VectorDQNWorkerFamily(cfg, spec, seeds, slots, eps,
                                            SEND_INTERVAL)
                fam.load_params(host_params(DuelingDQN(
                    **spec, generator=torch.Generator().manual_seed(SEED))))
                fam.reset_all()
                gen = torch.Generator().manual_seed(SEED)

                def step():
                    if mode == "serial":
                        fam.step_all(step_seed(gen))
                    else:
                        _overlapped_step(fam, helper, step_seed(gen))
                    fam.poll_msgs()

                for _ in range(5):
                    step()
                n = 40
                t0 = time.perf_counter()
                for _ in range(n):
                    step()
                rates[mode].append(n * fam.n_envs
                                   / (time.perf_counter() - t0))
                fam.close()
            log(f"actors: one worker's {ENVS_PER_ACTOR} envs, {dtype} "
                f"policy, {threads} torch threads: env frames/s serial "
                f"{rates['serial']}, helper-thread overlap "
                f"{rates['overlap']} (runs serial, overlap, overlap, "
                f"serial)")
    finally:
        helper.shutdown()
        torch.set_num_threads(saved)


# -- phase 6: the pipeline at full width -----------------------------------

class ListPool:
    """Phase 4's chunk list as a pool: every chunk ready from the start, an
    empty poll waits out its timeout as a real queue's does."""

    def __init__(self, msgs):
        self._msgs = list(msgs)
        self.procs = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        pass

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        if not out and timeout:
            time.sleep(timeout)
        return out


def _full_width_cfg(pipelined: bool, capacity: int = CAPACITY):
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, ReplayConfig)
    chunk = 512
    return ApexConfig(
        env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
        replay=ReplayConfig(capacity=capacity,
                            warmup=WARMUP_CHUNKS * chunk),
        learner=LearnerConfig(batch_size=BATCH,
                              target_update_interval=TARGET_INTERVAL,
                              ingest_pipeline=pipelined),
        actor=ActorConfig(send_interval=chunk))


def _same(x, y) -> bool:
    """Bit-equality of two learner states: tensors, containers of them,
    optimizer-state dataclasses and host numbers."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(map(_same, x, y))
    if dataclasses.is_dataclass(x):
        return all(_same(getattr(x, f.name), getattr(y, f.name))
                   for f in dataclasses.fields(x))
    return x == y


def _learners_equal(a, b, what: str) -> None:
    """Params, target, optimizer state (RMSprop's, or both AQL Adam
    groups'), replay state (sidecars included) and the generator of two
    trainers, bit for bit."""
    ta, tb = a.train_state, b.train_state
    for mod_a, mod_b in ((ta.params, tb.params),
                         (ta.target_params, tb.target_params)):
        for (name, x), y in zip(mod_a.state_dict().items(),
                                mod_b.state_dict().values()):
            check(torch.equal(x, y), f"{what}: weights {name} differ")
    check(ta.step == tb.step, f"{what}: step counts differ")
    check(_same(ta.opt_state, tb.opt_state),
          f"{what}: optimizer states differ")
    check(_same(a.replay_state, b.replay_state),
          f"{what}: replay states differ")
    check(torch.equal(a.generator.get_state(), b.generator.get_state()),
          f"{what}: generator states differ")


def pipeline_phase(dev, gather, msgs: list) -> dict:
    """Phase 4's chunks (8 warm-up + 24 of 512 transitions, 528 x 7056 B
    frames) through ``train()`` from a list pool, pipeline on and off in
    turns (on, off, off, on), from the same weights and seeds under
    deterministic cuDNN: the same dispatches, and bit-equal replay,
    weights and optimizer state.  Times the host interval between fused
    steps, and the staging thread's wall and CPU time per slot."""
    from apex_tpu_torch.training.apex import ApexTrainer
    from apex_tpu_torch.training.ingest_pipeline import IngestPipeline

    staging, copies = [], []
    build_slot = IngestPipeline._build_slot
    copy_to_device = IngestPipeline._copy_to_device

    def timed_build(self, first, st):
        wall, cpu, n = time.perf_counter(), time.thread_time(), len(copies)
        slot = build_slot(self, first, st)
        staging.append((time.perf_counter() - wall,
                        time.thread_time() - cpu,
                        sum(w for w, _ in copies[n:]),
                        sum(c for _, c in copies[n:])))
        return slot

    def timed_copy(self, arrays, slot):
        wall, cpu = time.perf_counter(), time.thread_time()
        copy_to_device(self, arrays, slot)
        copies.append((time.perf_counter() - wall, time.thread_time() - cpu))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    IngestPipeline._build_slot = timed_build
    IngestPipeline._copy_to_device = timed_copy
    runs = {"pipelined": [], "serial": []}
    try:
        for turn, name in enumerate(("pipelined", "serial", "serial",
                                     "pipelined")):
            pipelined = name == "pipelined"
            trainer = ApexTrainer(_full_width_cfg(pipelined),
                                  pool=ListPool(msgs), device=dev,
                                  respawn_workers=False)
            starts = []
            fused = trainer.core.fused_step

            def timed(*args, fused=fused, starts=starts):
                starts.append(time.perf_counter())
                return fused(*args)

            object.__setattr__(trainer.core, "fused_step", timed)
            staging.clear()
            copies.clear()
            zero_launches(gather)                     # this path starts
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(total_steps=TRAIN_STEPS, max_seconds=60.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches(gather)          # this path ends
            check(trainer.steps == TRAIN_STEPS == len(starts),
                  f"pipeline {name}: {trainer.steps} steps, "
                  f"{len(starts)} fused")
            check(gather_part(launches) == {"gather_rows": 0,
                                            "gather_stacks": TRAIN_STEPS},
                  f"pipeline {name}: gather launches {launches}")
            ms = (starts[-1] - starts[2]) / (len(starts) - 3) * 1e3
            stage = ""
            if pipelined:
                singles = staging[1:]              # the merged warm-up first
                mean = [1e3 * statistics.mean(x[i] for x in singles)
                        for i in range(4)]
                stage = (f"; staging per single slot {mean[0]:.3f} ms wall, "
                         f"{mean[1]:.3f} ms CPU, of which packing into "
                         f"pinned memory and the copy's launch "
                         f"{mean[2]:.3f} ms wall, {mean[3]:.3f} ms CPU "
                         f"(merged warm-up slot "
                         f"{1e3 * staging[0][0]:.3f} ms wall)")
            runs[name].append(dict(ms=ms, wall=wall, launches=launches))
            log(f"pipeline {name}: {trainer.steps} fused steps, dispatches "
                f"{trainer.dispatches}, pipeline stats "
                f"{trainer._pipeline_last_stats}; host interval between "
                f"fused steps 3..{TRAIN_STEPS} {ms:.3f} ms/step; train() "
                f"{wall:.3f} s{stage}")
            if turn == 0:
                piped = trainer
            elif turn == 1:
                check(piped.dispatches == dict(trainer.dispatches, ingest=1),
                      f"pipeline: dispatches {piped.dispatches} vs serial "
                      f"{trainer.dispatches} (the warm-up's 8 chunks merge "
                      f"into 1)")
                check(piped._pipeline_last_stats["merged_chunks"]
                      == WARMUP_CHUNKS,
                      f"pipeline: stats {piped._pipeline_last_stats}")
                _learners_equal(piped, trainer, "pipeline on vs off")
                log(f"pipeline: on and off bit-equal after {TRAIN_STEPS} "
                    f"fused steps (weights, target, optimizer, replay, "
                    f"generator)")
                del piped
            del trainer
            torch.cuda.empty_cache()
    finally:
        IngestPipeline._build_slot = build_slot
        IngestPipeline._copy_to_device = copy_to_device
        torch.backends.cudnn.deterministic = deterministic
    log("pipeline: host ms per fused step in turns (on, off, off, on): "
        f"pipelined {[round(r['ms'], 3) for r in runs['pipelined']]}, "
        f"serial {[round(r['ms'], 3) for r in runs['serial']]}")
    staging_costs(dev, msgs[WARMUP_CHUNKS]["payload"]["frames"])
    return {name: r[0] for name, r in runs.items()}


def staging_costs(dev, frames) -> None:
    """Host time of the pieces of staging one chunk's frame rows, alone on
    the learner's thread: a plain host copy, ``pin_memory()`` (the
    pipeline's copy into pinned memory), a copy into a pinned buffer made
    once, and the host-to-device copy from pinned and from pageable
    memory (each followed by a synchronise).  Median of 10."""
    import numpy as _np

    def median_ms(fn, n=10):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    src = torch.as_tensor(frames)
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)

    def h2d(t):
        t.to(dev, non_blocking=True)
        torch.cuda.synchronize()

    ms = {"host copy (numpy)": median_ms(lambda: frames.copy()),
          "pin_memory()": median_ms(lambda: src.pin_memory()),
          "copy into a pinned buffer": median_ms(
              lambda: _np.copyto(pinned.numpy(), frames)),
          "to the card from pinned": median_ms(lambda: h2d(pinned)),
          "to the card from pageable": median_ms(lambda: h2d(src))}
    log(f"staging costs for one chunk's {frames.nbytes} B of frames "
        f"({torch.get_num_threads()} torch threads): " + "; ".join(
            f"{k} {v:.3f} ms ({frames.nbytes / v / 1e6:.2f} GB/s)"
            for k, v in ms.items()))


# -- phase 7: checkpoint -----------------------------------------------------

CHECKPOINT_CAPACITY = 2 ** 16    # ring 2^17 x 7056 B, about 0.9 GiB on disk


def checkpoint_phase(dev, gather, msgs: list) -> dict:
    """Save a trainer that took a few steps, restore it into a fresh one,
    take the same 4 consume steps on both (bit-equal under deterministic
    cuDNN), and evaluate the file without a trainer."""
    import tempfile

    from apex_tpu_torch.training.apex import ApexTrainer
    from apex_tpu_torch.training.checkpoint import evaluate_checkpoint

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    zero_launches(gather)                             # this path starts
    try:
        with tempfile.TemporaryDirectory(prefix="apex-ckpt-") as tmp:
            cfg = _full_width_cfg(True, CHECKPOINT_CAPACITY)
            t1 = ApexTrainer(cfg, pool=ListPool([]), device=dev,
                             checkpoint_dir=tmp)
            for msg in msgs[:WARMUP_CHUNKS + 4]:
                t1.consume([msg])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = t1.save_checkpoint()
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            t2 = ApexTrainer(cfg, pool=ListPool([]), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t2.restore(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(t2.steps == t1.steps == 4,
                  f"checkpoint: steps {t1.steps} saved, {t2.steps} restored")
            _learners_equal(t1, t2, "checkpoint: restored")
            for trainer in (t1, t2):
                for msg in msgs[WARMUP_CHUNKS + 4:WARMUP_CHUNKS + 8]:
                    trainer.consume([msg])
            _learners_equal(t1, t2, "checkpoint: 4 steps after restore")
            score = evaluate_checkpoint(path, episodes=2, max_steps=500,
                                        device=dev)
            check(math.isfinite(score), f"checkpoint: eval score {score}")
        launches = read_launches(gather)              # this path ends
        check(launches["gather_stacks"] == 12 and launches["gather_rows"] == 0,
              f"checkpoint: gather launches {launches}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"checkpoint: capacity {CHECKPOINT_CAPACITY}, ring "
        f"{t1.replay.f_capacity} rows; file {size} bytes; save "
        f"{save_s:.3f} s, restore {restore_s:.3f} s; restored and saved "
        f"trainers bit-equal over 4 more steps; evaluate_checkpoint score "
        f"{score} (2 episodes); directory removed")
    del t1, t2
    torch.cuda.empty_cache()
    return dict(launches=launches, bytes=size, save_s=save_s,
                restore_s=restore_s)


# -- phase 8: the DQN driver -------------------------------------------------

DQN_FRAMES = 2048


def dqn_phase(gather) -> dict:
    """``DQNTrainer`` on ``ApexCartPole-v0`` at the model spec's widths
    (128-unit trunk and heads, bf16 compute, batch 512): warm-up 512,
    one update every 4 frames, autosaves every 100 updates."""
    import tempfile

    from apex_tpu_torch.config import (ApexConfig, EnvConfig, LearnerConfig,
                                       ReplayConfig)
    from apex_tpu_torch.training.dqn import DQNTrainer

    cfg = ApexConfig(env=EnvConfig(env_id="ApexCartPole-v0", seed=SEED,
                                   frame_stack=1),
                     replay=ReplayConfig(warmup=512),
                     learner=LearnerConfig(save_interval=100))
    zero_launches(gather)                             # this path starts
    with tempfile.TemporaryDirectory(prefix="apex-dqn-") as tmp:
        trainer = DQNTrainer(cfg, train_every=4, checkpoint_dir=tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(total_frames=DQN_FRAMES, log_every=50)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        saved = sorted(os.listdir(tmp))
    launches = read_launches(gather)                  # this path ends
    steps = trainer.steps_rate.total
    check(trainer.frames_rate.total == DQN_FRAMES and steps > 0,
          f"dqn: {trainer.frames_rate.total} frames, {steps} steps")
    check(trainer.train_state.step == steps, "dqn: train state step count")
    n_logged = 0
    for name in ("loss", "grad_norm", "q_mean", "td_mean"):
        values = [v for _, v in trainer.log.history.get(f"learner/{name}",
                                                        [])]
        check(bool(values) and all(math.isfinite(v) for v in values),
              f"dqn: {name} logged {values[:4]}")
        n_logged += len(values)
    want = [f"ckpt_{k}.pt" for k in range(100, steps + 1, 100)][-3:]
    check(saved == sorted(want), f"dqn: checkpoints {saved}, want {want}")
    check(gather_part(launches) == {"gather_rows": 0, "gather_stacks": 0},
          f"dqn: gather launches {launches} (the stacked replay indexes)")
    episodes = [v for _, v in trainer.log.history.get(
        "learner/episode_reward", [])]
    log(f"dqn: {DQN_FRAMES} frames and {steps} updates (batch "
        f"{cfg.learner.batch_size}, {trainer.model_spec['compute_dtype']}) "
        f"in {wall:.3f} s: {DQN_FRAMES / wall:.1f} frames/s, "
        f"{steps / wall:.2f} updates/s over the run; {n_logged} logged "
        f"metrics finite; autosaves {saved}; {len(episodes)} episodes, mean "
        f"reward {statistics.mean(episodes) if episodes else 0.0:.2f}")
    return dict(launches=launches, frames_per_s=DQN_FRAMES / wall,
                steps_per_s=steps / wall)


# -- phase 9: the recurrent (R2D2) family ------------------------------------

R2D2_CAPACITY = 2 ** 16      # sequences (the default 2^19 needs ~73 GB)
R2D2_STEPS = 50              # learner steps of R2D2ApexTrainer.train
R2D2_SECONDS = 300.0         # its wall-clock bound
R2D2_FRAMES = 1024           # env frames of the R2D2Trainer run
R2D2_WARMUP_SEQS = 64        # sequences resident before its first update
R2D2_TIMED = 10              # synchronised fused steps timed after train()


def _r2d2_cfg():
    """Phase 9's configuration: ``ApexCatch-v0`` single frames into the
    pooled sequence replay, the model spec's widths (bf16 convs, LSTM
    128, heads 128), burn-in 8, unroll 16, n-step 3, batch 512 sequences,
    4 actor processes x 8 envs."""
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, ReplayConfig)
    return ApexConfig(
        env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
        replay=ReplayConfig(capacity=R2D2_CAPACITY, warmup=TRAIN_WARMUP,
                            frame_pool=True),
        learner=LearnerConfig(batch_size=BATCH, target_update_interval=500),
        actor=ActorConfig(n_actors=N_ACTORS, n_envs_per_actor=ENVS_PER_ACTOR,
                          timing_interval=32))


def _pooled_messages(n: int, frame_shape, burn_in: int, unroll: int,
                     n_steps: int, lstm: int, group: int, rng) -> list:
    """``n`` pooled sequence messages cut from random episodes by the
    port's SequenceBuilder (carries and acting-time Q vectors random)."""
    from apex_tpu_torch.actors.r2d2 import (drain_grouped,
                                            pooled_sequence_message)
    from apex_tpu_torch.training.r2d2 import SequenceBuilder

    builder = SequenceBuilder(burn_in, unroll, n_steps, 0.99, pooled=True)
    ready, msgs = [], []
    while len(msgs) < n:
        length = int(rng.integers(3, 40))
        for t in range(length):
            carry = ((rng.normal(size=(2, lstm)) * 0.3).astype(np.float32)
                     if builder.needs_carry else (None, None))
            builder.add_step(rng.integers(0, 255, frame_shape, np.uint8),
                             int(rng.integers(0, 3)), float(rng.normal()),
                             terminated=t == length - 1, carry_c=carry[0],
                             carry_h=carry[1],
                             q_values=rng.normal(size=3).astype(np.float32))
        builder.end_episode()
        ready.extend(builder.drain())
        msgs.extend(drain_grouped(ready, group, pooled_sequence_message))
    return msgs[:n]


def r2d2_reference_phase(dev) -> None:
    """The recurrent learner core on the card against the same core on
    the CPU (42x42 frames, f32, TF32 off; the same weights, pooled
    messages and sample uniforms): sampled sequences bit-exact (the
    card's ``gather_rows`` against indexing), losses and priorities
    within rtol 1e-4, weights within rtol 1e-3 after the steps."""
    import copy

    from apex_tpu_torch.models.recurrent import RecurrentDuelingDQN
    from apex_tpu_torch.ops.losses import make_optimizer
    from apex_tpu_torch.replay.seq_pool import SequenceFramePoolReplay
    from apex_tpu_torch.training.r2d2 import R2D2Core
    from apex_tpu_torch.training.state import create_train_state

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    burn, unroll, n_steps, lstm, b, shape = 2, 4, 1, 32, 16, (42, 42, 1)
    rng = np.random.default_rng(SEED)
    msgs = _pooled_messages(6, shape, burn, unroll, n_steps, lstm, 4, rng)
    offsets = [rng.random(b, dtype=np.float32) for _ in msgs]
    replay = SequenceFramePoolReplay(
        capacity=64, t_total=burn + unroll + n_steps, lstm_features=lstm,
        frame_shape=shape, frame_capacity=512)
    model = RecurrentDuelingDQN(3, shape, compute_dtype=torch.float32,
                                lstm_features=lstm,
                                generator=torch.Generator().manual_seed(SEED))
    opt = make_optimizer(lr=1e-3)
    out = {}
    try:
        for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            core = R2D2Core(replay=replay, optimizer=opt, batch_size=b,
                            target_update_interval=2, burn_in=burn,
                            n_steps=n_steps)
            ts = create_train_state(copy.deepcopy(model).to(device), opt)
            rs = replay.init(device)
            for msg in msgs[:2]:
                core.ingest(rs, msg["payload"], msg["priorities"])
            batch = replay.sample(
                rs, torch.from_numpy(offsets[0]).to(device), 0.4)[0]
            losses, prios = [], []
            for msg, u in zip(msgs[2:], offsets[1:]):
                ts, rs, m = core.fused_step(ts, rs, msg["payload"],
                                            msg["priorities"],
                                            torch.from_numpy(u).to(device),
                                            0.4)
                losses.append(m["loss"].item())
                prios.append(rs.sum_tree[replay.capacity:].cpu().clone())
            out[name] = (batch, losses, torch.stack(prios).numpy(),
                         [p.detach().cpu() for p in ts.params.parameters()])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for key in ("obs", "action", "mask", "state_c"):
        check(torch.equal(out["cuda"][0][key].cpu(), out["cpu"][0][key]),
              f"r2d2 reference: sampled {key} differs between card and CPU")
    # f32 on both sides, TF32 off: cuDNN's convs and LSTM sum in another
    # order than the CPU's, so agreement is to f32 round-off
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               err_msg="r2d2 reference: losses")
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4,
                               err_msg="r2d2 reference: tree leaves")
    for pg, pc in zip(out["cuda"][3], out["cpu"][3]):
        np.testing.assert_allclose(pg.numpy(), pc.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg="r2d2 reference: weights")
    err = max(abs(a - c) for a, c in zip(out["cuda"][1], out["cpu"][1]))
    log(f"r2d2 reference: card vs CPU recurrent learner agree over "
        f"{len(msgs) - 2} fused steps (losses {out['cuda'][1]}, max abs "
        f"difference {err:.3g})")


class _RowsSeen:
    """Counts the rows of each ``gather_rows`` call the sequence replay
    makes (the wrapper itself counts the launches)."""

    def __init__(self):
        from apex_tpu_torch.replay import seq_pool
        self.module, self.real, self.rows = seq_pool, seq_pool.gather_rows, []

    def __enter__(self):
        def counted(frames, ids):
            self.rows.append(ids.shape[0])
            return self.real(frames, ids)
        self.module.gather_rows = counted
        return self

    def __exit__(self, *exc):
        self.module.gather_rows = self.real


def r2d2_train_phase(dev, gather, profile_dir: str | None = None) -> dict:
    """``R2D2ApexTrainer.train`` at full width with actor processes over
    the shm ring and the default ingest pipeline.  With ``profile_dir``,
    a few more fused steps on the last message run under the profiler."""
    from apex_tpu_torch.native.ring import SEGMENT_PREFIX
    from apex_tpu_torch.training.r2d2 import R2D2ApexTrainer

    what = "r2d2 train"
    cfg = _r2d2_cfg()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = R2D2ApexTrainer(cfg, publish_min_seconds=0.5)   # on "cuda"
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pool, core = trainer.pool, trainer.core
    log(f"{what}: {N_ACTORS} actor processes x {ENVS_PER_ACTOR} envs, "
        f"{pool.threads} torch threads each, messages of "
        f"{cfg.r2d2.sequence_group} sequences of {R2D2_T} steps, warm-up "
        f"{TRAIN_WARMUP} transitions, batch {BATCH} sequences, capacity "
        f"{trainer.replay.capacity} sequences, ring "
        f"{tuple(trainer.replay_state.frames.shape)} u8 "
        f"({trainer.replay.hbm_bytes() / 1e9:.3f} GB replay), built in "
        f"{build_s:.3f} s")
    ingested_seqs, last = [0], {}
    ingest = core.ingest

    def counted_ingest(rs, payload, prios):
        ingested_seqs[0] += int(payload["n_seqs"])
        last.update(payload=payload, prios=prios)
        return ingest(rs, payload, prios)

    object.__setattr__(core, "ingest", counted_ingest)
    zero_launches(gather)                             # main path starts
    with _RowsSeen() as seen:
        t0 = time.perf_counter()
        trainer.train(total_steps=R2D2_STEPS, max_seconds=R2D2_SECONDS,
                      log_every=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches(gather)                  # main path ends
    object.__setattr__(core, "ingest", ingest)
    # train()'s own counts, before the timed and profiled steps below
    steps, dispatches = trainer.steps, dict(trainer.dispatches)
    rate, ingested = trainer.steps_rate.rate, trainer.ingested
    frames_rate = trainer.frames_rate.rate

    check(trainer.steps == R2D2_STEPS == trainer.train_state.step,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s, want "
          f"{R2D2_STEPS} within {R2D2_SECONDS} s")
    check(gather_part(launches) == {"gather_rows": trainer.steps,
                                    "gather_stacks": 0},
          f"{what}: gather launches {launches} in {trainer.steps} steps "
          f"(want one gather_rows per step and no gather_stacks)")
    check(seen.rows == [R2D2_ROWS] * trainer.steps,
          f"{what}: gather_rows row counts {sorted(set(seen.rows))}, want "
          f"{R2D2_ROWS} ({BATCH} sequences x {R2D2_T} steps) per step")
    check(pool.chunk_plane == "shm",
          f"{what}: messages rode {pool.chunk_plane}, not the shm ring")
    check(trainer.param_version >= 2,
          f"{what}: {trainer.param_version} param publishes")
    versions = [v for _, v in
                trainer.log.history.get("learner/episode_param_version", [])]
    check(bool(versions) and min(versions) > 0,
          f"{what}: episode stats' param versions {versions[:8]}")
    stats = trainer._pipeline_last_stats
    check(stats is not None and stats["slots"] > 0
          and stats["merged_slots"] == 0 and stats["publishes"] >= 1,
          f"{what}: pipeline stats {stats} (sequence messages never merge)")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    rs, c = trainer.replay_state, trainer.replay.capacity
    leaves = rs.sum_tree[c:c + rs.size]
    root, total = rs.sum_tree[1].item(), leaves.double().sum().item()
    check(bool(torch.isfinite(leaves).all()) and bool((leaves > 0).all()),
          f"{what}: non-finite or non-positive priorities")
    check(abs(root - total) <= 1e-5 * total,
          f"{what}: sum-tree root {root} != sum of leaves {total}")
    check(rs.size == min(ingested_seqs[0], c),
          f"{what}: {rs.size} sequences resident, {ingested_seqs[0]} "
          f"ingested")
    alive = [p.pid for p in pool.procs if p.is_alive()]
    check(not alive, f"{what}: actor processes {alive} outlived train()")
    left = [f for f in os.listdir("/dev/shm")
            if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-")]
    check(not left, f"{what}: segments left in /dev/shm: {left}")
    peak = torch.cuda.max_memory_allocated(dev)
    plane = trainer.actor_plane()
    check(plane is not None, f"{what}: no actor reported its timing")

    # the fused step alone, synchronised, on the last message train() took
    step_ms = []
    for _ in range(R2D2_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_state, trainer.replay_state, metrics = core.fused_step(
            trainer.train_state, trainer.replay_state, last["payload"],
            last["prios"], trainer._offsets(), trainer._beta())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"{what}: non-finite metrics in the timed steps: {metrics}")
    ms = statistics.median(step_ms[2:])
    log(f"{what}: {steps} learner steps in {wall:.3f} s of train(); "
        f"dispatches {dispatches}; {ingested} transitions and "
        f"{ingested_seqs[0]} sequences ingested; param_version "
        f"{trainer.param_version}; {len(versions)} episodes drained, param "
        f"versions {min(versions)}..{max(versions)}; pipeline stats {stats}")
    log(f"{what}: learner steps/s {rate:.3f} ({rate * BATCH:.1f} sequences/s "
        f"sampled, {rate * BATCH * R2D2_T:.1f} frames/s through the "
        f"learner); sequences ingested/s {ingested_seqs[0] / wall:.2f} over "
        f"train(); env frames/s ingested {frames_rate:.1f} (last 100 "
        f"dispatches), {ingested / wall:.1f} over train(); actors report "
        f"{plane['frames_per_sec_sum']:.1f} frames/s in all")
    if profile_dir:
        msg = dict(payload=last["payload"], priorities=last["prios"],
                   n_trans=0)
        profile_steps(trainer, [msg] * PROFILE_STEPS, profile_dir,
                      "chip_smoke_profile_r2d2.txt")
    log(f"{what}: fused step at full width, synchronised, median of "
        f"{R2D2_TIMED - 2} after train(): {ms:.3f} ms (all "
        f"{[round(x, 3) for x in step_ms]}); actor phases policy_wait {plane['policy_wait_frac']:.4f} env_step "
        f"{plane['env_step_frac']:.4f} drain {plane['drain_frac']:.4f}; "
        f"peak memory {peak / 2**30:.3f} GiB; {n_logged} logged metrics "
        f"finite; gather launches {launches}, {R2D2_ROWS} rows each; no "
        f"actor alive, no segment left")
    del trainer, core, last
    torch.cuda.empty_cache()
    return dict(launches=launches, wall=wall, steps_per_s=rate,
                ms_per_fused_step=ms, peak_bytes=peak)


def r2d2_single_phase(dev, gather) -> dict:
    """``R2D2Trainer`` (the single-process driver) on phase 9's geometry:
    a 64-sequence warm-up, then an update every 4 frames."""
    from apex_tpu_torch.training.r2d2 import R2D2Trainer

    what = "r2d2 single"
    trainer = R2D2Trainer(_r2d2_cfg(), train_every=4)          # on "cuda"
    zero_launches(gather)                             # this path starts
    with _RowsSeen() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(total_frames=R2D2_FRAMES, log_every=10,
                      warmup_sequences=R2D2_WARMUP_SEQS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches(gather)                  # this path ends
    steps = trainer.steps_rate.total
    check(trainer.frames_rate.total == R2D2_FRAMES and steps > 0
          and trainer.train_state.step == steps,
          f"{what}: {trainer.frames_rate.total} frames, {steps} updates")
    check(gather_part(launches) == {"gather_rows": steps, "gather_stacks": 0}
          and seen.rows == [R2D2_ROWS] * steps,
          f"{what}: gather launches {launches} in {steps} updates, rows "
          f"{sorted(set(seen.rows))}")
    check(trainer.sequences >= R2D2_WARMUP_SEQS
          and trainer.replay_state.size == trainer.sequences,
          f"{what}: {trainer.sequences} sequences ingested, "
          f"{trainer.replay_state.size} resident")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    score = trainer.evaluate(episodes=1, max_steps=500)
    check(math.isfinite(score), f"{what}: eval score {score}")
    log(f"{what}: {R2D2_FRAMES} frames, {trainer.sequences} sequences and "
        f"{steps} updates (batch {BATCH} sequences) in {wall:.3f} s: "
        f"{R2D2_FRAMES / wall:.1f} frames/s, {steps / wall:.2f} updates/s "
        f"over the run; {n_logged} logged metrics finite; gather launches "
        f"{launches}; greedy eval {score} (1 episode)")
    del trainer
    torch.cuda.empty_cache()
    return dict(launches=launches, frames_per_s=R2D2_FRAMES / wall,
                steps_per_s=steps / wall)


# -- phase 10: the on-device planes ------------------------------------------

ONDEVICE_LANES = N_ACTORS * ENVS_PER_ACTOR    # the 32-lane ladder (4 x 8)
ONDEVICE_T = 64              # rollout_len: env steps per engine dispatch
ONDEVICE_N = 4               # steps_per_dispatch of the fused step
ENV_STEPS = 512              # batched env steps held card against CPU
REFERENCE_DISPATCHES = 2     # engine dispatches held card against CPU
ENGINE_DISPATCHES = 8        # warm engine dispatches timed per env
PROFILE_T = 8                # steps of the dispatch traced for launches
FUSED_STEPS = 16             # learner steps of FusedApexTrainer.train (from
#                              64, to bound the script's time)


def _ondevice_cfg(env_id: str, pipelined: bool = True, small: bool = False):
    """Phase 5's geometry for the on-device planes: ``env_id`` at full
    width, batch 512, capacity 2^19 (ring 2^20), the 32-lane ladder,
    64-transition chunks, a 4096-transition warm-up.  ``small`` is the
    fused == serial check's cut: ``ApexCatchSmall`` 4 lanes, batch 32,
    capacity 2^12."""
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, ReplayConfig)
    if small:
        return ApexConfig(
            env=EnvConfig(env_id=env_id, seed=SEED),
            replay=ReplayConfig(capacity=2 ** 12, warmup=64),
            learner=LearnerConfig(batch_size=32, target_update_interval=5,
                                  publish_interval=2),
            actor=ActorConfig(n_actors=1, n_envs_per_actor=4,
                              send_interval=8))
    return ApexConfig(
        env=EnvConfig(env_id=env_id, seed=SEED),
        replay=ReplayConfig(capacity=CAPACITY, warmup=TRAIN_WARMUP),
        learner=LearnerConfig(batch_size=BATCH, target_update_interval=500,
                              ingest_pipeline=pipelined),
        actor=ActorConfig(n_actors=N_ACTORS, n_envs_per_actor=ENVS_PER_ACTOR,
                          send_interval=SEND_INTERVAL))


def device_env_phase(dev) -> dict:
    """Batched Catch and Rally at 32 lanes for 512 steps on the card and on
    the CPU from the same draws and actions: observations, terminal
    frames, rewards and episode ends bit-equal at every step.  Then the
    card's env alone, timed."""
    from apex_tpu_torch.envs.device_envs import DrawSource, make_device_env

    lanes, rates = ONDEVICE_LANES, {}
    for env_id in ("ApexCatch-v0", "ApexRally-v0"):
        card = make_device_env(env_id, device=dev)
        host = make_device_env(env_id, device="cpu")
        draws = DrawSource(torch.Generator().manual_seed(SEED))
        first = draws.reset(host.reset_sites, lanes)
        steps = draws.dispatch(host.step_sites, ENV_STEPS, lanes)
        actions = torch.randint(0, 3, (ENV_STEPS, lanes),
                                generator=torch.Generator().manual_seed(SEED))
        c_steps = {k: v.to(dev) for k, v in steps.items()}
        c_actions = actions.to(dev)
        hs, h_obs = host.reset(first)
        cs, c_obs = card.reset({k: v.to(dev) for k, v in first.items()})
        check(torch.equal(c_obs.cpu(), h_obs), f"{env_id}: reset frames")
        dones = 0
        for t in range(ENV_STEPS):
            h = host.step(hs, actions[t], {k: v[t] for k, v in steps.items()})
            c = card.step(cs, c_actions[t],
                          {k: v[t] for k, v in c_steps.items()})
            hs, cs = h[0], c[0]
            for what, x, y in zip(("obs", "reward", "done", "final frame"),
                                  c[1:], h[1:]):
                check(torch.equal(x.cpu(), y),
                      f"{env_id}: {what} differs card vs CPU at step {t}")
            dones += int(h[3].sum())
        check(dones >= lanes, f"{env_id}: {dones} episode ends in "
              f"{ENV_STEPS} steps x {lanes} lanes")
        cs, _ = card.reset({k: v.to(dev) for k, v in first.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(ENV_STEPS):
            cs = card.step(cs, c_actions[t],
                           {k: v[t] for k, v in c_steps.items()})[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates[env_id] = ENV_STEPS * lanes / wall
        log(f"ondevice envs {env_id}: {ENV_STEPS} steps x {lanes} lanes "
            f"bit-equal card vs CPU (obs, final frames, rewards, dones; "
            f"{dones} episode ends); the card's env alone "
            f"{wall / ENV_STEPS * 1e3:.4f} ms per batched step, "
            f"{rates[env_id]:.1f} env frames/s")
    return rates


class _Recorded:
    """A CPU draw source that keeps what it drew, for :class:`_Played`."""

    def __init__(self, seed: int):
        from apex_tpu_torch.envs.device_envs import DrawSource
        self.source = DrawSource(torch.Generator().manual_seed(seed))
        self.log: list = []

    def reset(self, sites, n):
        self.log.append(self.source.reset(sites, n))
        return self.log[-1]

    def dispatch(self, sites, steps, n):
        self.log.append(self.source.dispatch(sites, steps, n))
        return self.log[-1]


class _Played:
    """Replays a :class:`_Recorded` source's draws, in order, on ``dev``."""

    def __init__(self, recorded: _Recorded, dev):
        self.recorded, self.dev, self.i = recorded, dev, 0

    def _next(self):
        self.i += 1
        return {k: v.to(self.dev) for k, v in
                self.recorded.log[self.i - 1].items()}

    def reset(self, sites, n):
        return self._next()

    def dispatch(self, sites, steps, n):
        return self._next()


def anakin_reference_phase(dev) -> None:
    """The rollout engine on ``ApexRally-v0`` at full width, eps 1 on every
    lane, on the card and on the CPU from the same f32 weights and draws
    with TF32 off: over two dispatches the sealed chunks' frames, refs,
    actions, rewards, discounts and counts and the episode tallies
    bit-equal; q-values and acting priorities within rtol 1e-4 plus
    1e-4 x max |q| (cuDNN's and the CPU's f32 convs round differently,
    and ``|target - q|`` magnifies it)."""
    import copy

    from apex_tpu_torch.envs.device_envs import make_device_env
    from apex_tpu_torch.models.dueling import DuelingDQN
    from apex_tpu_torch.training.anakin import (AnakinRollout,
                                                acting_priorities)
    from apex_tpu_torch.training.apex import dqn_env_specs

    cfg = _ondevice_cfg("ApexRally-v0")
    spec = dict(dqn_env_specs(cfg)[0], compute_dtype=torch.float32)
    host_model = DuelingDQN(**spec,
                            generator=torch.Generator().manual_seed(SEED))
    card_model = copy.deepcopy(host_model).to(dev)
    recorded = _Recorded(SEED)
    kw = dict(n_envs=ONDEVICE_LANES, epsilons=[1.0] * ONDEVICE_LANES,
              frame_stack=STACK, chunk_transitions=SEND_INTERVAL,
              rollout_len=ONDEVICE_T)
    host = AnakinRollout(make_device_env("ApexRally-v0", device="cpu"),
                         host_model, draws=recorded, **kw)
    card = AnakinRollout(make_device_env("ApexRally-v0", device=dev),
                         card_model, draws=_Played(recorded, dev), **kw)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst = {"q": 0.0, "priorities": 0.0}
        chunks = 0
        for d in range(REFERENCE_DISPATCHES):
            h, c = host.dispatch(), card.dispatch()
            h["priorities"] = acting_priorities(h)
            c["priorities"] = acting_priorities(c)
            c = {k: v.cpu() for k, v in c.items()}
            check(torch.equal(c["sealed"], h["sealed"]),
                  f"anakin reference: seals differ in dispatch {d}")
            real = (torch.arange(host.M)[None, :]
                    < h["sealed"][:, None])
            for key in ("frames", "action", "reward", "discount", "obs_ref",
                        "next_ref", "nf", "nt"):
                check(torch.equal(c[key][real], h[key][real]),
                      f"anakin reference: {key} differs card vs CPU in "
                      f"dispatch {d}")
            for key in ("done", "ep_ret", "ep_len"):
                check(torch.equal(c[key], h[key]),
                      f"anakin reference: {key} differs in dispatch {d}")
            chunks += int(real.sum())
            if not bool(real.any()):
                continue
            qmax = float(h["q0"][real].abs().max())
            for key, names in (("q", ("q0", "qn")),
                               ("priorities", ("priorities",))):
                for name in names:
                    x, y = c[name][real], h[name][real]
                    err = (x - y).abs()
                    check(bool((err <= 1e-4 * y.abs() + 1e-4 * qmax).all()),
                          f"anakin reference: {name} off by "
                          f"{float(err.max())} in dispatch {d}")
                    worst[key] = max(worst[key],
                                     float((err / (y.abs() + qmax)).max()))
        check(chunks > 0, "anakin reference: no chunk sealed")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    log(f"anakin reference (ApexRally-v0, {ONDEVICE_LANES} lanes x T "
        f"{ONDEVICE_T}, eps 1, f32, TF32 off): {REFERENCE_DISPATCHES} "
        f"dispatches, {chunks} sealed chunks bit-equal card vs CPU "
        f"(frames, refs, actions, rewards, discounts, counts, episode "
        f"tallies); largest |card - CPU| / (|CPU| + max|q|): q-values "
        f"{worst['q']:.3e}, priorities {worst['priorities']:.3e}")


def _profile_dispatch(engine) -> dict:
    """One engine dispatch under ``torch.profiler``, tracing the device
    only: device launches, device time and the busy share of the
    dispatch's wall time.  The engine's dispatch should be short
    (``PROFILE_T`` steps): a full one is tens of thousands of events, and
    traces of 64-step Rally dispatches counted 564-742 launches a step
    from run to run where the step's op count does not change."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.dispatch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    device_us = sum(a.self_device_time_total for a in avgs
                    if a.device_type == DeviceType.CUDA)
    launches = sum(a.count for a in avgs if a.device_type == DeviceType.CUDA)
    return dict(launches=launches, device_us=device_us, wall_us=wall_us)


def engine_phase(dev) -> dict:
    """The rollout engine alone at 32 lanes x T 64 with the DQN spec's
    bf16 model, on ``ApexCatch-v0`` and ``ApexRally-v0``: one dispatch in
    CUDA's sync-debug error mode (any host sync inside the T-step loop
    raises), the device launches of a ``PROFILE_T``-step dispatch under
    the profiler (its prologue and epilogue included), then env frames/s
    over 8 warm dispatches with the host epilogue (``rollout()``)."""
    from apex_tpu_torch.training.anakin import make_anakin_engine

    out = {}
    for env_id in ("ApexCatch-v0", "ApexRally-v0"):
        cfg = _ondevice_cfg(env_id)
        probe = make_anakin_engine(cfg, rollout_len=PROFILE_T)
        probe.dispatch()
        prof = _profile_dispatch(probe)
        del probe
        eng = make_anakin_engine(cfg, rollout_len=ONDEVICE_T)  # on "cuda"
        eng.rollout()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        frames = ENGINE_DISPATCHES * eng.T * eng.B
        t0 = time.perf_counter()
        n_msgs = 0
        for _ in range(ENGINE_DISPATCHES):
            msgs, _ = eng.rollout()
            n_msgs += len(msgs)
        wall = time.perf_counter() - t0
        check(n_msgs > 0, f"engine {env_id}: no chunk sealed")
        out[env_id] = dict(frames_per_s=frames / wall,
                           ms_per_dispatch=wall / ENGINE_DISPATCHES * 1e3)
        log(f"engine {env_id}: {eng.B} lanes x T {eng.T}, no host sync in "
            f"the step loop (sync-debug error mode); a profiled "
            f"{PROFILE_T}-step dispatch: {prof['launches']} device launches "
            f"({prof['launches'] / PROFILE_T:.1f} per env step), device "
            f"{prof['device_us'] / 1e3:.3f} ms of {prof['wall_us'] / 1e3:.3f}"
            f" ms wall, busy {prof['device_us'] / prof['wall_us']:.3f}; "
            f"{ENGINE_DISPATCHES} warm dispatches with the host epilogue: "
            f"{wall / ENGINE_DISPATCHES * 1e3:.3f} ms each, "
            f"{frames / wall:.1f} env frames/s, {n_msgs} chunks")
        del eng
    torch.cuda.empty_cache()
    return out


def _tree_consistent(rs, capacity: int, what: str) -> None:
    leaves = rs.sum_tree[capacity:capacity + rs.size]
    root, total = rs.sum_tree[1].item(), leaves.double().sum().item()
    check(bool(torch.isfinite(leaves).all()) and bool((leaves > 0).all()),
          f"{what}: non-finite or non-positive priorities")
    check(abs(root - total) <= 1e-5 * total,
          f"{what}: sum-tree root {root} != sum of leaves {total}")


def anakin_train_phase(dev, gather, pipelined: bool) -> dict:
    """``ApexTrainer.train`` fed by ``AnakinPool`` (the rollout engine on
    the card in place of actor processes) at phase 5's geometry for 100
    learner steps, with the ingest pipeline (the engine then runs on its
    staging thread) or the serial drain."""
    from apex_tpu_torch.training.anakin import AnakinPool
    from apex_tpu_torch.training.apex import ApexTrainer

    what = "anakin train" if pipelined else "anakin train (serial drain)"
    cfg = _ondevice_cfg("ApexCatch-v0", pipelined)
    torch.cuda.reset_peak_memory_stats(dev)
    pool = AnakinPool(cfg)                                # on "cuda"
    trainer = ApexTrainer(cfg, pool=pool, publish_min_seconds=0.5)
    engine, rollout_ms = pool.engine, []
    rollout = engine.rollout

    def timed_rollout():
        t0 = time.perf_counter()
        got = rollout()
        rollout_ms.append((time.perf_counter() - t0) * 1e3)
        return got

    engine.rollout = timed_rollout
    zero_launches(gather)                             # this path starts
    t0 = time.perf_counter()
    trainer.train(total_steps=LOOP_STEPS, max_seconds=LOOP_SECONDS,
                  log_every=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(gather)                  # this path ends

    check(trainer.steps == LOOP_STEPS,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    check(trainer.param_version >= 2 and pool._acting_version >= 2,
          f"{what}: {trainer.param_version} publishes, the engine acted "
          f"on version {pool._acting_version}")
    versions = [v for _, v in
                trainer.log.history.get("learner/episode_param_version", [])]
    check(bool(versions) and min(versions) >= 1,
          f"{what}: episode param versions {versions[:8]}")
    stats = trainer._pipeline_last_stats
    check((stats is not None and stats["publishes"] >= 1) if pipelined
          else stats is None, f"{what}: pipeline stats {stats}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    _tree_consistent(trainer.replay_state, trainer.replay.capacity, what)
    peak = torch.cuda.max_memory_allocated(dev)
    counters = pool.ondevice_counters()
    ms = statistics.median(rollout_ms)
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s of "
        f"train(); dispatches {trainer.dispatches}; {trainer.ingested} "
        f"transitions ingested; engine {counters}; param_version "
        f"{trainer.param_version}, the engine acted on up to "
        f"{pool._acting_version}; pipeline stats {stats}")
    log(f"{what}: learner steps/s {trainer.steps_rate.rate:.3f}, env "
        f"frames/s ingested {trainer.frames_rate.rate:.1f} (last 100 "
        f"dispatches), {trainer.ingested / wall:.1f} over train(), the "
        f"engine's {counters['frames'] / wall:.1f}; engine dispatch "
        f"{ms:.3f} ms median of {len(rollout_ms)}; peak memory "
        f"{peak / 2**30:.3f} GiB; {n_logged} logged metrics finite; gather "
        f"launches {launches}")
    out = dict(launches=launches, wall=wall,
               steps_per_s=trainer.steps_rate.rate,
               frames_over_train=trainer.ingested / wall,
               ms_per_dispatch=ms, peak_bytes=peak)
    del trainer, pool, engine
    torch.cuda.empty_cache()
    return out


def fused_train_phase(dev, gather) -> dict:
    """``FusedApexTrainer.train`` at phase 5's geometry: 32 lanes x T 64
    per macro step, 4 macro steps per dispatch, one learner step per
    macro step once warm, for ``FUSED_STEPS`` learner steps."""
    from apex_tpu_torch.ondevice.fused import FusedApexTrainer

    what = "fused train"
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = FusedApexTrainer(_ondevice_cfg("ApexCatch-v0"),
                               rollout_len=ONDEVICE_T,
                               steps_per_dispatch=ONDEVICE_N,
                               train_per_step=1)     # on "cuda"
    fused = trainer.fused
    zero_launches(gather)                             # this path starts
    t0 = time.perf_counter()
    trainer.train(total_steps=FUSED_STEPS, max_seconds=LOOP_SECONDS,
                  log_every=max(1, FUSED_STEPS // 4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(gather)                  # this path ends
    steps = trainer.steps
    check(FUSED_STEPS <= steps < FUSED_STEPS + ONDEVICE_N,
          f"{what}: {steps} learner steps in {wall:.1f} s")
    check(gather_part(launches) == {"gather_rows": 0, "gather_stacks": steps},
          f"{what}: gather launches {launches} in {steps} steps")
    check(fused.prio_writebacks == fused.train_steps == steps,
          f"{what}: {fused.prio_writebacks} write-backs, "
          f"{fused.train_steps} fused train steps, {steps} steps")
    check(trainer.ingested == fused.transitions
          == trainer.replay_state.size,
          f"{what}: {trainer.ingested} ingested, {fused.transitions} "
          f"transitions, {trainer.replay_state.size} resident")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    _tree_consistent(trainer.replay_state, trainer.replay.capacity, what)
    peak = torch.cuda.max_memory_allocated(dev)
    frames = fused.frames
    log(f"{what}: {steps} learner steps in {wall:.3f} s of train(): "
        f"{fused.dispatches} dispatches of {ONDEVICE_N} macro steps "
        f"({fused.macro_steps} in all, {wall / fused.dispatches * 1e3:.3f} "
        f"ms per dispatch), {fused.chunks} chunks, {fused.transitions} "
        f"transitions ingested, {fused.prio_writebacks} priority "
        f"write-backs; learner steps/s {steps / wall:.3f}, env frames/s "
        f"{frames / wall:.1f}; peak memory {peak / 2**30:.3f} GiB; "
        f"{n_logged} logged metrics finite; gather launches {launches}")
    del trainer, fused
    torch.cuda.empty_cache()
    return dict(launches=launches, wall=wall, steps_per_s=steps / wall,
                frames_per_s=frames / wall, peak_bytes=peak)


def fused_serial_phase(dev) -> None:
    """``FusedApexTrainer`` at a small size on the card under deterministic
    cuDNN: 2 dispatches of 3 macro steps against 6 of 1, bit-equal
    weights, optimizer, replay, generators and rollout carry."""
    import dataclasses

    from apex_tpu_torch.ondevice.fused import FusedApexTrainer

    def run(n, dispatches):
        t = FusedApexTrainer(_ondevice_cfg("ApexCatchSmall-v0", small=True),
                             rollout_len=8, steps_per_dispatch=n)
        for _ in range(dispatches):
            t.train_state, t.replay_state, _ = t.fused.dispatch(
                t.train_state, t.replay_state, t._offsets)
        return t

    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        a, b = run(3, 2), run(1, 6)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = deterministic
    check(a.train_state.step == b.train_state.step > 0,
          f"fused == serial: steps {a.train_state.step} vs "
          f"{b.train_state.step}")
    _learners_equal(a, b, "fused == serial")
    ea, eb = a.fused.engine, b.fused.engine
    check(torch.equal(ea.draws.generator.get_state(),
                      eb.draws.generator.get_state())
          and torch.equal(ea.ring, eb.ring),
          "fused == serial: engine generators or rings differ")
    for f in dataclasses.fields(ea.carry):
        x, y = getattr(ea.carry, f.name), getattr(eb.carry, f.name)
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            check(torch.equal(u, v), f"fused == serial: carry {f.name}")
    log(f"fused == serial on the card (ApexCatchSmall-v0, 4 lanes x T 8, "
        f"batch 32, deterministic cuDNN): 3 x 2 against 1 x 6 macro steps, "
        f"{a.train_state.step} learner steps each, bit-equal weights, "
        f"optimizer, replay, generators and rollout carry")


def ondevice_phase(dev, gather, phase5: dict, serial5: dict) -> dict:
    """Phase 10, in order: the envs, the engine against the CPU, the
    engine alone, ``ApexTrainer.train`` over ``AnakinPool`` pipelined and
    serial, ``FusedApexTrainer.train``, fused == serial.  Prints the
    rates beside phase 5's."""
    t0 = time.perf_counter()
    device_env_phase(dev)
    anakin_reference_phase(dev)
    t1 = time.perf_counter()
    engine = engine_phase(dev)
    t2 = time.perf_counter()
    anakin = anakin_train_phase(dev, gather, pipelined=True)
    anakin_serial = anakin_train_phase(dev, gather, pipelined=False)
    t3 = time.perf_counter()
    fused = fused_train_phase(dev, gather)
    fused_serial_phase(dev)
    t4 = time.perf_counter()
    log(f"ondevice: seconds per part: envs and reference {t1 - t0:.1f}, "
        f"engine {t2 - t1:.1f}, AnakinPool train {t3 - t2:.1f}, fused "
        f"{t4 - t3:.1f}")
    log("ondevice vs phase 5 (4 actor processes x 8 envs): learner "
        f"steps/s {anakin['steps_per_s']:.3f} / "
        f"{anakin_serial['steps_per_s']:.3f} (AnakinPool pipelined / "
        f"serial, last 100 steps), {fused['steps_per_s']:.3f} (fused, over "
        f"train()) against {phase5['steps_per_s']:.3f} / "
        f"{serial5['steps_per_s']:.3f} (phase 5 pipelined / serial, last "
        f"100 steps); env frames/s ingested over train() "
        f"{anakin['frames_over_train']:.1f} / "
        f"{anakin_serial['frames_over_train']:.1f} / "
        f"{fused['frames_per_s']:.1f} against "
        f"{phase5['frames_over_train']:.1f} / "
        f"{serial5['frames_over_train']:.1f}; engine "
        f"alone {engine['ApexCatch-v0']['frames_per_s']:.1f} (Catch), "
        f"{engine['ApexRally-v0']['frames_per_s']:.1f} (Rally) env frames/s, "
        f"{engine['ApexCatch-v0']['ms_per_dispatch']:.3f} / "
        f"{engine['ApexRally-v0']['ms_per_dispatch']:.3f} ms per dispatch")
    return dict(anakin_train=anakin["launches"],
                anakin_serial=anakin_serial["launches"],
                fused_train=fused["launches"],
                fused_rates={k: fused[k] for k in ("steps_per_s",
                                                   "frames_per_s")})


# -- phase 11: the AQL family -----------------------------------------------

AQL_PROPOSE, AQL_UNIFORM = 100, 400     # the published candidate split
AQL_T = AQL_PROPOSE + AQL_UNIFORM       # candidates per state on Box spaces
AQL_PIXEL_T = AQL_PROPOSE + 3           # ApexCatch: uniform clamped to 3
AQL_STEPS = 50               # learner steps of each AQLApexTrainer.train
AQL_SECONDS = 300.0          # their wall-clock bound
AQL_TIMED = 10               # synchronised fused steps timed after train()
AQL_FRAMES = 1024            # AQLTrainer frames past its warm-up
AQL_SINGLE_WARMUP = 512      # AQLTrainer's warm-up (the default is 50 000)
AQL_CHECKPOINT_CAPACITY = 2 ** 16   # the checkpoint's ring, 0.9 GiB on disk


def _aql_cfg(env_id: str, capacity: int = CAPACITY,
             warmup: int = TRAIN_WARMUP):
    """Phase 11's configuration: AQL's published widths (embed 128,
    proposal 128, Q feature 64-64, action embed 128-64, NoisyNet 64-1),
    100 proposal + 400 uniform candidates, batch 512, capacity 2^19, bf16
    compute, 4 actor processes x 8 envs, 64-transition chunks."""
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, AQLConfig,
                                       EnvConfig, LearnerConfig,
                                       ReplayConfig)
    return ApexConfig(
        env=EnvConfig(env_id=env_id, seed=SEED),
        replay=ReplayConfig(capacity=capacity, warmup=warmup),
        learner=LearnerConfig(batch_size=BATCH, target_update_interval=500,
                              ingest_chunk=512),
        actor=ActorConfig(n_actors=N_ACTORS, n_envs_per_actor=ENVS_PER_ACTOR,
                          send_interval=SEND_INTERVAL, timing_interval=32),
        aql=AQLConfig(propose_sample=AQL_PROPOSE,
                      uniform_sample=AQL_UNIFORM))


class _HostDraws:
    """AQL draws made by a CPU generator and moved to ``device``: the card
    and the CPU learner of the reference see the same numbers."""

    def __init__(self, seed: int, device):
        from apex_tpu_torch.models.aql import AQLDraws
        self.inner = AQLDraws(torch.Generator().manual_seed(seed))
        self.device = torch.device(device)
        self.generator = self.inner.generator

    def _to(self, tree):
        if isinstance(tree, dict):
            return {k: self._to(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(self._to(v) for v in tree)
        return tree.to(self.device)

    def proposal(self, model, b):
        return self._to(self.inner.proposal(model, b))

    def noise(self, model):
        return self._to(self.inner.noise(model))

    def explore(self, b, t):
        return self._to(self.inner.explore(b, t))


def _aql_reference_messages(pixels: bool, n: int, t: int, rng) -> list:
    """``n`` AQL messages of 16 transitions: frame chunks with an ``a_mu``
    sidecar (42x42 frames, stack 4, discrete candidates) or stacked
    continuous transitions (obs 2, A = 2)."""
    from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                    drain_builder_chunks)
    from apex_tpu_torch.training.aql import AQLTransitionBuilder

    msgs: list = []
    if pixels:
        b = FrameChunkBuilder(1, 0.99, 4, (42, 42, 1), chunk_transitions=16,
                              extra_shapes={"a_mu": (t, 1)})
        while len(msgs) < n:
            b.begin_episode(rng.integers(0, 255, (42, 42, 1), np.uint8))
            length = int(rng.integers(5, 30))
            for i in range(length):
                b.add_step(int(rng.integers(0, t)), float(rng.normal()),
                           rng.normal(size=t).astype(np.float32),
                           rng.integers(0, 255, (42, 42, 1), np.uint8),
                           i == length - 1, False,
                           extras={"a_mu": rng.integers(0, 3, (t, 1)).astype(
                               np.float32)})
            msgs.extend(drain_builder_chunks(b))
        return msgs[:n]
    b = AQLTransitionBuilder(0.99)
    for i in range(16 * n + 1):
        b.add_step(rng.normal(size=2).astype(np.float32),
                   int(rng.integers(0, t)), float(rng.normal()),
                   rng.normal(size=2).astype(np.float32),
                   rng.uniform(-1, 1, (t, 2)).astype(np.float32),
                   rng.normal(size=t).astype(np.float32), False,
                   i % 30 == 29)
    while len(b) >= 16:
        batch, prios = b.drain(16)
        msgs.append({"payload": batch, "priorities": prios, "n_trans": 16})
    return msgs[:n]


def _adam_moments(model, opt_state, mu_before: dict) -> dict:
    """Per parameter name of ``model``: its group's Adam ``mu`` and ``nu``
    after the last step and ``mu`` before it, on the host."""
    from apex_tpu_torch.ops.losses import aql_param_labels

    labels = aql_param_labels(model)
    out = {}
    for group in ("q", "proposal"):
        state = getattr(opt_state, group)
        names = [n for n in labels if labels[n] == group]
        for n, mu, nu, mu0 in zip(names, state.mu, state.nu,
                                  mu_before[group]):
            out[n] = (mu.cpu(), nu.cpu(), mu0.cpu())
    return out


def _log_weight_gaps(what: str, card: dict, cpu: dict, model, count: int,
                     lr: float, top: int = 4, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8) -> None:
    """Log the ``top`` weights furthest outside rtol 1e-4 between the card
    and the CPU, with each side's last clipped gradient (recovered from
    Adam's first moment), bias-corrected moments and last update, so the
    weights' atol rests on a reading of where the gap comes from."""
    names = [n for n, _ in model.named_parameters()]
    rows = []
    for n, pg, pc in zip(names, card["params"], cpu["params"]):
        excess = ((pg - pc).abs() - 1e-4 * pc.abs()).flatten()
        vals, idx = excess.topk(min(top, excess.numel()))
        rows += [(v, n, j) for v, j in zip(vals.tolist(), idx.tolist())]
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for _, n, j in sorted(rows, reverse=True)[:top]:
        i = names.index(n)
        pg, pc = (d["params"][i].flatten()[j].item() for d in (card, cpu))
        sides = []
        for side, d in (("card", card), ("cpu", cpu)):
            mu, nu, mu0 = (x.flatten()[j].item() for x in d["moments"][n])
            grad = (mu - b1 * mu0) / (1.0 - b1)
            mu_hat, root_nu = mu / bc1, math.sqrt(nu / bc2)
            sides.append(f"{side} |g| {abs(grad):.3e} mu_hat {mu_hat:.3e} "
                         f"sqrt(nu_hat) {root_nu:.3e} last update "
                         f"{-lr * mu_hat / (root_nu + eps):.3e}")
        log(f"{what}: weight gap {n}[{j}] |card - cpu| {abs(pg - pc):.3e} "
            f"(rtol part {1e-4 * abs(pc):.3e}, eps {eps:g}): "
            + "; ".join(sides))


def aql_reference_phase(dev) -> None:
    """11a: one AQL learner core on the card and on the CPU (f32, TF32
    off) from the same weights, messages, sample uniforms and NoisyNet
    draws, stacked continuous (T = 8 + 16, A = 2) and frame-pool pixels
    (42x42x4, T = 5 + 3 discrete): the sampled batch bit-exact, the Q
    loss, priorities and ``best_idx`` of one pass and the losses and tree
    leaves over 4 fused steps within rtol 1e-4, the weights within rtol
    1e-4 plus 5% of one Adam step, and each tree's root the sum of its
    leaves."""
    import copy

    from apex_tpu_torch.models.aql import AQLNetwork
    from apex_tpu_torch.ops.losses import aql_q_loss, make_aql_optimizer
    from apex_tpu_torch.replay.device import DeviceReplay
    from apex_tpu_torch.replay.frame_pool import FramePoolReplay
    from apex_tpu_torch.training.aql import AQLCore
    from apex_tpu_torch.training.state import TrainState

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 16
    try:
        for pixels in (False, True):
            what = f"aql reference ({'pixels' if pixels else 'continuous'})"
            rng = np.random.default_rng(SEED)
            if pixels:
                spec = dict(action_dim=3, discrete=True, propose_sample=5,
                            uniform_sample=3, obs_shape=(42, 42, 4),
                            obs_is_image=True, scale_uint8=True)
                t = 8
                replay = FramePoolReplay(capacity=64, frame_shape=(42, 42, 1),
                                         frame_stack=4,
                                         extra_spec=(("a_mu", (t, 1)),))
            else:
                spec = dict(action_dim=2, propose_sample=8,
                            uniform_sample=16, obs_shape=(2,))
                t = 24
                replay = DeviceReplay(capacity=64)
            msgs = _aql_reference_messages(pixels, 6, t, rng)
            offsets = [rng.random(b, dtype=np.float32) for _ in msgs]
            model = AQLNetwork(**spec,
                               generator=torch.Generator().manual_seed(SEED))
            opt = make_aql_optimizer(q_lr=1e-3, proposal_lr=1e-3)
            out = {}
            for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
                draws = _HostDraws(SEED, device)
                core = AQLCore(replay=replay, optimizer=opt, batch_size=b,
                               target_update_interval=2, draws=draws)
                online = copy.deepcopy(model).to(device)
                ts = TrainState(params=online,
                                target_params=copy.deepcopy(online)
                                .requires_grad_(False),
                                opt_state=opt.init(online), step=0)
                if pixels:
                    rs = replay.init(device)
                else:
                    example = {k: v[0] for k, v in msgs[0]["payload"].items()}
                    rs = replay.init(example, device)
                for msg in msgs[:2]:
                    core.ingest(rs, msg["payload"], msg["priorities"])
                batch, weights, _ = replay.sample(
                    rs, torch.from_numpy(offsets[0]).to(device), 0.4)
                _, aux = aql_q_loss(online, ts.target_params, batch, weights,
                                    draws.noise(online), draws.noise(online))
                losses, prios, roots = [], [], []
                for msg, u in zip(msgs[2:], offsets[1:]):
                    mu_before = {g: [x.clone() for x in
                                     getattr(ts.opt_state, g).mu]
                                 for g in ("q", "proposal")}
                    ts, rs, m = core.fused_step(
                        ts, rs, msg["payload"], msg["priorities"],
                        torch.from_numpy(u).to(device), 0.4)
                    losses.append([m["loss"].item(),
                                   m["loss_proposal"].item()])
                    leaves = rs.sum_tree[replay.capacity:].double()
                    prios.append(leaves.float().cpu().clone())
                    roots.append((rs.sum_tree[1].item(),
                                  leaves.sum().item()))
                out[name] = dict(
                    batch={k: v.cpu() for k, v in batch.items()},
                    aux=[x.detach().cpu() for x in aux], losses=losses,
                    prios=torch.stack(prios).numpy(), roots=roots,
                    params=[p.detach().cpu() for p in online.parameters()],
                    moments=_adam_moments(online, ts.opt_state, mu_before))
            cpu, card = out["cpu"], out["cuda"]
            for key in cpu["batch"]:
                check(torch.equal(card["batch"][key], cpu["batch"][key]),
                      f"{what}: sampled {key} differs between card and CPU")
            check(torch.equal(card["aux"][4], cpu["aux"][4]),
                  f"{what}: best_idx differs")
            for i, label in ((0, "q loss"), (2, "priorities")):
                np.testing.assert_allclose(card["aux"][i].numpy(),
                                           cpu["aux"][i].numpy(), rtol=1e-4,
                                           atol=1e-6,
                                           err_msg=f"{what}: {label}")
            np.testing.assert_allclose(card["losses"], cpu["losses"],
                                       rtol=1e-4, err_msg=f"{what}: losses")
            np.testing.assert_allclose(card["prios"], cpu["prios"],
                                       rtol=1e-4, err_msg=f"{what}: leaves")
            # Adam scales each step to about lr whatever the gradient's
            # size, so an element whose gradient is round-off (|g| near
            # eps) can move by a fraction of lr on one side only: the
            # weights get rtol 1e-4 plus 5% of one 1e-3 step
            _log_weight_gaps(what, card, cpu, model, count=len(msgs) - 2,
                             lr=1e-3)
            for pg, pc in zip(card["params"], cpu["params"]):
                np.testing.assert_allclose(pg.numpy(), pc.numpy(), rtol=1e-4,
                                           atol=5e-5,
                                           err_msg=f"{what}: weights")
            for root, total in card["roots"]:
                check(abs(root - total) <= 1e-5 * total,
                      f"{what}: sum-tree root {root} != leaves {total}")
            err = max(abs(a - c) for ra, rc in zip(card["losses"],
                                                   cpu["losses"])
                      for a, c in zip(ra, rc))
            log(f"{what}: card vs CPU AQL core agree: sampled batch "
                f"bit-exact, best_idx equal, {len(msgs) - 2} fused steps' "
                f"losses (Q, proposal) {card['losses']}, max abs "
                f"difference {err:.3g}; tree roots equal their leaves")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def aql_train_phase(dev, gather, env_id: str,
                    profile_dir: str | None = None) -> dict:
    """11b/11c: ``AQLApexTrainer.train`` at AQL's published widths with 4
    actor processes x 8 envs over the shm ring and the default pipeline,
    for 50 learner steps after a 4096-transition warm-up.  Continuous
    (``ApexContinuousNav-v0``, T = 500, stacked replay) or pixels
    (``ApexCatch-v0``, frame stack 4, T = 103, frame pool with the ``a_mu``
    sidecar: one ``gather_stacks`` launch per learner step).  Also keeps a
    few of the messages it ingested for 11e.  With ``profile_dir``, a few
    more fused steps on the last kept message run under the profiler."""
    from apex_tpu_torch.native.ring import SEGMENT_PREFIX
    from apex_tpu_torch.replay.frame_pool import FramePoolReplay
    from apex_tpu_torch.training.aql import AQLApexTrainer

    pixels = env_id.startswith("ApexCatch")
    what = f"aql train ({'pixels' if pixels else 'continuous'})"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = AQLApexTrainer(_aql_cfg(env_id),
                             publish_min_seconds=0.5)        # on "cuda"
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pool, core, replay = trainer.pool, trainer.core, trainer.replay
    t_cand = trainer.model.total_sample
    check(t_cand == (AQL_PIXEL_T if pixels else AQL_T)
          and isinstance(replay, FramePoolReplay) == pixels,
          f"{what}: {t_cand} candidates, replay {type(replay).__name__}")
    hbm = (replay.hbm_bytes() if pixels else sum(
        x.numel() * x.element_size()
        for x in trainer.replay_state.storage.values()))
    log(f"{what}: {N_ACTORS} actor processes x {ENVS_PER_ACTOR} envs, "
        f"{pool.threads} torch threads each, chunks of {SEND_INTERVAL} "
        f"transitions, {t_cand} candidates per state, warm-up "
        f"{TRAIN_WARMUP}, batch {BATCH}, capacity {replay.capacity}, "
        f"{hbm / 1e9:.3f} GB of replay storage, built in {build_s:.3f} s")
    kept: list = []
    ingest = core.ingest

    def keeping_ingest(rs, payload, prios):
        if len(kept) < 16 and prios.shape[0] == SEND_INTERVAL:  # unmerged
            kept.append({"payload": payload, "priorities": prios,
                         "n_trans": SEND_INTERVAL})
        return ingest(rs, payload, prios)

    object.__setattr__(core, "ingest", keeping_ingest)
    zero_launches(gather)                             # main path starts
    t0 = time.perf_counter()
    trainer.train(total_steps=AQL_STEPS, max_seconds=AQL_SECONDS,
                  log_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(gather)                  # main path ends
    object.__setattr__(core, "ingest", ingest)
    steps, dispatches = trainer.steps, dict(trainer.dispatches)
    rate, ingested = trainer.steps_rate.rate, trainer.ingested
    frames_rate = trainer.frames_rate.rate

    check(steps == AQL_STEPS == trainer.train_state.step,
          f"{what}: {steps} learner steps in {wall:.1f} s, want "
          f"{AQL_STEPS} within {AQL_SECONDS} s")
    want = {"gather_rows": 0, "gather_stacks": steps if pixels else 0}
    check(gather_part(launches) == want,
          f"{what}: gather launches {launches} in {steps} steps, want "
          f"{want}")
    check(pool.chunk_plane == "shm",
          f"{what}: chunks rode {pool.chunk_plane}, not the shm ring")
    check(trainer.param_version >= 2,
          f"{what}: {trainer.param_version} param publishes")
    versions = [v for _, v in
                trainer.log.history.get("learner/episode_param_version", [])]
    check(bool(versions) and min(versions) > 0,
          f"{what}: episode stats' param versions {versions[:8]}")
    stats = trainer._pipeline_last_stats
    check(stats is not None and stats["slots"] > 0
          and stats["publishes"] >= 1
          and (stats["merged_chunks"] >= 2 if pixels
               else stats["merged_slots"] == 0),
          f"{what}: pipeline stats {stats}")
    n_logged = _finite_logged(trainer, ("loss_proposal",))
    check(n_logged > 0, f"{what}: no learner metrics logged")
    rs, c = trainer.replay_state, replay.capacity
    leaves = rs.sum_tree[c:c + rs.size]
    root, total = rs.sum_tree[1].item(), leaves.double().sum().item()
    check(bool(torch.isfinite(leaves).all()) and bool((leaves > 0).all()),
          f"{what}: non-finite or non-positive priorities")
    check(abs(root - total) <= 1e-5 * total,
          f"{what}: sum-tree root {root} != sum of leaves {total}")
    a_mu = (rs.extras["a_mu"] if pixels else rs.storage["a_mu"])[:rs.size]
    check(bool(torch.isfinite(a_mu).all())
          and bool((a_mu.abs().sum(dim=(1, 2)) > 0).all()),
          f"{what}: a_mu rows not all written")
    if pixels:
        check(bool((a_mu[:, :3, 0].sort(dim=1).values
                    == torch.arange(3.0, device=dev)).all()),
              f"{what}: uniform candidates are not the 3 distinct actions")
    else:
        check(bool((a_mu[:, :AQL_UNIFORM].abs() <= 1.0).all()),
              f"{what}: uniform candidates outside the action box")
    alive = [p.pid for p in pool.procs if p.is_alive()]
    check(not alive, f"{what}: actor processes {alive} outlived train()")
    left = [f for f in os.listdir("/dev/shm")
            if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-")]
    check(not left, f"{what}: segments left in /dev/shm: {left}")
    peak = torch.cuda.max_memory_allocated(dev)
    plane = trainer.actor_plane()
    check(plane is not None, f"{what}: no actor reported its timing")
    check(bool(kept), f"{what}: no full message kept")

    step_ms = []
    last = kept[-1]
    for _ in range(AQL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_state, trainer.replay_state, metrics = core.fused_step(
            trainer.train_state, trainer.replay_state, last["payload"],
            last["priorities"], trainer._offsets(), trainer._beta())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"{what}: non-finite metrics in the timed steps: {metrics}")
    ms = statistics.median(step_ms[2:])
    if profile_dir:
        profile_steps(trainer, [last] * PROFILE_STEPS, profile_dir,
                      f"chip_smoke_profile_aql_"
                      f"{'pixels' if pixels else 'continuous'}.txt")
    score = trainer.evaluate(episodes=1, max_steps=500)
    check(math.isfinite(score), f"{what}: eval score {score}")
    log(f"{what}: {steps} learner steps in {wall:.3f} s of train(); "
        f"dispatches {dispatches}; {ingested} transitions ingested; "
        f"param_version {trainer.param_version}; {len(versions)} episodes "
        f"drained, param versions {min(versions)}..{max(versions)}; "
        f"pipeline stats {stats}")
    log(f"{what}: learner steps/s {rate:.3f} (last {min(100, steps)} "
        f"steps; {rate * BATCH * 3 * t_cand:.0f} candidate rows scored/s); "
        f"env frames/s ingested {frames_rate:.1f} (last 100 dispatches), "
        f"{ingested / wall:.1f} over train(); actors report "
        f"{plane['frames_per_sec_sum']:.1f} frames/s in all; actor phases "
        f"policy_wait {plane['policy_wait_frac']:.4f} env_step "
        f"{plane['env_step_frac']:.4f} drain {plane['drain_frac']:.4f}")
    log(f"{what}: fused step at full width, synchronised, median of "
        f"{AQL_TIMED - 2} after train(): {ms:.3f} ms (all "
        f"{[round(x, 3) for x in step_ms]}); peak memory "
        f"{peak / 2**30:.3f} GiB; {n_logged} logged metrics finite; gather "
        f"launches {launches}; greedy mu-only eval {score} (1 episode); no "
        f"actor alive, no segment left")
    del trainer, core, replay, rs, leaves, a_mu
    torch.cuda.empty_cache()
    return dict(launches=launches, wall=wall, steps_per_s=rate,
                frames_per_s=frames_rate, frames_over_train=ingested / wall,
                ms_per_fused_step=ms, peak_bytes=peak, msgs=kept)


def aql_single_phase(dev, gather) -> dict:
    """11d: ``AQLTrainer`` (the single-process driver, acting on the card)
    on ``ApexContinuousNav-v0`` at phase 11's widths: a 512-transition
    warm-up (cut from 50 000), then 1024 frames with an update every 4."""
    from apex_tpu_torch.training.aql import AQLTrainer

    what = "aql single"
    cfg = _aql_cfg("ApexContinuousNav-v0", warmup=AQL_SINGLE_WARMUP)
    trainer = AQLTrainer(cfg, train_every=4)                  # on "cuda"
    zero_launches(gather)                             # this path starts
    frames = AQL_SINGLE_WARMUP + AQL_FRAMES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(total_frames=frames, log_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(gather)                  # this path ends
    steps = trainer.steps_rate.total
    check(trainer.frames_rate.total == frames and steps > 0
          and trainer.train_state.step == steps,
          f"{what}: {trainer.frames_rate.total} frames, {steps} updates")
    check(gather_part(launches) == {"gather_rows": 0, "gather_stacks": 0},
          f"{what}: gather launches {launches} (the stacked replay)")
    n_logged = _finite_logged(trainer, ("loss_proposal",))
    check(n_logged > 0, f"{what}: no learner metrics logged")
    score = trainer.evaluate(episodes=1, max_steps=50)
    check(math.isfinite(score), f"{what}: eval score {score}")
    log(f"{what}: {frames} frames ({AQL_SINGLE_WARMUP} warm-up), "
        f"{trainer.ingested} transitions ingested and {steps} updates "
        f"(batch {BATCH}, T = {trainer.model.total_sample}) in {wall:.3f} "
        f"s: {frames / wall:.1f} frames/s, {steps / wall:.2f} updates/s "
        f"over the run; cosine lr at step {steps}: "
        f"{trainer.core.optimizer.q.learning_rate(steps):.6g}; {n_logged} "
        f"logged metrics finite; greedy eval {score} (1 episode)")
    del trainer
    torch.cuda.empty_cache()
    return dict(launches=launches, frames_per_s=frames / wall,
                steps_per_s=steps / wall)


def aql_checkpoint_phase(dev, gather, msgs: list) -> dict:
    """11e: an ``AQLApexTrainer`` on pixels at capacity 2^16 (a 2^17-row
    ring, to bound the file) consumes the messages 11c ingested, saves,
    restores into a fresh trainer bit-equal (both Adam groups, the ``a_mu``
    sidecar, the generator), both take 4 more steps bit-equal, and
    ``evaluate_checkpoint`` scores the file with mu-only heads."""
    import tempfile

    from apex_tpu_torch.training.aql import AQLApexTrainer
    from apex_tpu_torch.training.checkpoint import evaluate_checkpoint

    what = "aql checkpoint"
    warm = 8
    check(len(msgs) >= warm + 8, f"{what}: {len(msgs)} messages kept")
    cfg = _aql_cfg("ApexCatch-v0", capacity=AQL_CHECKPOINT_CAPACITY,
                   warmup=warm * SEND_INTERVAL)
    zero_launches(gather)                             # this path starts
    with tempfile.TemporaryDirectory(prefix="apex-aql-ckpt-") as tmp:
        t1 = AQLApexTrainer(cfg, pool=ListPool([]), device=dev,
                            checkpoint_dir=tmp)
        for msg in msgs[:warm + 4]:
            t1.consume([msg])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = t1.save_checkpoint()
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t2 = AQLApexTrainer(cfg, pool=ListPool([]), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t2.restore(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(t2.steps == t1.steps == 4,
              f"{what}: steps {t1.steps} saved, {t2.steps} restored")
        _learners_equal(t1, t2, f"{what}: restored")
        for trainer in (t1, t2):
            for msg in msgs[warm + 4:warm + 8]:
                trainer.consume([msg])
        _learners_equal(t1, t2, f"{what}: 4 steps after restore")
        score = evaluate_checkpoint(path, episodes=1, max_steps=500,
                                    device=dev)
        check(math.isfinite(score), f"{what}: eval score {score}")
    launches = read_launches(gather)                  # this path ends
    check(gather_part(launches) == {"gather_rows": 0, "gather_stacks": 12},
          f"{what}: gather launches {launches}")
    log(f"{what}: capacity {AQL_CHECKPOINT_CAPACITY}, ring "
        f"{t1.replay.f_capacity} rows + a_mu sidecar "
        f"{tuple(t1.replay_state.extras['a_mu'].shape)}; file {size} "
        f"bytes; save {save_s:.3f} s, restore {restore_s:.3f} s; restored "
        f"and saved trainers bit-equal over 4 more steps; "
        f"evaluate_checkpoint score {score} (1 episode, mu-only); "
        f"directory removed")
    del t1, t2
    torch.cuda.empty_cache()
    return dict(launches=launches, bytes=size)


def aql_phase(dev, gather, profile_dir: str | None = None) -> dict:
    """Phase 11, in order: 11a the card-vs-CPU reference, 11b continuous
    and 11c pixel ``AQLApexTrainer.train`` (each profiled after its run
    with ``profile_dir``), 11d ``AQLTrainer``, 11e the checkpoint.
    Returns the launch counts by path."""
    t0 = time.perf_counter()
    aql_reference_phase(dev)
    t1 = time.perf_counter()
    cont = aql_train_phase(dev, gather, "ApexContinuousNav-v0", profile_dir)
    t2 = time.perf_counter()
    pix = aql_train_phase(dev, gather, "ApexCatch-v0", profile_dir)
    t3 = time.perf_counter()
    single = aql_single_phase(dev, gather)
    t4 = time.perf_counter()
    saved = aql_checkpoint_phase(dev, gather, pix.pop("msgs"))
    cont.pop("msgs")
    t5 = time.perf_counter()
    log(f"aql: seconds per part: reference {t1 - t0:.1f}, continuous train "
        f"{t2 - t1:.1f}, pixel train {t3 - t2:.1f}, single {t4 - t3:.1f}, "
        f"checkpoint {t5 - t4:.1f}")
    return dict(aql_continuous=cont["launches"], aql_pixel=pix["launches"],
                aql_single=single["launches"],
                aql_checkpoint=saved["launches"])


# -- phase 12: the socket roles -------------------------------------------

ROLE_STEPS = 60              # learner steps of 12a and 14b (100 before PR 12)
CODEC_STEPS = 40             # learner steps of 12b
CODEC_ACTORS = 2             # actor processes of 12b
ROLE_SECONDS = 240.0         # run_learner's wall-clock bound
ROLE_JOIN_S = 30.0           # how long a stopped role process may take
CLI_FRAMES = 1024            # 12c's DQN driver frames (2048 before PR 12)


def _free_ports(n: int) -> list[int]:
    """``n`` ports the kernel hands out free (bind to 0, then release)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def _still_bound(ports: list[int], wait_s: float = 2.0) -> list[int]:
    """The ports that do not bind again within ``wait_s`` (zmq closes its
    sockets on its I/O thread; SO_REUSEADDR looks past TIME_WAIT, not past
    a listener)."""
    import socket

    bound = []
    for port in ports:
        deadline = time.monotonic() + wait_s
        while True:
            sk = socket.socket()
            sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sk.bind(("0.0.0.0", port))
                break
            except OSError:
                if time.monotonic() > deadline:
                    bound.append(port)
                    break
                time.sleep(0.05)
            finally:
                sk.close()
    return bound


class RoleProcesses:
    """Actor and evaluator processes launched through the CLI, as a user
    launches them (``python -m apex_tpu_torch.runtime --role ...``), each
    with its output in a temporary file.  :meth:`stop` sends SIGTERM (the
    CLI's roles then leave their loops and exit 0), waits, and kills and
    fails whatever is left."""

    def __init__(self):
        import tempfile

        self.tmp = tempfile.TemporaryDirectory(prefix="apex-roles-")
        self.procs: list = []

    def launch(self, name: str, argv: list[str], env: dict,
               module: str = "apex_tpu_torch.runtime") -> None:
        out = open(os.path.join(self.tmp.name, f"{name}.log"), "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            env=dict(os.environ, **env), stdout=out,
            stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        self.procs.append((name, proc, out))

    def tail(self, name: str, n: int = 2000) -> str:
        with open(os.path.join(self.tmp.name, f"{name}.log"), "rb") as f:
            return f.read()[-n:].decode(errors="replace")

    def wait_for(self, name: str, text: str, timeout_s: float) -> None:
        """Wait until ``name``'s output holds ``text``; fail if it exits
        or ``timeout_s`` passes first."""
        deadline = time.monotonic() + timeout_s
        path = os.path.join(self.tmp.name, f"{name}.log")
        proc = next(p for n, p, _ in self.procs if n == name)
        while True:
            with open(path, "rb") as f:
                if text.encode() in f.read():
                    return
            if proc.poll() is not None or time.monotonic() > deadline:
                log(f"{name} output:\n{self.tail(name)}")
                check(False, f"{name} never printed {text!r} (exit code "
                      f"{proc.poll()}, {timeout_s} s)")
            time.sleep(0.1)

    def stats(self, name: str) -> dict | None:
        """The ``<identity>: stats {...}`` line a service role prints as
        it stops, parsed; None when it printed none."""
        with open(os.path.join(self.tmp.name, f"{name}.log"), "rb") as f:
            text = f.read().decode(errors="replace")
        for line in reversed(text.splitlines()):
            if ": stats {" in line:
                return json.loads(line.split(": stats ", 1)[1])
        return None

    def dead(self) -> list[str]:
        return [name for name, proc, _ in self.procs
                if proc.poll() is not None]

    def stop(self) -> dict:
        """SIGTERM every process, wait; returns ``{name: exit code}``,
        None for one that had to be killed."""
        for _, proc, _ in self.procs:
            if proc.poll() is None:
                proc.terminate()
        codes = {}
        deadline = time.monotonic() + ROLE_JOIN_S
        for name, proc, out in self.procs:
            try:
                codes[name] = proc.wait(
                    timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
                codes[name] = None
            out.close()
        return codes

    def close(self) -> None:
        for _, proc, out in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            out.close()
        self.tmp.cleanup()


def _beats(trainer) -> dict:
    """The peers the learner's registry got a heartbeat from."""
    return {k: p for k, p in trainer.fleet.peers.items() if p.beats}


def _role_cfg(ports: list[int], n_actors: int, codec: bool):
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, CommsConfig,
                                       EnvConfig, LearnerConfig,
                                       ReplayConfig)
    batch, param, barrier = ports
    return ApexConfig(
        env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
        replay=ReplayConfig(capacity=CAPACITY, warmup=TRAIN_WARMUP),
        learner=LearnerConfig(batch_size=BATCH, target_update_interval=500),
        actor=ActorConfig(n_actors=n_actors, n_envs_per_actor=ENVS_PER_ACTOR,
                          send_interval=SEND_INTERVAL),
        comms=CommsConfig(batch_port=batch, param_port=param,
                          barrier_port=barrier, heartbeat_interval_s=1.0,
                          param_delta=codec))


def role_run(dev, gather, what: str, n_actors: int, steps: int,
             codec: bool) -> dict:
    """``run_learner`` in this process on ``dev`` with its default ingest
    pipeline, ``n_actors`` actor processes x 8 envs (on the CPU, at the
    in-host pool's thread count) and one evaluator process (on the card),
    all launched through the CLI with the env twins a deploy script sets.
    ``codec``: the actors ship ``dict``-coded chunks and the learner
    publishes sparse param deltas."""
    from apex_tpu_torch.actors.pool import worker_threads
    from apex_tpu_torch.runtime.roles import run_learner
    from apex_tpu_torch.training import apex as apex_module

    ports = _free_ports(3)
    cfg = _role_cfg(ports, n_actors, codec)
    common = ["--env-id", "ApexCatch-v0", "--seed", str(SEED),
              "--n-envs-per-actor", str(ENVS_PER_ACTOR), "--send-interval",
              str(SEND_INTERVAL), "--batch-port", str(ports[0]),
              "--param-port", str(ports[1]), "--barrier-port",
              str(ports[2]), "--heartbeat-interval", "1.0",
              "--barrier-timeout", "120"]
    if codec:
        common += ["--wire-codec", "dict"]
    threads = worker_threads(n_actors)
    publishes: list[int] = []
    real_publish = apex_module.ConcurrentTrainer._publish

    def publish(self):                 # count the warm-up republishes
        publishes.append(self.steps)
        real_publish(self)

    roles = RoleProcesses()
    torch.cuda.reset_peak_memory_stats(dev)
    apex_module.ConcurrentTrainer._publish = publish
    try:
        for i in range(n_actors):
            roles.launch(f"actor-{i}", ["--role", "actor", *common], {
                "ACTOR_ID": str(i), "N_ACTORS": str(n_actors),
                "LEARNER_IP": "127.0.0.1", "CUDA_VISIBLE_DEVICES": "",
                "OMP_NUM_THREADS": str(threads)})
        evaluator = ["--role", "evaluator", *common]
        if dev.type == "cpu":          # a CPU rehearsal of the phase
            evaluator += ["--device", "cpu"]
        roles.launch("evaluator", evaluator, {})
        log(f"{what}: run_learner on {dev} with {n_actors} actor processes "
            f"x {ENVS_PER_ACTOR} envs ({threads} torch threads each) and 1 "
            f"evaluator, launched through the CLI; chunks of "
            f"{SEND_INTERVAL}, warm-up {TRAIN_WARMUP}, batch {BATCH}, "
            f"capacity {CAPACITY}, ports {ports}, wire codec "
            f"{'dict' if codec else 'raw'}, param deltas {codec}")
        zero_launches(gather)                         # main path starts
        t0 = time.perf_counter()
        try:
            trainer = run_learner(cfg, n_peers=n_actors + 1,
                                  total_steps=steps,
                                  max_seconds=ROLE_SECONDS,
                                  barrier_timeout_s=120.0, device=dev,
                                  publish_min_seconds=0.5, log_every=25)
        except BaseException:
            for name, _, _ in roles.procs:
                log(f"{what}: {name} output:\n{roles.tail(name)}")
            raise
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gather)              # main path ends
        dead = roles.dead()
        codes = roles.stop()
        if dead or any(c != 0 for c in codes.values()):
            for name, _, _ in roles.procs:
                log(f"{what}: {name} output:\n{roles.tail(name)}")
        check(not dead, f"{what}: role processes {dead} died during the "
              f"run (exit codes {codes})")
        check(all(c == 0 for c in codes.values()),
              f"{what}: role exit codes after SIGTERM {codes}")
    finally:
        apex_module.ConcurrentTrainer._publish = real_publish
        roles.close()
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after train()")

    pool = trainer.pool
    summary = pool.wire_summary()
    check(trainer.steps == steps,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s, want "
          f"{steps} within {ROLE_SECONDS} s")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    check(trainer.param_version >= 2,
          f"{what}: {trainer.param_version} param publishes")
    hist = trainer.log.history
    pairs = list(zip([v for _, v in hist.get("learner/actor_id", [])],
                     [v for _, v in hist.get(
                         "learner/episode_param_version", [])]))
    actor_versions = [v for a, v in pairs if a >= 0]
    check(bool(actor_versions) and min(actor_versions) >= 1,
          f"{what}: actor episode stats' param versions "
          f"{actor_versions[:8]}")
    check(any(a == -1 for a, _ in pairs),
          f"{what}: no evaluator episode stat (actor_id -1) in "
          f"{sorted({a for a, _ in pairs})}")
    beats = _beats(trainer)
    want = {f"actor-{i}" for i in range(n_actors)}
    check(want <= set(beats) and any(k.startswith("evaluator-")
                                     for k in beats),
          f"{what}: heartbeats from {sorted(beats)}")
    check(pool.wire_rejected() == 0 and summary["codec_rejected"] == 0,
          f"{what}: wire rejected {pool.wire_rejected()}, codec rejected "
          f"{summary['codec_rejected']}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    rs, c = trainer.replay_state, trainer.replay.capacity
    leaves = rs.sum_tree[c:c + rs.size]
    root, total = rs.sum_tree[1].item(), leaves.double().sum().item()
    check(bool(torch.isfinite(leaves).all()) and bool((leaves > 0).all()),
          f"{what}: non-finite or non-positive priorities")
    check(abs(root - total) <= 1e-5 * total,
          f"{what}: sum-tree root {root} != sum of leaves {total}")
    peak = torch.cuda.max_memory_allocated(dev)
    warm = publishes.count(0)
    chunks = summary["chunks"]
    per_chunk = summary["chunk_wire_bytes"] / max(1, chunks)
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s of "
        f"run_learner (barrier included); dispatches {trainer.dispatches}; "
        f"{trainer.ingested} transitions ingested from {chunks} chunks "
        f"received, {per_chunk:.1f} wire bytes per chunk; param_version "
        f"{trainer.param_version} ({warm} publishes before the first step); "
        f"{len(actor_versions)} actor episodes, param versions "
        f"{min(actor_versions)}..{max(actor_versions)}; evaluator episodes "
        f"{sum(1 for a, _ in pairs if a == -1)}; heartbeats from "
        f"{sorted(beats)}; wire {summary}")
    log(f"{what}: learner steps/s {trainer.steps_rate.rate:.3f} (last "
        f"{min(100, trainer.steps)} steps), env frames/s ingested "
        f"{trainer.frames_rate.rate:.1f} (last 100 dispatches), "
        f"{trainer.ingested / wall:.1f} over run_learner; peak memory "
        f"{peak / 2**30:.3f} GiB; {n_logged} logged metrics finite; gather "
        f"launches {launches}; role exit codes {codes}; no port bound")
    out = dict(launches=launches, wall=wall, summary=summary,
               steps_per_s=trainer.steps_rate.rate,
               frames_per_s=trainer.frames_rate.rate,
               frames_over_train=trainer.ingested / wall,
               chunks=chunks, bytes_per_chunk=per_chunk, peak=peak)
    if codec:
        gauges = [b.gauges or {} for k, b in beats.items()
                  if k.startswith("actor-")]
        raw = sum(g.get("wire_bytes_raw", 0) for g in gauges)
        sent = sum(g.get("wire_bytes_out", 0) for g in gauges)
        out["chunk_ratio"] = raw / sent if sent else float("nan")
        out["param_ratio"] = (summary["param_bytes_raw"]
                              / max(1, summary["param_bytes_out"]))
    return out


def _cli_dqn(dev) -> dict:
    """12c: the DQN driver through the CLI with no ``--device``, in a
    subprocess: the CLI's default must resolve the card."""
    argv = [sys.executable, "-m", "apex_tpu_torch.runtime", "--role", "dqn",
            "--env-id", "ApexCartPole-v0", "--frame-stack", "1",
            "--total-frames", str(CLI_FRAMES), "--warmup", "512",
            "--seed", str(SEED), "--verbose"]
    if dev.type == "cpu":                      # a CPU rehearsal
        argv += ["--device", "cpu"]
    env = dict(os.environ)
    env.pop("APEX_DEVICE", None)
    t0 = time.perf_counter()
    done = subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    logged = [line for line in done.stdout.splitlines()
              if line.startswith("[learner/")]
    if done.returncode != 0 or not logged:
        log(f"cli: stdout tail\n{done.stdout[-2000:]}\nstderr tail\n"
            f"{done.stderr[-4000:]}")
    check(done.returncode == 0, f"cli: --role dqn exited "
          f"{done.returncode}")
    check(bool(logged), "cli: --role dqn logged no metric")
    tags = sorted({line.split("]")[0][1:] for line in logged})
    log(f"cli: python -m apex_tpu_torch.runtime --role dqn (no --device) "
        f"ran {CLI_FRAMES} frames in {wall:.3f} s of wall, process start "
        f"included; exit 0; {len(logged)} metric lines, tags {tags}")
    return dict(wall=wall, lines=len(logged))


def role_phase(dev, gather, phase5: dict) -> tuple[dict, dict]:
    """Phase 12: 12a (``remote_train``), 12b (``remote_codec``) and 12c.
    Returns the paths' launches and 12a's numbers."""
    t0 = time.perf_counter()
    remote = role_run(dev, gather, "remote_train", N_ACTORS, ROLE_STEPS,
                      codec=False)
    log("remote_train vs phase 5 (shm ring, pipelined): learner steps/s "
        f"{remote['steps_per_s']:.3f} vs {phase5['steps_per_s']:.3f}; env "
        f"frames/s ingested (last 100 dispatches) "
        f"{remote['frames_per_s']:.1f} vs {phase5['frames_per_s']:.1f}, "
        f"over the run {remote['frames_over_train']:.1f} vs "
        f"{phase5['frames_over_train']:.1f}; wall {remote['wall']:.3f} s vs "
        f"{phase5['wall']:.3f} s")
    t1 = time.perf_counter()
    coded = role_run(dev, gather, "remote_codec", CODEC_ACTORS, CODEC_STEPS,
                     codec=True)
    summary = coded["summary"]
    check(summary["codec_chunks"] > 0,
          f"remote_codec: no dict-coded chunk decoded ({summary})")
    check(summary["param_deltas"] > 0 and summary["param_keyframes"] >= 1,
          f"remote_codec: param publishes {summary}")
    log(f"remote_codec: {summary['codec_chunks']} dict-coded chunks "
        f"decoded, {coded['chunks']} filed before the stop, "
        f"{coded['bytes_per_chunk']:.1f} wire bytes per "
        f"chunk vs {remote['bytes_per_chunk']:.1f} raw in remote_train; "
        f"raw/wire byte ratio of the actors' chunks "
        f"{coded['chunk_ratio']:.3f}; param publishes "
        f"{summary['param_publishes']} ({summary['param_keyframes']} "
        f"keyframes, {summary['param_deltas']} deltas, "
        f"{summary['keyframes_forced']} forced), raw/wire byte ratio "
        f"{coded['param_ratio']:.3f} ({summary['param_bytes_raw']} / "
        f"{summary['param_bytes_out']} bytes)")
    t2 = time.perf_counter()
    _cli_dqn(dev)
    t3 = time.perf_counter()
    log(f"roles: phase 12 seconds: remote_train {t1 - t0:.1f}, "
        f"remote_codec {t2 - t1:.1f}, cli {t3 - t2:.1f}")
    return dict(remote_train=remote["launches"],
                remote_codec=coded["launches"]), remote


# -- phase 13: the services -----------------------------------------------

SERVICE_STEPS = 60           # learner steps of 13a and 13b (12a's count)
SERVICE_SECONDS = 240.0      # run_learner's wall-clock bound in phase 13
REF_STEPS = 8                # 13-ref's fused steps after the warm-up
LOADGEN_STEPS = 40           # learner steps of 13c
LOADGEN_LANES = 32           # the loadgen engine's lanes
SOCKET_STEPS = 20            # learner steps of each 13d run, at least
SOCKET_T = 16                # 13d's rollout_len
FALLBACK_SHARE = 0.10        # 13b: fallbacks after the first reply, at most
#: learner steps/s of 13a and 13b, printed beside phase 15's
RATES: dict = {}


def _port_block(n: int) -> int:
    """A base port with ``n`` consecutive free ports (shard s binds
    base + s)."""
    import socket

    for _ in range(64):
        base = _free_ports(1)[0]
        if base + n >= 65535:
            continue
        held = []
        try:
            for i in range(n):
                sk = socket.socket()
                held.append(sk)
                sk.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sk in held:
                sk.close()
    raise RuntimeError("no block of consecutive free ports")


def _service_cfg(ports: list[int], **comms):
    """Phase 12a's geometry on ``ports`` (batch, param, barrier), with
    the service plane's ``comms`` fields."""
    import dataclasses

    cfg = _role_cfg(ports[:3], N_ACTORS, codec=False)
    return cfg.replace(comms=dataclasses.replace(cfg.comms, **comms))


def _role_argv(ports: list[int], *extra) -> list[str]:
    """The CLI flags every process of a phase-13 topology shares."""
    return ["--env-id", "ApexCatch-v0", "--seed", str(SEED),
            "--n-envs-per-actor", str(ENVS_PER_ACTOR), "--send-interval",
            str(SEND_INTERVAL), "--batch-port", str(ports[0]),
            "--param-port", str(ports[1]), "--barrier-port", str(ports[2]),
            "--heartbeat-interval", "1.0", "--barrier-timeout", "120",
            "--capacity", str(CAPACITY), "--warmup", str(TRAIN_WARMUP),
            "--batch-size", str(BATCH), *extra]


def _device_flag(dev) -> list[str]:
    """A CPU rehearsal runs the card roles on the CPU too."""
    return ["--device", "cpu"] if dev.type == "cpu" else []


def _actor_env(i: int) -> dict:
    from apex_tpu_torch.actors.pool import worker_threads
    return {"ACTOR_ID": str(i), "N_ACTORS": str(N_ACTORS),
            "LEARNER_IP": "127.0.0.1", "CUDA_VISIBLE_DEVICES": "",
            "OMP_NUM_THREADS": str(worker_threads(N_ACTORS))}


def _stop_roles(roles, what: str) -> dict:
    """SIGTERM every role; each must exit 0.  Returns the exit codes."""
    dead = roles.dead()
    codes = roles.stop()
    if dead or any(c != 0 for c in codes.values()):
        for name, _, _ in roles.procs:
            log(f"{what}: {name} output:\n{roles.tail(name)}")
    check(not dead, f"{what}: role processes {dead} died during the run "
          f"(exit codes {codes})")
    check(all(c == 0 for c in codes.values()),
          f"{what}: role exit codes after SIGTERM {codes}")
    return codes


def _learner_run(dev, gather, roles, what: str, cfg, **kw):
    """``run_learner`` in this process on ``dev``, its gather launches
    counted from 0 (the path's main run); the roles' output is logged if
    it raises.  Returns ``(trainer, wall, launches)``."""
    from apex_tpu_torch.runtime.roles import run_learner

    zero_launches(gather)                             # the path starts
    t0 = time.perf_counter()
    try:
        trainer = run_learner(cfg, max_seconds=SERVICE_SECONDS,
                              barrier_timeout_s=120.0, device=dev,
                              publish_min_seconds=0.5, log_every=10, **kw)
    except BaseException:
        for name, _, _ in roles.procs:
            log(f"{what}: {name} output:\n{roles.tail(name)}")
        raise
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return trainer, wall, read_launches(gather)       # the path ends


def _wire(trainer) -> str:
    """The chunks the learner's socket took and their wire bytes each."""
    summary = trainer.pool.wire_summary()
    per = summary["chunk_wire_bytes"] / max(1, summary["chunks"])
    return f"{summary['chunks']} chunks on the wire, {per:.1f} bytes each"


def _tree_sums(trainer, what: str) -> None:
    rs, c = trainer.replay_state, trainer.replay.capacity
    leaves = rs.sum_tree[c:c + rs.size]
    root, total = rs.sum_tree[1].item(), leaves.double().sum().item()
    check(bool(torch.isfinite(leaves).all()),
          f"{what}: non-finite priorities")
    check(abs(root - total) <= 1e-5 * max(total, 1e-30),
          f"{what}: sum-tree root {root} != sum of leaves {total}")


def service_reference_phase(dev, gather) -> None:
    """13-ref: one strict ``ReplayShardCore`` on the card against the
    learner's serial loop (``ApexTrainer.consume``) over the same chunks
    and sample generator, under deterministic cuDNN: params, target,
    optimizer, every replay field and the generator state bit-equal.
    Then the shard's ``gather_stacks`` against its plain version."""
    import dataclasses

    from apex_tpu_torch.ops.gather import gather_stacks_reference
    from apex_tpu_torch.replay_service.service import dqn_replay_spec
    from apex_tpu_torch.replay_service.shard import (ReplayShardCore,
                                                     batch_from_wire)
    from apex_tpu_torch.training.apex import ApexTrainer

    cfg = _service_cfg(_free_ports(3), replay_shards=1)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    try:
        serial = ApexTrainer(cfg, pool=ListPool([]), device=dev)
        n_warm = -(-TRAIN_WARMUP // SEND_INTERVAL)
        msgs = act(serial, n_warm + REF_STEPS, N_ENVS, SEED + 13)
        for msg in msgs:
            serial.consume([msg])
        check(serial.steps >= 1, "service_ref: the serial loop took no step")
        small = cfg.replace(replay=dataclasses.replace(cfg.replay,
                                                       capacity=2 ** 10))
        learner = ApexTrainer(small, pool=ListPool([]), device=dev)
        spec = dqn_replay_spec(cfg, dev)
        check(spec == serial.replay,
              f"service_ref: the shard's spec {spec} is not the trainer's "
              f"{serial.replay}")
        core = ReplayShardCore(
            spec, torch.Generator(device=dev).manual_seed(SEED + 1),
            batch_size=BATCH, warmup=TRAIN_WARMUP, beta=cfg.replay.beta,
            beta_anneal=cfg.replay.beta_anneal, n_shards=1,
            strict_order=True, device=dev)
        last = None
        for msg in msgs:
            warm = core.warm
            core.ingest_msg(msg)
            if not warm:
                continue
            last = core.next_batch()
            batch = batch_from_wire({k: torch.as_tensor(v).to(dev)
                                     for k, v in last["batch"].items()})
            learner.train_state, prios, _ = learner.core.update_from_batch(
                learner.train_state, batch,
                torch.as_tensor(last["weights"]).to(dev))
            check(core.write_back(last["seq"], last["idx"],
                                  prios.cpu().numpy()),
                  "service_ref: a write-back was refused")
        torch.cuda.synchronize()
        a, b = serial.train_state, learner.train_state
        check(a.step == b.step == core.sampled == serial.steps,
              f"service_ref: steps {a.step} / {b.step}, shard sampled "
              f"{core.sampled}")
        check(_same(a.params.state_dict(), b.params.state_dict())
              and _same(a.target_params.state_dict(),
                        b.target_params.state_dict())
              and _same(a.opt_state, b.opt_state),
              "service_ref: params, target or optimizer differ")
        rs, ss = serial.replay_state, core.state
        for name in rs.__dataclass_fields__:
            check(_same(getattr(rs, name), getattr(ss, name)),
                  f"service_ref: replay field {name} differs")
        check(torch.equal(serial.generator.get_state(),
                          core.generator.get_state()),
              "service_ref: the sample generators' states differ")
        idx = torch.as_tensor(last["idx"]).to(dev)
        ids = torch.cat([ss.obs_ids[idx], ss.next_ids[idx]])
        got = gather.gather_stacks(ss.frames, ids, spec.frame_shape)
        want = gather_stacks_reference(ss.frames, ids, spec.frame_shape)
        err = (got.int() - want.int()).abs().max().item()
        check(err == 0, f"service_ref: the shard's gather_stacks is off its "
              f"plain version by {err}")
        log(f"service_ref: a strict N = 1 shard on {dev} against "
            f"ApexTrainer.consume over {len(msgs)} chunks of "
            f"{SEND_INTERVAL} ({serial.steps} fused steps after a "
            f"{TRAIN_WARMUP}-transition warm-up): params, target, "
            f"optimizer, all {len(rs.__dataclass_fields__)} replay fields "
            f"and the generator state bit-equal; the shard's "
            f"gather_stacks at ids {tuple(ids.shape)} equals its plain "
            f"version (max |err| {err}); {time.perf_counter() - t0:.3f} s")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        serial = learner = core = None
        torch.cuda.empty_cache()


def replay_service_run(dev, gather, p12a: dict) -> dict:
    """13a: ``run_learner`` with ``--replay-shards 2`` in this process, two
    ``--role replay`` shards on the card and 4 actors x 8 envs, through
    the CLI, for ``SERVICE_STEPS`` learner steps."""
    what = "replay_service"
    ports = _free_ports(3)
    base = _port_block(2)
    cfg = _service_cfg(ports, replay_shards=2, replay_port_base=base)
    shared = _role_argv(ports, "--replay-shards", "2",
                        "--replay-port-base", str(base))
    roles = RoleProcesses()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        for s in range(2):
            roles.launch(f"replay-{s}", ["--role", "replay", "--shard-id",
                                         str(s), *shared, *_device_flag(dev)],
                         {})
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", *shared],
                         _actor_env(i))
        log(f"{what}: run_learner on {dev} with 2 replay shards "
            f"(ports {base}, {base + 1}) and {N_ACTORS} actors x "
            f"{ENVS_PER_ACTOR} envs through the CLI; warm-up "
            f"{TRAIN_WARMUP} ({TRAIN_WARMUP // 2} per shard), batch "
            f"{BATCH}, capacity {CAPACITY} per shard, strict order")
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=N_ACTORS,
            total_steps=SERVICE_STEPS)
        _stop_roles(roles, what)
        shards = [roles.stats(f"replay-{s}") for s in range(2)]
    finally:
        roles.close()
    bound = _still_bound(ports + [base, base + 1])
    check(not bound, f"{what}: ports {bound} still bound after the run")
    check(all(st is not None for st in shards),
          f"{what}: a shard printed no stats")
    client = trainer.replay_client
    check(trainer.steps == SERVICE_STEPS,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s")
    local = trainer.steps - trainer.service_steps
    check(trainer.service_steps > 0,
          f"{what}: no step trained on a service batch")
    check(gather_part(launches) == {"gather_rows": 0, "gather_stacks": local},
          f"{what}: the learner's gather launches {launches} with {local} "
          f"local fallback steps")
    presample = cfg.comms.replay_presample
    for s, st in enumerate(shards):
        check(st["chunks"] > 0, f"{what}: no chunk reached shard {s}")
        tail = st["batches_served"] - st["wb_applied"]
        check(0 <= tail <= presample,
              f"{what}: shard {s} served {st['batches_served']} batches, "
              f"applied {st['wb_applied']} write-backs (tail {tail} > "
              f"{presample})")
        check(st["rejected"] == 0 and st["codec_rejected"] == 0,
              f"{what}: shard {s} rejected {st['rejected']} payloads")
        check(abs(st["tree_root"] - st["tree_leaves"])
              <= 1e-5 * max(st["tree_leaves"], 1e-30),
              f"{what}: shard {s} root {st['tree_root']} != leaves "
              f"{st['tree_leaves']}")
        if dev.type == "cuda":
            check(st["gather_launches"]["gather_stacks"] == st["sampled"]
                  > 0, f"{what}: shard {s} launched gather_stacks "
                  f"{st['gather_launches']} for {st['sampled']} batches")
    check(sum(st["batches_served"] for st in shards) >= client.batches,
          f"{what}: the client received {client.batches} batches, the "
          f"shards served {[st['batches_served'] for st in shards]}")
    check(trainer.pool.wire_rejected() == 0 and client.rejected == 0,
          f"{what}: wire rejects {trainer.pool.wire_rejected()} / "
          f"{client.rejected}")
    check({"replay-0", "replay-1"} <= set(_beats(trainer)),
          f"{what}: heartbeats from {sorted(_beats(trainer))}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    peak = torch.cuda.max_memory_allocated(dev)
    ingested = sum(st["ingested"] for st in shards) + trainer.ingested
    per_batch = client.batch_bytes / max(1, client.batches)
    pull_ms = 1000.0 * client.pull_s / max(1, client.batches)
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s of "
        f"run_learner (barrier included): {trainer.service_steps} on "
        f"shard batches, {local} on the learner's own pool (fallback "
        f"chunks); {client.batches} batches pulled, {client.prio_sent} "
        f"write-backs sent ({client.prio_dropped} dropped); shards "
        + "; ".join(f"{s}: {st['chunks']} chunks, {st['ingested']} "
                    f"transitions, {st['sampled']} sampled, "
                    f"{st['batches_served']} served, {st['wb_applied']} "
                    f"write-backs, gather launches "
                    f"{st['gather_launches']['gather_stacks']}, root "
                    f"{st['tree_root']:.6g} = leaves {st['tree_leaves']:.6g}"
                    for s, st in enumerate(shards)))
    log(f"{what}: learner steps/s {trainer.steps_rate.rate:.3f} (last "
        f"{min(100, trainer.steps)} steps) vs 12a {p12a['steps_per_s']:.3f}"
        f"; env frames/s ingested over the run {ingested / wall:.1f} vs "
        f"12a {p12a['frames_over_train']:.1f}; {per_batch:.0f} wire bytes "
        f"per batch, {pull_ms:.3f} ms per pull (pull sent to reply "
        f"received); peak memory learner {peak / 2**30:.3f} GiB (12a "
        f"{p12a['peak'] / 2**30:.3f}), shards "
        f"{[round(st['peak_bytes'] / 2**30, 3) for st in shards]} GiB; "
        f"learner gather launches {launches}")
    shard_launches = summed([stats_launches(st) for st in shards])
    RATES[what] = trainer.steps_rate.rate
    return dict(launches=launches, shard_launches=shard_launches)


def remote_policy_run(dev, gather, p12a: dict) -> dict:
    """13b: one ``--role infer`` server on the card, 4 ``--remote-policy``
    actors x 8 envs and ``run_learner`` (replay in the learner),
    ``SERVICE_STEPS`` steps."""
    what = "remote_policy"
    ports = _free_ports(4)
    cfg = _service_cfg(ports)
    shared = _role_argv(ports, "--infer-port", str(ports[3]))
    roles = RoleProcesses()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        roles.launch("infer-0", ["--role", "infer", *shared,
                                 *_device_flag(dev)], {})
        # the server up before the actors act: a request to a port nobody
        # binds yet waits out infer_wait_s and marks the server down for
        # infer_reprobe_s, longer than this run's learner takes
        roles.wait_for("infer-0", "infer-0: serving on port", ROLE_JOIN_S)
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", "--remote-policy",
                                        *shared], _actor_env(i))
        log(f"{what}: run_learner on {dev}, one infer server (port "
            f"{ports[3]}) on {dev}, {N_ACTORS} --remote-policy actors x "
            f"{ENVS_PER_ACTOR} envs through the CLI")
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=N_ACTORS,
            total_steps=SERVICE_STEPS)
        _stop_roles(roles, what)
        server = roles.stats("infer-0")
    finally:
        roles.close()
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after the run")
    check(server is not None, f"{what}: the infer server printed no stats")
    check(trainer.steps == SERVICE_STEPS,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    beats = _beats(trainer)
    gauges = [beats[f"actor-{i}"].gauges for i in range(N_ACTORS)
              if f"actor-{i}" in beats]
    check(len(gauges) == N_ACTORS, f"{what}: actor heartbeats from "
          f"{sorted(beats)}")
    remote = sum(g.get("infer_remote", 0) for g in gauges)
    fallbacks = sum(g.get("infer_fallbacks", 0) for g in gauges)
    late = sum(g.get("infer_late_fallbacks", 0) for g in gauges)
    check(remote > 0, f"{what}: no actor step was served remotely (actor "
          f"gauges {gauges}; server {server})")
    check(late <= FALLBACK_SHARE * (remote + late),
          f"{what}: {late} fallbacks after the first reply against "
          f"{remote} remote steps (> {FALLBACK_SHARE:.0%})")
    check(server["requests"] > 0 and server["dispatches"] > 0
          and server["rejected"] == 0,
          f"{what}: server stats {server}")
    check(trainer.pool.wire_rejected() == 0,
          f"{what}: {trainer.pool.wire_rejected()} wire rejects")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    _tree_sums(trainer, what)
    plane = trainer.actor_plane()
    fps = (f"{plane['frames_per_sec_sum']:.1f}" if plane is not None
           else "not reported")
    log(f"{what}: actors' policy calls {remote} remote, {fallbacks} local "
        f"fallbacks ({late} after the first reply, "
        f"{late / max(1, remote + late):.4f} of the calls after it); "
        f"server {server['requests']} requests in {server['dispatches']} "
        f"dispatches, batch p50 {server['batch_p50']} p90 "
        f"{server['batch_p90']} requests, {server['dispatch_ms_mean']} ms "
        f"per dispatch (mean; p50 {server['dispatch_ms_p50']}), coalesce "
        f"p50 {server['coalesce_ms_p50']} ms, {server['dry_replies']} dry "
        f"replies, {server['param_loads']} param loads, peak memory "
        f"{server['peak_bytes'] / 2**30:.3f} GiB")
    log(f"{what}: {_wire(trainer)}; env frames/s ingested "
        f"{trainer.frames_rate.rate:.1f} (last 100 dispatches) vs 12a "
        f"{p12a['frames_per_s']:.1f}, over the run "
        f"{trainer.ingested / wall:.1f} vs 12a "
        f"{p12a['frames_over_train']:.1f}; actors report {fps} frames/s "
        f"in all; learner steps/s {trainer.steps_rate.rate:.3f} vs 12a "
        f"{p12a['steps_per_s']:.3f}; peak memory learner "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; gather "
        f"launches {launches}")
    RATES[what] = trainer.steps_rate.rate
    return dict(launches=launches)


def loadgen_run(dev, gather) -> dict:
    """13c: one ``--role loadgen`` process, a 32-lane engine on the card,
    against ``run_learner`` with no barrier peers, 40 steps."""
    what = "loadgen"
    ports = _free_ports(3)
    cfg = _service_cfg(ports)
    argv = _role_argv(ports) + ["--n-envs-per-actor",
                                     str(LOADGEN_LANES), "--n-actors", "1"]
    roles = RoleProcesses()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        roles.launch("loadgen-0", ["--role", "loadgen", *argv,
                                   *_device_flag(dev)], {})
        log(f"{what}: run_learner on {dev} fed by one --role loadgen "
            f"process ({LOADGEN_LANES} lanes on {dev})")
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=0,
            total_steps=LOADGEN_STEPS)
        _stop_roles(roles, what)
        gen = roles.stats("loadgen-0")
    finally:
        roles.close()
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after the run")
    summary = trainer.pool.wire_summary()
    check(gen is not None and gen["chunks_sent"] > 0,
          f"{what}: loadgen stats {gen}")
    check(trainer.steps == LOADGEN_STEPS and summary["chunks"] > 0
          and trainer.ingested > 0,
          f"{what}: {trainer.steps} steps, wire {summary}, "
          f"{trainer.ingested} ingested")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    check("loadgen-0" in _beats(trainer),
          f"{what}: heartbeats from {sorted(_beats(trainer))}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    _tree_sums(trainer, what)
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s; "
        f"{_wire(trainer)}, {trainer.ingested} "
        f"transitions ingested, env frames/s ingested over the run "
        f"{trainer.ingested / wall:.1f}; the loadgen role made "
        f"{gen['frames']} frames in {gen['dispatches']} dispatches over "
        f"{gen['acting_s']} s from its first params "
        f"({gen['frames'] / max(gen['acting_s'], 1e-9):.1f} env frames/s) "
        f"and sent {gen['chunks_sent']} chunks, peak memory "
        f"{gen['peak_bytes'] / 2**30:.3f} GiB; learner steps/s "
        f"{trainer.steps_rate.rate:.3f}, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; gather "
        f"launches {launches}")
    return dict(launches=launches)


def socket_rollout_run(dev, gather, rollout: str) -> dict:
    """13d: the learner role with ``--rollout ondevice`` or ``fused`` and
    one CLI evaluator; it stops once it has taken 20 steps and logged an
    evaluator episode."""
    from apex_tpu_torch.training.apex import ConcurrentTrainer

    what = f"{rollout}_socket"
    ports = _free_ports(3)
    cfg = _service_cfg(ports)
    roles = RoleProcesses()
    real_drain = ConcurrentTrainer._drain_stats

    def drain(self, steps):
        real_drain(self, steps)
        ids = [a for _, a in self.log.history.get("learner/actor_id", [])]
        if steps >= SOCKET_STEPS and any(a < 0 for a in ids):
            self.request_stop()

    torch.cuda.reset_peak_memory_stats(dev)
    ConcurrentTrainer._drain_stats = drain
    try:
        roles.launch("evaluator", ["--role", "evaluator",
                                   *_role_argv(ports),
                                   *_device_flag(dev)], {})
        log(f"{what}: run_learner --rollout {rollout} on {dev} "
            f"({N_ACTORS * ENVS_PER_ACTOR} lanes, rollout_len {SOCKET_T}) "
            f"with one CLI evaluator")
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=1,
            total_steps=10 ** 6, rollout=rollout, rollout_len=SOCKET_T)
        _stop_roles(roles, what)
    finally:
        ConcurrentTrainer._drain_stats = real_drain
        roles.close()
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after the run")
    ids = [a for _, a in trainer.log.history.get("learner/actor_id", [])]
    evaluated = sum(1 for a in ids if a < 0)
    check(trainer.steps >= SOCKET_STEPS and evaluated > 0,
          f"{what}: {trainer.steps} steps and {evaluated} evaluator "
          f"episodes in {wall:.1f} s")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    check(any(k.startswith("evaluator-") for k in _beats(trainer)),
          f"{what}: heartbeats from {sorted(_beats(trainer))}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    _tree_sums(trainer, what)
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s "
        f"(barrier included), {trainer.ingested} transitions ingested "
        f"({_wire(trainer)}), "
        f"{evaluated} evaluator episodes; learner steps/s "
        f"{trainer.steps_rate.rate:.3f}, env frames/s ingested over the "
        f"run {trainer.ingested / wall:.1f}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; gather "
        f"launches {launches}")
    return dict(launches=launches)


def service_phase(dev, gather, p12a: dict) -> dict:
    """Phase 13: 13-ref, 13a-13d."""
    t = [time.perf_counter()]
    service_reference_phase(dev, gather)
    t.append(time.perf_counter())
    shards = replay_service_run(dev, gather, p12a)
    t.append(time.perf_counter())
    remote = remote_policy_run(dev, gather, p12a)
    t.append(time.perf_counter())
    gen = loadgen_run(dev, gather)
    t.append(time.perf_counter())
    ondevice = socket_rollout_run(dev, gather, "ondevice")
    t.append(time.perf_counter())
    fused = socket_rollout_run(dev, gather, "fused")
    t.append(time.perf_counter())
    names = ("service_ref", "replay_service", "remote_policy", "loadgen",
             "ondevice_socket", "fused_socket")
    log("services: phase 13 seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(names, t, t[1:])))
    return {"replay_service": shards["launches"],
            "replay_service_shards": shards["shard_launches"],
            "remote_policy": remote["launches"],
            "loadgen": gen["launches"],
            "ondevice_socket": ondevice["launches"],
            "fused_socket": fused["launches"]}


# -- phase 14: the fleet and observability planes --------------------------

CHAOS_KILL_AT = 50           # the killed actors' send index (64-transition
#                              chunks: about 3200 of each actor's frames;
#                              100 before PR 12)
CHAOS_MIN_STEPS = 100        # 14a learns at least this long (12a's count)
CHAOS_SECONDS = 150.0        # 14a's wall-clock bound
CHAOS_TRAIN_RATIO = 1.0      # samples per ingested transition, at most
CHAOS_MIN_RATIO = 0.5        # the replay-ratio floor the reaction relaxes
SUSPECT_AFTER, DEAD_AFTER = 2.0, 4.0   # the registry's windows, cut
RELAX_DEAD_FRAC = 0.4        # reaction and actor_dead_frac SLO bar, cut
SUPERVISE = ["--backoff", "12", "--min-uptime", "0.5", "--max-respawns", "3"]
#: the SLO engine's windows cut to the run: a 10 s / 30 s page pair at
#: burn 5, so one bad health tick pages and the alert clears within the run
SLO_KNOBS = {"APEX_SLO_FAST": "10,30", "APEX_SLO_PAGE_BURN": "5",
             "APEX_SLO_BREACH_AFTER": "4", "APEX_SLO_RESOLVE_AFTER": "5",
             "APEX_SLO_OK_AFTER": "5"}
FENCE_STEPS = 20             # 14c's learner steps (shard forgiveness paced)
PROFILE_LEARNER_STEPS = 16   # 14d's profiled learner steps
LINEAGE_HOPS = ("sealed→send", "send→recv", "recv→stage", "stage→consume",
                "consume→prio_wb")


def _fleet_cfg(ports: list[int], status_port: int, **comms):
    """Phase 12a's geometry on ``ports`` with the fleet plane's cuts:
    a status port, the registry's 2 s / 4 s windows and the reaction's
    bar."""
    return _service_cfg(ports, status_port=status_port,
                        suspect_after_s=SUSPECT_AFTER,
                        dead_after_s=DEAD_AFTER,
                        relax_floor_dead_frac=RELAX_DEAD_FRAC, **comms)


def fleet_spans_ref_phase(dev, gather, msgs: list) -> dict:
    """14-ref: phase 4's chunks through the learner's pipelined consume
    path (``train()`` over a list pool) twice on the card, spans on and
    off, from the same weights and seeds under deterministic cuDNN: the
    learners bit-equal; the spans-on run consumed every chunk's span."""
    import copy

    from apex_tpu_torch.obs import spans as obs_spans
    from apex_tpu_torch.training.apex import ApexTrainer

    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    saved = os.environ.get("APEX_OBS_SPANS")
    runs = {}
    try:
        for on in (True, False):
            os.environ["APEX_OBS_SPANS"] = "1" if on else "0"
            batch = []
            for msg in msgs:
                m = {k: v for k, v in msg.items() if k != obs_spans.SPAN_KEY}
                if on:
                    m[obs_spans.SPAN_KEY] = copy.deepcopy(
                        msg[obs_spans.SPAN_KEY])
                    obs_spans.mark_send(m, 1)
                batch.append(m)
            trainer = ApexTrainer(_full_width_cfg(True),
                                  pool=ListPool(batch), device=dev,
                                  respawn_workers=False)
            zero_launches(gather)                     # this path starts
            trainer.train(total_steps=TRAIN_STEPS, max_seconds=60.0)
            torch.cuda.synchronize()
            launches = read_launches(gather)          # this path ends
            check(trainer.steps == TRAIN_STEPS and gather_part(launches) == {
                "gather_rows": 0, "gather_stacks": TRAIN_STEPS},
                f"fleet_spans: {trainer.steps} steps, launches {launches}")
            runs[on] = (trainer, launches)
        (on_run, launches), (off_run, _) = runs[True], runs[False]
        _learners_equal(on_run, off_run, "spans on vs off")
        lat_on, lat_off = on_run.latency_summary(), off_run.latency_summary()
        check(lat_on["spans_consumed"] == len(msgs)
              and lat_off["spans_consumed"] == 0,
              f"fleet_spans: spans consumed {lat_on['spans_consumed']} / "
              f"{lat_off['spans_consumed']} of {len(msgs)} chunks")
        log(f"fleet_spans: phase 4's {len(msgs)} chunks through train() "
            f"(pipelined) with APEX_OBS_SPANS=1 and =0: weights, target, "
            f"optimizer, replay and generator bit-equal after "
            f"{TRAIN_STEPS} steps; {lat_on['spans_consumed']} spans "
            f"consumed, frame age p50 "
            f"{lat_on['frame_age_at_train_s']['p50_s']} s")
    finally:
        if saved is None:
            os.environ.pop("APEX_OBS_SPANS", None)
        else:
            os.environ["APEX_OBS_SPANS"] = saved
        torch.backends.cudnn.deterministic = flags
        runs.clear()
        torch.cuda.empty_cache()
    return launches


def _status_cli(port: int, *extra) -> tuple[int, str, float]:
    """``python -m apex_tpu_torch.runtime --role status`` against the
    learner on ``port``: (exit code, stdout, seconds)."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.runtime", "--role", "status",
         "--status-port", str(port), *extra], capture_output=True,
        text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return done.returncode, done.stdout, time.perf_counter() - t0


def _children(pid: int) -> list[int]:
    """The child processes of ``pid`` (Linux ``/proc``)."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(c) for c in f.read().split()]
    except OSError:
        return []


def _stop_supervised(roles, names: list[str], what: str) -> dict:
    """SIGTERM the role process under each supervisor in ``names``; the
    role exits 0, so its supervisor exits 0 after it.  Returns the
    supervisors' exit codes (None: did not exit)."""
    import signal

    procs = {n: p for n, p, _ in roles.procs if n in names}
    for name, proc in procs.items():
        for child in _children(proc.pid):
            os.kill(child, signal.SIGTERM)
    codes = {}
    deadline = time.monotonic() + ROLE_JOIN_S
    for name, proc in procs.items():
        try:
            codes[name] = proc.wait(timeout=max(0.1, deadline
                                                - time.monotonic()))
        except subprocess.TimeoutExpired:
            codes[name] = None
    if any(c != 0 for c in codes.values()):
        for name in procs:
            log(f"{what}: {name} output:\n{roles.tail(name)}")
    return codes


def fleet_chaos_run(dev, gather) -> dict:
    """14a: the learner role in this process with 4 actors under
    ``python -m apex_tpu_torch.fleet.supervise`` and 1 evaluator, through
    the CLI.  ``CHAOS_SEED`` kills actor-0 and actor-1 at send
    ``CHAOS_KILL_AT``; the supervisors respawn them (their kills are
    first-life only).  The learner runs until it has taken
    ``CHAOS_MIN_STEPS`` steps, seen both actors DEAD and ALIVE again,
    relaxed and restored its replay-ratio floor, and ``--role status``
    (table and ``--metrics``) has answered with every peer ALIVE."""
    import shutil
    import tempfile
    import threading

    from apex_tpu_torch.fleet import registry as reg_mod
    from apex_tpu_torch.fleet.registry import status_request
    from apex_tpu_torch.runtime.roles import run_learner
    from apex_tpu_torch.training import apex as apex_module

    what = "fleet_chaos"
    ports = _free_ports(4)
    cfg = _fleet_cfg(ports[:3], ports[3])
    shared = _role_argv(ports)
    chaos = {"CHAOS_SEED": str(SEED), "CHAOS_SPEC": json.dumps(
        {"kill": {"actor-0": CHAOS_KILL_AT, "actor-1": CHAOS_KILL_AT}})}
    tmp = tempfile.mkdtemp(prefix="apex-fleet-")
    logdir = os.path.join(tmp, "log")
    transitions, reacts, dead_at, alive_at = [], [], {}, {}
    status = {}
    done = threading.Event()
    real = (reg_mod.FleetRegistry.tick, reg_mod.FleetRegistry._revive,
            apex_module.ConcurrentTrainer._react_to_fleet)

    def tick(self):
        out = real[0](self)
        now = time.monotonic()
        for ident, old, new in out:
            transitions.append((ident, old, new))
            if new == "DEAD":
                dead_at[ident] = (now, now - self.peers[ident].last_any)
        return out

    def revive(self, peer):
        if peer.state == "DEAD":
            alive_at[peer.identity] = time.monotonic()
        real[1](self, peer)

    def react(self, steps):
        real[2](self, steps)
        reacts.append((round(self.fleet.dead_fraction(), 4),
                       self._floor_relaxed))
        if (self.steps >= CHAOS_MIN_STEPS and done.is_set()
                and not self._floor_relaxed):
            self.request_stop()

    def watch():
        """Poll the status server; once every peer is ALIVE after the
        rejoins and the floor is restored, run the status CLI twice."""
        deadline = time.monotonic() + CHAOS_SECONDS
        while time.monotonic() < deadline and not done.is_set():
            time.sleep(0.5)
            snap = status_request(cfg.comms, timeout_s=2.0)
            if not snap:
                continue
            m = snap["metrics"]
            alive = {p["identity"] for p in snap["peers"]
                     if p["state"] == "ALIVE"}
            want = {f"actor-{i}" for i in range(N_ACTORS)}
            if (want <= alive and any(a.startswith("evaluator-")
                                      for a in alive)
                    and m.get("dead_to_alive", 0) >= 2
                    and m.get("floor_relaxes", 0) >= 1
                    and not m.get("floor_relaxed")):
                rtt = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    status_request(cfg.comms, timeout_s=2.0)
                    rtt.append(1e3 * (time.perf_counter() - t0))
                status["rtt_ms"] = statistics.median(rtt)
                status["table"] = _status_cli(cfg.comms.status_port)
                status["metrics"] = _status_cli(cfg.comms.status_port,
                                                "--metrics")
                done.set()

    roles = RoleProcesses()
    saved_env = {k: os.environ.get(k) for k in SLO_KNOBS}
    os.environ.update(SLO_KNOBS)
    reg_mod.FleetRegistry.tick = tick
    reg_mod.FleetRegistry._revive = revive
    apex_module.ConcurrentTrainer._react_to_fleet = react
    watcher = threading.Thread(target=watch, daemon=True)
    try:
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", [*SUPERVISE, "--", sys.executable,
                                        "-m", "apex_tpu_torch.runtime",
                                        "--role", "actor", *shared],
                         dict(_actor_env(i), **chaos),
                         module="apex_tpu_torch.fleet.supervise")
        roles.launch("evaluator", ["--role", "evaluator", *shared,
                                   *_device_flag(dev)], {})
        log(f"{what}: run_learner on {dev}, {N_ACTORS} actors x "
            f"{ENVS_PER_ACTOR} envs under fleet.supervise ({SUPERVISE}) "
            f"and 1 evaluator through the CLI; CHAOS_SEED {SEED} kills "
            f"actor-0 and actor-1 at send {CHAOS_KILL_AT}; registry "
            f"suspect/dead after {SUSPECT_AFTER}/{DEAD_AFTER} s, reaction "
            f"bar {RELAX_DEAD_FRAC}, train_ratio {CHAOS_TRAIN_RATIO}, "
            f"min_train_ratio {CHAOS_MIN_RATIO}, status port "
            f"{cfg.comms.status_port}")
        watcher.start()
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=N_ACTORS + 1,
            total_steps=10 ** 6, logdir=logdir,
            train_ratio=CHAOS_TRAIN_RATIO, min_train_ratio=CHAOS_MIN_RATIO)
        done.set()
        watcher.join(timeout=30)
        dead = roles.dead()
        sup = _stop_supervised(roles, [f"actor-{i}"
                                       for i in range(N_ACTORS)], what)
        rest = roles.stop()
        outputs = {f"actor-{i}": roles.tail(f"actor-{i}", 20000)
                   for i in range(N_ACTORS)}
    finally:
        (reg_mod.FleetRegistry.tick, reg_mod.FleetRegistry._revive,
         apex_module.ConcurrentTrainer._react_to_fleet) = real
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        roles.close()
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after the run")
    check(not dead, f"{what}: role processes {dead} exited during the run")
    check(all(c == 0 for c in sup.values()) and all(
        c == 0 for c in rest.values()),
        f"{what}: exit codes after SIGTERM: supervisors {sup}, rest {rest}")
    for i in (0, 1):
        ident = f"actor-{i}"
        check(f"chaos: killing {ident} at message {CHAOS_KILL_AT}"
              in outputs[ident] and "respawn 1/" in outputs[ident],
              f"{what}: {ident} was not killed and respawned:\n"
              f"{outputs[ident][-3000:]}")
        mine = [(old, new) for who, old, new in transitions if who == ident]
        check(("SUSPECT", "DEAD") in mine and ("DEAD", "ALIVE") in mine
              and mine.index(("SUSPECT", "DEAD"))
              < mine.index(("DEAD", "ALIVE")),
              f"{what}: {ident} transitions {mine}")
    fleet = trainer.fleet
    check(fleet.dead_to_alive >= 2, f"{what}: dead_to_alive "
          f"{fleet.dead_to_alive}")
    relaxed_at = [frac for frac, relaxed in reacts if relaxed]
    check(trainer.floor_relaxes >= 1 and relaxed_at
          and max(relaxed_at) >= 0.5 and not trainer._floor_relaxed,
          f"{what}: floor reaction {reacts} (relaxes "
          f"{trainer.floor_relaxes})")
    with open(os.path.join(logdir, "fleet_summary.json")) as f:
        summary = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    slo_edges = [(e["from"], e["to"]) for e in summary["slo"]["timeline"]
                 if e["objective"] == "actor_dead_frac"]
    check(("OK", "BURNING") in slo_edges,
          f"{what}: actor_dead_frac SLO transitions {slo_edges}")
    check("table" in status, f"{what}: the status checks never ran")
    rc, table, status_s = status["table"]
    rows = table.split("\n\n")[0].splitlines()[1:]   # the peer rows
    check(rc == 0 and sum(r.startswith("actor-") for r in rows)
          == N_ACTORS and any(r.startswith("evaluator-") for r in rows)
          and all(" ALIVE " in r for r in rows),
          f"{what}: --role status exit {rc}:\n{table}")
    rc, text, metrics_s = status["metrics"]
    families = ("apex_fleet_", "apex_slo_", "apex_learner_steps_per_sec")
    check(rc == 0 and all(k in text for k in families),
          f"{what}: --role status --metrics exit {rc}:\n{text[:3000]}")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    _tree_sums(trainer, what)
    check(_finite_logged(trainer) > 0, f"{what}: no learner metrics logged")
    kill_dead = {k: round(v[1], 3) for k, v in dead_at.items()}
    dead_alive = {k: round(alive_at[k] - v[0], 3)
                  for k, v in dead_at.items() if k in alive_at}
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s; "
        f"transitions {transitions}; dead_to_alive {fleet.dead_to_alive}; "
        f"reaction (dead frac, floor relaxed) per health tick {reacts}; "
        f"actor_dead_frac SLO edges {slo_edges}; last kill to DEAD "
        f"(registry, 5 s health ticks) {kill_dead} s, DEAD to ALIVE "
        f"{dead_alive} s; status round trip median "
        f"{status['rtt_ms']:.3f} ms, --role status {status_s:.3f} s and "
        f"--metrics {metrics_s:.3f} s as processes")
    log(f"{what}: --role status printed:\n{table}")
    log(f"{what}: learner steps/s {trainer.steps_rate.rate:.3f}, env "
        f"frames/s ingested {trainer.frames_rate.rate:.1f} (last 100 "
        f"dispatches); gather launches {launches}; exit codes supervisors "
        f"{sup}, all roles {rest}; no port bound")
    return dict(launches=launches, kill_dead=kill_dead,
                dead_alive=dead_alive, rtt_ms=status["rtt_ms"])


def fleet_trace_run(dev, gather, spans: bool) -> dict:
    """14b: 12a's topology (4 actors x 8 envs, 1 evaluator) with
    ``--trace-dir`` on every process and the learner's ring on, for
    ``ROLE_STEPS`` steps; with ``spans`` off, the same run under
    ``APEX_OBS_SPANS=0`` everywhere.  The spans-on run merges the
    per-process traces with ``python -m apex_tpu_torch.obs.merge`` and
    checks the lineage hops in the merged timeline."""
    import shutil
    import tempfile

    from apex_tpu_torch.obs import trace as obs_trace

    what = "fleet_trace" if spans else "fleet_trace_nospans"
    ports = _free_ports(4)
    cfg = _fleet_cfg(ports[:3], ports[3])
    trace_dir = tempfile.mkdtemp(prefix="apex-trace-")
    flag = {"APEX_OBS_SPANS": "1" if spans else "0"}
    shared = _role_argv(ports, "--trace-dir", trace_dir)
    saved = {k: os.environ.get(k) for k in ("APEX_OBS_SPANS",
                                            "APEX_TRACE_DIR",
                                            "APEX_TRACE_FLUSH_S")}
    os.environ.update(flag, APEX_TRACE_DIR=trace_dir, APEX_TRACE_FLUSH_S="0")
    obs_trace.reset_for_tests()          # this process's ring, made anew
    roles = RoleProcesses()
    try:
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", *shared],
                         dict(_actor_env(i), **flag))
        roles.launch("evaluator", ["--role", "evaluator", *shared,
                                   *_device_flag(dev)], flag)
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=N_ACTORS + 1,
            total_steps=ROLE_STEPS, logdir=trace_dir)
        learner_file = obs_trace.dump_ring()
        _stop_roles(roles, what)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs_trace.reset_for_tests()
        roles.close()
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after the run")
    check(trainer.steps == ROLE_STEPS and gather_part(launches) == {
        "gather_rows": 0, "gather_stacks": trainer.steps},
        f"{what}: {trainer.steps} steps, gather launches {launches}")
    lat = trainer.latency_summary()
    out = dict(launches=launches, steps_per_s=trainer.steps_rate.rate,
               frames_per_s=trainer.frames_rate.rate,
               frames_over_run=trainer.ingested / wall, latency=lat)
    if not spans:
        shutil.rmtree(trace_dir, ignore_errors=True)
        check(lat["spans_consumed"] == 0,
              f"{what}: {lat['spans_consumed']} spans with spans off")
        return out
    files = sorted(f for f in os.listdir(trace_dir)
                   if f.startswith("trace-") and f.endswith(".json"))
    labels = sorted(f.split("-", 1)[1].rsplit("-", 1)[0] for f in files)
    check(len(files) == N_ACTORS + 2 and "learner" in labels
          and sum(lb.startswith("actor-") for lb in labels) == N_ACTORS
          and sum(lb.startswith("evaluator-") for lb in labels) == 1,
          f"{what}: trace files {files} (learner {learner_file})")
    merged_path = os.path.join(trace_dir, "merged_trace.json")
    done = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.obs.merge", trace_dir, "-o",
         merged_path], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(done.returncode == 0, f"{what}: obs.merge exited "
          f"{done.returncode}: {done.stdout}{done.stderr}")
    with open(merged_path) as f:
        merged = json.load(f)
    shutil.rmtree(trace_dir, ignore_errors=True)
    names = {ev["name"] for ev in merged["traceEvents"] if ev.get("ph") == "X"}
    check(set(LINEAGE_HOPS) <= names and lat["spans_consumed"] > 0,
          f"{what}: lineage hops {sorted(n for n in names if '→' in n)}, "
          f"{lat['spans_consumed']} spans consumed")
    n_events = sum(1 for ev in merged["traceEvents"] if ev.get("ph") == "X")
    fa, pl = lat["frame_age_at_train_s"], lat["param_propagation_lag_s"]
    gap = lat["dispatch_gap_ms"]
    log(f"{what}: {len(files)} trace files {labels} merged by "
        f"apex_tpu_torch.obs.merge into {n_events} events ("
        f"{done.stdout.strip()}); offsets "
        f"{merged['metadata'].get('offsets_applied')}; lineage hops "
        f"{sorted(n for n in names if '→' in n)}")
    log(f"{what}: latency_summary: frame age at train p50 {fa['p50_s']} s "
        f"p99 {fa['p99_s']} s ({fa['count']} spans); param propagation lag "
        f"p50 {pl['p50_s']} s p99 {pl['p99_s']} s; dispatch gap ms p50 "
        f"{gap['dispatch_gap_ms_p50']:.3f} p90 "
        f"{gap['dispatch_gap_ms_p90']:.3f} p99 "
        f"{gap['dispatch_gap_ms_p99']:.3f} over {gap['dispatches']} "
        f"dispatches")
    return out


def fleet_shards_run(dev, gather) -> dict:
    """14c: two ``--role replay`` shards on the card and 4 actors, the
    learner role in this process in its second life (epoch 2, as after a
    restore) under ``CHAOS_SPEC`` ``{"epoch_skew": {"learner": -1}}``:
    every write-back reaches the shards one epoch stale, and each shard
    rejects and counts them, forgives its batch after 0.5 s of silence
    (``--dead-after``, cut) and keeps its root equal to its leaves."""
    from apex_tpu_torch.training import apex as apex_module

    what = "fleet_shards"
    ports = _free_ports(3)
    base = _port_block(2)
    cfg = _service_cfg(ports, replay_shards=2, replay_port_base=base)
    shared = _role_argv(ports, "--replay-shards", "2", "--replay-port-base",
                        str(base))
    chaos = {"CHAOS_SEED": str(SEED),
             "CHAOS_SPEC": json.dumps({"epoch_skew": {"learner": -1}})}
    real_train = apex_module.ConcurrentTrainer.train

    def second_life(self, *args, **kw):
        self.learner_epoch = 2
        return real_train(self, *args, **kw)

    saved = {k: os.environ.get(k) for k in chaos}
    roles = RoleProcesses()
    try:
        for s in range(2):
            roles.launch(f"replay-{s}", [
                "--role", "replay", "--shard-id", str(s), *shared,
                "--dead-after", "0.5", *_device_flag(dev)], {})
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", *shared],
                         _actor_env(i))
        os.environ.update(chaos)
        apex_module.ConcurrentTrainer.train = second_life
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=N_ACTORS,
            total_steps=FENCE_STEPS)
        apex_module.ConcurrentTrainer.train = real_train
        _stop_roles(roles, what)
        shards = [roles.stats(f"replay-{s}") for s in range(2)]
    finally:
        apex_module.ConcurrentTrainer.train = real_train
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        roles.close()
    bound = _still_bound(ports + [base, base + 1])
    check(not bound, f"{what}: ports {bound} still bound after the run")
    client = trainer.replay_client
    local = trainer.steps - trainer.service_steps
    check(trainer.steps == FENCE_STEPS and client.epoch_skew == -1
          and trainer.service_steps > 0,
          f"{what}: {trainer.steps} steps ({trainer.service_steps} on shard "
          f"batches), client skew {client.epoch_skew}")
    check(gather_part(launches) == {"gather_rows": 0, "gather_stacks": local},
          f"{what}: the learner's gather launches {launches} with {local} "
          f"local fallback steps")
    for s, st in enumerate(shards):
        # no write-back applies: a batch leaves only by being forgiven
        check(st is not None and st["stale_wb"] >= 1
              and st["learner_epoch"] == 2 and st["forgiven"] >= 1
              and st["wb_applied"] == st["forgiven"],
              f"{what}: shard {s} stats {st}")
        check(abs(st["tree_root"] - st["tree_leaves"])
              <= 1e-5 * max(st["tree_leaves"], 1e-30),
              f"{what}: shard {s} root {st['tree_root']} != leaves "
              f"{st['tree_leaves']}")
        if dev.type == "cuda":
            check(st["gather_launches"]["gather_stacks"] == st["sampled"],
                  f"{what}: shard {s} launched "
                  f"{st['gather_launches']} for {st['sampled']} batches")
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s, "
        f"{trainer.service_steps} on shard batches; write-backs sent "
        f"{client.prio_sent} at epoch 1 by a learner of epoch 2; shards "
        + "; ".join(f"{s}: {st['sampled']} sampled, {st['stale_wb']} stale "
                    f"write-backs rejected, {st['forgiven']} batches "
                    f"forgiven, root {st['tree_root']:.6g}"
                    f" = leaves {st['tree_leaves']:.6g}"
                    for s, st in enumerate(shards)))
    shard_launches = summed([stats_launches(st) for st in shards])
    return dict(launches=launches, shard_launches=shard_launches)


def fleet_profile_run(dev, gather) -> dict:
    """14d: ``main(["--role", "learner", "--profile-dir", DIR, ...])`` of
    the CLI in this process with 4 CLI actors, for
    ``PROFILE_LEARNER_STEPS`` steps: the Chrome trace ``torch.profiler``
    writes into DIR names the gather kernel once per learner step."""
    import shutil
    import tempfile

    from apex_tpu_torch.runtime import cli

    what = "fleet_profile"
    ports = _free_ports(4)
    shared = _role_argv(ports)
    tmp = tempfile.mkdtemp(prefix="apex-profile-")
    prof_dir, logdir = os.path.join(tmp, "prof"), os.path.join(tmp, "log")
    roles = RoleProcesses()
    try:
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", *shared],
                         _actor_env(i))
        zero_launches(gather)                         # the path starts
        t0 = time.perf_counter()
        rc = cli.main(["--role", "learner", *shared, "--n-actors",
                       str(N_ACTORS), "--n-evaluators", "0",
                       "--status-port", str(ports[3]), "--total-steps",
                       str(PROFILE_LEARNER_STEPS), "--max-seconds", "240",
                       "--profile-dir", prof_dir, "--logdir", logdir,
                       *_device_flag(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gather)              # the path ends
        _stop_roles(roles, what)
    finally:
        roles.close()
    check(rc == 0, f"{what}: the learner role exited {rc}")
    with open(os.path.join(logdir, "fleet_summary.json")) as f:
        steps = json.load(f)["steps"]
    files = os.listdir(prof_dir)
    check(len(files) == 1, f"{what}: profile files {files}")
    with open(os.path.join(prof_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(tmp, ignore_errors=True)
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    gathers = [ev["name"] for ev in kernels
               if any(k in ev["name"] for k in ("bulk_kernel",
                                                "stacks_reg_kernel",
                                                "rows_reg_kernel"))]
    check(steps == PROFILE_LEARNER_STEPS
          and gather_part(launches) == {"gather_rows": 0,
                                        "gather_stacks": steps}
          and (len(gathers) == steps or dev.type == "cpu"),
          f"{what}: {steps} steps, launches {launches}, gather kernels in "
          f"the trace {len(gathers)} of {len(kernels)} kernel events")
    ms = sum(ev.get("dur", 0.0) for ev in kernels
             if ev["name"] in gathers) / 1e3 / max(1, len(gathers))
    log(f"{what}: --role learner --profile-dir: {steps} learner steps in "
        f"{wall:.3f} s (barrier included); the trace "
        f"{files[0]} holds {len(kernels)} kernel events, the gather kernel "
        f"{len(gathers)} times ({sorted(set(gathers))[:2]}), "
        f"{ms:.4f} ms each on average; gather launches {launches}")
    return dict(launches=launches)


def fleet_phase(dev, gather, msgs: list, p12a: dict) -> dict:
    """Phase 14: 14-ref, 14a-14d.  Returns the paths' launches."""
    t = [time.perf_counter()]
    ref = fleet_spans_ref_phase(dev, gather, msgs)
    t.append(time.perf_counter())
    chaos = fleet_chaos_run(dev, gather)
    t.append(time.perf_counter())
    traced = fleet_trace_run(dev, gather, spans=True)
    t.append(time.perf_counter())
    plain = fleet_trace_run(dev, gather, spans=False)
    t.append(time.perf_counter())
    shards = fleet_shards_run(dev, gather)
    t.append(time.perf_counter())
    prof = fleet_profile_run(dev, gather)
    t.append(time.perf_counter())
    log(f"fleet: spans on vs off (14b), learner steps/s "
        f"{traced['steps_per_s']:.3f} vs {plain['steps_per_s']:.3f}; env "
        f"frames/s ingested (last 100 dispatches) "
        f"{traced['frames_per_s']:.1f} vs {plain['frames_per_s']:.1f}, over "
        f"the run {traced['frames_over_run']:.1f} vs "
        f"{plain['frames_over_run']:.1f} (12a: {p12a['steps_per_s']:.3f} "
        f"steps/s)")
    names = ("fleet_spans", "fleet_chaos", "fleet_trace",
             "fleet_trace_nospans", "fleet_shards", "fleet_profile")
    log("fleet: phase 14 seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(names, t, t[1:])))
    return {"fleet_spans": ref, "fleet_chaos": chaos["launches"],
            "fleet_trace": traced["launches"],
            "fleet_trace_nospans": plain["launches"],
            "fleet_shards": shards["launches"],
            "fleet_shards_shards": shards["shard_launches"],
            "fleet_profile": prof["launches"]}



# -- phase 15: the control planes ------------------------------------------

CTL_INTERVAL = 1.0           # the controllers' control round, s (from 5)
SERVE_SOAK = 60.0            # 15a's canary soak, s (the default)
SERVE_VERSION_EVERY = 8      # 15a: publishes between deployments
SERVE_PUBLISH_INTERVAL = 5   # 15a's learner steps per publish (from 25)
SERVE_SECONDS = 200.0        # 15a's wall-clock bound
EVAL_SCORE_BAR = -50.0       # 15a: the eval_score objective's bar
SCORE_BIAS = -100.0          # the chaos score bias of the bad evaluators
SERVE_SLO = {**SLO_KNOBS, "APEX_SLO_EVAL_SCORE": str(EVAL_SCORE_BAR),
             # the actors' infer round trip on this loaded host is not
             # what 15a judges
             "APEX_SLO_INFER_RT_MS": "5000"}
TENANT_CAPACITY = 2 ** 18    # 15b: each shard partition (from 2^19)
TENANT_QUOTA = 2 ** 12       # 15b: rally's quota per shard (from 2^16)
TENANT_ACTORS = 2            # 15b: actor processes per tenant
TENANT_DEAD_S = 3.0          # 15b: tenant-ctl's eviction silence (from 15)
TENANT_AFTER_STEPS = 20      # 15b: t0's steps after the eviction
TENANT_SECONDS = 200.0
PBT_CAPACITY = 2 ** 16       # 15c: each lineage's replay (checkpoints)
PBT_SAVE_EVERY = 20          # 15c: la's checkpoint interval, steps
PBT_DECIDE = 5.0             # 15c: pbt-ctl's decision period (from 30)
PBT_AFTER_STEPS = 10         # 15c: lb's steps after the exploit
PBT_SECONDS = 200.0


def _retire(roles, name: str) -> int | None:
    """SIGTERM one role mid-run and wait for it; it leaves the set
    :func:`_stop_roles` stops (its log stays).  Returns its exit code,
    None if it had to be killed."""
    entry = next(e for e in roles.procs if e[0] == name)
    _, proc, out = entry
    proc.terminate()
    try:
        code = proc.wait(timeout=ROLE_JOIN_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        code = None
    roles.procs.remove(entry)
    out.close()
    return code


def _snapshot_line(roles, name: str) -> dict | None:
    """The ``<role>: snapshot {...}`` line a controller prints as it
    stops, parsed."""
    with open(os.path.join(roles.tmp.name, f"{name}.log"), "rb") as f:
        text = f.read().decode(errors="replace")
    for line in reversed(text.splitlines()):
        if ": snapshot {" in line:
            return json.loads(line.split(": snapshot ", 1)[1])
    return None


def _env_set(values: dict) -> dict:
    """Set ``values`` in this process's environment; returns what to
    restore with :func:`_env_restore`."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    return saved


def _env_restore(saved: dict) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def control_reference_phase(dev, gather, msgs: list) -> None:
    """15-ref: the infer server's version gate and ``restore_weights`` on
    the card.  (a) an ``InferServer`` at full width goes freeze -> canary
    (the candidate loaded) -> rollback, with ``infer_device_params`` off
    and on: its model's tensors then equal the incumbent's, bit for bit,
    and its replies are the incumbent's; promote opens the gate.  (b) a
    live learner takes a donor's checkpoint with ``restore_weights``:
    its ``train_state`` equals the donor's, bit for bit, its epoch goes up
    by one, its replay and generator stay, and its next update on one
    fixed batch equals the donor's (deterministic cuDNN)."""
    from apex_tpu_torch.models.dueling import DuelingDQN, host_params
    from apex_tpu_torch.training.apex import dqn_env_specs

    what = "ctl_ref"
    cfg = _service_cfg(_free_ports(3))
    spec = dqn_env_specs(cfg)[0]
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    weights = [host_params(DuelingDQN(
        **spec, generator=torch.Generator().manual_seed(SEED + i)))
        for i in (1, 2)]
    rng = np.random.default_rng(SEED)
    obs = rng.integers(0, 256, (16,) + tuple(spec["obs_shape"]),
                       dtype=np.uint8)
    request = {"rid": 1, "obs": obs, "eps": np.zeros(16, np.float32),
               "seed": 5, "group": 0}
    try:
        _gate_reference(dev, cfg, weights, request, what)
        _restore_reference(dev, msgs, what)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        torch.cuda.empty_cache()


def _gate_reference(dev, cfg, weights, request, what) -> None:
    """15-ref (a), the infer server's gate on the card."""
    import dataclasses

    from apex_tpu_torch.infer_service.service import (InferServer,
                                                      dqn_policy_model)

    for device_params in (False, True):
        comms = dataclasses.replace(cfg.comms, infer_port=_free_ports(1)[0],
                                    infer_device_params=device_params)
        model = dqn_policy_model(cfg, dev)
        server = InferServer(comms, model, heartbeat=False,
                             obs_shape=model.obs_shape)
        replies = []
        server._reply = lambda ident, msg: replies.append(msg)
        try:
            incumbent = {k: torch.as_tensor(v).to(dev)
                         for k, v in weights[0].items()}
            server.set_params(5, weights[0], epoch=1)
            server._dispatch([(b"x", dict(request), 0.0)])
            want_q = replies[-1][1]["q"]
            st = server.apply_ctl({"cmd": "freeze"})
            check(st["pinned"] and st["has_incumbent"],
                  f"{what}: freeze {st}")
            server.set_params(9, weights[1], epoch=1)     # held
            check(server.held == 1 and server.param_version == 5,
                  f"{what}: a frozen shard installed {server.ctl_state()}")
            server.apply_ctl({"cmd": "canary"})
            server.set_params(9, weights[1], epoch=1)     # tracked
            server._dispatch([(b"x", dict(request), 0.0)])
            check(replies[-1][1]["pv"] == 9 and not all(
                torch.equal(model.state_dict()[k], incumbent[k])
                for k in incumbent),
                f"{what}: the canary never served the candidate")
            st = server.apply_ctl({"cmd": "rollback", "epoch": 1,
                                   "version": 5})
            torch.cuda.synchronize()
            check(all(torch.equal(model.state_dict()[k], incumbent[k])
                      for k in incumbent) and st["version"] == 5
                  and st["pinned"] and server.gate_rollbacks == 1,
                  f"{what}: rollback did not restore the incumbent "
                  f"bit for bit ({st})")
            server._dispatch([(b"x", dict(request), 0.0)])
            check(replies[-1][1]["pv"] == 5 and np.array_equal(
                replies[-1][1]["q"], want_q),
                f"{what}: replies after rollback are not the incumbent's")
            server.set_params(12, weights[1], epoch=1)
            check(server.held == 2, f"{what}: a rolled-back shard installed")
            server.apply_ctl({"cmd": "promote"})
            server.set_params(12, weights[1], epoch=1)
            check(server.param_version == 12 and not server.ctl_state()[
                "pinned"], f"{what}: promote left {server.ctl_state()}")
        finally:
            server.close()
        log(f"{what}: infer gate with infer_device_params={device_params}: "
            f"freeze held the candidate, canary served it, rollback gave "
            f"back the incumbent's {len(incumbent)} tensors bit for bit "
            f"and its replies, promote opened the gate")


def _restore_reference(dev, msgs, what) -> None:
    """15-ref (b), ``restore_weights`` on the card."""
    import dataclasses
    import tempfile

    from apex_tpu_torch.training.apex import ApexTrainer

    with tempfile.TemporaryDirectory(prefix="apex-pbt-ref-") as tmp:
        donor = ApexTrainer(_full_width_cfg(True, CHECKPOINT_CAPACITY),
                            pool=ListPool([]), device=dev,
                            checkpoint_dir=tmp)
        for msg in msgs[:WARMUP_CHUNKS + 4]:
            donor.consume([msg])
        path = donor.save_checkpoint()
        cfg_b = _full_width_cfg(True, CHECKPOINT_CAPACITY)
        cfg_b = cfg_b.replace(env=dataclasses.replace(cfg_b.env,
                                                      seed=SEED + 5))
        live = ApexTrainer(cfg_b, pool=ListPool([]), device=dev)
        for msg in msgs[:WARMUP_CHUNKS + 2]:
            live.consume([msg])
        replay, gen = live.replay_state, live.generator.get_state()
        epoch, steps = live.learner_epoch, live.steps
        t0 = time.perf_counter()
        live.restore_weights(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(_same(live.train_state.opt_state,
                    donor.train_state.opt_state)
              and live.train_state.step == donor.train_state.step
              and all(_same(a.state_dict(), b.state_dict()) for a, b in (
                  (live.train_state.params, donor.train_state.params),
                  (live.train_state.target_params,
                   donor.train_state.target_params))),
              f"{what}: restore_weights did not impose the donor's "
              f"train_state bit for bit")
        check(live.learner_epoch == epoch + 1 and live.steps == steps
              and live.replay_state is replay and torch.equal(
                  live.generator.get_state(), gen),
              f"{what}: restore_weights moved more than the train_state")
        offsets = torch.rand(BATCH, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        batch, weights_is, _ = donor.replay.sample(
            donor.replay_state, offsets, 0.4)
        out = []
        for t in (donor, live):
            _, _, m = t.core.update_from_batch(t.train_state, batch,
                                               weights_is)
            out.append({k: v.item() for k, v in m.items()})
        check(out[0] == out[1] and all(
            _same(a.state_dict(), b.state_dict()) for a, b in (
                (live.train_state.params, donor.train_state.params),
                (live.train_state.target_params,
                 donor.train_state.target_params)))
              and _same(live.train_state.opt_state,
                        donor.train_state.opt_state),
              f"{what}: the next update differs ({out})")
    log(f"{what}: restore_weights imposed the donor's train_state bit "
        f"for bit in {restore_s:.3f} s (epoch {epoch} -> "
        f"{live.learner_epoch}, replay and generator kept); the next "
        f"update on one fixed batch equal on both: {out[0]}")


def serve_ctl_run(dev, gather) -> dict:
    """15a: the learner role in this process at 12a's geometry, 2
    ``--role infer`` shards on the card, 4 ``--remote-policy`` actors x 8
    envs, 1 evaluator and ``--role serve-ctl`` (canary fraction 0.5),
    through the CLI.  The first new version is canaried and PROMOTED;
    then a second evaluator starts under a chaos ``score_bias``, the
    ``eval_score`` objective breaches during the next canary, and that
    version is ROLLED_BACK: shard 0 loads back the weights it served
    before the canary and pins them; the rejected version is never
    canaried again."""
    import threading

    from apex_tpu_torch.training import apex as apex_module

    what = "ctl_serve"
    ports = _free_ports(4)
    base = _port_block(2)
    cfg = _service_cfg(ports[:3], infer_port=base, infer_shards=2,
                       status_port=ports[3])
    import dataclasses
    cfg = cfg.replace(learner=dataclasses.replace(
        cfg.learner, publish_interval=SERVE_PUBLISH_INTERVAL))
    shared = _role_argv(ports[:3], "--infer-port", str(base),
                        "--infer-shards", "2")
    published: dict[int, float] = {}
    snaps: list = []                  # (wall, serving snapshot) as it moves
    state = {"stop": False, "bad": False}
    real = (apex_module.ConcurrentTrainer._publish,
            apex_module.ConcurrentTrainer._drain_stats)

    def publish(self):
        real[0](self)
        published[self.param_version] = time.time()

    def drain(self, steps):
        real[1](self, steps)
        srv = self.serving_state
        if srv is not None and (not snaps or snaps[-1][1] is not srv):
            snaps.append((time.time(), srv))
        if state["stop"]:
            self.request_stop()

    def edges(snap):
        return [(e["from"], e["to"], e["version"])
                for e in snap.get("timeline", [])]

    def watch(roles):
        deadline = time.monotonic() + SERVE_SECONDS
        while time.monotonic() < deadline and not state["stop"]:
            time.sleep(0.25)
            if not snaps:
                continue
            snap = snaps[-1][1]
            ed = edges(snap)
            if not state["bad"] and any(e[1] == "PROMOTED" for e in ed):
                state["bad"] = True
                roles.launch("evaluator-bad", [
                    "--role", "evaluator", "--actor-id", "1", *shared,
                    *_device_flag(dev)], {
                        "CHAOS_SEED": str(SEED), "CHAOS_SPEC": json.dumps(
                            {"score_bias": {"evaluator-1": {
                                "after_s": 0, "delta": SCORE_BIAS}}})})
            if rolled_back(snap)[0]:
                state["stop"] = True

    def rolled_back(snap):
        """Shard 0 after the first rollback: pinned on a version between
        the incumbent and the rejected candidate, with a restore that
        changed its model.  Returns (ok, rejected version)."""
        rb = next((e for e in snap.get("timeline", [])
                   if e["to"] == "ROLLED_BACK"), None)
        shard0 = (snap.get("shards") or {}).get("0") or {}
        if rb is None or not snap.get("incumbent"):
            return False, None
        rejected = int(rb["version"].split(":")[1])
        ok = (shard0.get("pinned") and shard0.get("rollbacks", 0) >= 1
              and snap["incumbent"]["version"] <= shard0.get("version", -1)
              < rejected)
        return bool(ok), rejected

    roles = RoleProcesses()
    saved = _env_set(SERVE_SLO)
    apex_module.ConcurrentTrainer._publish = publish
    apex_module.ConcurrentTrainer._drain_stats = drain
    watcher = threading.Thread(target=watch, args=(roles,), daemon=True)
    try:
        for s in range(2):
            roles.launch(f"infer-{s}", ["--role", "infer",
                                        "--infer-shard-id", str(s), *shared,
                                        *_device_flag(dev)], {})
        for s in range(2):
            roles.wait_for(f"infer-{s}", f"infer-{s}: serving on port",
                           ROLE_JOIN_S)
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", "--remote-policy",
                                        *shared], _actor_env(i))
        roles.launch("evaluator", ["--role", "evaluator", *shared,
                                   *_device_flag(dev)], {})
        roles.launch("serve-ctl", [
            "--role", "serve-ctl", *shared, "--learner-ip", "127.0.0.1",
            "--status-port", str(ports[3]), "--serve-canary-frac", "0.5",
            "--serve-soak", str(SERVE_SOAK), "--serve-version-every",
            str(SERVE_VERSION_EVERY), "--serve-interval", str(CTL_INTERVAL),
            "--max-seconds", str(SERVE_SECONDS + 60)], {})
        log(f"{what}: run_learner on {dev}, 2 infer shards (ports {base}, "
            f"{base + 1}) on {dev}, {N_ACTORS} --remote-policy actors x "
            f"{ENVS_PER_ACTOR} envs, 1 evaluator and serve-ctl (canary "
            f"0.5, soak {SERVE_SOAK} s, a deployment every "
            f"{SERVE_VERSION_EVERY} publishes, publish every "
            f"{SERVE_PUBLISH_INTERVAL} steps, tick {CTL_INTERVAL} s) "
            f"through the CLI; eval_score bar {EVAL_SCORE_BAR}")
        watcher.start()
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=N_ACTORS + 1,
            total_steps=10 ** 6)
        state["stop"] = True
        watcher.join(timeout=30)
        codes = _stop_roles(roles, what)
        servers = [roles.stats(f"infer-{s}") for s in range(2)]
        final = _snapshot_line(roles, "serve-ctl")
    finally:
        (apex_module.ConcurrentTrainer._publish,
         apex_module.ConcurrentTrainer._drain_stats) = real
        _env_restore(saved)
        roles.close()
    bound = _still_bound(ports + [base, base + 1])
    check(not bound, f"{what}: ports {bound} still bound after the run")
    check(trainer.serving_state is not None and final is not None,
          f"{what}: no serving snapshot (learner {trainer.serving_state}, "
          f"controller {final})")
    snap = trainer.serving_state
    log(f"{what}: {trainer.steps} learner steps in {wall:.3f} s; "
        f"{trainer.param_version} publishes; timeline "
        f"{[(e['t_s'], e['from'], e['to'], e['version'], e['reason']) for e in snap['timeline']]}; "
        f"shards {snap['shards']}")
    ed = [(e["from"], e["to"]) for e in snap["timeline"]]
    check(("CANARY", "PROMOTED") in ed and ("CANARY", "ROLLED_BACK") in ed
          and ed.index(("CANARY", "PROMOTED"))
          < ed.index(("CANARY", "ROLLED_BACK")),
          f"{what}: timeline {snap['timeline']}")
    first_rb = next(e for e in snap["timeline"] if e["to"] == "ROLLED_BACK")
    check("eval_score" in first_rb["reason"],
          f"{what}: rolled back for {first_rb['reason']}")
    rejected = first_rb["version"]
    canaried = [e["version"] for e in snap["timeline"]
                if e["to"] == "CANARY"]
    check(canaried.count(rejected) <= 1,
          f"{what}: the rejected {rejected} was canaried again {canaried}")
    ok, _ = rolled_back(snap)
    shard0 = snap["shards"]["0"]
    check(ok and servers[0] is not None
          and servers[0]["serve_rollbacks"] >= 1
          and servers[0]["serve_version"] == shard0["version"]
          and servers[0]["serve_pinned"] == 1,
          f"{what}: shard 0 after the rollback {shard0} (incumbent "
          f"{snap['incumbent']}), its stats {servers[0]}")
    check(all(st is not None and st["rejected"] == 0 for st in servers),
          f"{what}: infer stats {servers}")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    check(_finite_logged(trainer) > 0, f"{what}: no learner metrics logged")
    _tree_sums(trainer, what)
    table = trainer.fleet_summary()
    from apex_tpu_torch.fleet.registry import format_fleet_table
    check("serving: " in format_fleet_table(table),
          f"{what}: no serving lines in the status table")

    def since_publish(event):
        v = int(event["version"].split(":")[1])
        return round(event["wall"] - published[v], 3) if v in published \
            else None

    timeline = snap["timeline"]
    canary_ev = [e for e in timeline if e["to"] == "CANARY"]
    promoted = next(e for e in timeline if e["to"] == "PROMOTED")
    first_canary = canary_ev[0]
    rb_canary = [e for e in canary_ev if e["t_s"] <= first_rb["t_s"]][-1]
    times = {"version_to_canary_s": [since_publish(e) for e in canary_ev],
             "version_to_promoted_s": round(
                 promoted["wall"] - published.get(int(
                     first_canary["version"].split(":")[1]),
                     promoted["wall"]), 3),
             "version_to_rolled_back_s": round(
                 first_rb["wall"] - published.get(int(
                     rb_canary["version"].split(":")[1]),
                     first_rb["wall"]), 3)}
    log(f"{what}: seconds from a new version's publish to CANARY "
        f"{times['version_to_canary_s']}, to PROMOTED "
        f"{times['version_to_promoted_s']}, to ROLLED_BACK "
        f"{times['version_to_rolled_back_s']}; shard 0 back on "
        f"{shard0['epoch']}:{shard0['version']} (incumbent "
        f"{snap['incumbent']['id']}, rejected {rejected}), pinned, {servers[0]['serve_rollbacks']} restore(s); "
        f"shard 1 {snap['shards'].get('1')}; infer-0 "
        f"{servers[0]['requests']} requests, infer-1 "
        f"{servers[1]['requests']}; controller snapshot deployments "
        f"{final['deployments']}, promotions {final['promotions']}, "
        f"rollbacks {final['rollbacks']}")
    log(f"{what}: learner steps/s {trainer.steps_rate.rate:.3f} vs 13b "
        f"{RATES.get('remote_policy', float('nan')):.3f}; gather launches "
        f"{launches} in {trainer.steps} steps; role exit codes {codes}; "
        f"no port bound")
    return dict(launches=launches, steps_per_s=trainer.steps_rate.rate,
                **times)


def tenant_ctl_run(dev, gather) -> dict:
    """15b: two tenants on 2 shared ``--role replay`` shards: ``t0`` (the
    default, ``ApexCatch-v0``, its learner in this process) and ``rally``
    (``ApexRally-v0``, its learner through the CLI), 2 actors x 8 envs
    each and ``--role tenant-ctl``.  Both are admitted and banded; once
    rally's quota has bitten, rally's learner is stopped; rally is
    EVICTED and t0's band grows to both shards while t0 keeps
    training."""
    import threading

    from apex_tpu_torch.fleet.registry import (format_fleet_table,
                                               status_request)
    from apex_tpu_torch.training import apex as apex_module

    what = "ctl_tenant"
    ports = _free_ports(8)
    t0_ports, rally_ports = ports[:3], ports[4:7]
    t0_status, rally_status = ports[3], ports[7]
    base = _port_block(2)
    cfg = _service_cfg(t0_ports, replay_shards=2, replay_port_base=base,
                       status_port=t0_status)
    import dataclasses
    cfg = cfg.replace(actor=dataclasses.replace(cfg.actor,
                                                n_actors=TENANT_ACTORS))
    roster = [{"name": "t0", "env_id": "ApexCatch-v0", "accel": True,
               "learner_ip": "127.0.0.1", "status_port": t0_status,
               "param_port": t0_ports[1]},
              {"name": "rally", "env_id": "ApexRally-v0",
               "replay_quota": TENANT_QUOTA, "learner_ip": "127.0.0.1",
               "status_port": rally_status, "param_port": rally_ports[1]}]
    tenants_env = {"APEX_TENANTS": json.dumps(roster)}
    shard_argv = ["--role", "replay", "--env-id", "ApexCatch-v0", "--seed",
                  str(SEED), "--replay-shards", "2", "--replay-port-base",
                  str(base), "--capacity", str(TENANT_CAPACITY), "--warmup",
                  str(TRAIN_WARMUP), "--batch-size", str(BATCH),
                  "--batch-port", str(t0_ports[0]), "--heartbeat-interval",
                  "1.0", *_device_flag(dev)]

    def tenant_argv(tports, env_id, *extra):
        return ["--env-id", env_id, "--seed", str(SEED),
                "--n-envs-per-actor", str(ENVS_PER_ACTOR),
                "--send-interval", str(SEND_INTERVAL), "--batch-port",
                str(tports[0]), "--param-port", str(tports[1]),
                "--barrier-port", str(tports[2]), "--heartbeat-interval",
                "1.0", "--barrier-timeout", "120", "--replay-shards", "2",
                "--replay-port-base", str(base), "--n-actors",
                str(TENANT_ACTORS), *extra]

    def actor_env(i, tenant):
        env = dict(_actor_env(i), N_ACTORS=str(TENANT_ACTORS))
        if tenant:
            env["APEX_TENANT"] = tenant
        return env

    rally_comms = dataclasses.replace(cfg.comms, status_port=rally_status)
    ctl_argv = ["--role", "tenant-ctl", "--learner-ip", "127.0.0.1",
                "--batch-port", str(t0_ports[0]), "--status-port",
                str(t0_status), "--replay-shards", "2", "--dead-after",
                str(TENANT_DEAD_S), "--serve-interval", str(CTL_INTERVAL),
                "--max-seconds", str(TENANT_SECONDS + 60)]
    state = {"stop": False, "phase": "start", "killed_at": None,
             "evicted_at": None, "steps_at_evict": None, "tenancy": []}
    real = apex_module.ConcurrentTrainer._drain_stats

    def drain(self, steps):
        real(self, steps)
        ten = self.tenancy_state
        if ten is not None and (not state["tenancy"]
                                or state["tenancy"][-1] is not ten):
            state["tenancy"].append(ten)
        state["steps"] = self.steps
        state["quota"] = {k: (p.gauges or {}).get("quota_dropped", 0)
                          for k, p in self.fleet.peers.items()
                          if k.startswith("replay-")}
        if (state["evicted_at"] is not None and self.steps
                >= state["steps_at_evict"] + TENANT_AFTER_STEPS):
            state["stop"] = True
        if state["stop"]:
            self.request_stop()

    def watch(roles):
        deadline = time.monotonic() + TENANT_SECONDS
        while time.monotonic() < deadline and not state["stop"]:
            time.sleep(0.25)
            if state["phase"] == "start":
                # tenant-ctl starts once both learners answer, so their
                # start-up is not read as a silence
                if state.get("steps", 0) >= 1 and status_request(
                        rally_comms, learner_ip="127.0.0.1", timeout_s=1.0):
                    roles.launch("tenant-ctl", ctl_argv, tenants_env)
                    state["phase"] = "admit"
                continue
            ten = state["tenancy"][-1] if state["tenancy"] else {}
            tenants = ten.get("tenants") or {}
            quota = state.get("quota") or {}
            if (state["phase"] == "admit" and len(tenants) == 2
                    and all(t["state"] == "ACTIVE" for t in tenants.values())
                    and len(quota) == 2 and all(quota.values())):
                state["killed_at"] = time.monotonic()
                state["rally_exit"] = _retire(roles, "learner-rally")
                state["phase"] = "evict"
            elif (state["phase"] == "evict"
                  and tenants.get("rally", {}).get("state") == "EVICTED"
                  and tenants.get("t0", {}).get("replay_band") == [0, 1]):
                state["evicted_at"] = time.monotonic()
                state["steps_at_evict"] = state["steps"]
                state["phase"] = "done"

    roles = RoleProcesses()
    saved = _env_set(tenants_env)
    apex_module.ConcurrentTrainer._drain_stats = drain
    watcher = threading.Thread(target=watch, args=(roles,), daemon=True)
    logdir = None
    try:
        import tempfile
        logdir = tempfile.mkdtemp(prefix="apex-tenancy-")
        for s in range(2):
            roles.launch(f"replay-{s}", [*shard_argv, "--shard-id", str(s)],
                         tenants_env)
        roles.launch("learner-rally", [
            "--role", "learner", "--tenant", "rally",
            *tenant_argv(rally_ports, "ApexRally-v0"), "--n-evaluators", "0",
            "--status-port", str(rally_status), "--capacity",
            str(TENANT_CAPACITY), "--warmup", str(TRAIN_WARMUP),
            "--batch-size", str(BATCH), "--total-steps", str(10 ** 6),
            "--max-seconds", str(TENANT_SECONDS), *_device_flag(dev)],
            tenants_env)
        for i in range(TENANT_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", *tenant_argv(
                t0_ports, "ApexCatch-v0")], actor_env(i, ""))
            roles.launch(f"rally-actor-{i}", ["--role", "actor", *tenant_argv(
                rally_ports, "ApexRally-v0")], actor_env(i, "rally"))
        log(f"{what}: t0 (ApexCatch-v0, run_learner on {dev}) and rally "
            f"(ApexRally-v0, --role learner) on 2 replay shards (ports "
            f"{base}, {base + 1}; a partition per tenant at capacity "
            f"{TENANT_CAPACITY}, rally's quota {TENANT_QUOTA} per shard), "
            f"{TENANT_ACTORS} actors x {ENVS_PER_ACTOR} envs each and "
            f"tenant-ctl (started once both learners answer; tick "
            f"{CTL_INTERVAL} s, eviction after {TENANT_DEAD_S} s of "
            f"silence)")
        watcher.start()
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=TENANT_ACTORS,
            total_steps=10 ** 6, logdir=logdir)
        state["stop"] = True
        watcher.join(timeout=30)
        codes = _stop_roles(roles, what)
        shards = [roles.stats(f"replay-{s}") for s in range(2)]
        final = _snapshot_line(roles, "tenant-ctl")
        with open(os.path.join(logdir, "fleet_summary.json")) as f:
            summary = json.load(f)
    finally:
        apex_module.ConcurrentTrainer._drain_stats = real
        _env_restore(saved)
        roles.close()
        if logdir is not None:
            import shutil
            shutil.rmtree(logdir, ignore_errors=True)
    bound = _still_bound(ports + [base, base + 1])
    check(not bound, f"{what}: ports {bound} still bound after the run")
    check(state.get("rally_exit") == 0,
          f"{what}: rally's learner exited {state.get('rally_exit')} on "
          f"SIGTERM")
    check(state["phase"] == "done",
          f"{what}: stopped in phase {state['phase']} (tenancy "
          f"{state['tenancy'][-1:] if state['tenancy'] else None}, quota "
          f"drops {state.get('quota')})")
    check(all(st is not None for st in shards),
          f"{what}: a shard printed no stats")
    for s, st in enumerate(shards):
        rally = st["tenants"].get("rally") or {}
        check(st["unknown_tenant"] == 0 and rally.get("quota_dropped", 0) > 0
              and rally.get("quota") == TENANT_QUOTA,
              f"{what}: shard {s} unknown {st['unknown_tenant']}, rally "
              f"partition {rally}")
        if dev.type == "cuda":
            sampled = sum(p["sampled"] for p in st["tenants"].values())
            check(st["gather_launches"]["gather_stacks"] == sampled > 0,
                  f"{what}: shard {s} launched {st['gather_launches']} for "
                  f"{sampled} batches")
    ten = summary.get("tenancy") or {}
    check(ten.get("tenants", {}).get("rally", {}).get("state") == "EVICTED"
          and ten["tenants"]["t0"]["replay_band"] == [0, 1]
          and ten["evictions"] >= 1 and ten["admissions"] >= 2,
          f"{what}: fleet_summary.json tenancy {ten}")
    table = format_fleet_table(summary)
    check("tenant rally: EVICTED" in table and "tenancy: " in table,
          f"{what}: the status table's tenancy lines:\n{table}")
    check(final is not None and final["tenants"]["rally"]["state"]
          == "EVICTED", f"{what}: tenant-ctl's snapshot {final}")
    local = trainer.steps - trainer.service_steps
    check(gather_part(launches) == {"gather_rows": 0, "gather_stacks": local},
          f"{what}: the learner's gather launches {launches} with {local} "
          f"local steps")
    check(trainer.service_steps > 0 and _finite_logged(trainer) > 0,
          f"{what}: {trainer.service_steps} service steps")
    kill_to_evict = state["evicted_at"] - state["killed_at"]
    shard_launches = summed([stats_launches(st) for st in shards])
    log(f"{what}: t0 {trainer.steps} learner steps in {wall:.3f} s "
        f"({trainer.service_steps} on shard batches, "
        f"{state['steps'] - state['steps_at_evict']} after rally's "
        f"eviction); rally's learner stopped to EVICTED in "
        f"{kill_to_evict:.3f} s; timeline "
        f"{[(e['t_s'], e['event'], e['tenant'], e['reason']) for e in ten['timeline']]}")
    log(f"{what}: shards " + "; ".join(
        f"{s}: " + ", ".join(
            f"{t} {p['ingested']} ingested, {p['sampled']} sampled, quota "
            f"{p['quota']} dropped {p['quota_dropped']}"
            for t, p in sorted(st["tenants"].items()))
        + f", gather launches {st['gather_launches']['gather_stacks']}, "
          f"unknown tenant {st['unknown_tenant']}, peak "
          f"{st['peak_bytes'] / 2**30:.3f} GiB"
        for s, st in enumerate(shards)))
    log(f"{what}: t0 learner steps/s {trainer.steps_rate.rate:.3f} vs 13a "
        f"{RATES.get('replay_service', float('nan')):.3f}; learner gather "
        f"launches {launches}; role exit codes {codes}; no port bound")
    return dict(launches=launches, shard_launches=shard_launches,
                steps_per_s=trainer.steps_rate.rate,
                kill_to_evict_s=kill_to_evict)


def pbt_ctl_run(dev, gather) -> dict:
    """15c: two lineages on the Catch ladder (``APEX_POPULATION``): ``la``
    with its learner through the CLI, ``lb`` with its learner in this
    process; each with 1 actor x 8 envs and an evaluator; a chaos
    ``score_bias`` scoped to ``lb`` ranks it last.  ``--role pbt-ctl``
    sends ``lb`` an EXPLOIT from ``la``: ``lb`` applies it at its next
    health tick, its ``train_state`` equals ``la``'s checkpoint bit for
    bit, its epoch goes up by one (the param channel carries the new
    epoch), the mutated lr is live and ``population_ctl.exploits`` is
    1."""
    import tempfile
    import threading

    from apex_tpu_torch.runtime.transport import ParamSubscriber
    from apex_tpu_torch.tenancy import namespace as tenancy_ns
    from apex_tpu_torch.training import apex as apex_module
    from apex_tpu_torch.training.checkpoint import load_raw

    what = "ctl_pbt"
    ports = _free_ports(8)
    la_ports, lb_ports = ports[:3], ports[4:7]
    la_status, lb_status = ports[3], ports[7]
    tmp = tempfile.mkdtemp(prefix="apex-pbt-")
    la_ckpt = os.path.join(tmp, "la")
    population = [{"name": "la", "env_id": "ApexCatch-v0",
                   "learner_ip": "127.0.0.1", "status_port": la_status,
                   "param_port": la_ports[1]},
                  {"name": "lb", "env_id": "ApexCatch-v0",
                   "learner_ip": "127.0.0.1", "status_port": lb_status,
                   "param_port": lb_ports[1]}]
    pop_env = {"APEX_POPULATION": json.dumps(population)}
    cfg = _service_cfg(lb_ports, status_port=lb_status)
    import dataclasses
    cfg = cfg.replace(
        replay=dataclasses.replace(cfg.replay, capacity=PBT_CAPACITY),
        actor=dataclasses.replace(cfg.actor, n_actors=1))

    def lineage_argv(lports, *extra):
        return ["--env-id", "ApexCatch-v0", "--seed", str(SEED),
                "--n-envs-per-actor", str(ENVS_PER_ACTOR),
                "--send-interval", str(SEND_INTERVAL), "--batch-port",
                str(lports[0]), "--param-port", str(lports[1]),
                "--barrier-port", str(lports[2]), "--heartbeat-interval",
                "1.0", "--barrier-timeout", "120", "--n-actors", "1",
                *extra]

    state = {"stop": False, "applied_at": None, "check": None,
             "epochs": None}
    real = (apex_module.ConcurrentTrainer.restore_weights,
            apex_module.ConcurrentTrainer._drain_stats)

    def restore(self, path):
        epoch = self.learner_epoch
        meta = real[0](self, path)
        state["restores"] = state.get("restores", 0) + 1
        if state["check"] is not None:
            return meta
        raw, _ = load_raw(path)
        ts, want = self.train_state, raw["train_state"]
        same = (all(torch.equal(t.cpu(), want["params"][k])
                    for k, t in ts.params.state_dict().items())
                and all(torch.equal(t.cpu(), want["target_params"][k])
                        for k, t in ts.target_params.state_dict().items())
                and all(torch.equal(t.cpu(), w) for t, w in zip(
                    ts.opt_state.mu + ts.opt_state.nu,
                    want["opt_state"]["mu"] + want["opt_state"]["nu"]))
                and ts.opt_state.count == want["opt_state"]["count"]
                and ts.step == want["step"])
        state["check"] = dict(path=path, bit_equal=same,
                              donor_step=int(want["step"]))
        state["epochs"] = (epoch, self.learner_epoch)
        state["applied_at"] = time.monotonic()
        state["steps_at_apply"] = self.steps
        return meta

    def drain(self, steps):
        real[1](self, steps)
        if (state["applied_at"] is not None
                and self.steps >= state["steps_at_apply"] + PBT_AFTER_STEPS
                and state.get("seen_epoch")):
            state["stop"] = True
        if state["stop"]:
            self.request_stop()

    def watch():
        """A subscriber on lb's param topic: the epoch the actors see."""
        sub = ParamSubscriber(cfg.comms, learner_ip="127.0.0.1",
                              topic=tenancy_ns.param_topic("lb"))
        try:
            deadline = time.monotonic() + PBT_SECONDS
            while time.monotonic() < deadline and not state["stop"]:
                got = sub.poll(250)
                if (got is not None and state["epochs"] is not None
                        and sub.learner_epoch >= state["epochs"][1]):
                    state["seen_epoch"] = sub.learner_epoch
        finally:
            sub.close()

    roles = RoleProcesses()
    saved = _env_set({**pop_env, "APEX_TENANT": "lb"})
    apex_module.ConcurrentTrainer.restore_weights = restore
    apex_module.ConcurrentTrainer._drain_stats = drain
    watcher = threading.Thread(target=watch, daemon=True)
    bias = {"CHAOS_SEED": str(SEED), "CHAOS_SPEC": json.dumps(
        {"tenant": "lb", "score_bias": {"evaluator": {
            "after_s": 0, "delta": SCORE_BIAS}}})}
    try:
        roles.launch("learner-la", [
            "--role", "learner", "--tenant", "la", *lineage_argv(la_ports),
            "--status-port", str(la_status), "--capacity",
            str(PBT_CAPACITY), "--warmup", str(TRAIN_WARMUP),
            "--batch-size", str(BATCH), "--checkpoint-dir", la_ckpt,
            "--save-interval", str(PBT_SAVE_EVERY), "--total-steps",
            str(10 ** 6), "--max-seconds", str(PBT_SECONDS),
            *_device_flag(dev)], pop_env)
        for name, lports, extra in (("la", la_ports, {}),
                                    ("lb", lb_ports, bias)):
            roles.launch(f"actor-{name}", ["--role", "actor", *lineage_argv(
                lports)], dict(_actor_env(0), N_ACTORS="1",
                               APEX_TENANT=name, **pop_env))
            roles.launch(f"evaluator-{name}", [
                "--role", "evaluator", "--tenant", name,
                *lineage_argv(lports), *_device_flag(dev)],
                {**pop_env, **extra})
        roles.launch("pbt-ctl", [
            "--role", "pbt-ctl", "--batch-port", str(lb_ports[0]),
            "--status-port", str(lb_status), "--pbt-decide",
            str(PBT_DECIDE), "--pbt-frac", "0.5", "--pbt-min-episodes",
            "1", "--serve-interval", str(CTL_INTERVAL), "--max-seconds",
            str(PBT_SECONDS + 60)], pop_env)
        log(f"{what}: lineages la (--role learner --tenant la, checkpoint "
            f"every {PBT_SAVE_EVERY} steps) and lb (run_learner on {dev} "
            f"under APEX_TENANT=lb), 1 actor x {ENVS_PER_ACTOR} envs and 1 "
            f"evaluator each (lb's under a score bias of {SCORE_BIAS}), "
            f"pbt-ctl (decide every {PBT_DECIDE} s, frac 0.5, 1 episode)")
        watcher.start()
        trainer, wall, launches = _learner_run(
            dev, gather, roles, what, cfg, n_peers=2, total_steps=10 ** 6)
        state["stop"] = True
        watcher.join(timeout=30)
        codes = _stop_roles(roles, what)
        final = _snapshot_line(roles, "pbt-ctl")
    finally:
        (apex_module.ConcurrentTrainer.restore_weights,
         apex_module.ConcurrentTrainer._drain_stats) = real
        _env_restore(saved)
        roles.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after the run")
    rec = trainer._population_ctl or {}
    check(state["check"] is not None and state["check"]["bit_equal"],
          f"{what}: lb's train_state after the exploit vs la's checkpoint: "
          f"{state['check']}")
    check(rec.get("exploits") == 1 == state.get("restores")
          and rec.get("errors") == 0,
          f"{what}: lb's population_ctl {rec}")
    check(state["epochs"] is not None
          and state["epochs"][1] == state["epochs"][0] + 1
          and trainer.learner_epoch == state["epochs"][1]
          and state.get("seen_epoch") == state["epochs"][1],
          f"{what}: epochs {state['epochs']}, the param channel carried "
          f"{state.get('seen_epoch')}")
    lr = (trainer.hparams_live or {}).get("lr")
    check(lr is not None and trainer.core.optimizer.lr == lr
          == trainer.cfg.learner.lr,
          f"{what}: the mutated lr {lr} is not live "
          f"({trainer.core.optimizer.lr})")
    check(final is not None and final["exploits"] >= 1
          and final["lineages"]["lb"]["parent"] == "la",
          f"{what}: pbt-ctl's snapshot {final}")
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
    check(_finite_logged(trainer) > 0, f"{what}: no learner metrics logged")
    _tree_sums(trainer, what)
    log(f"{what}: lb {trainer.steps} learner steps in {wall:.3f} s; exploit "
        f"applied from {state['check']['path']} (la's step "
        f"{state['check']['donor_step']}), train_state bit-equal to it; "
        f"epoch {state['epochs'][0]} -> {state['epochs'][1]}, carried by "
        f"lb's param channel; lr now {lr} (live in the optimizer); "
        f"population_ctl {rec}; pbt-ctl timeline "
        f"{[(e['t_s'], e['event'], e['lineage'], e['reason']) for e in final['timeline']]}")
    log(f"{what}: lb learner steps/s {trainer.steps_rate.rate:.3f}; gather "
        f"launches {launches}; role exit codes {codes}; no port bound")
    return dict(launches=launches, steps_per_s=trainer.steps_rate.rate)


def control_phase(dev, gather, msgs: list) -> dict:
    """Phase 15: 15-ref, 15a-15c.  Returns the paths' launches."""
    t = [time.perf_counter()]
    control_reference_phase(dev, gather, msgs)
    t.append(time.perf_counter())
    serve = serve_ctl_run(dev, gather)
    t.append(time.perf_counter())
    tenant = tenant_ctl_run(dev, gather)
    t.append(time.perf_counter())
    pbt = pbt_ctl_run(dev, gather)
    t.append(time.perf_counter())
    names = ("ctl_ref", "ctl_serve", "ctl_tenant", "ctl_pbt")
    log("control: phase 15 seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(names, t, t[1:])))
    return {"ctl_serve": serve["launches"],
            "ctl_tenant": tenant["launches"],
            "ctl_tenant_shards": tenant["shard_launches"],
            "ctl_pbt": pbt["launches"]}


# -- phase 16: the launcher, the soak and the lint -------------------------

LAUNCH_ACTORS = 2            # 16a/16b: actor processes (the drills' count)
LAUNCH_ENVS = 2              # 16a/16b: envs per actor
LAUNCH_STEPS = 40            # 16a: the launcher's learner step target
LAUNCH_SECONDS = 150.0       # 16a's wall-clock bound
#: 16b: the soak's wall budget (CI's drill: 210).  The run ends once
#: ``infer_rt_p99_ms`` has RESOLVED; kill to RESOLVED took 37.6-77.3 s on
#: an H100 80GB HBM3 at 700 W, the kill 10-20 s into the soak, as the
#: host allowed
SOAK_SECONDS = 180.0
SOAK_TICK = 1.0              # 16b: status sampling period, s (CI's: 2)
SOAK_BOUND = 260.0           # 16b's wall-clock bound, teardown included
#: CI's slo-smoke drill (.github/workflows/ci.yml), its resolve and ok
#: damping cut from 10 / 15 s to 5 / 5 s and its page burn from 14.4 to 5
#: (14a's), so that one outage of two health ticks pages and resolves
#: within the budget
SOAK_ENV = {"APEX_REMOTE_POLICY": "1", "APEX_SUPERVISE_INFER": "1",
            "APEX_INFER_WAIT": "0.5", "APEX_INFER_REPROBE": "2",
            "APEX_DEAD_AFTER": "8", "CHAOS_SEED": "7",
            "CHAOS_SPEC": '{"kill":{"infer-0":40}}',
            "APEX_SLO_FAST": "10,30", "APEX_SLO_SLOW": "60,180",
            "APEX_SLO_PAGE_BURN": "5", "APEX_SLO_BREACH_AFTER": "4",
            "APEX_SLO_RESOLVE_AFTER": "5", "APEX_SLO_OK_AFTER": "5"}
#: the heavy imports the stdlib lint must not make
HEAVY = ("torch", "numpy", "jax", "jaxlib", "flax", "msgpack")


def _bare_env(dev, trace_dir: str, **twins) -> dict:
    """This process's environment without the fleet's env twins, plus
    ``twins``, the device (``APEX_DEVICE``) and the trace dir."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("APEX_", "CHAOS_"))}
    env.update({k: str(v) for k, v in twins.items()})
    env["APEX_DEVICE"] = dev.type
    env["APEX_TRACE_DIR"] = trace_dir
    return env


def _fleet_pids(trace_dir: str) -> list[int]:
    """Live processes whose environment names ``trace_dir`` as their
    ``APEX_TRACE_DIR``: everything a launch started, supervisors' children
    included (Linux ``/proc``; zombies excluded)."""
    want = f"APEX_TRACE_DIR={trace_dir}".encode()
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    continue
            with open(f"/proc/{name}/environ", "rb") as f:
                if want in f.read().split(b"\0"):
                    out.append(int(name))
        except (OSError, IndexError):
            continue
    return out


def _stats_lines(text: str) -> dict:
    """``{name: stats}`` of every ``<name>: stats {...}`` record in the
    shared output of a fleet's processes, where one process's record may
    run into another's line."""
    import re

    out = {}
    dec = json.JSONDecoder()
    for m in re.finditer(r"([\w./-]+): stats \{", text):
        out[m.group(1)] = dec.raw_decode(text, m.end() - 1)[0]
    return out


def _wait_fleet_gone(trace_dir: str, what: str) -> None:
    deadline = time.monotonic() + 10.0
    while _fleet_pids(trace_dir) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _fleet_pids(trace_dir)
    check(not left, f"{what}: processes {left} outlived the run")


def launch_run(dev) -> dict:
    """16a: ``python -m apex_tpu_torch.runtime.launch ApexCatch-v0 2 40 2``
    with ``APEX_REPLAY_SHARDS=2`` on free ports: the launcher starts two
    replay shards, two actors, the evaluator and the learner, runs the
    learner to its step target, merges the trace dir and stops the rest."""
    import shutil
    import signal
    import tempfile

    from apex_tpu_torch.config import CommsConfig
    from apex_tpu_torch.fleet.registry import status_request

    what = "launch"
    ports = _free_ports(4)
    base = _port_block(2)
    tmp = tempfile.mkdtemp(prefix="apex-launch-")
    trace = os.path.join(tmp, "trace")
    env = _bare_env(dev, trace, APEX_REPLAY_SHARDS=2,
                    APEX_BATCH_PORT=ports[0], APEX_PARAM_PORT=ports[1],
                    APEX_BARRIER_PORT=ports[2], APEX_STATUS_PORT=ports[3],
                    APEX_REPLAY_PORT_BASE=base)
    comms = CommsConfig(status_port=ports[3])
    path = os.path.join(tmp, "launch.log")
    log(f"{what}: python -m apex_tpu_torch.runtime.launch ApexCatch-v0 "
        f"{LAUNCH_ACTORS} {LAUNCH_STEPS} {LAUNCH_ENVS} with "
        f"APEX_REPLAY_SHARDS=2 (shard ports {base}, {base + 1}), "
        f"APEX_DEVICE={dev.type}")
    t0 = time.perf_counter()
    barrier_s = None
    with open(path, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.runtime.launch",
             "ApexCatch-v0", str(LAUNCH_ACTORS), str(LAUNCH_STEPS),
             str(LAUNCH_ENVS)], env=env, stdout=out,
            stderr=subprocess.STDOUT, start_new_session=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            while proc.poll() is None:
                check(time.perf_counter() - t0 < LAUNCH_SECONDS,
                      f"{what}: still running after {LAUNCH_SECONDS} s")
                # the learner's status server answers once its barrier
                # released the fleet
                if barrier_s is None and status_request(
                        comms, timeout_s=0.25) is not None:
                    barrier_s = time.perf_counter() - t0
                time.sleep(0.1)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall = time.perf_counter() - t0
    with open(path, "rb") as f:
        text = f.read().decode(errors="replace")
    if proc.returncode != 0:
        log(f"{what}: launcher output:\n{text[-6000:]}")
    check(proc.returncode == 0,
          f"{what}: the launcher exited {proc.returncode}")
    _wait_fleet_gone(trace, what)
    bound = _still_bound(ports + [base, base + 1])
    check(not bound, f"{what}: ports {bound} still bound after the launch")
    stats = _stats_lines(text)
    check({"learner", "replay-0", "replay-1"} <= set(stats),
          f"{what}: stats lines from {sorted(stats)}")
    learner = stats["learner"]
    shards = [stats["replay-0"], stats["replay-1"]]
    check(learner.get("steps") == LAUNCH_STEPS,
          f"{what}: the learner's stats {learner}")
    local = learner["steps"] - learner["service_steps"]
    check(learner["service_steps"] > 0,
          f"{what}: no step trained on a shard batch")
    if dev.type == "cuda":
        check(learner["gather_launches"] == {"gather_rows": 0,
                                             "gather_stacks": local},
              f"{what}: the learner's gather launches "
              f"{learner['gather_launches']} with {local} local steps")
        for s, st in enumerate(shards):
            check(st["gather_launches"]["gather_stacks"] == st["sampled"]
                  > 0, f"{what}: shard {s} launched gather_stacks "
                  f"{st['gather_launches']} for {st['sampled']} batches")
    merged = os.path.join(trace, "merged_trace.json")
    check(os.path.exists(merged), f"{what}: no merged_trace.json")
    with open(merged) as f:
        events = json.load(f)["traceEvents"]
    check(os.path.exists(os.path.join(trace, "fleet_summary.json")),
          f"{what}: no fleet_summary.json")
    check(barrier_s is not None, f"{what}: the status port never answered")
    log(f"{what}: exit 0 in {wall:.3f} s; launch to barrier (the learner's "
        f"status server answering) {barrier_s:.3f} s; learner "
        f"{learner['steps']} steps ({learner['service_steps']} on shard "
        f"batches, {local} local), {learner['ingested']} transitions in the "
        f"learner, gather launches {learner['gather_launches']}; shards "
        + "; ".join(f"{s}: {st['chunks']} chunks, {st['sampled']} sampled, "
                    f"gather launches {st['gather_launches']['gather_stacks']}"
                    for s, st in enumerate(shards))
        + f"; merged trace {len(events)} events; no process left, no port "
        f"bound")
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches=stats_launches(learner),
                shard_launches=summed([stats_launches(st) for st in shards]),
                barrier_s=barrier_s, wall=wall)


def _slo_edges(status_port: int) -> set:
    """The ``(objective, from, to)`` edges of the learner's SLO timeline,
    from its status server (empty while nothing answers)."""
    from apex_tpu_torch.obs.soak import sample_status

    got = sample_status(status_port) or {}
    return {(e["objective"], e["from"], e["to"])
            for e in (got.get("slo") or {}).get("timeline", [])}


def _learner_under(pid: int) -> int | None:
    """The ``--role learner`` process among ``pid``'s descendants."""
    todo = _children(pid)
    while todo:
        p = todo.pop()
        try:
            with open(f"/proc/{p}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if (b"--role" in argv[:-1]
                and argv[argv.index(b"--role") + 1] == b"learner"):
            return p
        todo.extend(_children(p))
    return None


def soak_run(dev) -> dict:
    """16b: CI's ``slo-smoke`` drill on the card.  ``python -m
    apex_tpu_torch.obs.soak`` drives the launcher with a loadgen, 2
    remote-policy actors and a supervised infer server that chaos kills
    at its 40th request; a ``fleet.supervise --scale-signal slo`` probe
    watches the same learner."""
    import shutil
    import signal
    import tempfile

    what = "soak"
    ports = _free_ports(5)
    tmp = tempfile.mkdtemp(prefix="apex-soak-")
    trace = os.path.join(tmp, "trace")
    os.makedirs(trace)
    env = _bare_env(dev, trace, **SOAK_ENV, APEX_BATCH_PORT=ports[0],
                    APEX_PARAM_PORT=ports[1], APEX_BARRIER_PORT=ports[2],
                    APEX_STATUS_PORT=ports[3], APEX_INFER_PORT=ports[4])
    root = os.path.dirname(os.path.abspath(__file__))
    out_json = os.path.join(tmp, "SOAK.json")
    soak_log = os.path.join(tmp, "soak.log")
    probe_log = os.path.join(tmp, "probe.log")
    log(f"{what}: python -m apex_tpu_torch.obs.soak --seconds "
        f"{SOAK_SECONDS:g} --env-id ApexCatch-v0 --actors {LAUNCH_ACTORS} "
        f"--envs-per-actor {LAUNCH_ENVS} --loadgen 1 with "
        + " ".join(f"{k}={v}" for k, v in SOAK_ENV.items())
        + ", and a --scale-signal slo probe")
    t0 = time.perf_counter()
    kill_wall = kill_at = ended_at = None
    with open(probe_log, "wb") as pout, open(soak_log, "wb") as sout:
        probe = subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.fleet.supervise",
             "--scale-signal", "slo", "--scale-min", "1", "--scale-max",
             "3", "--scale-interval", "2", "--status-port", str(ports[3]),
             "--", "sleep", "600"], env=env, stdout=pout,
            stderr=subprocess.STDOUT, start_new_session=True, cwd=root)
        soak = subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.obs.soak", "--seconds",
             str(SOAK_SECONDS), "--env-id", "ApexCatch-v0", "--actors",
             str(LAUNCH_ACTORS), "--envs-per-actor", str(LAUNCH_ENVS),
             "--loadgen", "1", "--no-effective-cores", "--verbose",
             "--tick", str(SOAK_TICK), "--status-port", str(ports[3]),
             "--out", out_json], env=env, stdout=sout,
            stderr=subprocess.STDOUT, start_new_session=True, cwd=root)
        try:
            while soak.poll() is None:
                check(time.perf_counter() - t0 < SOAK_BOUND,
                      f"{what}: still running after {SOAK_BOUND} s")
                if kill_wall is None:
                    with open(soak_log, "rb") as f:
                        if b"chaos: killing infer-0" in f.read():
                            kill_wall = time.time()
                            kill_at = time.perf_counter() - t0
                elif ended_at is None and ("infer_rt_p99_ms", "BREACHED",
                                           "RESOLVED") in _slo_edges(
                                               ports[3]):
                    # the drill has walked: end the run as the launcher's
                    # step target would, through the learner's SIGINT (it
                    # ends after the step, dumps its summary, exits 0)
                    learner_pid = _learner_under(soak.pid)
                    if learner_pid is not None:
                        os.kill(learner_pid, signal.SIGINT)
                        ended_at = time.perf_counter() - t0
                    time.sleep(0.8)
                time.sleep(0.2)
        finally:
            for proc in (soak, probe):
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
                    try:
                        proc.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        os.killpg(proc.pid, signal.SIGKILL)
                        proc.wait()
    wall = time.perf_counter() - t0
    with open(soak_log, "rb") as f:
        text = f.read().decode(errors="replace")
    with open(probe_log, "rb") as f:
        probe_text = f.read().decode(errors="replace")
    if soak.returncode != 0:
        log(f"{what}: soak output:\n{text[-6000:]}")
    check(soak.returncode == 0, f"{what}: the soak exited {soak.returncode}")
    _wait_fleet_gone(trace, what)
    bound = _still_bound(ports)
    check(not bound, f"{what}: ports {bound} still bound after the soak")
    with open(out_json) as f:
        art = json.load(f)
    with open(os.path.join(trace, "fleet_summary.json")) as f:
        summary = json.load(f)
    timeline = summary["slo"]["timeline"]
    edges = [(e["objective"], e["from"], e["to"]) for e in timeline]
    rt = [e for e in timeline if e["objective"] == "infer_rt_p99_ms"]
    walls = {e["to"]: e["wall"] for e in reversed(rt)}   # each first edge
    thr = art.get("throughput") or {}
    comp = (art.get("slo") or {}).get("compliance", {}).get(
        "infer_rt_p99_ms")
    breaches = (art.get("slo") or {}).get("breaches", {}).get(
        "infer_rt_p99_ms")
    stats = _stats_lines(text)
    learner = stats.get("learner") or {}

    def since_kill(state: str) -> str:
        if kill_wall is None or state not in walls:
            return "n/a"
        return f"{walls[state] - kill_wall:.3f} s"

    log(f"{what}: exit {soak.returncode} in {wall:.3f} s ("
        + ("its budget ran out" if ended_at is None else
           f"the learner stopped {ended_at:.3f} s in, once RESOLVED")
        + "); "
        f"{len(art.get('samples', []))} samples; learner "
        f"{thr.get('steps_final')} steps, steps/s over the sampled span "
        f"{thr.get('steps_per_s')}; offered {thr.get('offered_frames_final')}"
        f" frames (the loadgen's, sealed on the card) vs ingested "
        f"{thr.get('ingested_final')} (the learner's, from the loadgen and "
        f"the actors; saturation {thr.get('saturation')}); infer-0 killed "
        f"{'n/a' if kill_at is None else f'{kill_at:.3f} s'} into the soak; "
        f"kill to BURNING "
        f"{since_kill('BURNING')}, to BREACHED {since_kill('BREACHED')}, to "
        f"RESOLVED {since_kill('RESOLVED')}; infer_rt_p99_ms compliance "
        f"{comp}, breaches {breaches}; timeline "
        f"{[(e['from'], e['to'], e['value']) for e in rt]}; probe: "
        f"{probe_text.count('scale up')} scale-ups; learner stats {learner}")
    if not {("infer_rt_p99_ms", a, b) for a, b in (
            ("OK", "BURNING"), ("BURNING", "BREACHED"),
            ("BREACHED", "RESOLVED"))} <= set(edges):
        log(f"{what}: soak output:\n{text[-6000:]}")
    for a, b in (("OK", "BURNING"), ("BURNING", "BREACHED"),
                 ("BREACHED", "RESOLVED")):
        check(("infer_rt_p99_ms", a, b) in edges,
              f"{what}: no infer_rt_p99_ms {a} -> {b} in {edges}")
    check(art["kind"] == "apex_soak" and art["samples"],
          f"{what}: the artifact {art.get('kind')} with "
          f"{len(art.get('samples', []))} samples")
    check(comp is not None and comp < 100.0,
          f"{what}: infer_rt_p99_ms compliance {comp}")
    check(breaches, f"{what}: no breach recorded: {art['slo']['breaches']}")
    check(thr["steps_final"] > 0, f"{what}: steps_final {thr}")
    check("scale up" in probe_text,
          f"{what}: the slo probe never scaled up:\n{probe_text[-2000:]}")
    check(kill_wall is not None, f"{what}: infer-0 was never killed")
    check(learner.get("steps") == thr["steps_final"],
          f"{what}: learner stats {learner} vs the artifact's "
          f"steps_final {thr['steps_final']}")
    if dev.type == "cuda":
        check(learner["gather_launches"] == {
            "gather_rows": 0, "gather_stacks": learner["steps"]},
            f"{what}: the learner's gather launches "
            f"{learner['gather_launches']} in {learner['steps']} steps")
    # the loadgen's lanes are the launcher's --n-envs-per-actor (2), so it
    # offers a share of what the learner ingests beside 2 x 2 host envs
    # (a saturation under 1); that it offered at all, and that its beats
    # reached the learner, is what holds
    check(thr["offered_frames_final"] > 0 and thr["saturation"],
          f"{what}: the loadgen offered {thr['offered_frames_final']} "
          f"frames, the learner ingested {thr['ingested_final']}")
    resolved = walls["RESOLVED"]
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches=stats_launches(learner), wall=wall,
                kill_to_resolved=resolved - kill_wall)


def lint_run() -> dict:
    """16c: ``python -m apex_tpu_torch.analysis --strict`` on this tree,
    under ``-X importtime``: exit 0, and none of :data:`HEAVY` imported."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "apex_tpu_torch.analysis",
         "--strict"], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    imported = {line.rsplit("|", 1)[1].strip()
                for line in done.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    heavy = sorted(m for m in imported if m.split(".")[0] in HEAVY)
    summary = done.stdout.strip().splitlines()[-1:] or [""]
    log(f"lint: python -m apex_tpu_torch.analysis --strict exit "
        f"{done.returncode} in {wall:.3f} s (-X importtime on); "
        f"{summary[0]}; {len(imported)} modules imported, heavy: {heavy}")
    check(done.returncode == 0, f"lint: exit {done.returncode}:\n"
          f"{done.stdout[-3000:]}{done.stderr[-2000:]}")
    check(not heavy, f"lint: imported {heavy}")
    return dict(wall=wall)


def tools_phase(dev) -> dict:
    """Phase 16: 16a, 16b, 16c.  Returns the paths' launches."""
    t = [time.perf_counter()]
    launch = launch_run(dev)
    t.append(time.perf_counter())
    soak = soak_run(dev)
    t.append(time.perf_counter())
    lint_run()
    t.append(time.perf_counter())
    names = ("launch", "soak", "lint")
    log("tools: phase 16 seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(names, t, t[1:]))
        + f"; in all {t[-1] - t[0]:.1f}")
    return {"launch": launch["launches"],
            "launch_shards": launch["shard_launches"],
            "soak": soak["launches"]}


# -- phase 17: the sharded learner -----------------------------------------

DP_WORLD = 2                 # ranks of phase 17 (one card: gloo)
DP_REF_STEPS = 8             # 17a's fused steps, after one ingest group
DP_ALLREDUCE_REPS = 20       # 17a's timed all-reduces of the step's bucket
DP_TRAIN_STEPS = 60          # 17b's learner steps
DP_SECONDS = 150.0           # 17b's wall-clock bound
DP_NCCL_STEPS = 4            # 17c's fused steps
DP_WEIGHT_ATOL = 1e-6        # 17a: weights against the reference, at most

_IS_SEEN: list = []          # a recording pool's IS weights, in order


def _digest(tensors) -> str:
    """sha256 of ``tensors``' bytes, in order (one device-to-host copy)."""
    import hashlib

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def _dp_learner(dev, seed: int, record: bool = False,
                with_replay: bool = True):
    """Phase 4's learner at full width on ``dev``: ``(core, train_state,
    replay_state)``, the weights drawn from ``seed``.  ``record``: the
    pool keeps each sample's IS weights in ``_IS_SEEN``;
    ``with_replay=False`` allocates no replay state (None)."""
    from apex_tpu_torch.models.dueling import DuelingDQN
    from apex_tpu_torch.ops.losses import make_optimizer
    from apex_tpu_torch.replay.frame_pool import FramePoolReplay
    from apex_tpu_torch.training.apex import dqn_env_specs
    from apex_tpu_torch.training.learner import LearnerCore
    from apex_tpu_torch.training.state import create_train_state

    class RecordingPool(FramePoolReplay):
        def sample(self, state, offsets, beta, group=None):
            out = super().sample(state, offsets, beta, group)
            _IS_SEEN.append(out[1])
            return out

    cfg = _full_width_cfg(True)
    spec = dqn_env_specs(cfg)[0]
    replay = (RecordingPool if record else FramePoolReplay)(
        capacity=CAPACITY, frame_shape=FRAME, frame_stack=STACK,
        frame_capacity=RING_ROWS)
    core = LearnerCore(replay=replay, optimizer=make_optimizer(),
                       batch_size=BATCH,
                       target_update_interval=TARGET_INTERVAL)
    model = DuelingDQN(**spec, generator=torch.Generator().manual_seed(seed))
    ts = create_train_state(model.to(dev), core.optimizer)
    return core, ts, replay.init(dev) if with_replay else None


def _dp_apply(sl, state: dict, msg: dict) -> dict | None:
    """One 17a op on this rank's ``state`` (``ts``, ``rs``): rank 0
    applies the message it sent, rank 1 the one it received.  A fused
    step returns its record: the weights' and the IS weights' digests
    and the metrics."""
    from apex_tpu_torch.runtime import wire

    op = msg["op"]
    if op == "sync":
        sl.sync_train_state_(state["ts"], msg["numbers"])
        return None
    if op == "allreduce":
        bucket = [p.detach().clone() for p in state["ts"].params.parameters()]
        sync = (torch.cuda.synchronize if sl.group.device.type == "cuda"
                else (lambda: None))
        sl.group.all_reduce_mean_(bucket)            # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(msg["reps"]):
            sl.group.all_reduce_mean_(bucket)
        sync()
        return {"ms": (time.perf_counter() - t0) * 1e3 / msg["reps"],
                "floats": sum(t.numel() for t in bucket)}
    payload, prios = wire.restricted_loads(msg["chunk"])
    if op == "ingest":
        state["rs"] = sl.make_ingest()(state["rs"], payload, prios)
        return None
    state["ts"], state["rs"], metrics = state["fused"](
        state["ts"], state["rs"], payload, prios, msg["offsets"],
        msg["beta"])
    return {"params": _digest(state["ts"].params.parameters()),
            "is": _digest([_IS_SEEN[-1]]),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _dp_ref_rank(store, rank: int, world: int, device: str,
                 geometry: dict) -> None:
    """17a's rank >= 1, a spawned process: rank 0's learner geometry
    (``geometry``: the module constants it set) on ``device`` (rank 0's
    card), weights from its own seed until rank 0's arrive, joined to the
    gloo groups, applying rank 0's ops until ``stop``; its step records
    and kernel launches go to the store."""
    from apex_tpu_torch.ops import gather
    from apex_tpu_torch.parallel.learner import ShardedLearner
    from apex_tpu_torch.parallel.mesh import init_dp

    globals().update(geometry)
    torch.backends.cudnn.deterministic = True
    dev = torch.device(device)
    core, ts, rs = _dp_learner(dev, SEED + rank, record=True)
    store.set(f"ready/{rank}", "1")
    group = init_dp(world, rank, backend="gloo", store=store, device=dev)
    sl = ShardedLearner(core, group)
    state = {"ts": ts, "rs": rs, "fused": sl.make_fused_step()}
    records = []
    zero_launches(gather)
    while True:
        msg = group.recv_op()
        if msg["op"] == "stop":
            break
        out = _dp_apply(sl, state, msg)
        if msg["op"] == "fused":
            records.append(out)
    store.set(f"stats/{rank}", json.dumps({
        "records": records, "launches": read_launches(gather),
        "peak": (torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else 0)}))
    group.close()


def _first_use_build(build_dir: str) -> dict:
    """One rank's first use of the gather kernels in a fresh process, with
    the library built into ``build_dir`` (which another rank builds into
    at the same time): whether this process ran ``nvcc``, how long the
    build took, and ``gather_rows`` on the card against its plain
    version."""
    from apex_tpu_torch.ops import gather

    gather.LIBRARY = os.path.join(build_dir, os.path.basename(gather.LIBRARY))
    compiled = not os.path.exists(gather.LIBRARY)
    t0 = time.perf_counter()
    gather.build()
    seconds = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.randint(0, 256, (4096, FRAME[0] * FRAME[1]),
                           dtype=torch.uint8, device="cuda", generator=gen)
    ids = torch.randint(0, 4096, (1024,), dtype=torch.int32, device="cuda",
                        generator=gen)
    exact = torch.equal(gather.gather_rows(frames, ids),
                        gather.gather_rows_reference(frames, ids))
    return {"compiled": compiled, "seconds": seconds, "exact": exact,
            "pid": os.getpid()}


def dp_build_check() -> dict:
    """17a's first step: two rank processes use the gather kernels for the
    first time at once, both building one fresh library directory (the
    one-card gloo plan's race): each must load a whole library and gather
    exactly.  ``ops/gather.py:build`` compiles into a temp file and
    renames it into place with ``os.replace``, so at worst each rank
    compiles once."""
    import multiprocessing as mp
    import shutil
    import tempfile

    build_dir = tempfile.mkdtemp(prefix="apex-dp-build-")
    try:
        with mp.get_context("spawn").Pool(DP_WORLD) as pool:
            out = pool.map(_first_use_build, [build_dir] * DP_WORLD)
        left = sorted(os.listdir(build_dir))
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    check(all(o["exact"] for o in out),
          f"dp_build: a rank's first-use gather was not exact: {out}")
    check(left == ["libapex_gather.so"],
          f"dp_build: the build directory holds {left}")
    compiles = sum(o["compiled"] for o in out)
    log(f"dp_build: {DP_WORLD} rank processes' first use at once into one "
        f"fresh build directory: {compiles} nvcc compile(s) (at most one "
        f"per rank), build seconds "
        f"{[round(o['seconds'], 3) for o in out]}, each gather_rows exact, "
        f"one whole library left")
    return {"compiles": compiles}


def _dp_reference(dev, params0: dict, groups: list, offsets: list,
                  beta: float) -> list[dict]:
    """17a's in-process reference: two plain replay shards and one
    learner; each step ingests each shard's chunk, samples each shard
    with its uniforms, weighs each sample with the IS normalizer taken
    over both shards, computes each shard's loss and grads on its own and
    steps once on their mean, then writes each shard's priorities back.
    Returns one record per step (digests of the weights and of each
    shard's IS weights, the metrics, each shard's normalizer)."""
    from apex_tpu_torch.ops import tree as tree_ops
    from apex_tpu_torch.ops.losses import double_dqn_loss

    core, ts, _ = _dp_learner(dev, SEED, with_replay=False)
    ts.params.load_state_dict(params0)
    ts.target_params.load_state_dict(params0)
    replay = core.replay
    shards = [replay.init(dev) for _ in range(DP_WORLD)]
    params = list(ts.params.parameters())
    records = []
    for parts, step_offsets in zip(groups, [None] + offsets):
        for r in range(DP_WORLD):
            replay.add(shards[r], *parts[r])
        if step_offsets is None:
            continue
        samples, norms = [], []
        for r, rs in enumerate(shards):
            batch, _, idx = replay.sample(
                rs, torch.as_tensor(step_offsets[r]).to(dev), beta)
            total = tree_ops.tree_total(rs.sum_tree)
            p_min = tree_ops.tree_min(rs.min_tree) / total
            norms.append((p_min * float(rs.size)) ** (-beta))
            samples.append((batch, idx, total, float(rs.size)))
        norm = torch.maximum(norms[0], norms[1])
        grads, auxes, is_digests = [], [], []
        for r, (batch, idx, total, size) in enumerate(samples):
            p = tree_ops.get_leaves(shards[r].sum_tree, idx) / total
            w = ((p * size) ** (-beta) / norm).float()
            is_digests.append(_digest([w]))
            loss, aux = double_dqn_loss(ts.params, ts.target_params, batch, w)
            grads.append(torch.autograd.grad(loss, params))
            auxes.append(aux)
        mean = [(a + b) / DP_WORLD for a, b in zip(*grads)]
        grad_norm = core.optimizer.step(params, mean, ts.opt_state)
        ts.step += 1
        if ts.step % TARGET_INTERVAL == 0:
            with torch.no_grad():
                for tgt, src in zip(ts.target_params.parameters(), params):
                    tgt.copy_(src)
        for r, aux in enumerate(auxes):
            replay.update_priorities(shards[r], samples[r][1],
                                     aux.priorities)
        pair = [torch.stack([a.loss, a.q_taken.detach().mean(),
                             a.td_abs.mean()]) for a in auxes]
        means = ((pair[0] + pair[1]) / DP_WORLD).tolist()  # apexlint: disable=T006 -- one record per reference step
        records.append({
            "params": _digest(params), "is": is_digests,
            "metrics": {"loss": means[0], "grad_norm": float(grad_norm),
                        "q_mean": means[1], "td_mean": means[2]},
            "norms": [float(n) for n in norms],
            "weights": [p.detach().clone() for p in params]})
    return records


def dp_reference_run(dev, gather, msgs: list) -> dict:
    """17a (``dp_reference``): a 2-rank ``ShardedLearner`` over gloo on
    ``cuda:0``, this process and one spawned rank, for ``DP_REF_STEPS``
    fused steps of phase 4's chunks (round-robin groups, one ingest group
    first), against :func:`_dp_reference` on the same weights, chunks and
    per-rank uniforms; then the step's all-reduce timed alone."""
    from apex_tpu_torch.parallel.learner import ShardedLearner
    from apex_tpu_torch.parallel.mesh import RankProcesses, init_dp
    from apex_tpu_torch.runtime import wire

    n_groups = 1 + DP_REF_STEPS
    check(len(msgs) >= DP_WORLD * n_groups,
          f"dp_reference: {len(msgs)} chunks for {n_groups} groups")
    groups = []
    for i in range(n_groups):
        parts = [(m["payload"], np.asarray(m["priorities"], np.float32))
                 for m in msgs[i * DP_WORLD:(i + 1) * DP_WORLD]]
        groups.append((parts, [wire.dumps(p) for p in parts]))
    gens = [torch.Generator().manual_seed(SEED + 17 + r)
            for r in range(DP_WORLD)]
    offsets = [[torch.rand(BATCH // DP_WORLD, generator=g).numpy()
                for g in gens] for _ in range(DP_REF_STEPS)]
    beta = 0.4
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ranks = None
    t0 = time.perf_counter()
    try:
        ranks = RankProcesses(DP_WORLD, _dp_ref_rank, (str(dev), {
            "CAPACITY": CAPACITY, "RING_ROWS": RING_ROWS, "BATCH": BATCH}))
        _IS_SEEN.clear()
        core, ts, rs = _dp_learner(dev, SEED, record=True)
        params0 = {k: v.detach().clone()
                   for k, v in ts.params.state_dict().items()}
        ranks.wait_ready(300.0)
        group = init_dp(DP_WORLD, 0, backend="gloo", store=ranks.store,
                        device=dev)
        t_ready = time.perf_counter() - t0
        sl = ShardedLearner(core, group)
        state = {"ts": ts, "rs": rs, "fused": sl.make_fused_step()}

        def send(msg_of):
            msgs_out = [None] + [msg_of(r) for r in range(1, DP_WORLD)]
            group.send_ops(msgs_out)
            return _dp_apply(sl, state, msg_of(0))

        numbers = sl.train_state_numbers(ts)
        send(lambda r: {"op": "sync", "numbers": numbers})
        zero_launches(gather)                         # main path starts
        records = []
        t1 = time.perf_counter()
        for i, (_, blobs) in enumerate(groups):
            if i == 0:
                send(lambda r: {"op": "ingest", "chunk": blobs[r]})
                continue
            records.append(send(lambda r: {
                "op": "fused", "chunk": blobs[r], "offsets": offsets[i - 1][r],
                "beta": beta}))
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t1
        launches0 = read_launches(gather)             # main path ends
        timed = send(lambda r: {"op": "allreduce",
                                "reps": DP_ALLREDUCE_REPS})
        group.send_ops([None] + [{"op": "stop"}] * (DP_WORLD - 1))
        ranks.stop(60.0)
        group.close()
        peer = ranks.rank_stats()
        check(sorted(peer) == [1], f"dp_reference: rank records {peer}")
        peer = peer[1]
        del group, sl
        ref = _dp_reference(dev, params0, [g[0] for g in groups], offsets,
                            beta)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if ranks is not None:
            ranks.stop(5.0)
    check(not ranks.alive(), "dp_reference: a rank process outlived 17a")
    launches1 = peer["launches"]
    for r, got in enumerate((launches0, launches1)):
        check(gather_part(got) == {"gather_rows": 0,
                                   "gather_stacks": DP_REF_STEPS},
              f"dp_reference: rank {r} gather launches {got} in "
              f"{DP_REF_STEPS} steps")
    recs1 = peer["records"]
    check(len(records) == len(recs1) == len(ref) == DP_REF_STEPS,
          f"dp_reference: {len(records)}/{len(recs1)}/{len(ref)} records")
    bit_equal, skewed = True, 0
    for i, (a, b, want) in enumerate(zip(records, recs1, ref)):
        check(a["params"] == b["params"],
              f"dp_reference: ranks' weights differ after step {i + 1}")
        check(a["metrics"] == b["metrics"],
              f"dp_reference: ranks' metrics differ at step {i + 1}")
        for r, got in enumerate((a["is"], b["is"])):
            check(got == want["is"][r],
                  f"dp_reference: rank {r}'s IS weights at step {i + 1} are "
                  f"not those of the normalizer over both shards")
        skewed += want["norms"][0] != want["norms"][1]
        for name, v in a["metrics"].items():
            check(math.isfinite(v) and abs(v - want["metrics"][name])
                  <= 1e-5 * max(1.0, abs(want["metrics"][name])),
                  f"dp_reference: {name} {v} vs reference "
                  f"{want['metrics'][name]} at step {i + 1}")
        bit_equal &= a["params"] == want["params"]
    check(skewed > 0, "dp_reference: the shards' IS normalizers never "
                      "differed, so the global max went untested")
    gap = max(float((p.detach() - w).abs().max())
              for p, w in zip(state["ts"].params.parameters(),
                              ref[-1]["weights"]))
    check(gap <= DP_WEIGHT_ATOL,
          f"dp_reference: weights {gap} from the reference after "
          f"{DP_REF_STEPS} steps (at most {DP_WEIGHT_ATOL})")
    log(f"dp_reference: {DP_WORLD} ranks (gloo, cuda:0, this process and "
        f"one spawned) ready in {t_ready:.3f} s; {DP_REF_STEPS} fused "
        f"steps at batch {BATCH} ({BATCH // DP_WORLD} per rank), capacity "
        f"{CAPACITY} and ring {RING_ROWS} per rank in {steps_s:.3f} s "
        f"({steps_s * 1e3 / DP_REF_STEPS:.3f} ms/step with the op "
        f"scatter and the chunks' host-to-device copies); ranks' weights "
        f"and metrics bit-identical after every step; IS weights those of "
        f"the normalizer over both shards on every rank and step (the "
        f"shards' normalizers differed on {skewed} of {DP_REF_STEPS} "
        f"steps); weights against the reference: max |diff| {gap:.3e}, "
        f"bit-equal {bit_equal}; gather launches rank 0 {launches0}, rank "
        f"1 {launches1}")
    log(f"dp_reference: the step's all-reduce alone ({timed['floats']} "
        f"f32, gloo through host memory, synchronised): "
        f"{timed['ms']:.3f} ms (mean of {DP_ALLREDUCE_REPS}); rank 1 peak "
        f"memory {peer['peak'] / 2**30:.3f} GiB")
    total = {k: launches0[k] + launches1[k] for k in launches0}
    return {"launches": total, "rank_launches": [launches0, launches1],
            "allreduce_ms": timed["ms"], "bit_equal": bit_equal,
            "max_gap": gap}


def dp_train_run(dev, gather, p5: dict, p17a: dict) -> dict:
    """17b (``dp_train``): ``ApexTrainer.train`` with ``mesh_shape=(2,)``
    and ``dp_backend="gloo"`` on the default ``"cuda"``: phase 5's actors
    and chunking on rank 0's pool, its warm-up, ``DP_TRAIN_STEPS`` learner
    steps."""
    import dataclasses
    import multiprocessing as mp

    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, ReplayConfig)
    from apex_tpu_torch.native.ring import SEGMENT_PREFIX
    from apex_tpu_torch.training.apex import ApexTrainer

    cfg = ApexConfig(
        env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
        replay=ReplayConfig(capacity=CAPACITY, warmup=TRAIN_WARMUP),
        learner=LearnerConfig(batch_size=BATCH, target_update_interval=500,
                              mesh_shape=(DP_WORLD,)),
        actor=ActorConfig(n_actors=N_ACTORS, n_envs_per_actor=ENVS_PER_ACTOR,
                          send_interval=SEND_INTERVAL, timing_interval=32))
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = ApexTrainer(cfg, publish_min_seconds=0.5, dp_backend="gloo")
    check(trainer.n_dp == DP_WORLD and trainer.dp_backend == "gloo",
          f"dp_train: n_dp {trainer.n_dp}, backend {trainer.dp_backend}")
    zero_launches(gather)                             # main path starts
    t0 = time.perf_counter()
    trainer.train(total_steps=DP_TRAIN_STEPS, max_seconds=DP_SECONDS,
                  log_every=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches0 = read_launches(gather)                 # main path ends
    ranks = trainer.dp_rank_stats
    check(trainer.steps == DP_TRAIN_STEPS,
          f"dp_train: {trainer.steps} learner steps in {wall:.1f} s, want "
          f"{DP_TRAIN_STEPS} within {DP_SECONDS} s")
    check(sorted(ranks) == list(range(DP_WORLD)),
          f"dp_train: rank records {sorted(ranks)}")
    launches1 = stats_launches(ranks[1])
    for r, got in enumerate((launches0, launches1)):
        check(gather_part(got) == {"gather_rows": 0,
                                   "gather_stacks": trainer.steps},
              f"dp_train: rank {r} gather launches {got} in "
              f"{trainer.steps} steps")
        check(ranks[r]["steps"] == trainer.steps,
              f"dp_train: rank {r} took {ranks[r]['steps']} steps")
    check(ranks[0]["replay_size"] + ranks[1]["replay_size"]
          == trainer.ingested,
          f"dp_train: shard sizes {ranks[0]['replay_size']} + "
          f"{ranks[1]['replay_size']} != {trainer.ingested} ingested")
    check(trainer.param_version >= 2,
          f"dp_train: {trainer.param_version} param publishes")
    versions = [v for _, v in
                trainer.log.history.get("learner/episode_param_version", [])]
    check(bool(versions) and min(versions) > 0,
          f"dp_train: episode stats' param versions {versions[:8]}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, "dp_train: no learner metrics logged")
    alive = [p.pid for p in trainer.pool.procs if p.is_alive()]
    check(not alive, f"dp_train: actor processes {alive} outlived train()")
    check([p.name for p in mp.active_children()] == ["apex-dp-rank1"],
          f"dp_train: after train(), processes {mp.active_children()} "
          f"(rank 1 parked, no actor)")
    trainer.close()
    check(trainer._ranks is None and not mp.active_children(),
          f"dp_train: processes outlived close(): {mp.active_children()}")
    left = [f for f in os.listdir("/dev/shm")
            if f.startswith(f"{SEGMENT_PREFIX}-{os.getpid()}-")]
    check(not left, f"dp_train: segments left in /dev/shm: {left}")
    coll = ranks[0]["collectives"]
    ar_ms = coll["allreduce_s"] * 1e3 / max(1, coll["allreduce_calls"])
    log(f"dp_train: {DP_WORLD} ranks (gloo on one card), {N_ACTORS} actor "
        f"processes x {ENVS_PER_ACTOR} envs on rank 0's pool, chunks of "
        f"{SEND_INTERVAL}, warm-up {TRAIN_WARMUP}; {trainer.steps} learner "
        f"steps in {wall:.3f} s of train(); dispatches "
        f"{trainer.dispatches}; {trainer.ingested} transitions ingested "
        f"(shards {ranks[0]['replay_size']} + {ranks[1]['replay_size']}); "
        f"param_version {trainer.param_version}; pipeline stats "
        f"{trainer._pipeline_last_stats}")
    log(f"dp_train: learner steps/s {trainer.steps_rate.rate:.3f} (phase 5, "
        f"one rank: {p5['steps_per_s']:.3f}); env frames/s over train() "
        f"{trainer.ingested / wall:.1f}; the update all-reduce's host ms "
        f"per step {ar_ms:.3f} (wait included; alone, synchronised, "
        f"{p17a['allreduce_ms']:.3f}); ops sent {coll['ops_sent']} "
        f"({coll['op_bytes'] / 2**20:.1f} MiB); peak memory rank 0 "
        f"{ranks[0]['peak_bytes'] / 2**30:.3f} GiB, rank 1 "
        f"{ranks[1]['peak_bytes'] / 2**30:.3f} GiB; {n_logged} logged "
        f"metrics finite; no rank, actor or segment left")
    return {"launches": {k: launches0[k] + launches1[k] for k in launches0},
            "rank_launches": [launches0, launches1],
            "steps_per_s": trainer.steps_rate.rate, "allreduce_ms": ar_ms}


def dp_nccl1_run(dev, gather, msgs: list) -> dict:
    """17c (``dp_nccl1``): ``ShardedLearner`` at world size 1 over NCCL on
    ``cuda:0`` for ``DP_NCCL_STEPS`` fused steps, against the unsharded
    ``LearnerCore`` fused step on the same weights, chunks and uniforms:
    bit-equal under deterministic cuDNN."""
    from apex_tpu_torch.parallel.learner import ShardedLearner
    from apex_tpu_torch.parallel.mesh import init_dp

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        group = init_dp(1, 0, backend="nccl", device=dev)
        core, ts, rs = _dp_learner(dev, SEED)
        sl = ShardedLearner(core, group)
        fused = sl.make_fused_step()
        gen = torch.Generator().manual_seed(SEED + 170)
        offsets = [torch.rand(BATCH, generator=gen)
                   for _ in range(DP_NCCL_STEPS)]
        chunks = [(m["payload"], m["priorities"])
                  for m in msgs[:1 + DP_NCCL_STEPS]]
        zero_launches(gather)                         # main path starts
        rs = sl.make_ingest()(rs, *chunks[0])
        got = []
        for (payload, prios), off in zip(chunks[1:], offsets):
            ts, rs, m = fused(ts, rs, payload, prios, off, 0.4)
            got.append({k: v.detach().clone() for k, v in m.items()})
        torch.cuda.synchronize()
        launches = read_launches(gather)              # main path ends
        wall = time.perf_counter() - t0
        group.close()
        ref_core, ref_ts, ref_rs = _dp_learner(dev, SEED)
        ref_rs = ref_core.ingest(ref_rs, *chunks[0])
        want = []
        for (payload, prios), off in zip(chunks[1:], offsets):
            ref_ts, ref_rs, m = ref_core.fused_step(
                ref_ts, ref_rs, payload, prios, off.to(dev), 0.4)
            want.append(m)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(gather_part(launches) == {"gather_rows": 0,
                                    "gather_stacks": DP_NCCL_STEPS},
          f"dp_nccl1: gather launches {launches} in {DP_NCCL_STEPS} steps")
    for i, (a, b) in enumerate(zip(got, want)):
        for name in a:
            check(torch.equal(a[name], b[name]),
                  f"dp_nccl1: {name} differs at step {i + 1}")
    _learners_equal(_Bundle(ts, rs), _Bundle(ref_ts, ref_rs), "dp_nccl1")
    log(f"dp_nccl1: ShardedLearner at world 1 over NCCL on {dev}: "
        f"{DP_NCCL_STEPS} fused steps (group, learner and steps in "
        f"{wall:.3f} s) bit-equal to the unsharded fused step (metrics, "
        f"weights, optimizer, replay); gather launches {launches}")
    return {"launches": launches}


class _Bundle:
    """What :func:`_learners_equal` reads of a trainer."""

    def __init__(self, ts, rs):
        self.train_state, self.replay_state = ts, rs
        self.generator = torch.Generator()


DP_FUSED_T = 16              # 17d: rollout_len (phase 10's 64 cut) and chunk
DP_FUSED_WARMUP = 1024       # 17d: warm-up (phase 10's 4096 cut)
DP_FUSED_STEPS = 6           # 17d: learner steps of train(), one a dispatch
DP_SHARD_CAPACITY = 2 ** 16  # 17d, 17g: phase 7's capacity per rank
DP_ANAKIN_STEPS = 40         # 17e: learner steps of train()
DP_SERVICE_STEPS = 20        # 17f: learner steps of run_learner
DP_CKPT_STEPS = 4            # 17g: learner steps of each train()


def _shard_digest(state=None, stacked=None, rank: int = 0) -> str:
    """sha256 of one replay shard's tensors and host numbers, in field
    order: a live state's (copied to the host tensor by tensor), or row
    ``rank`` of a stacked bundle's ``replay_state``."""
    import hashlib

    from apex_tpu_torch.parallel.learner import state_leaves

    def at(path):
        node = stacked
        for part in path.split("/"):
            node = node[part]
        return node[rank]

    h = hashlib.sha256()
    tensors, numbers = state_leaves(state)
    for path, t in tensors:
        row = t if stacked is None else at(path)
        h.update(row.detach().cpu().contiguous().numpy().tobytes())  # apexlint: disable=T006 -- a digest reads each field once
    for path, v in numbers:
        h.update(np.int64(v if stacked is None else int(at(path))).tobytes())
    return h.hexdigest()


def _dp_fused_cfg(mesh: bool):
    """17d's configuration: phase 10's 32-lane ladder on ``ApexCatch-v0``
    at batch 512, with ``DP_FUSED_T``-transition chunks, capacity 2^16 per
    rank and warm-up 1024; ``mesh``: dp 2 (rank 0's), else dp 1 (the
    other rank's trainer)."""
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, ReplayConfig)
    return ApexConfig(
        env=EnvConfig(env_id="ApexCatch-v0", seed=SEED),
        replay=ReplayConfig(capacity=DP_SHARD_CAPACITY,
                            warmup=DP_FUSED_WARMUP),
        learner=LearnerConfig(batch_size=BATCH, target_update_interval=500,
                              mesh_shape=(DP_WORLD,) if mesh else (1,)),
        actor=ActorConfig(n_actors=N_ACTORS, n_envs_per_actor=ENVS_PER_ACTOR,
                          send_interval=DP_FUSED_T))


def _fused_ranks_reference(dev, dispatches: int) -> list[dict]:
    """17d's in-process reference: the two ranks' ``FusedApexTrainer`` in
    threads of this process, joined to gloo groups over one ``HashStore``
    on ``dev``, ``dispatches`` lockstep dispatches each.  Returns each
    rank's weights digest, shard digest and step count."""
    import threading

    import torch.distributed as dist

    from apex_tpu_torch.ondevice.fused import FusedApexTrainer
    from apex_tpu_torch.parallel.mesh import init_dp

    store = dist.HashStore()
    out, errors = [None] * DP_WORLD, []

    def run(rank):
        try:
            kw = dict(device=dev, rollout_len=DP_FUSED_T,
                      steps_per_dispatch=1, respawn_workers=False)
            t = (FusedApexTrainer(_dp_fused_cfg(True), dp_backend="gloo",
                                  **kw) if rank == 0 else
                 FusedApexTrainer(_dp_fused_cfg(False),
                                  lanes=(rank, DP_WORLD), **kw))
            group = init_dp(DP_WORLD, rank, backend="gloo", store=store,
                            device=dev)
            t._join_dp(group)
            for _ in range(dispatches):
                t._fused_dispatch()
            torch.cuda.synchronize()
            out[rank] = {"params": _digest(t.train_state.params.parameters()),
                         "replay": _shard_digest(t.replay_state),
                         "step": t.train_state.step}
            group.close()
        except BaseException as exc:       # raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(DP_WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    if errors:
        raise errors[0]
    check(not any(t.is_alive() for t in threads),
          "dp_fused: a reference rank hung")
    return out


def dp_fused_run(dev, gather, p10: dict) -> dict:
    """17d (``dp_fused``): ``FusedApexTrainer.train`` at dp 2 over gloo on
    ``"cuda"`` (module docstring), against :func:`_fused_ranks_reference`
    on the same number of dispatches."""
    import multiprocessing as mp

    from apex_tpu_torch.ondevice.fused import FusedApexTrainer

    what = "dp_fused"
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        trainer = FusedApexTrainer(_dp_fused_cfg(True), rollout_len=DP_FUSED_T,
                                   steps_per_dispatch=1, dp_backend="gloo",
                                   publish_min_seconds=0.5)  # on "cuda"
        fused = trainer.fused
        zero_launches(gather)                         # main path starts
        t0 = time.perf_counter()
        trainer.train(total_steps=DP_FUSED_STEPS, max_seconds=DP_SECONDS,
                      log_every=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches0 = read_launches(gather)             # main path ends
        ranks = trainer.dp_rank_stats
        steps, dispatches = trainer.steps, fused.dispatches
        counters = fused.counters()
        sizes = list(fused.shard_sizes)
        t1 = time.perf_counter()
        bundle = trainer._sharded_bundle()            # the shards, gathered
        gather_s = time.perf_counter() - t1
        got = {"params": _digest(trainer.train_state.params.parameters()),
               "replay": [_shard_digest(trainer.replay_state,
                                        bundle["replay_state"], r)
                          for r in range(DP_WORLD)]}
        moved = trainer._dp.stats["transfer_bytes"]
        del bundle
        trainer.close()
        check(not mp.active_children(),
              f"{what}: processes outlived close(): {mp.active_children()}")
        del trainer, fused
        torch.cuda.empty_cache()
        ref = _fused_ranks_reference(dev, dispatches)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    torch.cuda.empty_cache()
    launches1 = stats_launches(ranks[1])
    check(DP_FUSED_STEPS <= steps and counters["dp"] == DP_WORLD,
          f"{what}: {steps} learner steps in {dispatches} dispatches, "
          f"counters {counters}")
    for r, counts in enumerate((launches0, launches1)):
        check(gather_part(counts) == {"gather_rows": 0,
                                      "gather_stacks": steps},
              f"{what}: rank {r} gather launches {counts} in {steps} steps")
    check(ranks[1]["steps"] == steps,
          f"{what}: rank 1 took {ranks[1]['steps']} steps")
    check(min(sizes) > 0 and sum(sizes) == counters["transitions"],
          f"{what}: shard sizes {sizes}, {counters['transitions']} "
          f"transitions")
    check(ref[0]["step"] == ref[1]["step"] == steps,
          f"{what}: reference steps {[r['step'] for r in ref]}")
    check(got["params"] == ref[0]["params"] == ref[1]["params"],
          f"{what}: weights differ from the in-process reference")
    for r in range(DP_WORLD):
        check(got["replay"][r] == ref[r]["replay"],
              f"{what}: rank {r}'s shard differs from the reference")
    log(f"{what}: FusedApexTrainer.train at dp {DP_WORLD} (gloo, one card, "
        f"{ENVS_PER_ACTOR * N_ACTORS // DP_WORLD} lanes per rank, T "
        f"{DP_FUSED_T}, batch {BATCH} = {BATCH // DP_WORLD} per rank, "
        f"capacity {DP_SHARD_CAPACITY} per rank): {steps} learner steps in "
        f"{dispatches} dispatches, {wall:.3f} s of train(); shards {sizes} "
        f"({counters['chunks']} chunks, {counters['transitions']} "
        f"transitions); both shards ({moved / 2**20:.1f} MiB from rank 1 in "
        f"{gather_s:.3f} s) and the weights bit-equal to the in-process "
        f"reference; gather launches rank 0 {launches0}, rank 1 "
        f"{launches1}")
    log(f"{what}: learner steps/s {steps / wall:.3f}, env frames/s "
        f"{counters['frames'] / wall:.1f} over train(), against phase 10's "
        f"fused {p10['steps_per_s']:.3f} steps/s and "
        f"{p10['frames_per_s']:.1f} frames/s (one rank, 32 lanes, T 64, 4 "
        f"macro steps a dispatch)")
    return {"launches": {k: launches0[k] + launches1[k] for k in launches0},
            "rank_launches": [launches0, launches1]}


def dp_anakin_run(dev, gather) -> dict:
    """17e (``dp_anakin``): ``ApexTrainer.train`` at dp 2 over gloo with
    an ``AnakinPool`` (phase 10's engine on rank 0's card, acting with
    rank 0's published weights), ``DP_ANAKIN_STEPS`` learner steps."""
    import dataclasses
    import multiprocessing as mp

    from apex_tpu_torch.training.anakin import AnakinPool, make_anakin_engine
    from apex_tpu_torch.training.apex import ApexTrainer

    what = "dp_anakin"
    cfg = _ondevice_cfg("ApexCatch-v0")
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  mesh_shape=(DP_WORLD,)))
    pool = AnakinPool(cfg, make_anakin_engine(cfg, rollout_len=ONDEVICE_T))
    trainer = ApexTrainer(cfg, pool=pool, publish_min_seconds=0.5,
                          dp_backend="gloo")                # on "cuda"
    zero_launches(gather)                             # main path starts
    t0 = time.perf_counter()
    trainer.train(total_steps=DP_ANAKIN_STEPS, max_seconds=DP_SECONDS,
                  log_every=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches0 = read_launches(gather)                 # main path ends
    ranks = trainer.dp_rank_stats
    trainer.close()
    check(not mp.active_children(),
          f"{what}: processes outlived close(): {mp.active_children()}")
    launches1 = stats_launches(ranks[1])
    steps = trainer.steps
    check(steps == DP_ANAKIN_STEPS,
          f"{what}: {steps} learner steps in {wall:.1f} s")
    for r, counts in enumerate((launches0, launches1)):
        check(gather_part(counts) == {"gather_rows": 0,
                                      "gather_stacks": steps},
              f"{what}: rank {r} gather launches {counts} in {steps} steps")
        check(ranks[r]["steps"] == steps,
              f"{what}: rank {r} took {ranks[r]['steps']} steps")
    sizes = [ranks[r]["replay_size"] for r in range(DP_WORLD)]
    check(min(sizes) > 0 and sum(sizes) == trainer.ingested,
          f"{what}: shard sizes {sizes}, {trainer.ingested} ingested")
    counters = pool.ondevice_counters()
    check(counters["dispatches"] > 0 and pool._acting_version >= 1,
          f"{what}: engine {counters}, acted on version "
          f"{pool._acting_version}")
    n_logged = _finite_logged(trainer)
    check(n_logged > 0, f"{what}: no learner metrics logged")
    log(f"{what}: ApexTrainer.train at dp {DP_WORLD} over AnakinPool "
        f"({ONDEVICE_LANES} lanes x T {ONDEVICE_T} on rank 0, chunks of "
        f"{SEND_INTERVAL} one per rank per group): {steps} learner steps "
        f"in {wall:.3f} s, {steps / wall:.3f} steps/s; {trainer.ingested} "
        f"transitions ({trainer.ingested / wall:.1f} env frames/s over "
        f"train()), shards {sizes}; engine {counters}, acting on up to "
        f"version {pool._acting_version} of {trainer.param_version}; "
        f"gather launches rank 0 {launches0}, rank 1 {launches1}")
    del trainer, pool
    torch.cuda.empty_cache()
    return {"launches": {k: launches0[k] + launches1[k] for k in launches0},
            "rank_launches": [launches0, launches1]}


def dp_service_run(dev, gather) -> dict:
    """17f (``dp_service``): 13a's topology (two ``--role replay`` shards
    on the card, 4 actors x 8 envs through the CLI) with ``run_learner``
    at dp 2 over gloo, ``DP_SERVICE_STEPS`` learner steps."""
    import dataclasses
    import multiprocessing as mp

    what = "dp_service"
    ports = _free_ports(3)
    base = _port_block(2)
    cfg = _service_cfg(ports, replay_shards=2, replay_port_base=base)
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  mesh_shape=(DP_WORLD,)))
    shared = _role_argv(ports, "--replay-shards", "2",
                        "--replay-port-base", str(base))
    roles = RoleProcesses()
    try:
        for s in range(2):
            roles.launch(f"replay-{s}", ["--role", "replay", "--shard-id",
                                         str(s), *shared, *_device_flag(dev)],
                         {})
        for i in range(N_ACTORS):
            roles.launch(f"actor-{i}", ["--role", "actor", *shared],
                         _actor_env(i))
        trainer, wall, launches0 = _learner_run(
            dev, gather, roles, what, cfg, n_peers=N_ACTORS,
            total_steps=DP_SERVICE_STEPS, dp_backend="gloo")
        _stop_roles(roles, what)
        shards = [roles.stats(f"replay-{s}") for s in range(2)]
    finally:
        roles.close()
    check(not mp.active_children(),
          f"{what}: processes outlived the run: {mp.active_children()}")
    check(all(st is not None for st in shards),
          f"{what}: a shard printed no stats")
    client = trainer.replay_client
    ranks = trainer.dp_rank_stats
    launches1 = stats_launches(ranks[1])
    local = trainer.steps - trainer.service_steps
    check(trainer.steps == DP_SERVICE_STEPS and trainer.service_steps > 0,
          f"{what}: {trainer.steps} learner steps ({trainer.service_steps} "
          f"on service batches) in {wall:.1f} s")
    check(ranks[1]["steps"] == trainer.steps
          and ranks[1]["service_steps"] == trainer.service_steps,
          f"{what}: rank 1 took {ranks[1]['steps']} steps, "
          f"{ranks[1]['service_steps']} on service batches")
    for r, counts in enumerate((launches0, launches1)):
        check(gather_part(counts) == {"gather_rows": 0,
                                      "gather_stacks": local},
              f"{what}: rank {r} gather launches {counts} with {local} "
              f"local fallback steps")
    check(client.prio_sent == trainer.service_steps
          and client.prio_dropped == 0,
          f"{what}: {client.prio_sent} write-backs sent, "
          f"{client.prio_dropped} dropped, for {trainer.service_steps} "
          f"batches")
    applied = sum(st["wb_applied"] for st in shards)
    check(0 < applied <= client.prio_sent,
          f"{what}: the shards applied {applied} write-backs of "
          f"{client.prio_sent}")
    if dev.type == "cuda":
        for s, st in enumerate(shards):
            check(st["gather_launches"]["gather_stacks"] == st["sampled"],
                  f"{what}: shard {s} launched {st['gather_launches']} for "
                  f"{st['sampled']} batches")
    log(f"{what}: run_learner at dp {DP_WORLD} (gloo, one card) with 2 "
        f"replay shards and {N_ACTORS} x {ENVS_PER_ACTOR} actors: "
        f"{trainer.steps} learner steps in {wall:.3f} s (barrier "
        f"included), {trainer.service_steps} on service batches of "
        f"{BATCH} ({BATCH // DP_WORLD} rows per rank), {local} local; "
        f"{client.batches} pulled, {client.prio_sent} write-backs sent, "
        f"{applied} applied by the shards ("
        + ", ".join(f"shard {s}: {st['wb_applied']}"
                    for s, st in enumerate(shards))
        + f"); learner steps/s {trainer.steps_rate.rate:.3f}; gather "
        f"launches rank 0 {launches0}, rank 1 {launches1}, shards "
        f"{[st['gather_launches']['gather_stacks'] for st in shards]}")
    shard_launches = summed([stats_launches(st) for st in shards])
    del trainer
    torch.cuda.empty_cache()
    return {"launches": {k: launches0[k] + launches1[k] for k in launches0},
            "rank_launches": [launches0, launches1],
            "shard_launches": shard_launches}


def dp_checkpoint_run(dev, gather, msgs: list) -> dict:
    """17g (``dp_checkpoint``): a dp 2 ``ApexTrainer`` at capacity 2^16 per
    rank on phase 4's chunks (serial drain, deterministic cuDNN): A trains
    ``DP_CKPT_STEPS``, saves, and trains as many more on the same ranks;
    B, fresh, restores A's file and trains ``DP_CKPT_STEPS`` on the chunks
    A took after its save.  A's and B's final bundles bit-equal."""
    import dataclasses
    import multiprocessing as mp
    import tempfile

    from apex_tpu_torch.training.apex import ApexTrainer

    what = "dp_checkpoint"
    cfg = _full_width_cfg(False, DP_SHARD_CAPACITY)
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  mesh_shape=(DP_WORLD,)))
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    a = b = None
    try:
        with tempfile.TemporaryDirectory(prefix="apex-dp-ckpt-") as tmp:
            def trainer(name, chunks):
                return ApexTrainer(cfg, pool=ListPool(chunks),
                                   publish_min_seconds=10.0,
                                   respawn_workers=False, dp_backend="gloo",
                                   checkpoint_dir=os.path.join(tmp, name))

            a = trainer("a", msgs)
            zero_launches(gather)                     # main path starts
            a.train(total_steps=DP_CKPT_STEPS, max_seconds=DP_SECONDS)
            t0 = time.perf_counter()
            path = a.save_checkpoint()
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            rest = list(a.pool.pool._msgs)
            a.train(total_steps=DP_CKPT_STEPS, max_seconds=DP_SECONDS)
            torch.cuda.synchronize()
            launches_a = read_launches(gather)
            ranks_a = a.dp_rank_stats
            b = trainer("b", rest)
            t0 = time.perf_counter()
            b.restore(path)
            restore_s = time.perf_counter() - t0
            zero_launches(gather)
            b.train(total_steps=DP_CKPT_STEPS, max_seconds=DP_SECONDS)
            torch.cuda.synchronize()
            launches_b = read_launches(gather)        # main path ends
            ranks_b = b.dp_rank_stats
            # the bundles a save would write, gathered to the host
            same = _same(b._sharded_bundle(), a._sharded_bundle())
            steps = (a.steps, b.steps)
            for t in (a, b):
                t.close()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        for t in (a, b):
            if t is not None:
                t.close()
    check(not mp.active_children(),
          f"{what}: processes outlived close(): {mp.active_children()}")
    check(steps == (2 * DP_CKPT_STEPS, 2 * DP_CKPT_STEPS),
          f"{what}: steps {steps}")
    check(same, f"{what}: the restored trainer's bundle differs from the "
                f"uninterrupted one's")
    want_l = {"gather_rows": 0, "gather_stacks": 2 * DP_CKPT_STEPS}
    check(gather_part(launches_a) == want_l
          and ranks_a[1]["gather_launches"] == want_l,
          f"{what}: A's gather launches {launches_a} / "
          f"{ranks_a[1]['gather_launches']}")
    want_l = {"gather_rows": 0, "gather_stacks": DP_CKPT_STEPS}
    check(gather_part(launches_b) == want_l
          and ranks_b[1]["gather_launches"] == want_l,
          f"{what}: B's gather launches {launches_b} / "
          f"{ranks_b[1]['gather_launches']}")
    log(f"{what}: dp {DP_WORLD} ApexTrainer, capacity {DP_SHARD_CAPACITY} "
        f"per rank: {DP_CKPT_STEPS} steps, a {size} byte checkpoint "
        f"(saved in {save_s:.3f} s, both shards gathered), {DP_CKPT_STEPS} "
        f"more on the same ranks; a fresh trainer restored it in "
        f"{restore_s:.3f} s (rank 1's shard scattered at its start) and "
        f"took {DP_CKPT_STEPS} steps: the two final bundles (train state, "
        f"both shards, every generator and the uniforms) bit-equal; no rank "
        f"left after close(); gather launches A {launches_a} + rank 1 "
        f"{ranks_a[1]['gather_launches']}, B {launches_b} + rank 1 "
        f"{ranks_b[1]['gather_launches']}")
    torch.cuda.empty_cache()
    r0 = {k: launches_a[k] + launches_b[k] for k in launches_a}
    r1 = summed([stats_launches(ranks_a[1]), stats_launches(ranks_b[1])])
    return {"launches": {k: r0[k] + r1[k] for k in r0},
            "rank_launches": [r0, r1]}


def dp_phase(dev, gather, msgs: list, p5: dict, p10: dict) -> dict:
    """Phase 17: 17a-17g.  Returns the paths' launches, summed over the
    ranks and per rank (17f's shard processes' apart)."""
    t = [time.perf_counter()]
    dp_build_check()
    t.append(time.perf_counter())
    ref = dp_reference_run(dev, gather, msgs)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    run = dp_train_run(dev, gather, p5, ref)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    nccl = dp_nccl1_run(dev, gather, msgs)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    fused = dp_fused_run(dev, gather, p10)
    t.append(time.perf_counter())
    anakin = dp_anakin_run(dev, gather)
    t.append(time.perf_counter())
    service = dp_service_run(dev, gather)
    t.append(time.perf_counter())
    ckpt = dp_checkpoint_run(dev, gather, msgs)
    t.append(time.perf_counter())
    names = ("dp_build", "dp_reference", "dp_train", "dp_nccl1", "dp_fused",
             "dp_anakin", "dp_service", "dp_checkpoint")
    log("dp: phase 17 seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(names, t, t[1:]))
        + f"; in all {t[-1] - t[0]:.1f}")
    out = {"dp_nccl1": nccl["launches"],
           "dp_service_shards": service["shard_launches"]}
    for name, res in (("dp_reference", ref), ("dp_train", run),
                      ("dp_fused", fused), ("dp_anakin", anakin),
                      ("dp_service", service), ("dp_checkpoint", ckpt)):
        out[name] = res["launches"]
        for r, counts in enumerate(res["rank_launches"]):
            out[f"{name}_rank{r}"] = counts
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="after the timed steps, trace a few more fused "
                             "steps with torch.profiler into DIR")
    parser.add_argument("--parent", metavar="DIR",
                        help="also build the gather_rows kernel of the "
                             "checkout at DIR and time it beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch.ops import gather, tree

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    t0 = time.perf_counter()
    gather.build(verbose=True)
    log(f"build: gather.cu in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    tree.build(verbose=True)
    log(f"build: tree.cu in {time.perf_counter() - t0:.3f} s")

    marks = [("build", time.perf_counter())]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    rows = kernel_phase(dev, gather, card, args.parent)
    mark("kernels")
    reference_phase(dev)
    mark("reference")
    result = slice_phase(dev, gather, args.profile)
    msgs = result.pop("msgs")
    torch.cuda.empty_cache()
    mark("slice")
    loop = train_phase(dev, gather, pipelined=True)
    serial = train_phase(dev, gather, pipelined=False)
    log("train: pipelined vs serial drain, learner steps/s "
        f"{loop['steps_per_s']:.3f} vs {serial['steps_per_s']:.3f}; env "
        f"frames/s ingested (last 100 dispatches) {loop['frames_per_s']:.1f} "
        f"vs {serial['frames_per_s']:.1f}, over train() "
        f"{loop['frames_over_train']:.1f} vs "
        f"{serial['frames_over_train']:.1f}; dispatches "
        f"{loop['dispatches']} vs {serial['dispatches']}; wall "
        f"{loop['wall']:.3f} s vs {serial['wall']:.3f} s")
    actor_phase(loop["threads"])
    mark("train")
    full = pipeline_phase(dev, gather, msgs)
    mark("pipeline")
    saved = checkpoint_phase(dev, gather, msgs)
    mark("checkpoint")
    dqn = dqn_phase(gather)
    mark("dqn")
    r2d2_reference_phase(dev)
    r2d2 = r2d2_train_phase(dev, gather, args.profile)
    r2d2_single = r2d2_single_phase(dev, gather)
    mark("r2d2")
    ondevice = ondevice_phase(dev, gather, loop, serial)
    fused10 = ondevice.pop("fused_rates")
    mark("ondevice")
    aql = aql_phase(dev, gather, args.profile)
    mark("aql")
    remote, p12a = role_phase(dev, gather, loop)
    mark("roles")
    services = service_phase(dev, gather, p12a)
    mark("services")
    fleet = fleet_phase(dev, gather, msgs, p12a)
    mark("fleet")
    control = control_phase(dev, gather, msgs)
    mark("control")
    tools = tools_phase(dev)
    mark("tools")
    dp = dp_phase(dev, gather, msgs, loop, fused10)
    mark("dp")
    log("chip_smoke: phase seconds " + ", ".join(
        f"{name} {t1 - t0:.1f}"
        for (_, t0), (name, t1) in zip(marks, marks[1:])))
    paths = {"train": loop["launches"], "train_serial": serial["launches"],
             "consume": result["launches"],
             "full_width_pipelined": full["pipelined"]["launches"],
             "full_width_serial": full["serial"]["launches"],
             "checkpoint": saved["launches"], "dqn": dqn["launches"],
             "r2d2_train": r2d2["launches"],
             "r2d2_single": r2d2_single["launches"], **ondevice, **aql,
             **remote, **services, **fleet, **control, **tools, **dp}
    # each kernel's main path is the trainers' train() that runs it:
    # ApexTrainer's for gather_stacks and tree_update, R2D2ApexTrainer's
    # for gather_rows; the other paths stand beside
    main_path = {"gather_stacks": "train", "gather_rows": "r2d2_train",
                 "tree_update": "train"}
    for row in rows:
        row["launches"] = paths[main_path[row["name"]]][row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in paths.items()}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"chip_smoke: phases 1-17 in {time.perf_counter() - t_script:.1f} s")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
