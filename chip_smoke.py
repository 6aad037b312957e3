#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure before any result line:

1. build   -- compile the hand-written CUDA kernels from ``csrc/``.
2. kernels -- hold each kernel (``gather_rows``, ``gather_stacks``)
   bit-exact against its plain PyTorch version on the card over every
   copy path, and time kernel, plain version and the library call (CUDA
   events, median) at the learner's shapes.
3. reference -- a small learner (42x42 Catch frames, f32, TF32 off) run
   on the card and on the CPU from the same weights, chunks and sample
   uniforms: batches bit-exact, losses and weights within tolerance.
4. slice   -- the Ape-X frame-pool learner (``ApexTrainer``) at full
   width on ``ApexCatch-v0``: 84x84x1 u8 frames, stack 4, batch 512,
   capacity 2^19, frame ring 2^20, 512-transition / 528-frame chunks
   made by an in-process acting loop.  Ingest until warm, then fused
   steps; checks losses, priorities, the sum tree, the target sync and
   that ``gather_stacks`` ran once per step (obs and next_obs together)
   and ``gather_rows`` not at all.
5. train    -- the system as its users run it: ``ApexTrainer.train`` with
   4 spawned actor processes x 8 envs acting on the CPU (32 ladder
   slots, 64-transition chunks) feeding the learner on the card over the
   shared-memory chunk ring, at the geometry of phase 4 with a
   4096-transition warm-up, for 100 learner steps: first with its default
   ingest pipeline, then with the serial drain, printed side by side.
   Checks the steps, the ring, the param publishes the actors acted on,
   one ``gather_stacks`` launch per learner step and no ``gather_rows``,
   finite metrics, the sum tree, that no actor process and no segment
   outlive ``train()`` and, pipelined, merged warm-up slots and publishes
   through the staging thread; prints the dispatch counts, learner
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
   dispatch, one learner step each) for 64 steps; each checks one
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

Then it prints the card's name and power limit, one ``{"kernels": ...}``
line (``launches`` counts each kernel's main path: phase 5's pipelined
``train()`` for ``gather_stacks``, phase 9's for ``gather_rows``;
``launches_by_path`` adds the serial drain, phase 4's consume path,
phases 6-9, phase 10's ``anakin_train``, ``anakin_serial`` and
``fused_train`` and phase 11's ``aql_continuous``, ``aql_pixel``,
``aql_single`` and ``aql_checkpoint``) and, last,
``{"ok": true, "device": {...}}``.  It needs one card
and exits nonzero without one.  ``--profile DIR`` also traces a few more
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

    lib_path = os.path.join(gather.BUILD_DIR, "libapex_gather_parent.so")
    os.makedirs(gather.BUILD_DIR, exist_ok=True)
    subprocess.run([gather._nvcc(), *gather.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(root, "apex_tpu_torch", "ops", "csrc",
                                 "gather.cu")],
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
                 library_ms=st["library"], **common)]


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
    for name in gather.LAUNCH_COUNTS:                 # main path starts
        gather.LAUNCH_COUNTS[name] = 0
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
    launches = dict(gather.LAUNCH_COUNTS)             # main path ends

    check(trainer.steps == TRAIN_STEPS == ts.step,
          f"slice: {trainer.steps} fused steps, train state at {ts.step}")
    check(launches == {"gather_rows": 0, "gather_stacks": TRAIN_STEPS},
          f"slice: gather launches {launches} in {TRAIN_STEPS} steps (want "
          f"one gather_stacks per step and no gather_rows)")
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
    for name in gather.LAUNCH_COUNTS:                 # main path starts
        gather.LAUNCH_COUNTS[name] = 0
    t0 = time.perf_counter()
    trainer.train(total_steps=LOOP_STEPS, max_seconds=LOOP_SECONDS,
                  log_every=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gather.LAUNCH_COUNTS)             # main path ends

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
    check(launches == {"gather_rows": 0, "gather_stacks": trainer.steps},
          f"{what}: gather launches {launches} in {trainer.steps} steps")
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
            for key in gather.LAUNCH_COUNTS:          # this path starts
                gather.LAUNCH_COUNTS[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train(total_steps=TRAIN_STEPS, max_seconds=60.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(gather.LAUNCH_COUNTS)     # this path ends
            check(trainer.steps == TRAIN_STEPS == len(starts),
                  f"pipeline {name}: {trainer.steps} steps, "
                  f"{len(starts)} fused")
            check(launches == {"gather_rows": 0,
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
    for key in gather.LAUNCH_COUNTS:                  # this path starts
        gather.LAUNCH_COUNTS[key] = 0
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
        launches = dict(gather.LAUNCH_COUNTS)         # this path ends
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
    for key in gather.LAUNCH_COUNTS:                  # this path starts
        gather.LAUNCH_COUNTS[key] = 0
    with tempfile.TemporaryDirectory(prefix="apex-dqn-") as tmp:
        trainer = DQNTrainer(cfg, train_every=4, checkpoint_dir=tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(total_frames=DQN_FRAMES, log_every=50)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        saved = sorted(os.listdir(tmp))
    launches = dict(gather.LAUNCH_COUNTS)             # this path ends
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
    check(launches == {"gather_rows": 0, "gather_stacks": 0},
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
    for name in gather.LAUNCH_COUNTS:                 # main path starts
        gather.LAUNCH_COUNTS[name] = 0
    with _RowsSeen() as seen:
        t0 = time.perf_counter()
        trainer.train(total_steps=R2D2_STEPS, max_seconds=R2D2_SECONDS,
                      log_every=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(gather.LAUNCH_COUNTS)             # main path ends
    object.__setattr__(core, "ingest", ingest)
    # train()'s own counts, before the timed and profiled steps below
    steps, dispatches = trainer.steps, dict(trainer.dispatches)
    rate, ingested = trainer.steps_rate.rate, trainer.ingested
    frames_rate = trainer.frames_rate.rate

    check(trainer.steps == R2D2_STEPS == trainer.train_state.step,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s, want "
          f"{R2D2_STEPS} within {R2D2_SECONDS} s")
    check(launches == {"gather_rows": trainer.steps, "gather_stacks": 0},
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
    for key in gather.LAUNCH_COUNTS:                  # this path starts
        gather.LAUNCH_COUNTS[key] = 0
    with _RowsSeen() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(total_frames=R2D2_FRAMES, log_every=10,
                      warmup_sequences=R2D2_WARMUP_SEQS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(gather.LAUNCH_COUNTS)             # this path ends
    steps = trainer.steps_rate.total
    check(trainer.frames_rate.total == R2D2_FRAMES and steps > 0
          and trainer.train_state.step == steps,
          f"{what}: {trainer.frames_rate.total} frames, {steps} updates")
    check(launches == {"gather_rows": steps, "gather_stacks": 0}
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
FUSED_STEPS = 64             # learner steps of FusedApexTrainer.train


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
    for name in gather.LAUNCH_COUNTS:                 # this path starts
        gather.LAUNCH_COUNTS[name] = 0
    t0 = time.perf_counter()
    trainer.train(total_steps=LOOP_STEPS, max_seconds=LOOP_SECONDS,
                  log_every=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gather.LAUNCH_COUNTS)             # this path ends

    check(trainer.steps == LOOP_STEPS,
          f"{what}: {trainer.steps} learner steps in {wall:.1f} s")
    check(launches == {"gather_rows": 0, "gather_stacks": trainer.steps},
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
    macro step once warm, for 64 learner steps."""
    from apex_tpu_torch.ondevice.fused import FusedApexTrainer

    what = "fused train"
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = FusedApexTrainer(_ondevice_cfg("ApexCatch-v0"),
                               rollout_len=ONDEVICE_T,
                               steps_per_dispatch=ONDEVICE_N,
                               train_per_step=1)     # on "cuda"
    fused = trainer.fused
    for name in gather.LAUNCH_COUNTS:                 # this path starts
        gather.LAUNCH_COUNTS[name] = 0
    t0 = time.perf_counter()
    trainer.train(total_steps=FUSED_STEPS, max_seconds=LOOP_SECONDS,
                  log_every=max(1, FUSED_STEPS // 4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gather.LAUNCH_COUNTS)             # this path ends
    steps = trainer.steps
    check(FUSED_STEPS <= steps < FUSED_STEPS + ONDEVICE_N,
          f"{what}: {steps} learner steps in {wall:.1f} s")
    check(launches == {"gather_rows": 0, "gather_stacks": steps},
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
                fused_train=fused["launches"])


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
    for name in gather.LAUNCH_COUNTS:                 # main path starts
        gather.LAUNCH_COUNTS[name] = 0
    t0 = time.perf_counter()
    trainer.train(total_steps=AQL_STEPS, max_seconds=AQL_SECONDS,
                  log_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gather.LAUNCH_COUNTS)             # main path ends
    object.__setattr__(core, "ingest", ingest)
    steps, dispatches = trainer.steps, dict(trainer.dispatches)
    rate, ingested = trainer.steps_rate.rate, trainer.ingested
    frames_rate = trainer.frames_rate.rate

    check(steps == AQL_STEPS == trainer.train_state.step,
          f"{what}: {steps} learner steps in {wall:.1f} s, want "
          f"{AQL_STEPS} within {AQL_SECONDS} s")
    want = {"gather_rows": 0, "gather_stacks": steps if pixels else 0}
    check(launches == want,
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
    for key in gather.LAUNCH_COUNTS:                  # this path starts
        gather.LAUNCH_COUNTS[key] = 0
    frames = AQL_SINGLE_WARMUP + AQL_FRAMES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(total_frames=frames, log_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gather.LAUNCH_COUNTS)             # this path ends
    steps = trainer.steps_rate.total
    check(trainer.frames_rate.total == frames and steps > 0
          and trainer.train_state.step == steps,
          f"{what}: {trainer.frames_rate.total} frames, {steps} updates")
    check(launches == {"gather_rows": 0, "gather_stacks": 0},
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
    for key in gather.LAUNCH_COUNTS:                  # this path starts
        gather.LAUNCH_COUNTS[key] = 0
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
    launches = dict(gather.LAUNCH_COUNTS)             # this path ends
    check(launches == {"gather_rows": 0, "gather_stacks": 12},
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
    from apex_tpu_torch.ops import gather

    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    t0 = time.perf_counter()
    gather.build(verbose=True)
    log(f"build: gather.cu in {time.perf_counter() - t0:.3f} s")

    rows = kernel_phase(dev, gather, card, args.parent)
    reference_phase(dev)
    result = slice_phase(dev, gather, args.profile)
    msgs = result.pop("msgs")
    torch.cuda.empty_cache()
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
    full = pipeline_phase(dev, gather, msgs)
    saved = checkpoint_phase(dev, gather, msgs)
    dqn = dqn_phase(gather)
    r2d2_reference_phase(dev)
    r2d2 = r2d2_train_phase(dev, gather, args.profile)
    r2d2_single = r2d2_single_phase(dev, gather)
    ondevice = ondevice_phase(dev, gather, loop, serial)
    aql = aql_phase(dev, gather, args.profile)
    paths = {"train": loop["launches"], "train_serial": serial["launches"],
             "consume": result["launches"],
             "full_width_pipelined": full["pipelined"]["launches"],
             "full_width_serial": full["serial"]["launches"],
             "checkpoint": saved["launches"], "dqn": dqn["launches"],
             "r2d2_train": r2d2["launches"],
             "r2d2_single": r2d2_single["launches"], **ondevice, **aql}
    # each kernel's main path is the trainers' train() that runs it:
    # ApexTrainer's for gather_stacks, R2D2ApexTrainer's for gather_rows;
    # the other paths stand beside
    main_path = {"gather_stacks": "train", "gather_rows": "r2d2_train"}
    for row in rows:
        row["launches"] = paths[main_path[row["name"]]][row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in paths.items()}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
