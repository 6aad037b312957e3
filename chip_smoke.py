#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure before any result line:

1. build   -- compile the hand-written CUDA kernels from ``csrc/``.
2. kernels -- hold each kernel bit-exact against its plain PyTorch
   version on the card, and time kernel, plain version and the library
   call (CUDA events, median) at the learner's shapes.
3. reference -- a small learner (42x42 Catch frames, f32, TF32 off) run
   on the card and on the CPU from the same weights, chunks and sample
   uniforms: batches bit-exact, losses and weights within tolerance.
4. slice   -- the Ape-X frame-pool learner (``ApexTrainer``) at full
   width on ``ApexCatch-v0``: 84x84x1 u8 frames, stack 4, batch 512,
   capacity 2^19, frame ring 2^20, 512-transition / 528-frame chunks
   made by an in-process acting loop.  Ingest until warm, then fused
   steps; checks losses, priorities, the sum tree, the target sync and
   that the gather kernel ran twice per step.

Then it prints the card's name and power limit, one ``{"kernels": ...}``
line and, last, ``{"ok": true, "device": {...}}``.  It needs one card
and exits nonzero without one.  ``--profile DIR`` also traces a few more
fused steps with ``torch.profiler`` and writes device time by op to DIR.
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

# published device-memory rates (bytes/s) by card name, NVIDIA data sheets
_MEMORY_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                ("H200", 4.8e12), ("H100", 3.35e12))

SEED = 1122
WARMUP_CHUNKS = 8            # ingest-only chunks before the first step
TRAIN_STEPS = 24             # fused steps timed on the main path
CAPACITY = 2 ** 19           # transitions; the frame ring holds twice as many
BATCH = 512
TARGET_INTERVAL = 10         # target syncs at steps 10 and 20
N_ENVS = 32                  # acting envs batched into one policy call
PROFILE_STEPS = 8            # extra fused steps traced with --profile


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def memory_rate(name: str) -> float:
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
    round-robin, so every function sees the same card state."""
    for name, fn in fns.items():
        for i in range(warmup):
            fn(i)
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    torch.cuda._sleep(200_000_000)          # ~0.1 s at H100 clocks
    for it in range(iters):
        for name, fn in fns.items():
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

def kernel_phase(dev, gather, card: str) -> dict:
    g = torch.Generator(device=dev).manual_seed(SEED)
    f_rows, d = 2 ** 20, 84 * 84
    n = 2 * 512 * 4 // 2                       # one gather call of the step
    ring = torch.empty((f_rows, d), dtype=torch.uint8, device=dev)
    ring.random_(0, 256, generator=g)

    def rand_ids(count, high):
        return torch.randint(0, high, (count,), dtype=torch.int32,
                             device=dev, generator=g)

    small_u8 = torch.empty((4096, 42 * 42), dtype=torch.uint8, device=dev)
    small_u8.random_(0, 256, generator=g)
    odd_u8 = small_u8[:, :1763].contiguous()            # byte-wise path
    ring_f32 = torch.randn((4096, 1024), device=dev, generator=g)
    edge = torch.tensor([0, f_rows - 1, f_rows - 1, 7, 0, 0, f_rows - 1, 1],
                        dtype=torch.int32, device=dev)
    cases = {
        "u8 D=7056, N=2048 over F=2^20": (ring, rand_ids(n, f_rows)),
        "u8 D=7056, repeated + boundary ids": (ring, edge),
        "u8 D=1764 (4-byte path)": (small_u8, rand_ids(n, 4096)),
        "u8 D=1763 (byte path)": (odd_u8, rand_ids(n, 4096)),
        "f32 D=1024": (ring_f32, rand_ids(n, 4096)),
    }
    max_err = 0.0
    for what, (frames, ids) in cases.items():
        got = gather.gather_rows(frames, ids)
        want = gather.gather_rows_reference(frames, ids)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"gather_rows != plain version: {what}")
        log(f"kernel gather_rows {what}: bit-exact")

    id_sets = [rand_ids(n, f_rows) for _ in range(33)]
    ms = time_ms({
        "kernel": lambda i: gather.gather_rows(ring, id_sets[i]),
        "plain": lambda i: gather.gather_rows_reference(ring, id_sets[i]),
        "library": lambda i: torch.index_select(ring, 0, id_sets[i]),
    })
    moved = 2 * n * d + 4 * n                  # rows read + written, ids read
    bound_ms = moved / memory_rate(card) * 1e3
    log(f"gather_rows N={n} D={d}: kernel {ms['kernel']:.6f} ms, plain "
        f"{ms['plain']:.6f} ms, index_select {ms['library']:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({moved} B at {memory_rate(card):.3g} B/s)")
    del ring, id_sets
    torch.cuda.empty_cache()
    return dict(name="gather_rows", route="cuda",
                source="apex_tpu_torch/ops/csrc/gather.cu",
                replaces="apex_tpu/ops/gather.py:71",
                max_abs_err=max_err, ms=ms["kernel"], kernel_ms=ms["kernel"],
                plain_ms=ms["plain"], bound_ms=bound_ms, bound_by="bytes",
                library_ms=ms["library"])


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

def profile_steps(trainer, msgs: list, out_dir: str) -> None:
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
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chip_smoke_profile.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    log("profile: " + "\nprofile: ".join(lines[:16]) + f"\nprofile: -> {path}")


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
    gather.LAUNCH_COUNTS["gather_rows"] = 0           # main path starts
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
    launches = gather.LAUNCH_COUNTS["gather_rows"]   # main path ends

    check(trainer.steps == TRAIN_STEPS == ts.step,
          f"slice: {trainer.steps} fused steps, train state at {ts.step}")
    check(launches == 2 * TRAIN_STEPS,
          f"slice: gather kernel launched {launches} times for "
          f"{TRAIN_STEPS} steps (want 2 per step)")
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
    return dict(launches=launches, ms_per_step=ms, peak_bytes=peak)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="after the timed steps, trace a few more fused "
                             "steps with torch.profiler into DIR")
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

    row = kernel_phase(dev, gather, card)
    reference_phase(dev)
    result = slice_phase(dev, gather, args.profile)
    row["launches"] = result["launches"]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"kernels": [row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
