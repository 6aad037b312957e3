"""The fused train step: the whole Ape-X cycle on the card, the host in its
epilogue only.

Counterpart of :mod:`apex_tpu.ondevice.fused` at dp = 1.  One
:meth:`FusedStep.dispatch` runs ``steps_per_dispatch`` macro steps of

    rollout segment (AnakinRollout.dispatch)
    -> acting-time TD priorities
    -> ingest of every sealed chunk (FramePoolReplay.add)
    -> [warm] P x (prioritized sample -> update_from_batch
                   -> priority write-back)

Where JAX compiles the dispatch into one program and reads its results
once per dispatch, the port runs the macro steps eagerly and syncs once
per macro: the frame pool's ``add`` takes a chunk's counts as host ints,
so the host reads each macro's ``sealed``/``n_frames``/``n_trans`` in one
copy and ingests only the sealed slots, in JAX's flat lane-major order.
That leaves the replay as JAX's masked scan over the whole slot grid
leaves it (``fused.py:261-278``).  The sealed chunks go in as one merged
ingest (as many as the pool's bounds allow), which writes the same cells,
priorities and frame epochs as one ingest per chunk, the contract of the
ingest pipeline's merge (``epoch_off``).  Episode tallies and metrics are
read once per dispatch.

Contracts carried over (``fused.py:21-39``):

* **fused == serial**: an N-macro dispatch equals N one-macro dispatches
  bit for bit (same macro body, same draws and uniforms in the same
  order).
* **Acting params are the live learner weights**: the engine acts with the
  train state's online module; no copy, no staleness.
* **Replay ratio**: ``B * rollout_len`` transitions per ``train_per_step``
  updates, unless ``train_ratio`` is set; then a budget (f32 saturating at
  2^24) gains ``ratio`` per ingested transition and spends ``batch_size``
  per update, gating each train slot.
* **Beta anneals off the ingest counter**, an int32 that saturates at
  ``max(warmup, beta_anneal) + 1``; warm-up gates training on it.  Both
  counter and budget live on the host here, in JAX's arithmetic.
* **An outbox overflow raises.**

The acting priorities are the host builder's two rounded f32 ops
(:func:`acting_priorities`); JAX's program contracts them into one FMA,
so the two agree within 1 ulp.  Not ported: the dp mesh (``shard_map``
over lanes and replay partitions, item 4) and the JAX trainer's
heartbeat, fleet registry, status server and obs ring (item 10).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from apex_tpu_torch.actors.pool import EpisodeStat
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.device_envs import make_device_env
from apex_tpu_torch.training.anakin import (acting_priorities, host_arrays,
                                            make_anakin_engine)
from apex_tpu_torch.training.apex import ApexTrainer
from apex_tpu_torch.utils.profiling import DispatchGapTimer

__all__ = ["FusedApexTrainer", "FusedStep", "acting_priorities"]


class FusedStep:
    """The macro-step program and its host-side counters.

    ``core`` is the :class:`~apex_tpu_torch.training.learner.LearnerCore`
    (``update_from_batch`` is the family hook), ``replay`` its
    :class:`~apex_tpu_torch.replay.frame_pool.FramePoolReplay` and
    ``engine`` an :class:`~apex_tpu_torch.training.anakin.AnakinRollout`
    whose carry this object now drives."""

    def __init__(self, core, replay, engine, *, warmup: int, beta: float,
                 beta_anneal: int, steps_per_dispatch: int = 4,
                 train_per_step: int = 1, train_ratio: float | None = None):
        if steps_per_dispatch < 1 or train_per_step < 1:
            raise ValueError(
                f"steps_per_dispatch={steps_per_dispatch} and "
                f"train_per_step={train_per_step} must be >= 1")
        self.core = core
        self.replay = replay
        self.engine = engine
        self.N = int(steps_per_dispatch)
        self.P = int(train_per_step)
        self.ratio = None if train_ratio is None else float(train_ratio)
        self.warmup = int(warmup)
        self.beta0 = float(beta)
        self.anneal = max(1, int(beta_anneal))
        # the warm/anneal counter saturates past both thresholds, where
        # the exact count no longer matters (JAX keeps it in i32)
        self._ing_cap = max(self.warmup, self.anneal) + 1
        self.ingested = 0
        # the train_ratio budget: f32 is integer-exact below 2^24
        self._bud_cap = np.float32(2 ** 24)
        self.budget = np.float32(0.0)
        # most chunks one merged ingest may carry within the pool's bounds
        self._merge_cap = max(1, min(replay.capacity // engine.K,
                                     replay.f_capacity // engine.Kf))
        self.dispatches = 0
        self.macro_steps = 0
        self.train_steps = 0
        self.prio_writebacks = 0
        self.chunks = 0
        self.frames = 0
        self.transitions = 0
        self.external_ingest = 0

    # -- the macro step ----------------------------------------------------

    def _beta_at(self, ing: int) -> float:
        frac = min(np.float32(1.0), np.float32(ing) / np.float32(self.anneal))
        return float(np.float32(self.beta0)
                     + np.float32(1.0 - self.beta0) * frac)

    def _merged_chunk(self, out: dict, prios: torch.Tensor, group: list,
                      nf: np.ndarray, nt: np.ndarray):
        """The sealed slots ``group`` ([(lane, slot)], lane-major) as one
        ingest: real frame and transition rows compacted in order, refs
        rebased and ``epoch_off`` set by each chunk's frame offset, the
        tail repeating the last real row
        (:func:`~apex_tpu_torch.training.ingest_pipeline.merge_chunk_messages`
        on the device, with indices built on the host)."""
        eng = self.engine
        B, M, K, Kf = eng.B, eng.M, eng.K, eng.Kf
        n_fr = [int(nf[b, j]) for b, j in group]
        n_tr = [int(nt[b, j]) for b, j in group]
        cum = np.concatenate([[0], np.cumsum(n_fr)[:-1]])

        def padded(parts, length):
            idx = np.concatenate(parts)
            return np.concatenate([idx, np.full(length - len(idx), idx[-1])])

        m = len(group)
        fsrc = padded([(b * M + j) * Kf + np.arange(f)
                       for (b, j), f in zip(group, n_fr)], m * Kf)
        tsrc = padded([(b * M + j) * K + np.arange(t)
                       for (b, j), t in zip(group, n_tr)], m * K)
        off = padded([np.full(t, c) for t, c in zip(n_tr, cum)], m * K)
        idx = torch.from_numpy(np.concatenate([fsrc, tsrc, off])).to(
            eng.device, non_blocking=True)
        fsrc, tsrc, off = idx[:m * Kf], idx[m * Kf:m * (Kf + K)], \
            idx[m * (Kf + K):].int()

        def rows(x):
            return x.reshape(B * M * K, *x.shape[3:]).index_select(0, tsrc)

        chunk = dict(
            frames=out["frames"].reshape(B * M * Kf, -1).index_select(
                0, fsrc),
            n_frames=sum(n_fr), n_trans=sum(n_tr),
            action=rows(out["action"]), reward=rows(out["reward"]),
            discount=rows(out["discount"]),
            obs_ref=rows(out["obs_ref"]) + off[:, None],
            next_ref=rows(out["next_ref"]) + off[:, None],
            epoch_off=off)
        return chunk, rows(prios)

    def _macro(self, ts, rs, offsets: torch.Tensor):
        eng, replay = self.engine, self.replay
        out = eng.dispatch(ts.params)
        prios = acting_priorities(out)
        # the macro's one host read: seals and the sealed slots' counts
        counts = host_arrays({"c": torch.cat(
            [out["sealed"][:, None], out["nf"], out["nt"]], 1)})["c"]
        sealed = counts[:, 0]
        nf, nt = counts[:, 1:1 + eng.M], counts[:, 1 + eng.M:]
        if sealed.max(initial=0) > eng.M - 1:
            raise RuntimeError(
                f"fused outbox overflow: {int(sealed.max())} seals > "
                f"{eng.M - 1} sealed slots; raise rollout_len headroom")
        sel = [(b, j) for b in range(eng.B) for j in range(int(sealed[b]))]
        for i in range(0, len(sel), self._merge_cap):
            chunk, pr = self._merged_chunk(out, prios,
                                           sel[i:i + self._merge_cap], nf,
                                           nt)
            rs = replay.add(rs, chunk, pr)
        delta = sum(int(nt[b, j]) for b, j in sel)
        self.ingested = min(self.ingested + delta, self._ing_cap)
        if self.ratio is not None:
            self.budget = min(
                self.budget + np.float32(delta) * np.float32(self.ratio),
                self._bud_cap)
        metrics, mask = [], []
        if self.ingested >= self.warmup:
            beta = self._beta_at(self.ingested)
            for p in range(self.P):
                go = self.ratio is None or self.budget > 0
                mask.append(go)
                if not go:
                    continue
                batch, weights, idx = replay.sample(rs, offsets[p], beta)
                ts, new_prios, m = self.core.update_from_batch(ts, batch,
                                                               weights)
                rs = replay.update_priorities(rs, idx, new_prios)
                metrics.append(m)
                if self.ratio is not None:
                    self.budget = np.float32(
                        self.budget - np.float32(self.core.batch_size))
        else:
            mask = [False] * self.P
        info = dict(metrics=metrics, mask=mask, chunks=len(sel),
                    transitions=delta, done=out["done"],
                    ep_ret=out["ep_ret"], ep_len=out["ep_len"])
        return ts, rs, info

    # -- host surface ------------------------------------------------------

    def dispatch(self, train_state, replay_state, offsets):
        """``steps_per_dispatch`` macro steps.  ``offsets(k)`` returns the
        per-stratum uniforms ``f32[k, batch_size]`` of the macro's ``k =
        train_per_step`` sample slots, drawn for every slot whether it
        trains or not (the JAX program's pre-split sample keys).  Returns
        ``(train_state, replay_state, info)``; ``info`` has the episode
        stats, the mean metrics of the slots that trained (None when none
        did), ``train_steps``, ``transitions`` and ``frames``."""
        eng = self.engine
        macros = []
        for _ in range(self.N):
            train_state, replay_state, info = self._macro(
                train_state, replay_state, offsets(self.P))
            macros.append(info)
        trained = [m for info in macros for m in info["metrics"]]
        got = host_arrays(dict(
            done=torch.stack([i["done"] for i in macros]),
            ep_ret=torch.stack([i["ep_ret"] for i in macros]),
            ep_len=torch.stack([i["ep_len"] for i in macros]),
            **{f"m_{k}": torch.stack([m[k] for m in trained]).float()
               for k in (trained[0] if trained else {})}))
        done, ep_ret, ep_len = got["done"], got["ep_ret"], got["ep_len"]
        stats = [EpisodeStat(eng.slot_ids[b], float(ep_ret[m, t, b]),
                             int(ep_len[m, t, b]))
                 for m in range(self.N) for t in range(eng.T)
                 for b in range(eng.B) if done[m, t, b]]
        metrics = ({k[2:]: float(v.mean()) for k, v in got.items()
                    if k.startswith("m_")} if trained else None)
        transitions = sum(i["transitions"] for i in macros)
        frames = self.N * eng.T * eng.B
        self.dispatches += 1
        self.macro_steps += self.N
        self.train_steps += len(trained)
        self.prio_writebacks += len(trained)
        self.chunks += sum(i["chunks"] for i in macros)
        self.frames += frames
        self.transitions += transitions
        info = dict(stats=stats, metrics=metrics, train_steps=len(trained),
                    transitions=transitions, frames=frames,
                    step_mask=[i["mask"] for i in macros])
        return train_state, replay_state, info

    def note_external_ingest(self, n: int) -> None:
        """Host-path chunks ingested outside the fused step still advance
        the warm/anneal counter and, with ``train_ratio``, the budget."""
        self.ingested = min(self.ingested + int(n), self._ing_cap)
        if self.ratio is not None:
            self.budget = min(
                self.budget + np.float32(float(n) * self.ratio),
                self._bud_cap)
        self.external_ingest += int(n)

    def sync_ingested(self, n: int, steps: int = 0) -> None:
        """Re-seed the counters after a checkpoint restore: ``n``
        transitions ingested, ``steps`` learner updates taken."""
        self.ingested = min(n, 2 ** 31 - 1, self._ing_cap)
        if self.ratio is not None:
            self.budget = min(
                np.float32(float(n) * self.ratio
                           - float(steps) * self.core.batch_size),
                self._bud_cap)

    def counters(self) -> dict:
        return {"dispatches": self.dispatches,
                "macro_steps": self.macro_steps,
                "train_steps": self.train_steps,
                "prio_writebacks": self.prio_writebacks,
                "chunks": self.chunks, "frames": self.frames,
                "transitions": self.transitions,
                "external_ingest": self.external_ingest,
                "steps_per_dispatch": self.N, "train_per_step": self.P,
                "train_ratio": float(self.ratio or 0.0),
                "rollout_len": self.engine.T, "n_envs": self.engine.B}


class _IdlePool:
    """The fused trainer's default pool: rollouts live inside the
    dispatch, so there is no actor plane; this is the pool surface the
    trainer's helpers call."""

    accepts_device_params = True

    def start(self) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def publish_params(self, version: int, params) -> None:
        pass

    def poll_chunks(self, max_chunks: int, timeout: float = 0.0) -> list:
        return []

    def poll_stats(self) -> list:
        return []


class FusedApexTrainer(ApexTrainer):
    """The ``train()`` driver whose hot loop is one :class:`FusedStep`
    dispatch per iteration (``apex_tpu/ondevice/fused.py:512-729``).

    It reuses the :class:`ApexTrainer` substrate: model, replay and
    optimizer construction, the checkpoint bundle (the replay state is the
    on-device pool), the publish cadence and the log.  A ``pool`` that is
    given keeps its chunks flowing in: they are ingested into the same
    replay between dispatches (hybrid mode).  ``device`` defaults to the
    card.  An env without a device port refuses here, naming its id.  Not
    ported: the heartbeat, fleet registry, status server and obs ring of
    the JAX trainer (item 10), and its dp mesh (item 4)."""

    def __init__(self, config: ApexConfig | None = None, pool=None,
                 train_ratio: float | None = None,
                 device: torch.device | str = "cuda",
                 logdir: str | None = None, verbose: bool = False,
                 publish_min_seconds: float = 0.2,
                 min_train_ratio: float | None = None,
                 respawn_workers: bool = True,
                 checkpoint_dir: str | None = None,
                 rollout_len: int | None = None,
                 steps_per_dispatch: int = 4, train_per_step: int = 1):
        cfg = config or ApexConfig()
        # an env without a device port refuses here, before anything is
        # built on the card
        make_device_env(cfg.env.env_id, cfg.env, device="cpu")
        super().__init__(cfg, pool=pool if pool is not None else _IdlePool(),
                         train_ratio=train_ratio, device=device,
                         logdir=logdir, verbose=verbose,
                         publish_min_seconds=publish_min_seconds,
                         min_train_ratio=min_train_ratio,
                         respawn_workers=respawn_workers,
                         checkpoint_dir=checkpoint_dir)
        engine = make_anakin_engine(cfg, rollout_len=rollout_len,
                                    device=self.device,
                                    model=self.train_state.params)
        self.fused = FusedStep(
            self.core, self.replay, engine, warmup=cfg.replay.warmup,
            beta=cfg.replay.beta, beta_anneal=cfg.replay.beta_anneal,
            steps_per_dispatch=steps_per_dispatch,
            train_per_step=train_per_step, train_ratio=train_ratio)

    def train(self, total_steps: int, max_seconds: float = 3600.0,
              log_every: int = 200):
        """Run at least ``total_steps`` more learner updates: a dispatch
        may overshoot by up to ``steps_per_dispatch * train_per_step - 1``.
        Stops early at ``max_seconds`` or :meth:`request_stop`."""
        cfg = self.cfg
        pool = self.pool
        target_steps = self.steps_rate.total + total_steps
        gap = self._dispatch_gap = DispatchGapTimer()
        pool.start()
        try:
            self._publish()
            last_publish = time.monotonic()
            t_end = last_publish + max_seconds
            last_pub_step = self.steps_rate.total
            last_health = last_publish
            self._episode_idx = 0
            metrics = None
            while self.steps_rate.total < target_steps:
                now = time.monotonic()
                stop = self._stop_requested
                if now > t_end or (stop is not None and stop.is_set()):
                    break
                gap.about_to_dispatch()
                self.train_state, self.replay_state, info = \
                    self.fused.dispatch(self.train_state, self.replay_state,
                                        self._offsets)
                gap.dispatch_returned()
                if info["train_steps"]:
                    self.steps_rate.tick(info["train_steps"])
                    metrics = info["metrics"]
                self.ingested += info["transitions"]
                self.frames_rate.tick(info["transitions"])
                for stat in info["stats"]:
                    stat.param_version = self.param_version
                    self.log.scalars(
                        {"episode_reward": stat.reward,
                         "episode_length": stat.length,
                         "actor_id": stat.actor_id}, self._episode_idx)
                    self._episode_idx += 1
                # hybrid: a given pool's chunks are ingested between
                # dispatches; the fused step owns the train cadence
                for msg in pool.poll_chunks(64, timeout=0):
                    self.replay_state = self.core.ingest(
                        self.replay_state, msg["payload"],
                        msg["priorities"])
                    n_new = int(msg["n_trans"])
                    self.ingested += n_new
                    self.frames_rate.tick(n_new)
                    self.fused.note_external_ingest(n_new)

                steps = self.steps_rate.total
                if (self.checkpointer is not None
                        and steps - self._last_save
                        >= cfg.learner.save_interval):
                    self.save_checkpoint()
                    self._last_save = steps
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
                if metrics is not None \
                        and steps - self._last_log >= log_every:
                    self.log.scalars(
                        dict(metrics)
                        | {"bps": self.steps_rate.rate,
                           "fps": self.frames_rate.rate,
                           "param_version": self.param_version,
                           "ingested": self.ingested} | gap.snapshot(),
                        steps)
                    self._last_log = steps
        finally:
            pool.cleanup()
            stop = self._stop_requested
            if stop is not None:
                stop.clear()
        return self

    def _apply_counters(self, meta: dict) -> None:
        super()._apply_counters(meta)
        self.fused.sync_ingested(self.ingested, steps=self.steps_rate.total)
