"""The fused train step: the whole Ape-X cycle on the card, the host in its
epilogue only.

Counterpart of :mod:`apex_tpu.ondevice.fused`.  One
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
so the two agree within 1 ulp.

**dp** (``learner.mesh_shape`` above 1, ``apex_tpu/ondevice/fused.py:
53-63,123-172,276-285,324-410``): where JAX maps the whole macro scan
over the mesh, each rank of :mod:`apex_tpu_torch.parallel` runs its own
:class:`FusedStep` in lockstep with the others:

* the env lanes split into contiguous blocks: rank r's engine owns lanes
  ``[r*B/dp, (r+1)*B/dp)``, with their epsilons and slot ids (JAX's
  per-chip engine is a copy with ``B/dp``);
* each rank ingests into its own replay shard, and each train slot
  samples ``batch_size / dp`` from it, with the IS normalizer's max over
  the group and the update meaned over it;
* per macro, one host all-gather sums the ranks' ``delta`` and
  ``sealed_n`` (``n_trans`` is the same count) and takes the max of their
  ``sealed_max`` (JAX's ``psum``/``pmax``), so warm-up, the beta anneal
  and the ``train_ratio`` budget stay global and equal on every rank, and
  an outbox overflow raises on every rank;
* each rank draws from its own generators: its engine's (seeded for its
  lane band, :func:`~apex_tpu_torch.training.anakin.make_anakin_engine`)
  and its PER uniforms' (rank 0 keeps the dp = 1 seed), in the order JAX
  fans its keys: one engine draw block per macro, one ``f32[P,
  batch/dp]`` uniform block per macro;
* the episode tallies come back in global lane order, with each rank's
  shard size, through one host all-gather per dispatch.

:class:`FusedApexTrainer` runs the one concurrent loop,
:meth:`~apex_tpu_torch.training.apex.ConcurrentTrainer.train`, with one
:meth:`FusedStep.dispatch` as its iteration's body.  At dp > 1 it is
rank 0: its body sends the other ranks a ``fused`` op per dispatch (and
the host plan's ``ingest`` op for a hybrid pool's chunks), and the loop
runs the ranks' lifecycle.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.actors.pool import EpisodeStat
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.device_envs import make_device_env
from apex_tpu_torch.fleet.heartbeat import HeartbeatEmitter
from apex_tpu_torch.parallel.aggregate import split_group
from apex_tpu_torch.training.anakin import (acting_priorities, host_arrays,
                                            make_anakin_engine)
from apex_tpu_torch.training.apex import ApexTrainer

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
                 train_per_step: int = 1, train_ratio: float | None = None,
                 n_dp: int = 1):
        if steps_per_dispatch < 1 or train_per_step < 1:
            raise ValueError(
                f"steps_per_dispatch={steps_per_dispatch} and "
                f"train_per_step={train_per_step} must be >= 1")
        self.n_dp = int(n_dp)
        check_dp_fit(core.batch_size, engine.B * self.n_dp, self.n_dp)
        # this rank's group (join); None at dp 1
        self.group = None
        self._batch_chip = core.batch_size // self.n_dp
        # every rank's lane slot ids in global lane order, and every
        # rank's shard size after the last dispatch (fleet_summary)
        self.lane_ids = list(engine.slot_ids)
        self.shard_sizes: list[int] = []
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

    def join(self, group) -> None:
        """Take this rank's dp ``group`` (its world must be ``n_dp``) and
        learn every rank's lane slot ids."""
        if group.world != self.n_dp:
            raise ValueError(f"a group of {group.world} ranks for a fused "
                             f"step of dp {self.n_dp}")
        self.group = group
        ids = group.all_gather_host(torch.tensor(self.engine.slot_ids,
                                                 dtype=torch.int64))
        self.lane_ids = [int(i) for i in ids.reshape(-1)]

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
        eng, replay, group = self.engine, self.replay, self.group
        out = eng.dispatch(ts.params)
        prios = acting_priorities(out)
        # the macro's one host read: seals and the sealed slots' counts
        counts = host_arrays({"c": torch.cat(
            [out["sealed"][:, None], out["nf"], out["nt"]], 1)})["c"]
        sealed = counts[:, 0]
        nf, nt = counts[:, 1:1 + eng.M], counts[:, 1 + eng.M:]
        sel = [(b, j) for b in range(eng.B) for j in range(int(sealed[b]))]
        delta = sum(int(nt[b, j]) for b, j in sel)
        n_sealed, sealed_max = len(sel), int(sealed.max(initial=0))
        if group is not None:
            # warm-up, anneal and budget are global: every rank's ingest
            # (one all-gather for JAX's psums and its pmax)
            got = group.all_gather_host(torch.tensor(
                [delta, n_sealed, sealed_max], dtype=torch.int64))
            delta, n_sealed = int(got[:, 0].sum()), int(got[:, 1].sum())
            sealed_max = int(got[:, 2].max())
        if sealed_max > eng.M - 1:
            raise RuntimeError(
                f"fused outbox overflow: {sealed_max} seals > "
                f"{eng.M - 1} sealed slots; raise rollout_len headroom")
        for i in range(0, len(sel), self._merge_cap):
            chunk, pr = self._merged_chunk(out, prios,
                                           sel[i:i + self._merge_cap], nf,
                                           nt)
            rs = replay.add(rs, chunk, pr)
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
                batch, weights, idx = replay.sample(rs, offsets[p], beta,
                                                    group=group)
                ts, new_prios, m = self.core.update_from_batch(
                    ts, batch, weights, group=group)
                rs = replay.update_priorities(rs, idx, new_prios)
                metrics.append(m)
                if self.ratio is not None:
                    self.budget = np.float32(
                        self.budget - np.float32(self.core.batch_size))
        else:
            mask = [False] * self.P
        info = dict(metrics=metrics, mask=mask, chunks=n_sealed,
                    transitions=delta, done=out["done"],
                    ep_ret=out["ep_ret"], ep_len=out["ep_len"])
        return ts, rs, info

    # -- host surface ------------------------------------------------------

    def dispatch(self, train_state, replay_state, offsets):
        """``steps_per_dispatch`` macro steps.  ``offsets(k)`` returns the
        per-stratum uniforms ``f32[k, batch_size / dp]`` of the macro's
        ``k = train_per_step`` sample slots, drawn for every slot whether
        it trains or not (the JAX program's pre-split sample keys).
        Returns ``(train_state, replay_state, info)``; ``info`` has the
        episode stats (every rank's, in global lane order), the mean
        metrics of the slots that trained (None when none did),
        ``train_steps``, ``transitions`` and ``frames`` (all ranks')."""
        eng = self.engine
        if self.n_dp > 1 and self.group is None:
            raise RuntimeError(f"a fused step of dp {self.n_dp} runs on a "
                               f"joined dp group (FusedStep.join)")
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
        size = int(replay_state.size)
        self.shard_sizes = [size]
        if self.group is not None:
            # every rank's tallies, in global lane order, and shard size
            tally = np.stack([done, ep_ret, ep_len]).astype(np.float64)
            rows = self.group.all_gather_host(torch.from_numpy(
                np.append(tally.reshape(-1), float(size))))
            self.shard_sizes = [int(v) for v in rows[:, -1]]
            full = np.concatenate([r[:-1].numpy().reshape(tally.shape)
                                   for r in rows], axis=-1)
            done, ep_ret, ep_len = (full[0] != 0, full[1].astype(np.float32),
                                    full[2].astype(np.int64))
        lanes = self.lane_ids
        stats = [EpisodeStat(lanes[b], float(ep_ret[m, t, b]),
                             int(ep_len[m, t, b]))
                 for m in range(self.N) for t in range(eng.T)
                 for b in range(len(lanes)) if done[m, t, b]]
        metrics = ({k[2:]: float(v.mean()) for k, v in got.items()
                    if k.startswith("m_")} if trained else None)
        transitions = sum(i["transitions"] for i in macros)
        frames = self.N * eng.T * eng.B * self.n_dp
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
                "dp": self.n_dp, "train_ratio": float(self.ratio or 0.0),
                "rollout_len": self.engine.T,
                "n_envs": self.engine.B * self.n_dp}


def check_dp_fit(batch_size: int, n_envs: int, n_dp: int) -> None:
    """Raise a ``ValueError`` naming both knobs unless the batch and the env
    lanes split evenly over ``n_dp`` ranks (``apex_tpu/ondevice/fused.py:
    126-138``)."""
    if batch_size % n_dp:
        raise ValueError(
            f"learner.batch_size={batch_size} must be divisible by the dp "
            f"axis (dp={n_dp}, from learner.mesh_shape / --mesh-dp) — raise "
            f"batch_size or shrink the mesh")
    if n_envs % n_dp:
        raise ValueError(
            f"fused dp={n_dp} shards the env lanes: B={n_envs} envs "
            f"(actor.n_actors x actor.n_envs_per_actor) % dp={n_dp} != 0 — "
            f"align --n-envs-per-actor with the mesh (--mesh-dp / "
            f"APEX_MESH_DP) so every rank gets whole lanes")


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
    """The concurrent loop (:meth:`~apex_tpu_torch.training.apex.
    ConcurrentTrainer.train`) with one :class:`FusedStep` dispatch as its
    iteration (``apex_tpu/ondevice/fused.py:512-729``); ``train()`` may
    overshoot ``total_steps`` by up to ``steps_per_dispatch *
    train_per_step - 1``.

    It reuses the :class:`ApexTrainer` substrate: model, replay and
    optimizer construction, the checkpoint bundle (the replay state is the
    on-device pool), and the loop's session, cadence and log.  A ``pool``
    that is given keeps its chunks flowing in: they are ingested into the
    same replay between dispatches (hybrid mode).  ``device`` defaults to
    the card.  An env without a device port refuses here, naming its id.  A
    socket pool (the learner role's ``--rollout fused``) serves its
    evaluators and host actors this way, stamped with the learner epoch
    and republished until the first step.  The fleet plane is the
    trainer's: the fused plane beats into the registry as ``fused-0``
    (role ``rollout``, :meth:`FusedStep.counters` as gauges), a socket
    pool's learner serves ``--role status``, and the hot loop's dispatch
    gaps land on the ``learner-fused-loop`` track of the trace ring.

    With ``learner.mesh_shape`` above 1 the whole fused step is sharded
    (module docstring): this trainer is rank 0 and drives the other ranks
    of the sharded plan (``dp_backend`` for the dp group), whose trainers
    own the lane blocks ``lanes=(rank, world)`` names; the batch and the
    env lanes must split evenly over the ranks, and the ``ValueError``
    names both knobs."""

    gap_track = "learner-fused-loop"

    def __init__(self, config: ApexConfig | None = None, pool=None,
                 train_ratio: float | None = None,
                 device: torch.device | str = "cuda",
                 logdir: str | None = None, verbose: bool = False,
                 publish_min_seconds: float = 0.2,
                 min_train_ratio: float | None = None,
                 respawn_workers: bool = True,
                 checkpoint_dir: str | None = None,
                 rollout_len: int | None = None,
                 steps_per_dispatch: int = 4, train_per_step: int = 1,
                 dp_backend: str = "nccl",
                 lanes: tuple[int, int] | None = None):
        cfg = config or ApexConfig()
        # an env without a device port refuses here, before anything is
        # built on the card
        make_device_env(cfg.env.env_id, cfg.env, device="cpu")
        rank, world = lanes or (0, int(np.prod(cfg.learner.mesh_shape)))
        n_envs = max(cfg.actor.n_actors, 1) * max(
            1, cfg.actor.n_envs_per_actor)
        check_dp_fit(cfg.learner.batch_size, n_envs, world)
        super().__init__(cfg, pool=pool if pool is not None else _IdlePool(),
                         train_ratio=train_ratio, device=device,
                         logdir=logdir, verbose=verbose,
                         publish_min_seconds=publish_min_seconds,
                         min_train_ratio=min_train_ratio,
                         respawn_workers=respawn_workers,
                         checkpoint_dir=checkpoint_dir,
                         dp_backend=dp_backend)
        engine = make_anakin_engine(
            cfg, rollout_len=rollout_len, device=self.device,
            model=self.train_state.params, n_envs=n_envs // world,
            slot_band=rank, total_slots=n_envs)
        self.fused = FusedStep(
            self.core, self.replay, engine, warmup=cfg.replay.warmup,
            beta=cfg.replay.beta, beta_anneal=cfg.replay.beta_anneal,
            steps_per_dispatch=steps_per_dispatch,
            train_per_step=train_per_step, train_ratio=train_ratio,
            n_dp=world)
        # the other ranks' trainers: the same fused knobs, their lanes
        self._dp_kwargs = dict(
            rollout_len=rollout_len, steps_per_dispatch=steps_per_dispatch,
            train_per_step=train_per_step, train_ratio=train_ratio)

    @classmethod
    def _dp_follower_kwargs(cls, kwargs: dict, rank: int,
                            world: int) -> dict:
        return dict(kwargs, lanes=(rank, world))

    def _join_dp(self, group) -> None:
        super()._join_dp(group)
        self.fused.join(group)

    def _fused_offsets(self, k: int) -> torch.Tensor:
        """This rank's uniforms of ``k`` sample slots, ``f32[k, batch /
        dp]``, from its generator."""
        return self._offsets(k, self.fused._batch_chip)

    def _fused_dispatch(self) -> dict:
        self.train_state, self.replay_state, info = self.fused.dispatch(
            self.train_state, self.replay_state, self._fused_offsets)
        return info

    def _follow_op(self, msg: dict) -> None:
        op = msg["op"]
        if op == "fused":
            self.steps_rate.tick(self._fused_dispatch()["train_steps"])
            return
        super()._follow_op(msg)
        if op == "ingest":
            # a hybrid pool's chunks count toward the global counters
            self.fused.note_external_ingest(int(msg["n_trans"]))

    def _apply_dp_counters(self, counters: dict) -> None:
        super()._apply_dp_counters(counters)
        self.fused.sync_ingested(self.ingested, steps=self.steps_rate.total)

    def _open_feed(self) -> None:
        """The fused step is this loop's feed: no staging thread
        (``learner.ingest_pipeline`` does not apply).  The fused plane
        beats into the registry like AnakinPool's ondevice-0, so the
        status table shows it beside socket peers."""
        self._beat = HeartbeatEmitter(
            "fused-0", role="rollout",
            interval_s=self.cfg.comms.heartbeat_interval_s,
            gauges_fn=self.fused.counters)
        return None

    def _iteration(self, target_steps: int) -> dict | None:
        """One :class:`FusedStep` dispatch (a ``fused`` op to the other
        ranks first), its episodes into the episode log, a given pool's
        chunks ingested (hybrid; a group of one chunk per rank at dp > 1;
        the fused step owns the train cadence) and the ``fused-0`` beat.
        Returns the dispatch's metrics, or None when it trained none."""
        gap = self._dispatch_gap
        gap.about_to_dispatch()
        if self._dp is not None:
            self._dp_send("fused")
        info = self._fused_dispatch()
        gap.dispatch_returned()
        if info["train_steps"]:
            self.steps_rate.tick(info["train_steps"])
        self.ingested += info["transitions"]
        self.frames_rate.tick(info["transitions"])
        for stat in info["stats"]:
            stat.param_version = self.param_version
            self._log_episode(stat)
        for msg in self.pool.poll_chunks(64, timeout=0):
            n_new = int(msg["n_trans"])
            if self.n_dp > 1:
                parts = split_group(msg["payload"], msg["priorities"],
                                    self.n_dp)
                self._dp_dispatch("ingest", *parts[0], parts[1:], n_new)
            else:
                self.replay_state = self.core.ingest(
                    self.replay_state, msg["payload"], msg["priorities"])
            self.ingested += n_new
            self.frames_rate.tick(n_new)
            self.fused.note_external_ingest(n_new)
        self._beat.tick(info["frames"])
        hb = self._beat.maybe_beat(self.param_version)
        if hb is not None:
            self.fleet.observe(hb)
        return info["metrics"] if info["train_steps"] else None

    def fleet_summary(self) -> dict | None:
        """:meth:`ConcurrentTrainer.fleet_summary` with the fused plane's
        counters and every rank's shard size as ``metrics.ondevice``
        (``apex_tpu/ondevice/fused.py:702-715``)."""
        snap = super().fleet_summary()
        if snap is not None:
            ond = self.fused.counters()
            ond["pool_size_per_shard"] = list(
                self.fused.shard_sizes or [int(self.replay_state.size)])
            snap["metrics"]["ondevice"] = ond
        return snap

    def _apply_counters(self, meta: dict) -> None:
        super()._apply_counters(meta)
        self.fused.sync_ingested(self.ingested, steps=self.steps_rate.total)

    def apply_hparams(self, h: dict) -> dict:
        """:meth:`ConcurrentTrainer.apply_hparams`; a live lr rebuilds the
        core, which the fused step takes too (``apex_tpu/ondevice/
        fused.py:722-729``)."""
        applied = super().apply_hparams(h)
        self.fused.core = self.core
        return applied
