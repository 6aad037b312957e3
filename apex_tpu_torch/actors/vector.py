"""Vector actor workers: B envs per process behind one batched policy call.

Counterpart of :mod:`apex_tpu.actors.vector`.  Semantics per env slot are
those of the scalar worker (:mod:`apex_tpu_torch.actors.pool`): each slot
has its own env, seed, :class:`~apex_tpu_torch.replay.frame_chunks.FrameChunkBuilder`
and epsilon from the global Ape-X ladder, which spans all
``n_actors * n_envs_per_actor`` slots; params are polled every
``update_interval`` env steps (``update_interval / B`` vector steps);
episode stats carry the global slot id.  Chunks of all slots share the
process's bounded queue.

The B slots split into two half-groups.  Each vector step draws one seed
from the worker's ``torch.Generator`` and each group derives its own
generator from that seed and its group id (:func:`group_generator`, the
port's ``fold_in(step_key, group)``).  Each group runs its policy, then
steps its envs, one group after the other, whatever
``ActorConfig.double_buffer`` says.  In JAX that knob overlaps one
group's env steps with the other group's asynchronously dispatched
inference (``vector.py:163-174``); eager CPU torch has no asynchronous
dispatch, and a helper thread running one group's policy while this
thread steps the other group's envs measured slower than the serial
interleave on the card's host (``chip_smoke.py``, PERF.md, PR 3), so
the port keeps the group split and the per-group generators, and the
flag only rides along in :class:`~apex_tpu_torch.actors.pool.ActorTimingStat`.
Actions, chunks and priorities per slot are the same in both modes.

Acting stacks live in one ``[B, *stacked]`` buffer whose rows the
builders maintain in place.  Each step's wall time is split into
policy-wait, env-step and drain phases and shipped every
``timing_interval`` vector steps as an
:class:`~apex_tpu_torch.actors.pool.ActorTimingStat`.  Remote policy
(the JAX inference service) is not ported.
"""

from __future__ import annotations

import math
import queue as queue_lib

import numpy as np
import torch

from apex_tpu_torch.actors.pool import (ActorTimingStat, EpisodeStat,
                                        _first_params, _latest_params,
                                        actor_epsilons)
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.utils.profiling import DispatchGapTimer, PhaseTimer

_GOLDEN = 0x9E3779B97F4A7C15


def group_generator(step_seed: int, group: int) -> torch.Generator:
    """The half-group's generator for one vector step."""
    return torch.Generator().manual_seed(
        (step_seed + _GOLDEN * (group + 1)) % 2 ** 64)


def step_seed(generator: torch.Generator) -> int:
    """One vector step's seed from the worker's generator."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


class VectorFamilyBase:
    """Slot bookkeeping, the per-slot epsilon anneal, episode accounting
    with auto-reset and the two-group step shared by B-env families.
    Subclasses provide ``_make_env(seed)``, ``_on_reset(i, obs)``,
    ``_policy_group`` and ``_step_group``."""

    def __init__(self, cfg: ApexConfig, seeds, slot_ids, epsilons):
        self.cfg = cfg
        self.seeds = list(seeds)
        self.slot_ids = list(slot_ids)
        self.epsilons = np.asarray(epsilons, np.float32)
        self.n_envs = len(self.seeds)
        if not (self.n_envs == len(self.slot_ids) == len(self.epsilons)):
            raise ValueError(
                f"vector worker slot arity mismatch: {len(self.seeds)} "
                f"seeds, {len(self.slot_ids)} slot_ids, "
                f"{len(self.epsilons)} epsilons; all three derive from "
                f"ActorConfig.n_envs_per_actor x ActorConfig.n_actors "
                f"(see worker_slots)")
        self.envs = [self._make_env(s) for s in self.seeds]
        self.ep_reward = np.zeros(self.n_envs, np.float64)
        self.ep_len = np.zeros(self.n_envs, np.int64)
        self.slot_steps = np.zeros(self.n_envs, np.int64)
        half = (self.n_envs + 1) // 2
        self.groups = [sl for sl in (slice(0, half), slice(half, self.n_envs))
                       if sl.stop > sl.start]
        # reported only: both modes run the serial interleave (docstring)
        self.double_buffer = cfg.actor.double_buffer and len(self.groups) == 2
        self._eps_cache: list | None = None
        self.phase = PhaseTimer()
        self.gap = DispatchGapTimer()

    def reset_all(self) -> None:
        for i, (env, seed) in enumerate(zip(self.envs, self.seeds)):
            obs, _ = env.reset(seed=seed)
            self._on_reset(i, obs)

    def close(self) -> None:
        for env in self.envs:
            env.close()

    # -- the two-group vector step -----------------------------------------

    def step_all(self, seed: int) -> list:
        """One vector step over all B slots under the step seed ``seed``:
        each group's policy, then its env steps.  Returns stats of slots
        whose episodes ended (those auto-reset)."""
        stats: list = []
        for g, (sl, eps) in enumerate(zip(self.groups, self._group_eps())):
            self.gap.about_to_dispatch()
            with self.phase.phase("policy_wait"):
                out = self._policy_group(sl, eps, group_generator(seed, g))
            self.gap.dispatch_returned()
            with self.phase.phase("env_step"):
                self._step_group(sl, out, stats)
        return stats

    def _group_eps(self) -> list:
        """Per-group epsilon tensors; cached while the anneal is off (the
        ladder is then constant)."""
        if not self.cfg.actor.eps_anneal_steps:
            if self._eps_cache is None:
                self._eps_cache = [torch.from_numpy(self.epsilons[sl].copy())
                                   for sl in self.groups]
            return self._eps_cache
        eps = self._current_eps()
        return [torch.from_numpy(eps[sl].copy()) for sl in self.groups]

    def _policy_group(self, sl: slice, eps: torch.Tensor,
                      generator: torch.Generator) -> tuple:
        """Run the policy for the slots in ``sl``; returns host arrays."""
        raise NotImplementedError

    def _step_group(self, sl: slice, host: tuple, stats: list) -> None:
        """Step the envs in ``sl`` with the group's policy outputs and
        record per-slot transitions."""
        raise NotImplementedError

    def _current_eps(self) -> np.ndarray:
        anneal = self.cfg.actor.eps_anneal_steps
        if not anneal:
            return self.epsilons
        decay = np.exp(-self.slot_steps / anneal)
        return (self.epsilons + (1.0 - self.epsilons) * decay).astype(
            np.float32)

    def _finish_step(self, i: int, reward: float, done: bool,
                     stats: list) -> None:
        """Per-slot accounting and auto-reset; an ended episode appends an
        EpisodeStat with the global slot id."""
        self.ep_reward[i] += reward
        self.ep_len[i] += 1
        self.slot_steps[i] += 1
        if done:
            stats.append(EpisodeStat(self.slot_ids[i],
                                     float(self.ep_reward[i]),
                                     int(self.ep_len[i])))
            self.ep_reward[i] = 0.0
            self.ep_len[i] = 0
            obs, _ = self.envs[i].reset()
            self._on_reset(i, obs)


class VectorChunkFamilyBase(VectorFamilyBase):
    """B-env families that record through per-slot FrameChunkBuilders:
    un-stacked envs, builder-maintained acting stacks in one buffer, and
    chunk-message draining."""

    builders: list            # set by subclass __init__

    def _make_env(self, seed: int):
        from apex_tpu_torch.envs.registry import make_env
        return make_env(self.cfg.env.env_id, self.cfg.env, seed=seed,
                        max_episode_steps=self.cfg.actor.max_episode_length)

    def _on_reset(self, i: int, obs) -> None:
        self.builders[i].begin_episode(obs)

    def _bind_acting_buffer(self) -> None:
        """One contiguous ``[B, *stacked]`` acting buffer whose rows the
        builders maintain in place; the policy reads group slices of it
        without a copy."""
        stacked = self.builders[0].stacked_shape()
        self._acting = np.zeros((self.n_envs,) + stacked,
                                self.builders[0].frame_dtype)
        for i, builder in enumerate(self.builders):
            builder.bind_acting_view(self._acting[i])

    def poll_msgs(self) -> list[dict]:
        from apex_tpu_torch.replay.frame_chunks import drain_builder_chunks
        out = []
        for builder in self.builders:
            out.extend(drain_builder_chunks(builder))
        return out


class VectorDQNWorkerFamily(VectorChunkFamilyBase):
    """B-env DQN acting and recording: the vector counterpart of
    :class:`apex_tpu_torch.actors.pool.DQNWorkerFamily`."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seeds,
                 slot_ids, epsilons, chunk_transitions: int):
        from apex_tpu_torch.envs.registry import unstacked_env_spec
        from apex_tpu_torch.models.dueling import DuelingDQN, make_policy_fn
        from apex_tpu_torch.replay.frame_chunks import FrameChunkBuilder

        super().__init__(cfg, seeds, slot_ids, epsilons)
        frame_shape, frame_dtype, frame_stack = unstacked_env_spec(
            self.envs[0], cfg.env)
        self.model = DuelingDQN(
            **model_spec, generator=torch.Generator().manual_seed(
                self.seeds[0])).to("cpu").requires_grad_(False)
        self.policy = make_policy_fn(self.model)
        self.builders = [
            FrameChunkBuilder(
                cfg.learner.n_steps, cfg.learner.gamma, frame_stack,
                frame_shape, chunk_transitions=chunk_transitions,
                frame_dtype=frame_dtype)
            for _ in range(self.n_envs)]
        self._bind_acting_buffer()

    def load_params(self, params) -> None:
        from apex_tpu_torch.models.dueling import load_host_params
        load_host_params(self.model, params)

    def _policy_group(self, sl: slice, eps: torch.Tensor,
                      generator: torch.Generator) -> tuple:
        actions, q = self.policy(torch.from_numpy(self._acting[sl]), eps,
                                 generator)
        return actions.numpy(), q.numpy()

    def _step_group(self, sl: slice, host: tuple, stats: list) -> None:
        actions, q = host
        for j, i in enumerate(range(sl.start, sl.stop)):
            a = int(actions[j])
            next_obs, reward, term, trunc, _ = self.envs[i].step(a)
            self.builders[i].add_step(a, float(reward), q[j], next_obs,
                                      bool(term), bool(trunc))
            self._finish_step(i, float(reward), bool(term or trunc), stats)


def _timing_stat(actor_id: int, family, steps_window: int) -> ActorTimingStat:
    """One ActorTimingStat from the family's timers, resetting the phase
    window (``dropped_stats`` is stamped by the put loop)."""
    w = family.phase.window(reset=True)
    fr = w["fracs"]
    return ActorTimingStat(
        actor_id=actor_id,
        frames_per_sec=round(steps_window * family.n_envs / w["wall_s"], 1),
        policy_wait_frac=round(fr.get("policy_wait", 0.0), 4),
        env_step_frac=round(fr.get("env_step", 0.0), 4),
        drain_frac=round(fr.get("drain", 0.0), 4),
        dispatch_gap_ms_p50=family.gap.snapshot()["dispatch_gap_ms_p50"],
        vector_steps=steps_window,
        double_buffer=family.double_buffer)


def vector_worker_loop(actor_id: int, cfg: ApexConfig, family, chunk_queue,
                       param_queue, stat_queue, stop_event) -> None:
    """The scalar worker's lifecycle over B env slots, plus the periodic
    :class:`~apex_tpu_torch.actors.pool.ActorTimingStat`."""
    generator = torch.Generator().manual_seed(family.seeds[0])
    version = _first_params(param_queue, stop_event, family)
    if version is None:
        family.close()
        return
    # poll cadence in vector steps, so staleness in env frames matches
    # the scalar worker's update_interval
    poll_every = max(1, math.ceil(cfg.actor.update_interval / family.n_envs))
    timing_every = max(0, cfg.actor.timing_interval)
    steps_since_poll = 0
    vec_steps = 0
    dropped = 0
    family.reset_all()
    family.phase.window(reset=True)   # windows start at the loop
    while not stop_event.is_set():
        steps_since_poll += 1
        if steps_since_poll >= poll_every:
            steps_since_poll = 0
            version = _latest_params(param_queue, version, family)
        stats = family.step_all(step_seed(generator))
        vec_steps += 1
        if timing_every and vec_steps % timing_every == 0:
            stats.append(_timing_stat(actor_id, family, timing_every))
        for stat in stats:
            if isinstance(stat, EpisodeStat):
                stat.param_version = version
            stat.dropped_stats = dropped
            try:
                stat_queue.put_nowait(stat)
                dropped = 0
            except queue_lib.Full:
                dropped += 1
        with family.phase.phase("drain"):
            for msg in family.poll_msgs():
                chunk_queue.put(("chunk", actor_id, msg))    # blocks when full
    family.close()


def worker_slots(cfg: ApexConfig, actor_id: int):
    """``(slot_ids, seeds, epsilons)`` of one vector worker: worker ``i``
    owns the contiguous band ``[i*B, (i+1)*B)`` of the fleet-wide ladder,
    with the seeds scalar workers of those ids would use."""
    b = cfg.actor.n_envs_per_actor
    total = cfg.actor.n_actors * b
    ladder = actor_epsilons(total, cfg.actor.eps_base, cfg.actor.eps_alpha)
    slot_ids = list(range(actor_id * b, (actor_id + 1) * b))
    seeds = [cfg.env.seed + 1000 * (s + 1) for s in slot_ids]
    return slot_ids, seeds, ladder[slot_ids]


def vector_worker_main(actor_id: int, cfg: ApexConfig, model_spec: dict,
                       chunk_queue, param_queue, stat_queue, stop_event,
                       epsilon: float, chunk_transitions: int) -> None:
    """Vector worker process body, with the pool's scalar signature:
    ``epsilon`` is ignored, the family takes its slots' epsilons from the
    fleet-wide ladder (:func:`worker_slots`)."""
    slot_ids, seeds, epsilons = worker_slots(cfg, actor_id)
    family = VectorDQNWorkerFamily(
        cfg, model_spec, seeds=seeds, slot_ids=slot_ids, epsilons=epsilons,
        chunk_transitions=chunk_transitions)
    vector_worker_loop(actor_id, cfg, family, chunk_queue, param_queue,
                       stat_queue, stop_event)


vector_worker_main.is_vector = True     # ActorPool guard marker
