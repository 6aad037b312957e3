"""Recurrent (R2D2) actor messages and worker families.

Counterpart of :mod:`apex_tpu.actors.r2d2`.  The workers run the same
lifecycle as the DQN families (:func:`apex_tpu_torch.actors.pool.
worker_loop`, :func:`apex_tpu_torch.actors.vector.vector_worker_loop`):
the epsilon ladder, latest-wins param polls, bounded chunk backpressure.
What ships differs: overlapping fixed-length sequences with the policy's
stored recurrent state at each sequence start and acting-time insert
priorities (:class:`apex_tpu_torch.training.r2d2.SequenceBuilder`),
``group`` sequences per message so every message has one fixed shape.

The carry is worker-local: it threads through the episode, resets at
episode boundaries, and only its stride-aligned snapshots go into the
builder (its ``needs_carry`` gate).  A model fed the previous action and
reward (``r2d2.prev_action_reward``) gets them beside the carry, zeros at
an episode's first step, and the builder records them at each sequence
start.  Each message carries a lineage span in its metadata
(:func:`drain_grouped`).
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.actors.vector import VectorFamilyBase, group_generator
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.models.recurrent import initial_prev


def sequence_message(seqs: list[dict]) -> dict:
    """Stack ``group`` drained sequences into one fixed-shape message of
    the stacked layout.  ``n_trans`` sums the sequences' ``n_new`` (env
    steps new to each sequence against its overlapping predecessors), so
    transition-denominated gates count each env step once."""
    prios = np.stack([s.pop("priority") for s in seqs])
    n_new = sum(s.pop("n_new") for s in seqs)
    payload = {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}
    return {"payload": payload, "priorities": prios, "n_trans": int(n_new)}


def pooled_sequence_message(seqs: list[dict]) -> dict:
    """Pack ``group`` drained pooled sequences (``SequenceBuilder(...,
    pooled=True)``) into one fixed-shape message for
    :meth:`apex_tpu_torch.replay.seq_pool.SequenceFramePoolReplay.add`.

    Each referenced frame ships once: windows over one episode share its
    frame array, so the union ``[min start, max end)`` of each episode is
    packed once.  ``frames`` is ``[G*T + 1, D]`` with ``n_frames`` real
    rows; row 0 is the all-zero frame every padded position references
    and rows past ``n_frames`` stay zero.  ``obs_ref [G, T]`` indexes
    ``frames``; ``n_trans`` sums ``n_new`` as :func:`sequence_message`
    does."""
    g = len(seqs)
    t_total = seqs[0]["action"].shape[0]
    frame_shape = seqs[0]["ep_frames"].shape[1:]
    d = int(np.prod(frame_shape))
    kf_max = g * t_total + 1
    prios = np.stack([s.pop("priority") for s in seqs])
    n_new = sum(s.pop("n_new") for s in seqs)

    # union coverage per episode array, keyed by identity: the builder
    # hands every window over one episode the same ndarray
    episodes: dict[int, list] = {}
    for s in seqs:
        k = id(s["ep_frames"])
        e = episodes.get(k)
        if e is None:
            episodes[k] = [s["ep_frames"], s["start"], s["end"]]
        else:
            e[1] = min(e[1], s["start"])
            e[2] = max(e[2], s["end"])

    frames = np.zeros((kf_max, d), seqs[0]["ep_frames"].dtype)
    base: dict[int, int] = {}
    off = 1                          # row 0: the shared zero pad frame
    for k, (arr, lo, hi) in episodes.items():
        n = hi - lo
        frames[off:off + n] = arr[lo:hi].reshape(n, d)
        base[k] = off - lo           # message row of episode frame `lo`
        off += n
    # off <= kf_max: a pooled builder refuses stride > t_total, so the
    # coverage is at most t_total rows per sequence

    obs_ref = np.zeros((g, t_total), np.int32)
    for i, s in enumerate(seqs):
        ln = s["end"] - s["start"]
        b = base[id(s.pop("ep_frames"))]
        obs_ref[i, :ln] = b + s.pop("start") + np.arange(ln, dtype=np.int32)
        s.pop("end")                 # the padded tail keeps ref 0

    payload = dict(
        frames=frames, n_frames=np.int32(off), n_seqs=np.int32(g),
        obs_ref=obs_ref,
        **{k: np.stack([s[k] for s in seqs]) for k in seqs[0]})
    return {"payload": payload, "priorities": prios, "n_trans": int(n_new)}


def drain_grouped(ready: list[dict], group: int,
                  message_fn=sequence_message) -> list[dict]:
    """Pop full groups of ``group`` sequences off ``ready`` (in place) as
    fixed-shape messages made by ``message_fn``; a partial group stays
    for the next drain.  Shared by the worker families and the
    single-process driver.  Each message is born with its lineage span
    (``sealed`` hop) in its metadata, as a frame chunk's is."""
    from apex_tpu_torch.obs import spans as obs_spans

    stamped = obs_spans.enabled()
    out = []
    while len(ready) >= group:
        take, ready[:] = ready[:group], ready[group:]
        msg = message_fn(take)
        if stamped:
            msg[obs_spans.SPAN_KEY] = [obs_spans.new_span(hop="sealed")]
        out.append(msg)
    return out


def _sequence_builder(cfg: ApexConfig, obs_shape):
    """(builder factory, message function) of the layout
    :func:`~apex_tpu_torch.training.r2d2.r2d2_uses_frame_pool` picks, the
    predicate the learner's replay is built by."""
    from apex_tpu_torch.training.r2d2 import (SequenceBuilder,
                                              r2d2_rescale_eps,
                                              r2d2_uses_frame_pool)

    pooled = r2d2_uses_frame_pool(cfg, obs_shape)
    rc, lc = cfg.r2d2, cfg.learner

    def make():
        return SequenceBuilder(rc.burn_in, rc.unroll, lc.n_steps, lc.gamma,
                               stride=rc.stride, pooled=pooled,
                               prev_inputs=rc.prev_action_reward,
                               rescale_eps=r2d2_rescale_eps(cfg))

    return make, (pooled_sequence_message if pooled else sequence_message)


def _cpu_model(model_spec: dict, seed: int):
    from apex_tpu_torch.models.recurrent import (RecurrentDuelingDQN,
                                                 make_recurrent_policy_fn)
    model = RecurrentDuelingDQN(
        **model_spec, generator=torch.Generator().manual_seed(seed)
    ).to("cpu").requires_grad_(False)
    return model, make_recurrent_policy_fn(model)


class R2D2WorkerFamily:
    """Recurrent acting and recording for :func:`~apex_tpu_torch.actors.
    pool.worker_loop`: one env, a CPU copy of the model, a carry threaded
    through the episode."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seed: int,
                 group: int):
        from apex_tpu_torch.envs.registry import make_env

        self.seed = seed
        self.env = make_env(cfg.env.env_id, cfg.env, seed=seed,
                            max_episode_steps=cfg.actor.max_episode_length)
        self.model, self.policy = _cpu_model(model_spec, seed)
        make_builder, self.message_fn = _sequence_builder(
            cfg, self.env.observation_space.shape)
        self.builder = make_builder()
        self.group = group
        self.carry = self.model.initial_state(1)
        self.prev = initial_prev(self.model, 1)
        self._obs = None
        self._ready: list[dict] = []

    def load_params(self, params) -> None:
        from apex_tpu_torch.models.dueling import load_host_params
        load_host_params(self.model, params)

    def begin_episode(self, obs) -> None:
        self._obs = np.asarray(obs)
        self.carry = self.model.initial_state(1)
        self.prev = initial_prev(self.model, 1)

    def step(self, epsilon: float, generator: torch.Generator):
        """One env step with the carry that produced its action; returns
        ``(next_obs, reward, terminated, truncated)``."""
        obs = self._obs
        cc = ch = None
        if self.builder.needs_carry:
            cc, ch = (t[0].numpy().copy() for t in self.carry)
        actions, q, self.carry = self.policy(torch.from_numpy(obs[None]),
                                             self.carry, epsilon, generator,
                                             self.prev)
        action = int(actions[0])
        next_obs, reward, term, trunc, _ = self.env.step(action)
        if self.prev is not None:
            self.prev = (actions.long(),
                         torch.full_like(self.prev[1], float(reward)))
        self.builder.add_step(obs, action, float(reward), bool(term), cc, ch,
                              q_values=q[0].numpy())
        if term or trunc:
            self.builder.end_episode(truncated=bool(trunc and not term))
            self._ready.extend(self.builder.drain())
        self._obs = np.asarray(next_obs)
        return next_obs, float(reward), bool(term), bool(trunc)

    def poll_msgs(self) -> list[dict]:
        return drain_grouped(self._ready, self.group, self.message_fn)


def r2d2_worker_main(actor_id: int, cfg: ApexConfig, model_spec: dict,
                     chunk_queue, param_queue, stat_queue, stop_event,
                     epsilon: float, chunk_transitions: int) -> None:
    """Scalar recurrent worker body; the pool's ``chunk_transitions`` is
    the sequence group per message."""
    from apex_tpu_torch.actors.pool import worker_loop

    family = R2D2WorkerFamily(cfg, model_spec,
                              seed=cfg.env.seed + 1000 * (actor_id + 1),
                              group=chunk_transitions)
    worker_loop(actor_id, cfg, family, chunk_queue, param_queue, stat_queue,
                stop_event, epsilon)


class VectorR2D2WorkerFamily(VectorFamilyBase):
    """B-env recurrent acting: one batched policy call per vector step
    advances the ``[B, H]`` carries in lockstep, per-slot builders cut the
    windows, and a slot's carry row zeroes on its episode reset.  The
    carry cannot be split between two half-groups, so this family runs
    one group, whatever ``ActorConfig.double_buffer`` says, and reports
    ``double_buffer`` False."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seeds, slot_ids,
                 epsilons, group: int):
        super().__init__(cfg, seeds, slot_ids, epsilons)
        self.double_buffer = False
        self.model, self.policy = _cpu_model(model_spec, self.seeds[0])
        self.carry = self.model.initial_state(self.n_envs)
        self.prev = initial_prev(self.model, self.n_envs)
        make_builder, self.message_fn = _sequence_builder(
            cfg, self.envs[0].observation_space.shape)
        self.builders = [make_builder() for _ in range(self.n_envs)]
        self.group = group
        self._obs: list = [None] * self.n_envs
        self._ready: list[dict] = []

    def _make_env(self, seed: int):
        from apex_tpu_torch.envs.registry import make_env
        return make_env(self.cfg.env.env_id, self.cfg.env, seed=seed,
                        max_episode_steps=self.cfg.actor.max_episode_length)

    def _on_reset(self, i: int, obs) -> None:
        self._obs[i] = np.asarray(obs)
        for t in self.carry:
            t[i] = 0.0
        for t in self.prev or ():
            t[i] = 0

    def load_params(self, params) -> None:
        from apex_tpu_torch.models.dueling import load_host_params
        load_host_params(self.model, params)

    def step_all(self, seed: int) -> list:
        """One vector step over all B slots, the policy drawing from the
        step's group-0 generator; returns stats of ended episodes."""
        obs = np.stack(self._obs)
        need = [b.needs_carry for b in self.builders]
        if any(need):               # copies: a reset zeroes rows in place
            cc_all, ch_all = (t.numpy().copy() for t in self.carry)
        eps = torch.from_numpy(np.asarray(self._current_eps(), np.float32))
        self.gap.about_to_dispatch()
        with self.phase.phase("policy_wait"):
            actions, q, self.carry = self.policy(
                torch.from_numpy(obs), self.carry, eps,
                group_generator(seed, 0), self.prev)
            if self.prev is not None:
                # this step's action; its rewards are written below
                self.prev = (actions.long().clone(), self.prev[1].clone())
            actions, q = actions.numpy(), q.numpy()
        self.gap.dispatch_returned()
        stats: list = []
        with self.phase.phase("env_step"):
            for i, env in enumerate(self.envs):
                a = int(actions[i])
                next_obs, reward, term, trunc, _ = env.step(a)
                if self.prev is not None:
                    self.prev[1][i] = float(reward)
                self.builders[i].add_step(
                    obs[i], a, float(reward), bool(term),
                    cc_all[i] if need[i] else None,
                    ch_all[i] if need[i] else None, q_values=q[i])
                if term or trunc:
                    self.builders[i].end_episode(
                        truncated=bool(trunc and not term))
                    self._ready.extend(self.builders[i].drain())
                else:
                    self._obs[i] = np.asarray(next_obs)
                # on done the auto-reset calls _on_reset: obs, carry row
                self._finish_step(i, float(reward), bool(term or trunc),
                                  stats)
        return stats

    def poll_msgs(self) -> list[dict]:
        return drain_grouped(self._ready, self.group, self.message_fn)


def vector_r2d2_worker_main(actor_id: int, cfg: ApexConfig,
                            model_spec: dict, chunk_queue, param_queue,
                            stat_queue, stop_event, epsilon: float,
                            chunk_transitions: int) -> None:
    """B-env recurrent worker body (``epsilon`` ignored: the slots take
    theirs from the fleet-wide ladder, as every vector family does)."""
    from apex_tpu_torch.actors.vector import vector_worker_loop, worker_slots

    slot_ids, seeds, epsilons = worker_slots(cfg, actor_id)
    family = VectorR2D2WorkerFamily(cfg, model_spec, seeds=seeds,
                                    slot_ids=slot_ids, epsilons=epsilons,
                                    group=chunk_transitions)
    vector_worker_loop(actor_id, cfg, family, chunk_queue, param_queue,
                       stat_queue, stop_event)


vector_r2d2_worker_main.is_vector = True     # ActorPool guard marker
