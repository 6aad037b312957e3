"""AQL actor worker families.

Counterpart of :mod:`apex_tpu.actors.aql` (reference
``batchrecoder_AQL.py``).  The workers run the DQN families' lifecycle
(:func:`apex_tpu_torch.actors.pool.worker_loop`,
:func:`apex_tpu_torch.actors.vector.vector_worker_loop`): the epsilon
ladder, latest-wins param polls, bounded chunk backpressure.  Acting is
the proposal + candidate-scoring step on a CPU copy of the model, and
what ships is 1-step transitions that carry the candidate set ``a_mu``
with acting-time priorities:

* vector observations: :class:`~apex_tpu_torch.training.aql.
  AQLTransitionBuilder` batches, for the stacked replay;
* pixel observations: :class:`~apex_tpu_torch.replay.frame_chunks.
  FrameChunkBuilder` chunks with ``a_mu`` as a per-transition sidecar,
  for the frame pool.  The recorded ``action`` is the candidate index,
  and the chunk builder's priority ``|ret + disc * max q' - q[idx]|`` is
  the same formula over candidate scores.

Each step's draws come from an :class:`~apex_tpu_torch.models.aql.
AQLDraws` over the step's generator (``draws_from``, which a test can
replace with a source replaying JAX's keyed draws).
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.actors.vector import (VectorChunkFamilyBase,
                                          VectorFamilyBase)
from apex_tpu_torch.config import ApexConfig


def _cpu_policy(model_spec: dict, seed: int):
    from apex_tpu_torch.models.aql import AQLNetwork, make_aql_policy_fn
    model = AQLNetwork(
        **model_spec, generator=torch.Generator().manual_seed(seed)
    ).to("cpu").requires_grad_(False)
    return model, make_aql_policy_fn(model)


def _pixel_builder(cfg: ApexConfig, model, frame_shape, frame_dtype,
                   frame_stack, chunk_transitions: int):
    from apex_tpu_torch.replay.frame_chunks import FrameChunkBuilder
    return FrameChunkBuilder(
        cfg.learner.n_steps, cfg.learner.gamma, frame_stack, frame_shape,
        chunk_transitions=chunk_transitions, frame_dtype=frame_dtype,
        extra_shapes={"a_mu": (model.total_sample, model.candidate_dim)})


class _AQLActing:
    """What the four families share: a CPU model, its policy, the draw
    source and param loading."""

    def _init_policy(self, model_spec: dict, seed: int) -> None:
        from apex_tpu_torch.models.aql import AQLDraws
        self.model, self.policy = _cpu_policy(model_spec, seed)
        self.draws_from = AQLDraws

    def load_params(self, params) -> None:
        from apex_tpu_torch.models.dueling import load_host_params
        load_host_params(self.model, params)

    def _act(self, obs: np.ndarray, epsilon, generator) -> tuple:
        """The policy on a batch of observations; host arrays out."""
        out = self.policy(torch.from_numpy(obs), epsilon,
                          self.draws_from(generator))
        return tuple(x.numpy() for x in out)


class AQLWorkerFamily(_AQLActing):
    """Scalar AQL acting for ``worker_loop``: one vector-observation env,
    1-step transitions with their candidate sets."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seed: int,
                 chunk_transitions: int):
        from apex_tpu_torch.envs.registry import make_env
        from apex_tpu_torch.training.aql import AQLTransitionBuilder

        self.seed = seed
        self.env = make_env(cfg.env.env_id, cfg.env, seed=seed,
                            max_episode_steps=cfg.actor.max_episode_length)
        self._init_policy(model_spec, seed)
        self.builder = AQLTransitionBuilder(cfg.learner.gamma)
        self.chunk_transitions = chunk_transitions
        self._obs = None

    def begin_episode(self, obs) -> None:
        self._obs = np.asarray(obs)

    def step(self, epsilon: float, generator: torch.Generator):
        """One env step; returns ``(next_obs, reward, terminated,
        truncated)``."""
        obs = self._obs
        actions, idx, a_mu, q = self._act(obs[None], epsilon, generator)
        next_obs, reward, term, trunc, _ = self.env.step(actions[0])
        self.builder.add_step(obs, int(idx[0]), float(reward),
                              np.asarray(next_obs), a_mu[0], q[0],
                              bool(term), bool(trunc))
        self._obs = np.asarray(next_obs)
        return next_obs, float(reward), bool(term), bool(trunc)

    def poll_msgs(self) -> list[dict]:
        return _drain_transitions([self.builder], self.chunk_transitions)


def _drain_transitions(builders, count: int) -> list[dict]:
    out = []
    for builder in builders:
        while len(builder) >= count:
            batch, prios = builder.drain(count)
            out.append({"payload": batch, "priorities": prios,
                        "n_trans": len(prios)})
    return out


class AQLPixelWorkerFamily(_AQLActing):
    """Frame-pool AQL acting for image observations: an un-stacked env and
    a FrameChunkBuilder whose chunks carry ``a_mu`` as a sidecar."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seed: int,
                 chunk_transitions: int):
        from apex_tpu_torch.envs.registry import make_env, unstacked_env_spec

        self.seed = seed
        self.env = make_env(cfg.env.env_id, cfg.env, seed=seed,
                            max_episode_steps=cfg.actor.max_episode_length)
        self._init_policy(model_spec, seed)
        self.builder = _pixel_builder(cfg, self.model,
                                      *unstacked_env_spec(self.env, cfg.env),
                                      chunk_transitions)

    def begin_episode(self, obs) -> None:
        self.builder.begin_episode(obs)

    def step(self, epsilon: float, generator: torch.Generator):
        stack = self.builder.current_stack()
        actions, idx, a_mu, q = self._act(stack[None], epsilon, generator)
        next_obs, reward, term, trunc, _ = self.env.step(actions[0])
        self.builder.add_step(int(idx[0]), float(reward), q[0], next_obs,
                              bool(term), bool(trunc),
                              extras={"a_mu": a_mu[0]})
        return next_obs, float(reward), bool(term), bool(trunc)

    def poll_msgs(self) -> list[dict]:
        from apex_tpu_torch.replay.frame_chunks import drain_builder_chunks
        return drain_builder_chunks(self.builder)


def aql_worker_main(actor_id: int, cfg: ApexConfig, model_spec: dict,
                    chunk_queue, param_queue, stat_queue, stop_event,
                    epsilon: float, chunk_transitions: int) -> None:
    """Scalar AQL worker process body."""
    from apex_tpu_torch.actors.pool import worker_loop

    cls = (AQLPixelWorkerFamily if model_spec.get("obs_is_image")
           else AQLWorkerFamily)
    family = cls(cfg, model_spec, seed=cfg.env.seed + 1000 * (actor_id + 1),
                 chunk_transitions=chunk_transitions)
    worker_loop(actor_id, cfg, family, chunk_queue, param_queue, stat_queue,
                stop_event, epsilon)


class VectorAQLWorkerFamily(_AQLActing, VectorFamilyBase):
    """B-env AQL acting: one batched propose + score per half-group over
    contiguous rows of one ``[B, *obs]`` acting buffer, per-slot
    transition builders."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seeds, slot_ids,
                 epsilons, chunk_transitions: int):
        from apex_tpu_torch.training.aql import AQLTransitionBuilder

        VectorFamilyBase.__init__(self, cfg, seeds, slot_ids, epsilons)
        space = self.envs[0].observation_space
        self._acting = np.zeros((self.n_envs,) + tuple(space.shape),
                                space.dtype)
        self._init_policy(model_spec, self.seeds[0])
        self.builders = [AQLTransitionBuilder(cfg.learner.gamma)
                         for _ in range(self.n_envs)]
        self.chunk_transitions = chunk_transitions

    def _make_env(self, seed: int):
        from apex_tpu_torch.envs.registry import make_env
        return make_env(self.cfg.env.env_id, self.cfg.env, seed=seed,
                        max_episode_steps=self.cfg.actor.max_episode_length)

    def _on_reset(self, i: int, obs) -> None:
        self._acting[i] = np.asarray(obs)

    def _policy_group(self, sl: slice, eps: torch.Tensor,
                      generator: torch.Generator) -> tuple:
        return self._act(self._acting[sl], eps, generator)

    def _step_group(self, sl: slice, host: tuple, stats: list) -> None:
        actions, idx, a_mu, q = host
        for j, i in enumerate(range(sl.start, sl.stop)):
            # the builder keeps obs past this step: a copy, not the row
            obs = self._acting[i].copy()
            next_obs, reward, term, trunc, _ = self.envs[i].step(actions[j])
            self.builders[i].add_step(obs, int(idx[j]), float(reward),
                                      np.asarray(next_obs), a_mu[j], q[j],
                                      bool(term), bool(trunc))
            self._acting[i] = np.asarray(next_obs)
            self._finish_step(i, float(reward), bool(term or trunc), stats)

    def poll_msgs(self) -> list[dict]:
        return _drain_transitions(self.builders, self.chunk_transitions)


class VectorAQLPixelWorkerFamily(_AQLActing, VectorChunkFamilyBase):
    """B-env frame-pool AQL acting: batched propose + score over each
    half-group's rows of the in-place acting buffer, per-slot chunk
    builders with ``a_mu`` sidecars."""

    def __init__(self, cfg: ApexConfig, model_spec: dict, seeds, slot_ids,
                 epsilons, chunk_transitions: int):
        from apex_tpu_torch.envs.registry import unstacked_env_spec

        VectorChunkFamilyBase.__init__(self, cfg, seeds, slot_ids, epsilons)
        self._init_policy(model_spec, self.seeds[0])
        spec = unstacked_env_spec(self.envs[0], cfg.env)
        self.builders = [_pixel_builder(cfg, self.model, *spec,
                                        chunk_transitions)
                         for _ in range(self.n_envs)]
        self._bind_acting_buffer()

    def _policy_group(self, sl: slice, eps: torch.Tensor,
                      generator: torch.Generator) -> tuple:
        return self._act(self._acting[sl], eps, generator)

    def _step_group(self, sl: slice, host: tuple, stats: list) -> None:
        actions, idx, a_mu, q = host
        for j, i in enumerate(range(sl.start, sl.stop)):
            next_obs, reward, term, trunc, _ = self.envs[i].step(actions[j])
            self.builders[i].add_step(int(idx[j]), float(reward), q[j],
                                      next_obs, bool(term), bool(trunc),
                                      extras={"a_mu": a_mu[j]})
            self._finish_step(i, float(reward), bool(term or trunc), stats)


def vector_aql_worker_main(actor_id: int, cfg: ApexConfig, model_spec: dict,
                           chunk_queue, param_queue, stat_queue, stop_event,
                           epsilon: float, chunk_transitions: int) -> None:
    """B-env AQL worker body (``epsilon`` ignored: the slots take theirs
    from the fleet-wide ladder, as every vector family does)."""
    from apex_tpu_torch.actors.vector import vector_worker_loop, worker_slots

    slot_ids, seeds, epsilons = worker_slots(cfg, actor_id)
    cls = (VectorAQLPixelWorkerFamily if model_spec.get("obs_is_image")
           else VectorAQLWorkerFamily)
    family = cls(cfg, model_spec, seeds=seeds, slot_ids=slot_ids,
                 epsilons=epsilons, chunk_transitions=chunk_transitions)
    vector_worker_loop(actor_id, cfg, family, chunk_queue, param_queue,
                       stat_queue, stop_event)


vector_aql_worker_main.is_vector = True     # ActorPool guard marker
