"""AQL drivers: the learner core, the transition builder, both trainers.

Counterpart of :mod:`apex_tpu.training.aql` (``aql.py:56-578``; reference
``AQL.py``, ``AQL_dis.py``):

* :class:`AQLCore` is the learner core of
  :class:`~apex_tpu_torch.training.learner.LearnerCore` (ingest, train,
  fused and multi-step dispatches) with the AQL update: the candidate-set
  Q loss and the proposal loss, each differentiated over its own parameter
  group (``torch.autograd.grad`` twice: proposal leaves take their grads
  from the proposal loss alone, every other leaf from the Q loss alone,
  ``aql.py:83-106``), then the two-group clip + Adam, the target sync and
  the priority write-back.
* :class:`AQLTransitionBuilder` ships 1-step transitions with their
  candidate set and acting-time priorities, emitted one step late.
* :func:`build_aql` wires model, replay, optimizer and core: the stacked
  :class:`~apex_tpu_torch.replay.device.DeviceReplay` with an ``a_mu``
  item, or, for pixels, the frame pool with ``a_mu`` as a per-transition
  sidecar, whose sample is the card's ``gather_stacks`` kernel.
* :class:`AQLTrainer` is the single-process driver, :class:`AQLApexTrainer`
  the concurrent one on :class:`~apex_tpu_torch.training.apex.
  ConcurrentTrainer` with the worker processes of
  :mod:`apex_tpu_torch.actors.aql` over the shm ring.

Where the JAX steps take PRNG keys, the PER sample takes per-stratum
uniforms and the NoisyNet and acting draws come from an
:class:`~apex_tpu_torch.models.aql.AQLDraws` over the learner's
``torch.Generator``.  Entry points default to ``"cuda"``.  With
``learner.mesh_shape`` above 1, :class:`AQLApexTrainer` runs the sharded
plan of :class:`~apex_tpu_torch.training.apex.ConcurrentTrainer`, each
rank drawing its NoisyNet noise from a generator of its own
(:func:`~apex_tpu_torch.parallel.mesh.per_rank_seed`, the role of JAX's
``fold_in(key, axis_index("dp"))``), whose state a checkpoint keeps for
every rank beside the shards in JAX's stacked layout; the ranks live
across ``train()`` calls until ``close()``.  The learner role
builds :class:`AQLApexTrainer` over sockets
(:func:`apex_tpu_torch.runtime.roles.run_learner`); remote policy serves
the DQN family only, as in the reference.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from apex_tpu_torch import resolve_device
from apex_tpu_torch.actors.pool import ActorPool
from apex_tpu_torch.config import ApexConfig
from apex_tpu_torch.envs.registry import (make_env, make_eval_env,
                                          unstacked_env_spec)
from apex_tpu_torch.models.aql import AQLDraws, AQLNetwork, make_aql_policy_fn
from apex_tpu_torch.ops.losses import (aql_param_groups, aql_proposal_loss,
                                       aql_q_loss, global_norm,
                                       make_aql_optimizer)
from apex_tpu_torch.ops.tree import stratified_offsets
from apex_tpu_torch.replay.base import check_hbm_budget
from apex_tpu_torch.replay.device import DeviceReplay
from apex_tpu_torch.replay.frame_chunks import FRAME_MARGIN
from apex_tpu_torch.replay.frame_pool import FramePoolReplay
from apex_tpu_torch.training.apex import ConcurrentTrainer
from apex_tpu_torch.training.checkpoint import (CheckpointableTrainer,
                                                Checkpointer,
                                                run_policy_episodes)
from apex_tpu_torch.training.dqn import BetaSchedule, EpsilonSchedule
from apex_tpu_torch.training.learner import LearnerCore, _advance
from apex_tpu_torch.training.state import TrainState
from apex_tpu_torch.utils.metrics import MetricLogger, RateCounter


@dataclass(frozen=True)
class AQLCore(LearnerCore):
    """The learner core with the AQL update (``aql.py:56-129``).
    ``draws`` supplies one online and one target NoisyNet draw per
    update."""

    entropy_coef: float = 0.01
    draws: AQLDraws | None = None

    def update_from_batch(self, train_state: TrainState, batch: dict,
                          weights: torch.Tensor, group=None):
        """Both losses -> per-group grads -> two-group clip + Adam ->
        target sync.  Returns ``(train_state, priorities, metrics)``; the
        metrics are device scalars: ``loss`` (the Q loss),
        ``loss_proposal``, ``grad_norm`` (of the merged unclipped grads),
        ``q_mean`` and ``td_mean``.

        With a dp ``group`` the q and proposal grads, both losses,
        ``q_mean`` and ``td_mean`` are meaned over its ranks in one
        all-reduce before the Adam step (``apex_tpu/training/aql.py:
        102-119``); each rank's NoisyNet draws come from its own
        ``draws``."""
        online, target = train_state.params, train_state.target_params
        online_noise = self.draws.noise(online)
        target_noise = self.draws.noise(target)
        groups = aql_param_groups(online)
        loss_q, aux = aql_q_loss(online, target, batch, weights,
                                 online_noise, target_noise)
        q_grads = list(torch.autograd.grad(loss_q, groups["q"]))
        # the argmax-Q candidate of the Q pass, under its noise draw
        loss_p = aql_proposal_loss(online, batch, aux.best_idx,
                                   self.entropy_coef)
        p_grads = list(torch.autograd.grad(loss_p, groups["proposal"]))
        loss_p = loss_p.detach()
        q_mean, td_mean = aux.q_taken.mean(), aux.td_abs.mean()
        loss_q = aux.loss
        if group is not None:
            scalars = torch.stack([loss_q, loss_p, q_mean, td_mean])
            group.all_reduce_mean_(q_grads + p_grads + [scalars])
            loss_q, loss_p, q_mean, td_mean = scalars.unbind()
        grad_norm = global_norm(q_grads + p_grads)
        self.optimizer.step(online, {"q": q_grads, "proposal": p_grads},
                            train_state.opt_state)

        _advance(train_state, self.target_update_interval)
        metrics = {"loss": loss_q, "loss_proposal": loss_p,
                   "grad_norm": grad_norm, "q_mean": q_mean,
                   "td_mean": td_mean}
        return train_state, aux.priorities, metrics


class AQLTransitionBuilder:
    """Host-side 1-step transitions with acting-time TD priorities
    (``aql.py:132-205``; reference ``batchrecoder_AQL.py:43-59``).
    Emission is one step late, so the priority ``|r + gamma * max q' -
    q[idx]|`` uses the next state's candidate scores; a truncated
    episode's last transition bootstraps its priority from the current
    state's max-Q."""

    def __init__(self, gamma: float):
        self.gamma = gamma
        self._pending = None          # (obs, idx, reward, next_obs, a_mu, q)
        self._rows: list[dict] = []

    def add_step(self, obs, idx, reward, next_obs, a_mu, q,
                 terminated: bool, truncated: bool) -> None:
        q_next_max = float(np.max(q))  # q is the CURRENT state's scores
        if self._pending is not None:
            self._emit(self._pending, bootstrap=q_next_max)
        self._pending = (np.asarray(obs), int(idx), float(reward),
                         np.asarray(next_obs), np.asarray(a_mu),
                         float(q[int(idx)]))
        if terminated:
            self._emit(self._pending, bootstrap=None, discount=0.0)
            self._pending = None
        elif truncated:
            self._emit(self._pending, bootstrap=q_next_max,
                       discount=self.gamma)
            self._pending = None

    def _emit(self, t, bootstrap, discount=None) -> None:
        obs, idx, reward, next_obs, a_mu, q_taken = t
        disc = self.gamma if discount is None else discount
        boot = 0.0 if bootstrap is None else bootstrap
        prio = abs(reward + disc * boot - q_taken) + 1e-6
        self._rows.append(dict(obs=obs, action=np.int32(idx),
                               reward=np.float32(reward), next_obs=next_obs,
                               discount=np.float32(disc), a_mu=a_mu,
                               priority=np.float32(prio)))

    def __len__(self) -> int:
        return len(self._rows)

    def drain(self, count: int) -> tuple[dict, np.ndarray]:
        rows, self._rows = self._rows[:count], self._rows[count:]
        batch = {k: np.stack([r[k] for r in rows])
                 for k in ("obs", "action", "reward", "next_obs",
                           "discount", "a_mu")}
        prios = np.asarray([r["priority"] for r in rows], np.float32)
        return batch, prios


def aql_model_spec(cfg: ApexConfig, env, obs_shape) -> dict:
    """:class:`~apex_tpu_torch.models.aql.AQLNetwork` keyword arguments
    from the config and the env's spaces (``aql.py:208-230``), picklable
    for the worker processes.  Box spaces get the Gaussian proposal,
    Discrete ones the Categorical one with ``uniform_sample`` clamped to
    the action count (``model.py:176-184``).  ``obs_shape`` is one
    stacked observation, which torch layers need up front."""
    space = env.action_space
    common = dict(
        propose_sample=cfg.aql.propose_sample,
        uniform_sample=cfg.aql.uniform_sample,
        action_var=cfg.aql.action_var,
        obs_is_image=len(env.observation_space.shape) == 3,
        compute_dtype=getattr(torch, cfg.learner.compute_dtype),
        scale_uint8=np.dtype(env.observation_space.dtype) == np.uint8,
        obs_shape=tuple(obs_shape))
    if hasattr(space, "high"):                         # Box
        return dict(action_dim=int(np.prod(space.shape)),
                    action_low=float(np.min(space.low)),
                    action_high=float(np.max(space.high)), **common)
    if not hasattr(space, "n"):
        raise ValueError(f"AQL drives Box or Discrete action spaces, "
                         f"got {type(space).__name__}")
    n = int(space.n)
    common["uniform_sample"] = min(cfg.aql.uniform_sample, n)
    return dict(action_dim=n, discrete=True, **common)


def aql_env_specs(cfg: ApexConfig):
    """``(model_spec, frame_shape, frame_dtype, frame_spec)`` of the
    concurrent AQL family from one un-stacked probe env, shared by
    :class:`AQLApexTrainer` and the actor role
    (:func:`apex_tpu_torch.runtime.roles.run_actor`), so the two cannot
    drift.  Pixel envs get ``frame_spec = (frame_shape, frame_dtype,
    frame_stack)`` (the frame-pool layout) and the stacked shape by
    FrameStack's formula; others ``frame_spec = None``."""
    probe = make_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed)
    frame_shape, frame_dtype, frame_stack = unstacked_env_spec(probe,
                                                               cfg.env)
    frame_spec = None
    if len(frame_shape) == 3:
        frame_spec = (frame_shape, frame_dtype, frame_stack)
        obs_shape = frame_shape[:-1] + (frame_stack * frame_shape[-1],)
    else:
        obs_shape = frame_shape
    model_spec = aql_model_spec(cfg, probe, obs_shape)
    probe.close()
    return model_spec, frame_shape, frame_dtype, frame_spec


def build_aql(cfg: ApexConfig, model_spec: dict, obs_dtype,
              device: torch.device, generator: torch.Generator,
              cosine_steps: int | None = None,
              frame_spec: tuple | None = None):
    """``(model, train_state, replay, replay_state, core)`` on ``device``
    for either driver (``aql.py:233-302``).  The weights are drawn from
    ``cfg.env.seed``; the core's NoisyNet draws from ``generator``.

    ``cosine_steps``: the Adam groups' cosine horizon (the single-process
    driver's ``cfg.aql.cosine_lr_steps``; the concurrent driver's lr is
    constant, as ``AQL_dis`` constructs no scheduler).
    ``frame_spec``: ``(frame_shape, frame_dtype, frame_stack)`` selects the
    frame-pool layout with ``a_mu`` as a sidecar (pixel AQL; ingest then
    takes FrameChunkBuilder chunks)."""
    model = AQLNetwork(
        **model_spec, generator=torch.Generator().manual_seed(cfg.env.seed)
    ).to(device)
    t, a_dim = model.total_sample, model.candidate_dim
    optimizer = make_aql_optimizer(
        q_lr=cfg.aql.q_lr, proposal_lr=cfg.aql.proposal_lr,
        max_grad_norm=cfg.learner.max_grad_norm, cosine_steps=cosine_steps)
    train_state = TrainState(
        params=model, target_params=copy.deepcopy(model).requires_grad_(False),
        opt_state=optimizer.init(model), step=0)
    obs_shape = model_spec["obs_shape"]
    if frame_spec is not None:
        frame_shape, frame_dtype, frame_stack = frame_spec
        replay = FramePoolReplay(
            capacity=cfg.replay.capacity, frame_shape=tuple(frame_shape),
            frame_stack=frame_stack, frame_dtype=np.dtype(frame_dtype).name,
            alpha=cfg.replay.alpha, eps=cfg.replay.eps,
            extra_spec=(("a_mu", (t, a_dim)),))
        check_hbm_budget(replay.hbm_bytes(), cfg.replay.hbm_budget_gb,
                         "AQL frame-pool replay (frames + a_mu sidecars)",
                         cfg.replay.capacity, device)
        replay_state = replay.init(device)
    else:
        replay = DeviceReplay(capacity=cfg.replay.capacity,
                              alpha=cfg.replay.alpha, eps=cfg.replay.eps)
        example_item = dict(
            obs=np.zeros(obs_shape, obs_dtype), action=np.int32(0),
            reward=np.float32(0), next_obs=np.zeros(obs_shape, obs_dtype),
            discount=np.float32(0), a_mu=np.zeros((t, a_dim), np.float32))
        check_hbm_budget(replay.hbm_bytes(example_item),
                         cfg.replay.hbm_budget_gb,
                         "AQL replay (stacked obs + a_mu candidate sets)",
                         cfg.replay.capacity, device)
        replay_state = replay.init(example_item, device)
    core = AQLCore(replay=replay, optimizer=optimizer,
                   batch_size=cfg.learner.batch_size,
                   target_update_interval=cfg.learner.target_update_interval,
                   entropy_coef=cfg.aql.entropy_coef,
                   draws=AQLDraws(generator))
    return model, train_state, replay, replay_state, core


def aql_eval_policy(model: AQLNetwork, draws: AQLDraws):
    """The mu-only AQL policy (``aql.py:405-431``) in
    :func:`~apex_tpu_torch.training.checkpoint.run_policy_episodes`' form,
    ``(obs, epsilon, generator) -> (actions, q)``, drawing from ``draws``
    (the loop's generator only places the observation)."""
    policy = make_aql_policy_fn(model, deterministic=True)
    return lambda obs, epsilon, _: policy(obs, epsilon, draws)[::3]


def aql_evaluate(trainer, episodes: int = 10, epsilon: float = 0.0,
                 max_steps: int = 1000) -> float:
    """Mean score over full episodes of the evaluation env, acting with
    mu-only NoisyNet heads on the trainer's device and drawing from its
    generator."""
    if not hasattr(trainer, "_eval_env"):
        trainer._eval_env = make_eval_env(trainer.cfg.env.env_id,
                                          trainer.cfg.env,
                                          seed=trainer.cfg.env.seed + 999)
    draws = trainer.core.draws
    return float(np.mean(run_policy_episodes(
        trainer._eval_env, aql_eval_policy(trainer.model, draws),
        draws.generator, episodes, epsilon, max_steps,
        seed_base=trainer.cfg.env.seed + 1000)))


class AQLTrainer(CheckpointableTrainer):
    """Single-process AQL driver (``aql.py:305-402``; reference
    ``AQL.py:17-109``): act on the learner's device one frame at a time,
    1-step transitions into the stacked replay in ``ingest_chunk``
    blocks, a train step every ``train_every`` frames once warm, the
    cosine lr over ``cfg.aql.cosine_lr_steps``.  ``device`` defaults to
    the card and raises without one unless ``"cpu"`` is asked for."""

    def __init__(self, config: ApexConfig | None = None,
                 logdir: str | None = None, verbose: bool = False,
                 train_every: int = 1, checkpoint_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg = config or ApexConfig()
        self.env = make_env(cfg.env.env_id, cfg.env, seed=cfg.env.seed,
                            stack_frames=True)
        space = self.env.observation_space
        self.model_spec = aql_model_spec(cfg, self.env, space.shape)
        # acting, NoisyNet and the PER sample's uniforms
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.env.seed + 1)
        (self.model, self.train_state, self.replay, self.replay_state,
         self.core) = build_aql(cfg, self.model_spec, space.dtype,
                                self.device, self.generator,
                                cosine_steps=cfg.aql.cosine_lr_steps)
        self.policy = make_aql_policy_fn(self.model)
        self.builder = AQLTransitionBuilder(cfg.learner.gamma)
        self.epsilon = EpsilonSchedule(decay=4000.0)
        self.beta = BetaSchedule(start=cfg.replay.beta)
        self.ingest_chunk = cfg.learner.ingest_chunk
        self.train_every = train_every
        self.log = MetricLogger("learner", logdir, verbose=verbose)
        self.steps_rate = RateCounter()
        self.frames_rate = RateCounter()
        self.ingested = 0
        self.checkpointer = (Checkpointer(checkpoint_dir)
                             if checkpoint_dir else None)

    # -- checkpointing: format and IO in CheckpointableTrainer --------------

    def _counters(self) -> dict:
        return dict(ingested=self.ingested, frames=self.frames_rate.total,
                    steps=self.steps_rate.total)

    def _apply_counters(self, meta: dict) -> None:
        self.ingested = meta["ingested"]
        self.frames_rate.total = meta["frames"]
        self.steps_rate.total = meta["steps"]

    # -- main loop ---------------------------------------------------------

    def train(self, total_frames: int, log_every: int = 500):
        """Run ``total_frames`` more env frames (the schedules continue
        from a restored checkpoint's frame counter)."""
        cfg = self.cfg
        obs, _ = self.env.reset(seed=cfg.env.seed)
        ep_reward, ep_idx = 0.0, 0
        start = self.frames_rate.total
        for frame in range(start + 1, start + total_frames + 1):
            obs_np = np.asarray(obs)
            actions, idx, a_mu, q = self.policy(
                torch.as_tensor(obs_np[None]).to(self.device),
                self.epsilon(frame), self.core.draws)
            next_obs, reward, term, trunc, _ = self.env.step(
                actions[0].cpu().numpy())
            self.builder.add_step(obs_np, int(idx[0]), float(reward),
                                  np.asarray(next_obs), a_mu[0].cpu().numpy(),
                                  q[0].cpu().numpy(), bool(term), bool(trunc))
            ep_reward += float(reward)
            self.frames_rate.tick()
            if term or trunc:
                obs, _ = self.env.reset()
                self.log.scalars({"episode_reward": ep_reward}, ep_idx)
                ep_reward, ep_idx = 0.0, ep_idx + 1
            else:
                obs = next_obs

            while len(self.builder) >= self.ingest_chunk:
                batch, prios = self.builder.drain(self.ingest_chunk)
                self.replay_state = self.core.ingest(self.replay_state,
                                                     batch, prios)
                self.ingested += len(prios)

            warm = self.ingested >= cfg.replay.warmup
            if warm and frame % self.train_every == 0:
                self.train_state, self.replay_state, metrics = \
                    self.core.train_step(
                        self.train_state, self.replay_state,
                        stratified_offsets(self.core.batch_size,
                                           self.generator, self.device),
                        self.beta(frame))
                self.steps_rate.tick()
                if (self.checkpointer is not None and self.steps_rate.total
                        % cfg.learner.save_interval == 0):
                    self.save_checkpoint()
                if self.steps_rate.total % log_every == 0:
                    self.log.scalars(
                        {k: float(v) for k, v in metrics.items()}
                        | {"bps": self.steps_rate.rate,
                           "fps": self.frames_rate.rate},
                        self.steps_rate.total)
        return self

    evaluate = aql_evaluate


class AQLApexTrainer(ConcurrentTrainer):
    """Concurrent AQL (``aql.py:434-578``; reference ``AQL_dis.py``): the
    Ape-X loop of :class:`ConcurrentTrainer`, its ingest pipeline
    included, over AQL worker processes (:mod:`apex_tpu_torch.actors.aql`)
    that ship 1-step transitions with their candidate sets.  Pixel envs
    take the frame-pool layout (``FrameChunkBuilder`` chunks with an
    ``a_mu`` sidecar), others the stacked replay (:func:`aql_env_specs`).
    ``device`` defaults to the card and raises without one unless
    ``"cpu"`` is asked for; the actors act on the CPU."""

    def __init__(self, config: ApexConfig | None = None, pool=None,
                 train_ratio: float | None = None,
                 device: str | torch.device = "cuda",
                 logdir: str | None = None, verbose: bool = False,
                 publish_min_seconds: float = 0.2,
                 min_train_ratio: float | None = None,
                 respawn_workers: bool = True,
                 checkpoint_dir: str | None = None,
                 dp_backend: str = "nccl"):
        from apex_tpu_torch.actors.aql import (aql_worker_main,
                                               vector_aql_worker_main)

        self.device = resolve_device(device)
        self.cfg = cfg = config or ApexConfig()
        self.model_spec, frame_shape, frame_dtype, frame_spec = \
            aql_env_specs(cfg)
        obs_shape = self.model_spec["obs_shape"]
        self._init_loop(train_ratio, min_train_ratio, publish_min_seconds,
                        respawn_workers, logdir, verbose, checkpoint_dir)
        (self.model, self.train_state, self.replay, self.replay_state,
         self.core) = build_aql(cfg, self.model_spec, frame_dtype,
                                self.device, self.generator,
                                frame_spec=frame_spec)
        self.scan_steps = cfg.learner.scan_steps
        if pool is None:
            k = cfg.actor.send_interval
            a_dim, t = self.model.candidate_dim, self.model.total_sample
            if frame_spec is not None:
                # a frame chunk (single frames + refs) + a_mu sidecar rows
                from apex_tpu_torch.native.ring import chunk_slot_bytes
                slot = chunk_slot_bytes(
                    frame_dim=int(np.prod(frame_shape)),
                    frame_dtype_size=np.dtype(frame_dtype).itemsize,
                    kf=k + FRAME_MARGIN, k=k,
                    stack=frame_spec[2]) + k * 4 * a_dim * t
            else:
                obs_bytes = (int(np.prod(obs_shape))
                             * np.dtype(frame_dtype).itemsize)
                slot = k * (2 * obs_bytes + 4 * a_dim * (t + 1) + 32) + 65536
            worker = (vector_aql_worker_main
                      if cfg.actor.n_envs_per_actor > 1 else aql_worker_main)
            pool = ActorPool(cfg, self.model_spec, chunk_transitions=k,
                             worker_fn=worker, shm_slot_bytes=slot)
        self.pool = pool
        self._init_sharded(dp_backend)

    evaluate = aql_evaluate
