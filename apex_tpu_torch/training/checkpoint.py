"""Whole-learner checkpointing and evaluation from a checkpoint.

Counterpart of :mod:`apex_tpu.training.checkpoint` (``checkpoint.py:37-297``).
A checkpoint is the full learner, so a restored learner continues
bit-exactly:

    train_state: online and target weights, the RMSprop moments and
        count, the step
    replay_state: every field of the replay state (device tensors and the
        host cursors)
    generator: the state of the learner's torch.Generator
    meta: the config, the model spec and the host counters, as JSON

Format: one ``torch.save`` file of a dict of tensors, ints and lists plus
the JSON ``meta`` string, written to ``<path>.tmp`` and moved into place
with ``os.replace``, so a crash mid-save never damages the newest
checkpoint.  It is read back only with ``torch.load(...,
weights_only=True)``, which unpickles tensors and containers and refuses
any other object: the rule of :mod:`apex_tpu_torch.runtime.wire`.
Tensors are saved from host copies, so a file restores on any device.

The JAX package's bundles are msgpack files (flax serialization); the port
cannot read them itself, but :mod:`apex_tpu_torch.convert` carries their
state, read on a JAX host with ``apex_tpu``'s ``load_raw``, across.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from apex_tpu_torch import resolve_device


def _to_host(tree):
    """Tensors to CPU tensors, containers rebuilt, ints and floats kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree


def save_bundle(path: str, bundle: dict, meta: dict | None = None) -> str:
    """Atomically write ``bundle`` (nested dicts and lists of tensors and
    ints) plus JSON-able ``meta`` to ``path``."""
    payload = {"state": _to_host(bundle), "meta": json.dumps(meta or {})}
    tmp = path + ".tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def load_raw(path: str) -> tuple[dict, dict]:
    """Read a checkpoint as ``(state, meta)``: the nested state of CPU
    tensors and ints, and the metadata dict.  Only tensors and containers
    unpickle; a file naming any other object raises
    ``pickle.UnpicklingError``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["state"], json.loads(payload["meta"])


def _impose(target, raw, where: str):
    """Copy ``raw`` into ``target`` (same structure): tensors in place,
    after checking shape and dtype; ints and floats returned."""
    if isinstance(target, torch.Tensor):
        if (not isinstance(raw, torch.Tensor) or raw.shape != target.shape
                or raw.dtype != target.dtype):
            got = (f"{tuple(raw.shape)} {raw.dtype}"
                   if isinstance(raw, torch.Tensor) else type(raw).__name__)
            raise ValueError(f"checkpoint {where}: {got} does not fit "
                             f"{tuple(target.shape)} {target.dtype}")
        with torch.no_grad():
            target.copy_(raw)
        return target
    if isinstance(target, dict):
        if not isinstance(raw, dict) or raw.keys() != target.keys():
            raise ValueError(f"checkpoint {where}: keys "
                             f"{sorted(raw) if isinstance(raw, dict) else raw}"
                             f" != {sorted(target)}")
        return {k: _impose(target[k], raw[k], f"{where}/{k}") for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(raw, (list, tuple)) or len(raw) != len(target):
            raise ValueError(f"checkpoint {where}: not {len(target)} items")
        return [_impose(t, r, f"{where}/{i}")
                for i, (t, r) in enumerate(zip(target, raw))]
    if not isinstance(raw, (int, float)):
        raise ValueError(f"checkpoint {where}: {type(raw).__name__} where "
                         f"a number belongs")
    return type(target)(raw)


def restore_bundle(path: str, target: dict,
                   check=None) -> tuple[dict, dict]:
    """Impose the saved state onto ``target``, a bundle of the same
    structure: its tensors are overwritten in place on their own devices;
    the returned bundle carries them and the saved numbers.  ``check``,
    when given, is called with the saved meta before anything is imposed
    (to refuse a file before it overwrites).  Returns ``(bundle, meta)``."""
    raw, meta = load_raw(path)
    if check is not None:
        check(meta)
    return _impose(target, raw, ""), meta


@dataclasses.dataclass
class Checkpointer:
    """Directory of ``ckpt_<step>.pt`` files; the newest ``keep`` stay."""

    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    @staticmethod
    def _step_of(name: str) -> int:
        return int(name[len("ckpt_"):-len(".pt")])

    def _all(self) -> list[str]:
        names = [n for n in os.listdir(self.directory)
                 if n.startswith("ckpt_") and n.endswith(".pt")]
        return sorted(names, key=self._step_of)

    def save(self, step: int, bundle: dict, meta: dict | None = None) -> str:
        path = os.path.join(self.directory, f"ckpt_{step}.pt")
        save_bundle(path, bundle, meta)
        for stale in self._all()[:-self.keep]:
            os.remove(os.path.join(self.directory, stale))
        return path

    def latest_path(self) -> str | None:
        names = self._all()
        return os.path.join(self.directory, names[-1]) if names else None


class CheckpointableTrainer:
    """Save and restore shared by the trainers.  A trainer provides
    ``cfg``, ``model_spec``, ``train_state``, ``replay_state``,
    ``generator``, ``checkpointer`` (or None), ``steps_rate`` and
    ``_counters()`` / ``_apply_counters(meta)`` for its host counters."""

    def _counters(self) -> dict:
        raise NotImplementedError

    def _apply_counters(self, meta: dict) -> None:
        raise NotImplementedError

    def _bundle(self) -> dict:
        """The learner's state, by reference (tensors are the live ones)."""
        ts = self.train_state
        opt = ts.opt_state
        rs = self.replay_state
        return dict(
            train_state=dict(
                params=ts.params.state_dict(),
                target_params=ts.target_params.state_dict(),
                opt_state=dict(count=opt.count, mu=opt.mu, nu=opt.nu),
                step=ts.step),
            replay_state={f.name: getattr(rs, f.name)
                          for f in dataclasses.fields(rs)},
            generator=self.generator.get_state())

    def _meta(self) -> dict:
        return dict(config=config_to_meta(self.cfg),
                    model_spec=spec_to_meta(self.model_spec),
                    **self._counters())

    def save_checkpoint(self) -> str:
        if self.checkpointer is None:
            raise ValueError("no checkpoint directory configured "
                             "(pass checkpoint_dir)")
        return self.checkpointer.save(self.steps_rate.total, self._bundle(),
                                      self._meta())

    def restore(self, path: str | None = None):
        """Restore the whole learner (weights, optimizer, replay,
        generator) and the host counters onto this trainer's device; the
        learner continues bit-exactly.  ``path`` defaults to the newest
        checkpoint of ``checkpointer``."""
        if path is None:
            if self.checkpointer is None:
                raise ValueError("no checkpoint directory configured "
                                 "(pass checkpoint_dir)")
            path = self.checkpointer.latest_path()
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoint found in "
                    f"{self.checkpointer.directory!r}")
        bundle, meta = restore_bundle(path, self._bundle())
        saved_ts = bundle["train_state"]
        self.train_state.opt_state.count = saved_ts["opt_state"]["count"]
        self.train_state.step = saved_ts["step"]
        for name, value in bundle["replay_state"].items():
            setattr(self.replay_state, name, value)
        self.generator.set_state(bundle["generator"])
        self._apply_counters(meta)
        return self


# -- config and spec round trips -------------------------------------------

def config_to_meta(cfg) -> dict:
    """ApexConfig -> JSON-able nested dict."""
    return dataclasses.asdict(cfg)


def config_from_meta(meta_cfg: dict):
    """The ApexConfig of :func:`config_to_meta` output; keys the port's
    config does not have (a JAX config's mesh or comms fields) are
    dropped."""
    from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                       LearnerConfig, R2D2Config,
                                       ReplayConfig)

    def build(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in names})

    return ApexConfig(env=build(EnvConfig, meta_cfg["env"]),
                      replay=build(ReplayConfig, meta_cfg["replay"]),
                      learner=build(LearnerConfig, meta_cfg["learner"]),
                      actor=build(ActorConfig, meta_cfg["actor"]),
                      r2d2=build(R2D2Config, meta_cfg.get("r2d2", {})))


def spec_to_meta(spec: dict) -> dict:
    """A model spec with its torch dtype as a name and shapes as lists."""
    out = dict(spec)
    out["compute_dtype"] = str(spec["compute_dtype"]).removeprefix("torch.")
    out["obs_shape"] = list(spec["obs_shape"])
    return out


def spec_from_meta(meta_spec: dict) -> dict:
    out = dict(meta_spec)
    out["compute_dtype"] = getattr(torch, meta_spec["compute_dtype"])
    out["obs_shape"] = tuple(meta_spec["obs_shape"])
    return out


# -- evaluation ------------------------------------------------------------

def run_policy_episodes(env, policy, generator: torch.Generator,
                        episodes: int, epsilon: float, max_steps: int,
                        seed_base: int, reset_hook=None) -> list[float]:
    """The greedy-eval episode loop (``eval.py:49-87``) shared by the
    trainers' ``evaluate`` and :func:`evaluate_checkpoint`: episode ``i``
    resets with seed ``seed_base + i``; ``policy(obs, epsilon, generator)
    -> (actions, q)`` (:func:`~apex_tpu_torch.models.dueling.
    make_policy_fn`) acts on a batch of one on the generator's device.
    ``reset_hook()``, when given, runs before each episode (a recurrent
    policy zeroes its carry there)."""
    rewards = []
    for ep in range(episodes):
        if reset_hook is not None:
            reset_hook()
        obs, _ = env.reset(seed=seed_base + ep)
        total, done, steps = 0.0, False, 0
        while not done and steps < max_steps:
            actions, _ = policy(
                torch.as_tensor(np.asarray(obs)[None]).to(generator.device),
                epsilon, generator)
            obs, r, term, trunc, _ = env.step(int(actions[0]))
            total += float(r)
            done = term or trunc
            steps += 1
        rewards.append(total)
    return rewards


def evaluate_checkpoint(path: str, episodes: int = 10, epsilon: float = 0.0,
                        max_steps: int = 10_000, seed: int = 7,
                        device: torch.device | str = "cuda") -> float:
    """Rebuild the env and the model from the checkpoint's metadata, load
    the online weights and run epsilon-greedy episodes on the unclipped
    eval env (``enjoy.py:29-48``, ``DQN.py:124-149``); no trainer is
    built.  ``device`` defaults to the card and raises without one unless
    ``"cpu"`` is asked for."""
    from apex_tpu_torch.envs.registry import make_eval_env
    from apex_tpu_torch.models.dueling import DuelingDQN, make_policy_fn
    from apex_tpu_torch.models.recurrent import (RecurrentDuelingDQN,
                                                 episodic_policy)

    dev = resolve_device(device)
    raw, meta = load_raw(path)
    if "action_dim" in meta["model_spec"]:
        raise NotImplementedError("AQL checkpoints: the AQL family is not "
                                  "ported yet (ROADMAP item 6)")
    cfg = config_from_meta(meta["config"])
    # a spec with lstm_features is the recurrent family's
    recurrent = "lstm_features" in meta["model_spec"]
    model = (RecurrentDuelingDQN if recurrent else DuelingDQN)(
        **spec_from_meta(meta["model_spec"]),
        generator=torch.Generator().manual_seed(seed))
    model.load_state_dict(raw["train_state"]["params"])
    model.to(dev)
    policy, reset = (episodic_policy(model) if recurrent
                     else (make_policy_fn(model), None))
    env = make_eval_env(cfg.env.env_id, cfg.env, seed=seed)
    rewards = run_policy_episodes(
        env, policy, torch.Generator(device=dev).manual_seed(seed), episodes,
        epsilon, max_steps, seed_base=seed, reset_hook=reset)
    env.close()
    return float(np.mean(rewards))
