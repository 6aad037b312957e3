"""Learner state carried from the JAX package into the port.

``params_from_flax`` turns a flax ``DuelingDQN`` or
``RecurrentDuelingDQN`` param tree (nested dicts of numpy arrays, with or
without the top-level ``"params"`` collection) into a ``state_dict`` for
the port's model: conv kernels HWIO -> OIHW, dense kernels ``(in, out)``
-> ``(out, in)``.  The port's trunk flattens in flax's NHWC order, so no
row permutation of the kernels after it is needed.  The ``lstm`` subtree
of ``OptimizedLSTMCell`` (input kernels ``ii/if/ig/io``, hidden kernels
and biases ``hi/hf/hg/ho``) packs into the port's
``weight_ih``/``weight_hh``/``bias_hh``, gates in the order i, f, g, o,
and a zero ``bias_ih`` buffer.  A NoisyNet layer (``w_mu``/``w_sigma``/
``b_mu``/``b_sigma``) keeps flax's ``[in, out]`` layout in the port
(:mod:`apex_tpu_torch.models.noisy`) and is copied as it is.

A whole JAX checkpoint crosses with :func:`train_state_from_flax`,
:func:`frame_pool_state_from_jax`, :func:`seq_pool_state_from_jax` and
:func:`device_replay_state_from_jax`.
They take the bundle's raw numpy tree, ``load_raw(path)[0]`` of
:mod:`apex_tpu.training.checkpoint` read by the caller on a host with
JAX: the bundles are msgpack files, and the port does not read msgpack.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.ops.losses import (AdamState, AQLOptimizer,
                                       AQLOptState, ClipRMSprop,
                                       RMSpropState, aql_param_labels)
from apex_tpu_torch.replay.device import DeviceReplay, ReplayState
from apex_tpu_torch.replay.frame_pool import FramePoolReplay, FramePoolState
from apex_tpu_torch.replay.seq_pool import (SequenceFramePoolReplay,
                                            SequenceFramePoolState)
from apex_tpu_torch.training.state import TrainState

_GATES = "ifgo"


def _lstm_from_flax(cell: dict) -> dict[str, torch.Tensor]:
    def packed(prefix, leaf):             # 4 x (in, H) -> (4H, in)
        return torch.tensor(np.concatenate(
            [np.asarray(cell[prefix + g][leaf], np.float32) for g in _GATES],
            axis=-1).T.copy())

    bias_hh = packed("h", "bias")
    return {"lstm.weight_ih": packed("i", "kernel"),
            "lstm.weight_hh": packed("h", "kernel"),
            "lstm.bias_hh": bias_hh,
            "lstm.bias_ih": torch.zeros_like(bias_hh)}


def params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    tree = params.get("params", params)
    state = {}
    for name, leaf in tree.items():
        if name == "lstm":
            state.update(_lstm_from_flax(leaf))
            continue
        if "w_mu" in leaf:                            # NoisyDense
            state.update({f"{name}.{k}": torch.tensor(
                np.asarray(v, np.float32)) for k, v in leaf.items()})
            continue
        kernel = np.asarray(leaf["kernel"], np.float32)
        if kernel.ndim == 4:                          # HWIO -> OIHW
            kernel = kernel.transpose(3, 2, 0, 1)
        elif kernel.ndim == 2:                        # (in, out) -> (out, in)
            kernel = kernel.T
        else:
            raise ValueError(f"{name}: unexpected kernel rank {kernel.ndim}")
        state[f"{name}.weight"] = torch.tensor(kernel)
        state[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"],
                                                        np.float32))
    return state


def _load(module: nn.Module, tree: dict) -> None:
    module.load_state_dict(params_from_flax(tree), strict=True)


def train_state_from_flax(raw: dict, model: nn.Module,
                          optimizer: ClipRMSprop | AQLOptimizer
                          ) -> TrainState:
    """The port's train state from a JAX bundle's ``train_state`` tree:
    ``params`` loaded into ``model`` (in place, on its device), the target
    into a copy of it, the optimizer state and the step.

    RMSprop: optax's clip + RMSprop state (``opt_state[1][0]``: ``mu``/
    ``nu`` trees, ``opt_state[1][1]["count"]``: the lr schedule's count)
    onto :class:`RMSpropState` in ``model.parameters()`` order.  A
    constant lr keeps no count in optax; the port's count then equals the
    step, as both advance once per update.

    The AQL optimizer: ``optax.multi_transform``'s state
    (``opt_state["inner_states"][group]["inner_state"]``, each a clip +
    Adam chain whose masked ``mu``/``nu`` trees hold only the group's
    leaves) onto one :class:`AdamState` per group, in the group's
    ``named_parameters`` order, with Adam's own count."""
    _load(model, raw["params"])
    target = copy.deepcopy(model).requires_grad_(False)
    _load(target, raw["target_params"])
    step = int(raw["step"])
    if isinstance(optimizer, AQLOptimizer):
        return TrainState(params=model, target_params=target,
                          opt_state=_aql_opt_state(raw["opt_state"], model),
                          step=step)
    rms, schedule = raw["opt_state"]["1"]["0"], raw["opt_state"]["1"]["1"]
    device = next(model.parameters()).device
    moments = {}
    for key in ("mu", "nu"):
        if key in rms:
            state = params_from_flax(rms[key])
            moments[key] = [state[name].to(device)
                            for name, _ in model.named_parameters()]
    opt = optimizer.init(list(model.parameters()))
    opt = RMSpropState(count=int(schedule.get("count", step)),
                       mu=moments.get("mu", opt.mu),
                       nu=moments.get("nu", opt.nu))
    return TrainState(params=model, target_params=target, opt_state=opt,
                      step=step)


def _drop_masked(tree):
    """A masked moment tree without the other group's leaves (optax's
    ``MaskedNode``, which a saved bundle holds as an empty dict)."""
    if not isinstance(tree, dict):
        return tree
    kept = {k: _drop_masked(v) for k, v in tree.items()}
    return {k: v for k, v in kept.items() if not (isinstance(v, dict)
                                                  and not v)}


def _aql_opt_state(raw_opt: dict, model: nn.Module) -> AQLOptState:
    labels = aql_param_labels(model)
    device = next(model.parameters()).device
    groups = {}
    for group in ("q", "proposal"):
        adam = raw_opt["inner_states"][group]["inner_state"]["1"]["0"]
        names = [n for n, _ in model.named_parameters()
                 if labels[n] == group]
        moments = {key: params_from_flax(_drop_masked(adam[key]))
                   for key in ("mu", "nu")}
        groups[group] = AdamState(
            count=int(adam["count"]),
            **{key: [moments[key][n].to(device) for n in names]
               for key in ("mu", "nu")})
    return AQLOptState(**groups)


def _check_capacity(raw: dict, capacity: int) -> None:
    saved = np.asarray(raw["sum_tree"]).shape[0] // 2
    if saved != capacity:
        raise ValueError(f"replay state of capacity {saved} != {capacity}")


def frame_pool_state_from_jax(raw: dict, pool: FramePoolReplay,
                              device: torch.device | str) -> FramePoolState:
    """The port's frame-pool state from a JAX bundle's ``replay_state``
    tree.  The JAX ring pads each row to whole (8, 128) tiles; the port's
    is unpadded, so each row keeps its first ``frame_dim`` elements.  The
    sidecars (``extras``, the AQL family's candidate sets) are the pool's
    ``extra_spec``."""
    _check_capacity(raw, pool.capacity)
    saved = sorted((raw.get("extras") or {}).keys())
    if saved != sorted(name for name, _ in pool.extra_spec):
        raise ValueError(f"replay state sidecars {saved} != the pool's "
                         f"{[name for name, _ in pool.extra_spec]}")

    def put(name):
        return torch.from_numpy(np.array(raw[name])).to(device)

    frames = np.asarray(raw["frames"]).reshape(pool.f_capacity, -1)
    return FramePoolState(
        frames=torch.from_numpy(
            np.ascontiguousarray(frames[:, :pool.frame_dim])).to(device),
        action=put("action"), reward=put("reward"),
        discount=put("discount"), obs_ids=put("obs_ids"),
        next_ids=put("next_ids"), frame_epoch=put("frame_epoch"),
        sum_tree=put("sum_tree"), min_tree=put("min_tree"),
        pos=int(raw["pos"]), f_epoch=int(raw["f_epoch"]),
        size=int(raw["size"]), max_priority=put("max_priority"),
        extras={name: torch.from_numpy(np.array(raw["extras"][name])).to(
            device) for name, _ in pool.extra_spec})


def seq_pool_state_from_jax(raw: dict, pool: SequenceFramePoolReplay,
                            device: torch.device | str
                            ) -> SequenceFramePoolState:
    """The port's pooled sequence state from a JAX bundle's
    ``replay_state`` tree.  A JAX ring the Pallas gather may read is
    stored tile-padded, ``[F, 8, row_dim/8]`` (84x84 frames pad to 7168,
    42x42 to 2048); the port's is ``[F, D]``, so each row keeps its first
    ``frame_dim`` elements."""
    _check_capacity(raw, pool.capacity)

    def put(name):
        return torch.from_numpy(np.array(raw[name])).to(device)

    frames = np.asarray(raw["frames"]).reshape(pool.f_capacity, -1)
    return SequenceFramePoolState(
        frames=torch.from_numpy(
            np.ascontiguousarray(frames[:, :pool.frame_dim])).to(device),
        **{name: put(name) for name in (
            "action", "reward", "discount", "mask", "state_c", "state_h",
            "obs_ids", "frame_epoch", "sum_tree", "min_tree",
            "max_priority")},
        pos=int(raw["pos"]), f_epoch=int(raw["f_epoch"]),
        size=int(raw["size"]))


def device_replay_state_from_jax(raw: dict, replay: DeviceReplay,
                                 device: torch.device | str) -> ReplayState:
    """The port's :class:`ReplayState` from a JAX bundle's
    ``replay_state`` tree (a :class:`apex_tpu.replay.device.ReplayState`)."""
    def put(x):
        return torch.from_numpy(np.array(x)).to(device)

    _check_capacity(raw, replay.capacity)
    return ReplayState(
        storage={name: put(x) for name, x in raw["storage"].items()},
        sum_tree=put(raw["sum_tree"]), min_tree=put(raw["min_tree"]),
        pos=int(raw["pos"]), size=int(raw["size"]),
        max_priority=put(raw["max_priority"]))
