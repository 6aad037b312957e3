"""Weights carried from the JAX package's flax models into the port.

``params_from_flax`` turns a flax ``DuelingDQN`` param tree (nested dicts
of numpy arrays, with or without the top-level ``"params"`` collection)
into a ``state_dict`` for :class:`apex_tpu_torch.models.dueling.DuelingDQN`:
conv kernels HWIO -> OIHW, dense kernels ``(in, out)`` -> ``(out, in)``.
The port's trunk flattens in flax's NHWC order, so no row permutation of
the heads' hidden kernels is needed.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    tree = params.get("params", params)
    state = {}
    for name, leaf in tree.items():
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
