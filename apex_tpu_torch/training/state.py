"""Train state of the DQN learner.

Counterpart of :class:`apex_tpu.training.state.TrainState`.  The JAX
state is an immutable pytree; here it is a mutable bundle whose
``params``/``target_params`` are the online and target ``nn.Module``s,
updated in place by the learner.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

from torch import nn

from apex_tpu_torch.ops.losses import ClipRMSprop, RMSpropState


@dataclass
class TrainState:
    params: nn.Module           # online network
    target_params: nn.Module    # target network (synced every interval)
    opt_state: RMSpropState
    step: int = 0               # learner update count


def create_train_state(model: nn.Module,
                       optimizer: ClipRMSprop) -> TrainState:
    """Wrap an initialized model; the target starts as a copy of it."""
    target = copy.deepcopy(model).requires_grad_(False)
    return TrainState(params=model, target_params=target,
                      opt_state=optimizer.init(list(model.parameters())),
                      step=0)
