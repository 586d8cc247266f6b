"""Train state: what a training run carries from step to step; the
counterpart of ``elasticdl_tpu/trainer/state.py``.

The JAX package threads one immutable pytree (step, params, optax state)
through jitted steps.  PyTorch keeps parameters in the module and moments
in the optimizer, so the port's ``TrainState`` holds the step counter,
the module and the optimizer, and
:meth:`TrainState.apply_gradients` updates them in place.

Checkpoints use the JAX package's flat layout: ``params/<flax name>``
keys (``block_0/attn/query/kernel``, ...) with flax's array layouts, and
the model's state beside its parameters under its collection's name
(BatchNorm's running statistics, module buffers here:
``batch_stats/BatchNorm_0/mean``), so either package loads the other's
(``utils/flax_weights.py`` does the renaming and transposes).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.utils import flax_weights


class Modes(str, enum.Enum):
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    def apply_gradients(self, grads: dict[str, torch.Tensor | None]):
        """One optimizer update from ``grads`` (keyed as
        ``model.named_parameters()``; ``None`` leaves a parameter
        untouched), in place; returns ``self``.  Each parameter's
        ``.grad`` keeps the gradient it was given."""
        for name, param in self.model.named_parameters():
            param.grad = grads.get(name)
        self.optimizer.step()
        self.step += 1
        return self

    @classmethod
    def create(cls, model: nn.Module, tx: Callable) -> "TrainState":
        """A fresh state at step 0; ``tx`` builds the optimizer from the
        model's parameters."""
        return cls(step=0, model=model, optimizer=tx(model.parameters()))


def state_to_checkpoint(state: TrainState) -> dict[str, np.ndarray]:
    """The model's weights as one flat ``params/<flax name>`` dict of f32
    arrays in flax's layouts, with its state beside the parameters under
    its collection's name: the JAX package's checkpoint layout."""
    out = {
        f"params/{k}": v
        for k, v in flax_weights.flax_flat_from_torch(state.model).items()
    }
    out.update(flax_weights.flax_state_from_torch(state.model))
    return out


def checkpoint_to_state(state: TrainState, flat: dict) -> TrainState:
    """Inverse of :func:`state_to_checkpoint`: load the ``params/`` keys,
    and the state's keys when the checkpoint has any, into
    ``state.model`` in place (missing, extra or misshaped names raise).
    A checkpoint without state leaves the model's state as it is, as in
    the reference.  The optimizer is left as it is, fresh for a new
    state, as in the reference, which restores variables only."""
    params = {
        k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")
    }
    rest = {k: v for k, v in flat.items() if not k.startswith("params/")}
    weights = flax_weights.torch_state_from_flax(
        params, state.model, rest or None
    )
    with torch.no_grad():
        for name, tensor in state.model.state_dict().items():
            if name in weights:
                tensor.copy_(weights[name])
    return state


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
