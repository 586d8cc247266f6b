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

import contextlib
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
        model's parameters, or from ``model.named_parameters()`` when it
        :func:`takes_named_parameters`."""
        params = (
            model.named_parameters() if wants_named_parameters(tx)
            else model.parameters()
        )
        return cls(step=0, model=model, optimizer=tx(params))


def takes_named_parameters(factory: Callable) -> Callable:
    """Mark an optimizer factory as one that builds its optimizer from
    ``model.named_parameters()``, ``(name, parameter)`` pairs, instead of
    the bare parameters: the form of a factory that chooses parameter
    groups by name (the JAX package's optax masks).  Returns
    ``factory``."""
    factory.takes_named_parameters = True
    return factory


def wants_named_parameters(factory: Callable) -> bool:
    return getattr(factory, "takes_named_parameters", False)


class LRSchedule:
    """The model's ``learning_rate_scheduler`` as an optimizer step
    pre-hook: before update ``count`` (0, 1, ...) every parameter group's
    lr becomes ``scheduler(count)``, the learning rate optax's schedule
    gives the same update.

    The lr is a Python float, or a 0-d device tensor (on the card, for
    an optimizer that reads it there: :func:`make_capturable`), which
    the hook fills in place.  While a CUDA graph of k steps is captured
    (:meth:`feeding`), update j copies its lr from slot j of a ``(k,)``
    device tensor instead, which the trainer fills with the k scheduled
    values before each replay: every replayed step gets its own lr."""

    def __init__(self, scheduler: Callable):
        self.scheduler = scheduler
        self.updates = 0
        self._feed: torch.Tensor | None = None
        self._slot = 0

    def values(self, k: int) -> list[float]:
        """The lrs of the next ``k`` updates."""
        return [float(self.scheduler(self.updates + j)) for j in range(k)]

    def __call__(self, optimizer, _args, _kwargs):
        if self._feed is not None:
            value = self._feed[self._slot]
            self._slot += 1
            for group in optimizer.param_groups:
                group["lr"].copy_(value)
        else:
            value = float(self.scheduler(self.updates))
            for group in optimizer.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].fill_(value)
                else:
                    group["lr"] = value
        self.updates += 1

    @contextlib.contextmanager
    def feeding(self, feed: torch.Tensor):
        """Within: the updates read their lrs from ``feed`` in order, and
        the update count is left as it was (a capture runs no update)."""
        updates = self.updates
        self._feed, self._slot = feed, 0
        try:
            yield
        finally:
            self._feed = None
            self.updates = updates


def make_capturable(optimizer: torch.optim.Optimizer, device) -> bool:
    """Prepare ``optimizer`` for CUDA graphs on ``device``: every group
    that can keep its update's state on the card (Adam and its kin, with
    ``capturable``) does so, the step counts of updates it already made
    included, and, for a scheduled lr (``optimizer.lr_schedule``), holds
    its lr in a 0-d f32 tensor there.  Returns whether a graph can replay
    the update with the lr it should have: False for a scheduled lr that
    some group reads on the host (SGD turns a tensor lr into a host
    number)."""
    schedule = getattr(optimizer, "lr_schedule", None)
    on_device = True
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = True
            for param in group["params"]:
                state = optimizer.state.get(param, {})
                if isinstance(state.get("step"), torch.Tensor):
                    state["step"] = state["step"].to(device)
            if schedule is not None:
                group["lr"] = torch.tensor(
                    float(group["lr"]), dtype=torch.float32, device=device
                )
        elif schedule is not None:
            on_device = False
    return on_device


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
