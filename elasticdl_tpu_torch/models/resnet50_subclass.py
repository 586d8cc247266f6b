"""The ResNet-50 classifier; the port of
``elasticdl_tpu/models/resnet50_subclass.py``.

ResNet-50 over ``features["image"]`` giving softmax probabilities; sparse
categorical cross entropy on the probabilities; SGD(0.02) with the
decoupled weight decay the reference's L2 1e-4 gives (2e-4 * w) on every
conv and dense kernel and on ``fc``'s bias, never on BatchNorm's scale or
bias; accuracy.  Images arrive as ``(H, W, 3)`` uint8 records and cross
to the device as uint8 (``_image_wire``).

The optimizer is two SGD parameter groups chosen by name, one with
``weight_decay`` 2e-4 and one without: for plain SGD the update of
``optax.chain(add_decayed_weights(2e-4, mask), sgd(lr))``.  Its factory
takes ``model.named_parameters()`` (``trainer.state.takes_named_parameters``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.models._image_wire import (  # noqa: F401
    batch_parse,
    device_parse,
)
from elasticdl_tpu_torch.models.resnet50_model import L2_WEIGHT_DECAY, ResNet50
from elasticdl_tpu_torch.trainer.metrics import Accuracy
from elasticdl_tpu_torch.trainer.state import Modes, takes_named_parameters


class CustomModel(ResNet50):
    pass


def custom_model(num_classes=10, **kwargs):
    return CustomModel(num_classes=num_classes, **kwargs)


def loss(labels, predictions):
    """``-log(clip(p, 1e-8, 1))`` at the label, averaged: the model's
    outputs are probabilities."""
    labels = torch.as_tensor(labels, device=predictions.device)
    logp = torch.log(torch.clamp(predictions.float(), 1e-8, 1.0))
    return -torch.gather(logp, 1, labels.reshape(-1, 1).long()).mean()


def decays(name: str) -> bool:
    """Whether the parameter ``name`` (a ``named_parameters()`` key)
    takes weight decay: the JAX package's ``_decay_mask``, every conv and
    dense kernel (a torch ``weight``) and the final ``fc``'s bias, never
    BatchNorm's ``scale`` or ``bias``."""
    parent, _, leaf = name.rpartition(".")
    return leaf == "weight" or (parent == "fc" and leaf == "bias")


def _masked_decay_sgd(named_parameters, lr: float, weight_decay: float):
    decayed, plain = [], []
    for name, param in named_parameters:
        (decayed if decays(name) else plain).append(param)
    return torch.optim.SGD(
        [
            {"params": decayed, "weight_decay": weight_decay},
            {"params": plain, "weight_decay": 0.0},
        ],
        lr=lr,
    )


def optimizer(lr=0.02):
    """A factory of ``model.named_parameters()``: SGD at ``lr`` with the
    keras L2 1e-4 penalty's gradient, 2e-4 * w, on the decayed
    parameters (:func:`decays`)."""
    return takes_named_parameters(functools.partial(
        _masked_decay_sgd, lr=lr, weight_decay=2 * L2_WEIGHT_DECAY
    ))


def dataset_fn(dataset, mode, metadata):
    def _parse(record):
        ex = decode_example(record)
        image = ex["image"].astype(np.float32) / 255.0
        if mode == Modes.PREDICTION:
            return {"image": image}
        return {"image": image}, ex["label"].astype(np.int32)

    dataset = dataset.map(_parse)
    if mode == Modes.TRAINING:
        dataset = dataset.shuffle(1024, seed=0)
    return dataset


def eval_metrics_fn():
    return {"accuracy": Accuracy()}
