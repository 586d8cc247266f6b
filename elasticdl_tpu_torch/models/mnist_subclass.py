"""The MNIST CNN, subclass style; the port of
``elasticdl_tpu/models/mnist_subclass.py``: the functional model's
network (Conv32 -> Conv64 -> BatchNorm -> MaxPool -> Dropout(0.25) ->
Dense10, flax's ``Conv_0``, ``Conv_1``, ``BatchNorm_0``, ``Dense_0``)
under the ``CustomModel`` entry point, with SGD(0.01)."""

from __future__ import annotations

import functools

import torch

from elasticdl_tpu_torch.models.mnist_functional_api import (  # noqa: F401
    MnistCNN,
    batch_parse,
    dataset_fn,
    device_parse,
    eval_metrics_fn,
    loss,
)


class CustomModel(MnistCNN):
    pass


def custom_model(**kwargs):
    return CustomModel(**kwargs)


def optimizer(lr=0.01):
    """A factory: ``optimizer()(model.parameters())`` is plain SGD at
    ``lr``, ``optax.sgd``'s update."""
    return functools.partial(torch.optim.SGD, lr=lr)
