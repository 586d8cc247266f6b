"""The CIFAR-10 CNN, subclass style; the port of
``elasticdl_tpu/models/cifar10_subclass.py``: the functional model's
network under the ``CustomModel`` entry point, with SGD(0.1) and no
learning-rate schedule."""

from __future__ import annotations

from elasticdl_tpu_torch.models.cifar10_functional_api import (  # noqa: F401
    Cifar10CNN,
    batch_parse,
    dataset_fn,
    device_parse,
    eval_metrics_fn,
    loss,
    optimizer,
)


class CustomModel(Cifar10CNN):
    pass


def custom_model(**kwargs):
    return CustomModel(**kwargs)
