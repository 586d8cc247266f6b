"""The CIFAR-10 CNN; the port of
``elasticdl_tpu/models/cifar10_functional_api.py``.

Three blocks of [Conv(3x3, SAME, with bias) -> BatchNorm(epsilon 1e-6,
momentum 0.9) -> relu] x2 -> MaxPool(2x2, VALID) -> Dropout(0.2 / 0.3 /
0.4), at 32, 64 and 128 channels; Flatten -> Dense(10) named
``output``; SGD(0.1) with a step schedule (0.1, then 0.01 from model
version 5000, then 0.001 from 15000); sparse softmax cross entropy;
accuracy.  Images cross to the device as uint8
(``_image_wire.device_parse``).

As in the mnist model, the convolutions run on NCHW activations with
OIHW kernels, dropout draws its mask on NHWC activations (from the
step's generator; the bits are not JAX's), and the flatten is in flax's
(H, W, C) order.  ``dtype`` is the compute dtype; parameters and
BatchNorm statistics stay f32 and the logits come out f32.

The schedule is an SGD lr read on the host: on the card, a run of
``--steps_per_dispatch k > 1`` replays CUDA graphs, which would freeze
it, so the trainer refuses it at the capture (run k = 1, or an optimizer
with ``capturable=True``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.layers.attention import dense, dropout, to_torch_dtype
from elasticdl_tpu_torch.layers.initializers import flax_default_init_
from elasticdl_tpu_torch.layers.normalization import BatchNorm
from elasticdl_tpu_torch.models._image_wire import (  # noqa: F401
    batch_parse,
    device_parse,
)
from elasticdl_tpu_torch.models.mnist_functional_api import conv
from elasticdl_tpu_torch.trainer.metrics import Accuracy
from elasticdl_tpu_torch.trainer.state import Modes

IMAGE_SIDE = 32
# (channels, dropout rate) of each block
BLOCKS = ((32, 0.2), (64, 0.3), (128, 0.4))


class Cifar10CNN(nn.Module):
    def __init__(self, num_classes: int = 10, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = to_torch_dtype(dtype)
        # flax's Conv_0..5 and BatchNorm_0..5, in order
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        channels = 3
        for width, _rate in BLOCKS:
            for _ in range(2):
                layer = nn.Conv2d(channels, width, 3, padding=1)
                flax_default_init_(layer)
                self.convs.append(layer)
                self.norms.append(
                    BatchNorm(width, axis=1, momentum=0.9, epsilon=1e-6, dtype=self.dtype)
                )
                channels = width
        side = IMAGE_SIDE // 2 ** len(BLOCKS)
        self.output = nn.Linear(side * side * channels, num_classes)
        flax_default_init_(self.output)

    def forward(
        self, features, training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """f32 logits ``(batch, num_classes)``.  ``training=True`` uses
        the batch's statistics (and moves the running ones) and turns
        dropout on, with its masks drawn from ``generator``."""
        if not training:
            generator = None
        elif generator is None:
            raise ValueError("training with dropout needs a generator")
        x = features["image"] if isinstance(features, dict) else features
        x = torch.as_tensor(x, device=self.output.weight.device)
        x = x.reshape(x.shape[0], IMAGE_SIDE, IMAGE_SIDE, 3)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)
        layers = iter(zip(self.convs, self.norms))
        for _width, rate in BLOCKS:
            for _ in range(2):
                layer, norm = next(layers)
                x = F.relu(norm(conv(x, layer, self.dtype), training))
            x = F.max_pool2d(x, 2)
            # NHWC, flax's layout, for the dropout mask and the flatten
            x = dropout(x.permute(0, 2, 3, 1), rate, generator)
            x = x.permute(0, 3, 1, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return dense(x, self.output, self.dtype).float()


def custom_model(**kwargs):
    return Cifar10CNN(**kwargs)


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return F.cross_entropy(predictions.float(), labels.reshape(-1).long())


def optimizer(lr=0.1):
    """A factory: ``optimizer()(model.parameters())`` is plain SGD at
    ``lr``, ``optax.sgd``'s update."""
    return functools.partial(torch.optim.SGD, lr=lr)


def learning_rate_scheduler(model_version):
    """The lr of update ``model_version``: 0.1, 0.01 from 5000, 0.001
    from 15000."""
    if model_version < 5000:
        return 0.1
    return 0.01 if model_version < 15000 else 0.001


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
