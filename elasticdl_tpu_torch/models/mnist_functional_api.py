"""The MNIST CNN; the port of ``elasticdl_tpu/models/mnist_functional_api.py``.

Conv(32, 3x3, relu) -> Conv(64, 3x3, relu) -> BatchNorm -> MaxPool(2) ->
Dropout(0.25) -> Flatten -> Dense(10); SGD(lr 0.1); sparse softmax
cross entropy; accuracy.  Images cross to the device as uint8 and are
scaled to [0, 1] there (``_image_wire.device_parse``).

Where flax and torch differ, the port follows flax:

- The convolutions run on NCHW activations with OIHW kernels (flax:
  NHWC, HWIO; ``utils/flax_weights.py`` transposes).
- The activations go back to NHWC before dropout and the flatten, so
  the Dense rows are in flax's (H, W, C) order and the dropout mask has
  flax's layout.
- BatchNorm is flax's rule (``layers/normalization.py``): momentum 0.9
  on the old value, biased batch variance, statistics over every row of
  the batch, padding included.
- Dropout draws from the step's generator
  (``layers.attention.dropout_generator``); its bits are not JAX's.
- ``dtype`` (e.g. ``"bfloat16"``) is the compute dtype: parameters and
  BatchNorm statistics stay f32, and the logits come out f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.layers.attention import (
    compute_dtype,
    dense,
    dropout,
    to_torch_dtype,
)
from elasticdl_tpu_torch.layers.initializers import flax_default_init_
from elasticdl_tpu_torch.layers.normalization import BatchNorm
from elasticdl_tpu_torch.models._image_wire import (  # noqa: F401
    batch_parse,
    device_parse,
)
from elasticdl_tpu_torch.trainer.metrics import Accuracy
from elasticdl_tpu_torch.trainer.state import Modes

IMAGE_SIDE = 28
DROPOUT_RATE = 0.25


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype) -> torch.Tensor:
    """``layer(x)`` with input, kernel and bias cast to the compute dtype
    (flax ``Conv`` with ``dtype=``; parameters stay f32)."""
    dt = compute_dtype(dtype, x)
    bias = layer.bias.to(dt) if layer.bias is not None else None
    return F.conv2d(
        x.to(dt), layer.weight.to(dt), bias,
        stride=layer.stride, padding=layer.padding,
    )


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = to_torch_dtype(dtype)
        # VALID padding, as flax's padding="VALID"
        self.conv_0 = nn.Conv2d(1, 32, 3)
        self.conv_1 = nn.Conv2d(32, 64, 3)
        # momentum 0.9 (not flax's 0.99 default) so that the running
        # statistics serve evaluation after short runs
        self.batch_norm = BatchNorm(64, axis=1, momentum=0.9, dtype=self.dtype)
        pooled = (IMAGE_SIDE - 4) // 2
        self.dense = nn.Linear(pooled * pooled * 64, num_classes)
        for layer in (self.conv_0, self.conv_1, self.dense):
            flax_default_init_(layer)

    def forward(
        self, features, training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """f32 logits ``(batch, num_classes)``.  ``training=True`` uses
        the batch's statistics (and moves the running ones) and turns
        dropout on, with its mask drawn from ``generator``."""
        if not training:
            generator = None
        elif generator is None:
            raise ValueError("training with dropout needs a generator")
        x = features["image"] if isinstance(features, dict) else features
        x = torch.as_tensor(x, device=self.dense.weight.device)
        # (batch, 28, 28) -> NCHW with one channel: the memory of flax's
        # (batch, 28, 28, 1)
        x = x.reshape(x.shape[0], 1, IMAGE_SIDE, IMAGE_SIDE)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(conv(x, self.conv_0, self.dtype))
        x = F.relu(conv(x, self.conv_1, self.dtype))
        x = self.batch_norm(x, training)
        x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1)  # NHWC, flax's layout
        x = dropout(x, DROPOUT_RATE, generator)
        x = x.reshape(x.shape[0], -1)
        return dense(x, self.dense, self.dtype).float()


def custom_model(**kwargs):
    return MnistCNN(**kwargs)


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return F.cross_entropy(predictions.float(), labels.reshape(-1).long())


def optimizer(lr=0.1):
    """A factory: ``optimizer()(model.parameters())`` is plain SGD at
    ``lr``, ``optax.sgd``'s update."""
    return functools.partial(torch.optim.SGD, lr=lr)


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
