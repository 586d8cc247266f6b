"""The iris linear classifier (the ODPS-table demo model); the port of
``elasticdl_tpu/models/odps_iris_dnn_model.py``.

``(4,)`` features, Flatten, Dense(3) named ``output``; sparse softmax
cross entropy; SGD(0.1); accuracy.  Its ``dataset_fn`` reads the
framework's record codec (the synthetic iris shards); the ODPS reader is
not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.layers.attention import dense
from elasticdl_tpu_torch.layers.initializers import flax_default_init_
from elasticdl_tpu_torch.trainer.metrics import Accuracy
from elasticdl_tpu_torch.trainer.state import Modes

# iris's four measurements (flax's Dense reads its input width off the
# first batch; torch's is fixed here)
NUM_FEATURES = 4


class IrisDNN(nn.Module):
    def __init__(self, num_classes: int = 3, num_features: int = NUM_FEATURES):
        super().__init__()
        self.output = nn.Linear(num_features, num_classes)
        flax_default_init_(self.output)

    def forward(self, features, training: bool = False, generator=None):
        x = features["features"] if isinstance(features, dict) else features
        x = torch.as_tensor(x, device=self.output.weight.device)
        # flax's Dense promotes a bf16 input with its f32 kernel to f32
        return dense(x.reshape(x.shape[0], -1), self.output, None)


def custom_model(**kwargs):
    return IrisDNN(**kwargs)


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
        feats = {"features": ex["features"].astype(np.float32)}
        if mode == Modes.PREDICTION:
            return feats
        return feats, ex["label"].astype(np.int32)

    return dataset.map(_parse)


def eval_metrics_fn():
    return {"accuracy": Accuracy()}
