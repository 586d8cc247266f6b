"""The heart-disease classifier over feature columns; the port of
``elasticdl_tpu/models/heart_functional_api.py``.

Six numeric columns, ``age`` bucketized at 10 boundaries, ``thal``
hashed into 100 buckets and embedded at dimension 8; DenseFeatures ->
Dense(16) x2 -> Dense(1, sigmoid); binary cross entropy on clipped
probabilities; SGD(1e-6); thresholded binary accuracy (the JAX
package's deviation from the reference's argmax over one column).
Records are parsed one by one (``dataset_fn``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elasticdl_tpu_torch import feature_column as fc
from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.models._tabular import FeatureColumnDNN, binary_cross_entropy
from elasticdl_tpu_torch.trainer.metrics import BinaryAccuracy
from elasticdl_tpu_torch.trainer.state import Modes

NUMERIC_KEYS = ["trestbps", "chol", "thalach", "oldpeak", "slope", "ca"]
AGE_BOUNDARIES = (18, 25, 30, 35, 40, 45, 50, 55, 60, 65)


def get_feature_columns():
    columns = [fc.numeric_column(k) for k in NUMERIC_KEYS]
    columns.append(
        fc.bucketized_column(fc.numeric_column("age"), AGE_BOUNDARIES)
    )
    columns.append(
        fc.embedding_column(
            fc.categorical_column_with_hash_bucket("thal", 100), dimension=8
        )
    )
    return tuple(columns)


COLUMNS = get_feature_columns()


class HeartDNN(FeatureColumnDNN):
    def __init__(self):
        super().__init__(COLUMNS)


def custom_model(**kwargs):
    return HeartDNN(**kwargs)


def loss(labels, predictions):
    return binary_cross_entropy(labels, predictions.reshape(-1))


def optimizer(lr=1e-6):
    """A factory: ``optimizer()(model.parameters())`` is plain SGD at
    ``lr``, ``optax.sgd``'s update."""
    return functools.partial(torch.optim.SGD, lr=lr)


def dataset_fn(dataset, mode, metadata):
    def _parse(record):
        ex = decode_example(record)
        label = ex.pop("target", None)
        feats = fc.transform_features(COLUMNS, ex)
        if mode == Modes.PREDICTION:
            return feats
        return feats, label.astype(np.int32)

    return dataset.map(_parse)


def eval_metrics_fn():
    return {"accuracy": BinaryAccuracy()}
