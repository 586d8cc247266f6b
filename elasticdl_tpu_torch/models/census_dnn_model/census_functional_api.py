"""The census-income DNN, functional style; the port of
``elasticdl_tpu/models/census_dnn_model/census_functional_api.py``:
DenseFeatures(columns) -> Dense(16, relu) x2 -> Dense(1, sigmoid);
binary cross entropy; Adam(1e-3); thresholded binary accuracy.  Every
column transform is a shape-preserving numpy op, so ``batch_parse`` runs
it over whole decoded columns (the vectorized pipeline)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from elasticdl_tpu_torch import feature_column as fc
from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.models._tabular import FeatureColumnDNN, binary_cross_entropy
from elasticdl_tpu_torch.models.census_dnn_model.census_feature_columns import (
    LABEL_KEY,
    get_feature_columns,
)
from elasticdl_tpu_torch.trainer.metrics import BinaryAccuracy
from elasticdl_tpu_torch.trainer.state import Modes

COLUMNS = get_feature_columns()


class CensusDNN(FeatureColumnDNN):
    def __init__(self):
        super().__init__(COLUMNS)


def custom_model(**kwargs):
    return CensusDNN(**kwargs)


def loss(labels, predictions):
    return binary_cross_entropy(labels, predictions)


def optimizer(lr=1e-3):
    """A factory: ``optimizer()(model.parameters())`` is Adam at ``lr``
    with optax's defaults, ``optax.adam``'s update."""
    return functools.partial(torch.optim.Adam, lr=lr)


def batch_parse(example_batch, mode):
    """The batched ``dataset_fn``: every column's transform over the
    batch's ``(B,)`` columns."""
    feats_in = {
        k: v for k, v in example_batch.items() if k != LABEL_KEY
    }
    feats = fc.transform_features(COLUMNS, feats_in)
    if mode == Modes.PREDICTION:
        return feats
    return feats, example_batch[LABEL_KEY].astype(np.int32)


def dataset_fn(dataset, mode, metadata):
    def _parse(record):
        ex = decode_example(record)
        label = ex.pop(LABEL_KEY, None)
        feats = fc.transform_features(COLUMNS, ex)
        if mode == Modes.PREDICTION:
            return feats
        return feats, label.astype(np.int32)

    dataset = dataset.map(_parse)
    if mode == Modes.TRAINING:
        dataset = dataset.shuffle(1024, seed=0)
    return dataset


def eval_metrics_fn():
    return {"accuracy": BinaryAccuracy()}
