"""Evaluation metrics; a copy of ``elasticdl_tpu/trainer/metrics.py``
(which the port cannot import: ``elasticdl_tpu/trainer/__init__.py``
loads flax), taking torch tensors where that takes JAX arrays.

Reference: the model zoo's ``eval_metrics_fn`` returns a dict of Keras
metric objects that the master's EvaluationJob accumulates from reported
output/label tensors (``evaluation_service.py:69-124``).  The TPU build
replaces Keras metrics with this dependency-free library: each metric is a
small accumulator over numpy arrays (metric accumulation happens on the
master's CPU from control-plane tensor reports, never on device — same
topology as the reference).

Metrics accept ``update(labels, predictions)`` in any mix of numpy
arrays and torch tensors (on any device, bf16 widened to f32) and support nested-output models via dict-valued metric trees
(reference ``deepfm_edl_embedding.py:104-111``).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric:
    name = "metric"

    def update(self, labels, predictions):
        raise NotImplementedError

    def result(self) -> float:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class Mean(Metric):
    """Running mean of a per-batch value (loss tracking)."""

    name = "mean"

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0

    def update_value(self, value, weight: int = 1):
        self._total += float(_np(value)) * weight
        self._count += weight

    def update(self, labels, predictions):
        self.update_value(predictions)

    def result(self) -> float:
        return self._total / self._count if self._count else 0.0


class Accuracy(Metric):
    """Sparse categorical accuracy: labels are class ids, predictions are
    logits/probs [batch, classes] (argmax) or already class ids."""

    name = "accuracy"

    def __init__(self):
        self.reset()

    def reset(self):
        self._correct = 0
        self._count = 0

    def update(self, labels, predictions):
        labels = _np(labels).reshape(-1)
        predictions = _np(predictions)
        if predictions.ndim > 1 and predictions.shape[-1] > 1:
            predicted = predictions.reshape(
                -1, predictions.shape[-1]
            ).argmax(axis=-1)
        else:
            predicted = predictions.reshape(-1)
        self._correct += int((predicted.astype(np.int64) == labels.astype(np.int64)).sum())
        self._count += labels.shape[0]

    def result(self) -> float:
        return self._correct / self._count if self._count else 0.0


class BinaryAccuracy(Metric):
    """Labels in {0,1}; predictions are probabilities or logits (>0.5 / >0)."""

    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5, from_logits: bool = False):
        self._threshold = 0.0 if from_logits else threshold
        self.reset()

    def reset(self):
        self._correct = 0
        self._count = 0

    def update(self, labels, predictions):
        labels = _np(labels).reshape(-1)
        predicted = (_np(predictions).reshape(-1) > self._threshold).astype(
            np.int64
        )
        self._correct += int((predicted == labels.astype(np.int64)).sum())
        self._count += labels.shape[0]

    def result(self) -> float:
        return self._correct / self._count if self._count else 0.0


class AUC(Metric):
    """Exact ROC-AUC via the Mann-Whitney rank statistic over all reported
    scores (the master sees every eval example, so no binning is needed)."""

    name = "auc"

    def __init__(self):
        self.reset()

    def reset(self):
        self._scores: list[np.ndarray] = []
        self._labels: list[np.ndarray] = []

    def update(self, labels, predictions):
        self._labels.append(_np(labels).reshape(-1).astype(np.int64))
        self._scores.append(_np(predictions).reshape(-1).astype(np.float64))

    def result(self) -> float:
        if not self._labels:
            return 0.0
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        pos = int(y.sum())
        neg = y.shape[0] - pos
        if pos == 0 or neg == 0:
            return 0.0
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, y.shape[0] + 1)
        # average ranks over ties
        sorted_s = s[order]
        i = 0
        while i < len(sorted_s):
            j = i
            while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            if j > i:
                avg = (i + j + 2) / 2.0
                ranks[order[i : j + 1]] = avg
            i = j + 1
        rank_sum_pos = ranks[y == 1].sum()
        return float(
            (rank_sum_pos - pos * (pos + 1) / 2.0) / (pos * neg)
        )


class MeanSquaredError(Metric):
    name = "mse"

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0

    def update(self, labels, predictions):
        labels = _np(labels).reshape(-1).astype(np.float64)
        predictions = _np(predictions).reshape(-1).astype(np.float64)
        self._total += float(((labels - predictions) ** 2).sum())
        self._count += labels.shape[0]

    def result(self) -> float:
        return self._total / self._count if self._count else 0.0


def update_metric_tree(metrics, labels, outputs):
    """Update a (possibly nested) metric dict.

    Shapes supported (mirroring ``evaluation_service.py:39-61``):
    - {name: Metric} with a single model output;
    - {name: {output_key: Metric}} for multi-output models, where
      ``outputs`` is a dict keyed the same way.
    """
    for name, metric in metrics.items():
        if isinstance(metric, dict):
            for key, sub in metric.items():
                out = outputs[key] if isinstance(outputs, dict) else outputs
                sub.update(labels, out)
        else:
            out = (
                next(iter(outputs.values()))
                if isinstance(outputs, dict)
                else outputs
            )
            metric.update(labels, out)


def metric_tree_results(metrics) -> dict:
    out = {}
    for name, metric in metrics.items():
        if isinstance(metric, dict):
            for key, sub in metric.items():
                out[f"{name}_{key}"] = sub.result()
        else:
            out[name] = metric.result()
    return out


def reset_metric_tree(metrics):
    for metric in metrics.values():
        if isinstance(metric, dict):
            for sub in metric.values():
                sub.reset()
        else:
            metric.reset()
