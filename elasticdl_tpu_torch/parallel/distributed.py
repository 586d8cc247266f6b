"""The trainer: device-side state plus the train/eval/predict steps; the
counterpart of ``elasticdl_tpu/parallel/distributed.py::SPMDTrainer``.

This slice runs on one device: an explicit ``device`` takes the place of
the JAX trainer's mesh, and gradients need no all-reduce.  The data-
parallel axis (``torch.distributed``) comes with a later slice; the
shape-canonical batching below (``pad_to`` + ``row_mask``) is already
the one every runtime uses, so padded rows carry zero weight.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from elasticdl_tpu_torch.trainer.state import TrainState
from elasticdl_tpu_torch.trainer.step import (
    build_eval_step,
    build_predict_step,
    build_train_step,
)
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.tree_utils import map_tree, to_host


class SPMDTrainer:
    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn: Callable,
        tx: Callable,
        compute_dtype=None,
        device: str | torch.device = "cuda",
        device_parse: Callable | None = None,
    ):
        """``model`` comes with its weights (torch modules initialise
        eagerly; the JAX trainer inits from a sample batch instead) and
        is moved to ``device``; ``tx`` builds the optimizer from the
        parameters (``resolve_optimizer``'s result).  ``device`` is CUDA
        unless the caller asks for the CPU.  ``device_parse`` (the
        model's device-side half of its parse) runs in every step on the
        placed features."""
        self.device = resolve_device(device)
        self.state = TrainState.create(model.to(self.device), tx)
        self._train_step = build_train_step(
            loss_fn, compute_dtype=compute_dtype, device_parse=device_parse
        )
        self._eval_step = build_eval_step(loss_fn, device_parse=device_parse)
        self._predict_step = build_predict_step(device_parse)

    # ---- batch placement --------------------------------------------------

    def place_batch(self, tree):
        """A host batch (numpy arrays or tensors) as tensors on the
        trainer's device."""

        def _place(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(self.device)

        return map_tree(_place, tree)

    def pad_to(self, tree, rows: int):
        """Pad the batch's leading dim to EXACTLY ``rows`` (repeating the
        last row; padded rows carry zero weight via :meth:`row_mask`, so
        the fill only has to be shape/dtype-valid, not meaningful)."""

        def _pad(x):
            x = np.asarray(x)
            n = x.shape[0]
            if n == rows:
                return x
            if n > rows:
                raise ValueError(
                    f"batch of {n} rows exceeds the canonical shape "
                    f"({rows} rows)"
                )
            return np.concatenate(
                [x, np.repeat(x[-1:], rows - n, axis=0)], axis=0
            )

        return map_tree(_pad, tree)

    def row_mask(self, n_real: int, rows: int) -> np.ndarray:
        """``(rows,)`` float32 sample weights: 1 for the real rows, 0 for
        the padding :meth:`pad_to` appended."""
        mask = np.zeros(rows, np.float32)
        mask[:n_real] = 1.0
        return mask

    def place_canonical(self, tree, rows: int):
        """pad_to + place_batch: THE canonical-shape feed; outputs are
        trimmed back by :func:`trim_pad`, and the loss side carries
        :meth:`place_mask` weights so the padding is weightless."""
        return self.place_batch(self.pad_to(tree, rows))

    def place_mask(self, n_real: int, rows: int) -> torch.Tensor:
        """:meth:`row_mask` placed like any 1-D batch leaf."""
        return self.place_batch(self.row_mask(n_real, rows))

    # ---- steps ------------------------------------------------------------

    def train_step(self, features, labels, weights=None) -> dict:
        """One optimizer step; returns ``{"loss": 0-d f32 tensor}`` on
        the device (read it with ``float()``, which waits for the step)."""
        _state, metrics = self._train_step(self.state, features, labels, weights)
        return metrics

    def eval_step(self, features, labels, weights=None):
        return self._eval_step(self.state, features, labels, weights)

    def predict_step(self, features):
        return self._predict_step(self.state.model, features)

    @property
    def step(self) -> int:
        """Model version: optimizer steps taken."""
        return self.state.step


def trim_pad(outputs, n: int):
    """Drop the rows padding added (device tensors come back as host
    numpy, bf16 as ``ml_dtypes.bfloat16``)."""
    return map_tree(
        lambda x: to_host(x)[:n] if isinstance(x, torch.Tensor)
        else np.asarray(x)[:n],
        outputs,
    )
