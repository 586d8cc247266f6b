"""Step builders; the counterpart of ``elasticdl_tpu/trainer/step.py``.

This slice has the predict step only.  PyTorch runs eagerly, so there
is no ``jit``: the step is a plain function of ``(model, features)``.
"""

from __future__ import annotations

from typing import Callable

import torch


def build_predict_step(device_parse: Callable | None = None) -> Callable:
    """``predict_step(model, features) -> outputs``: the model in eval
    mode under ``torch.inference_mode()``, after the model's optional
    device-side parse of the features."""

    def predict_step(model: torch.nn.Module, features):
        model.eval()
        with torch.inference_mode():
            if device_parse is not None:
                features = device_parse(features)
            return model(features)

    return predict_step
