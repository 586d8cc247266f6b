"""Flax's initializers for ``Dense`` and ``Conv`` layers (the default
``lecun_normal`` and ResNet's ``he_normal``), so that a model of the
port that starts from no checkpoint draws its weights from the
distributions the JAX package's model draws from (the bits differ: the
generators do)."""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def _variance_scaling_(weight: torch.Tensor, scale: float) -> torch.Tensor:
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    a normal truncated to two standard deviations, scaled to variance
    ``scale / fan_in``.  ``weight`` is in torch's layout (``(out, in,
    *kernel)``), so its fan-in is the product of every dimension but the
    first (flax's ``H * W * I`` of an HWIO kernel)."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(scale / fan_in) / _TRUNCATED_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's ``lecun_normal()``: variance ``1 / fan_in``."""
    return _variance_scaling_(weight, 1.0)


def he_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's ``he_normal()``: variance ``2 / fan_in``."""
    return _variance_scaling_(weight, 2.0)


def flax_default_init_(layer: nn.Linear | nn.Conv2d) -> None:
    """A ``Linear`` or ``Conv2d`` as flax's ``Dense``/``Conv`` start:
    ``lecun_normal`` kernel, zero bias."""
    with torch.no_grad():
        lecun_normal_(layer.weight)
        if layer.bias is not None:
            layer.bias.zero_()
