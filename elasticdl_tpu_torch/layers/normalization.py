"""Flax's ``nn.BatchNorm`` in PyTorch: the rule the JAX package's
models train their running statistics by, which ``nn.BatchNorm2d``
does not follow.

- Momentum is the weight of the OLD value (flax's convention):
  ``ra = momentum * ra + (1 - momentum) * batch``.  ``momentum=0.9``
  here is ``nn.BatchNorm2d(momentum=0.1)``.
- The running variance takes the BIASED batch variance (torch's takes
  the unbiased one), computed as flax computes it:
  ``max(E[x^2] - E[x]^2, 0)``, in f32 whatever the input's dtype.
- ``epsilon`` defaults to flax's 1e-5.
- Batch statistics cover every row the layer sees, the zero-weight
  padding rows of a canonical batch included, as in the JAX step.
- In a data-parallel step (``parallel/elastic.py::current_rows``) they
  cover the GLOBAL batch, as the JAX step's do over its sharded batch:
  each process all-reduces its sums of x and x^2 in f32 over the group,
  through an all-reduce autograd sees
  (``torch.distributed.nn.functional.all_reduce``), so the backward
  carries the statistics' cross-process terms.

Parameter and statistic names are flax's (``scale``, ``bias``; the
``batch_stats`` collection's ``mean`` and ``var``), and all four stay
f32; ``dtype`` is the compute dtype of the output.

Under ``--remat`` the backward runs the forward a second time, and the
running statistics must move once per step, as in the JAX package, whose
BatchNorm returns them from the forward instead of writing them:
:func:`frozen_statistics` holds them still for that second run.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from elasticdl_tpu_torch.layers.attention import compute_dtype
from elasticdl_tpu_torch.parallel import elastic

# flax nn.BatchNorm's defaults
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.99


class BatchNorm(nn.Module):
    """Normalise over every axis but ``axis`` (the feature axis: 1 for
    NCHW activations), with learned ``scale`` and ``bias``.

    ``forward(x, training)``: in training the batch's statistics
    normalise ``x`` (gradients flow through them) and move the running
    ones; otherwise the running statistics normalise it."""

    def __init__(
        self,
        num_features: int,
        axis: int = 1,
        momentum: float = BATCH_NORM_MOMENTUM,
        epsilon: float = BATCH_NORM_EPS,
        dtype=None,
    ):
        super().__init__()
        self.axis = axis
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        # False while frozen_statistics holds the running statistics
        self.update_statistics = True

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        axis = self.axis % x.ndim
        feature_shape = [1] * x.ndim
        feature_shape[axis] = x.shape[axis]
        if training:
            reduce = [d for d in range(x.ndim) if d != axis]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            rows = elastic.current_rows()
            if rows is None:
                mean = xf.mean(reduce)
                mean_sq = (xf * xf).mean(reduce)
            else:
                mean, mean_sq = _global_means(xf, reduce, axis, rows)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if self.update_statistics:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean.reshape(feature_shape)) * mul.reshape(feature_shape)
        y = y + self.bias.reshape(feature_shape)
        return y.to(compute_dtype(self.dtype, x))


def _global_means(xf: torch.Tensor, reduce: list, axis: int, rows) -> tuple:
    """E[x] and E[x^2] over the global batch of a data-parallel step:
    this process's sums all-reduced over the group (every process holds
    the same number of rows)."""
    from torch.distributed.nn.functional import all_reduce

    count = (xf.numel() // xf.shape[axis]) * rows.world_size
    sums = torch.stack([xf.sum(reduce), (xf * xf).sum(reduce)])
    sums = all_reduce(sums, group=rows.group)
    return sums[0] / count, sums[1] / count


@contextlib.contextmanager
def frozen_statistics(model: torch.nn.Module):
    """Within: ``model``'s BatchNorm layers normalise training batches by
    the batch's statistics as always, but leave the running statistics
    as they are (the recompute of a rematerialized forward)."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for layer in layers:
        layer.update_statistics = False
    try:
        yield
    finally:
        for layer in layers:
            layer.update_statistics = True
