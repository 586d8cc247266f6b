"""ResNet-50's building blocks; the port of
``elasticdl_tpu/models/resnet50_model.py``.

IdentityBlock and ConvBlock bottlenecks with BatchNorm (momentum 0.9,
epsilon 1e-5) and ``he_normal`` conv kernels without bias, and the whole
network: a 7x7/2 stem, a 3x3/2 max-pool, 16 bottleneck blocks, a global
mean pool and ``Dense(num_classes)``, returning softmax probabilities.
The L2 weight decay of 1e-4 is the optimizer's
(``resnet50_subclass.optimizer``), as in the JAX package.

Where flax and torch differ, the port follows flax:

- Submodule names are flax's (``conv1``, ``bn_conv1``,
  ``conv_block_2.conv_shortcut``, ``identity_block_3_2.bn_c``, ``fc``),
  so the checkpoint's names, the decay mask and ``utils/flax_weights.py``
  are plain name maps.
- The convolutions run on NCHW activations with OIHW kernels.  Images
  arrive NHWC, and their permutation to NCHW has ``channels_last``
  strides, which the convolutions and BatchNorm keep (cuDNN's NHWC
  path); the arithmetic is the same in either layout.
- The stem's max-pool is XLA's SAME: on an odd total the pad is one
  larger AFTER the input than before it (:func:`max_pool_same`); a
  symmetric ``padding=1`` would shift every window by one.
- A strided ConvBlock strides its 1x1 ``conv_a`` and its 1x1 shortcut,
  never the 3x3.
- ``dtype`` (e.g. ``"bfloat16"``) is the compute dtype: parameters and
  BatchNorm statistics stay f32, each convolution casts its f32 kernel to
  ``dtype`` where it is used, and the probabilities come out f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.attention import dense, to_torch_dtype
from elasticdl_tpu_torch.layers.initializers import flax_default_init_, he_normal_
from elasticdl_tpu_torch.layers.normalization import BatchNorm
from elasticdl_tpu_torch.models.mnist_functional_api import conv

L2_WEIGHT_DECAY = 1e-4
BATCH_NORM_DECAY = 0.9
BATCH_NORM_EPSILON = 1e-5


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    """flax ``Conv(out_ch, (kernel, kernel), strides, use_bias=False,
    kernel_init=he_normal())``, SAME-padded; an odd kernel at stride 1
    pads ``kernel // 2`` on each side, and a 1x1 needs no pad at any
    stride."""
    layer = nn.Conv2d(
        in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=False
    )
    with torch.no_grad():
        he_normal_(layer.weight)
    return layer


def _bn(channels: int, dtype) -> BatchNorm:
    return BatchNorm(
        channels, axis=1, momentum=BATCH_NORM_DECAY,
        epsilon=BATCH_NORM_EPSILON, dtype=dtype,
    )


class _Bottleneck(nn.Module):
    """1x1 ``conv_a`` (strided), ``kernel_size`` ``conv_b``, 1x1
    ``conv_c``, each followed by its BatchNorm."""

    def __init__(self, in_channels: int, kernel_size: int, filters,
                 strides: int, dtype):
        super().__init__()
        f1, f2, f3 = filters
        self.dtype = to_torch_dtype(dtype)
        self.conv_a = _conv(in_channels, f1, 1, strides)
        self.bn_a = _bn(f1, self.dtype)
        self.conv_b = _conv(f1, f2, kernel_size)
        self.bn_b = _bn(f2, self.dtype)
        self.conv_c = _conv(f2, f3, 1)
        self.bn_c = _bn(f3, self.dtype)

    def _bottleneck(self, x, training):
        dt = self.dtype
        x = F.relu(self.bn_a(conv(x, self.conv_a, dt), training))
        x = F.relu(self.bn_b(conv(x, self.conv_b, dt), training))
        return self.bn_c(conv(x, self.conv_c, dt), training)


class IdentityBlock(_Bottleneck):
    """The bottleneck whose shortcut is the identity: ``in_channels``
    must be ``filters[2]``."""

    def __init__(self, in_channels: int, kernel_size: int, filters, dtype=None):
        super().__init__(in_channels, kernel_size, filters, 1, dtype)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        return F.relu(self._bottleneck(x, training) + x)


class ConvBlock(_Bottleneck):
    """The bottleneck with a 1x1 projection shortcut; ``strides`` is on
    ``conv_a`` and the shortcut."""

    def __init__(self, in_channels: int, kernel_size: int, filters,
                 strides: int = 2, dtype=None):
        super().__init__(in_channels, kernel_size, filters, strides, dtype)
        self.conv_shortcut = _conv(in_channels, filters[2], 1, strides)
        self.bn_shortcut = _bn(filters[2], self.dtype)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        shortcut = self.bn_shortcut(conv(x, self.conv_shortcut, self.dtype), training)
        return F.relu(self._bottleneck(x, training) + shortcut)


# (filters, blocks, stride) of ResNet-50's stages 2 to 5
RESNET50_STAGES = (
    ((64, 64, 256), 3, 1),
    ((128, 128, 512), 4, 2),
    ((256, 256, 1024), 6, 2),
    ((512, 512, 2048), 3, 2),
)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (window, window), (stride, stride),
    padding="SAME")`` on NCHW ``x``.  XLA pads each spatial axis by
    ``(out - 1) * stride + window - size`` in all, ``out =
    ceil(size / stride)``: ``total // 2`` before and the rest after, with
    -inf, which no window takes."""
    pads = []
    for size in reversed(x.shape[2:]):  # F.pad lists the last axis first
        out = -(-size // stride)
        total = max((out - 1) * stride + window - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 10, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = to_torch_dtype(dtype)
        # the JAX model zero-pads 3 and runs a VALID 7x7/2 conv: the same
        # as a conv with padding 3
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        with torch.no_grad():
            he_normal_(self.conv1.weight)
        self.bn_conv1 = _bn(64, self.dtype)
        self.block_names = []
        channels = 64
        for stage, (filters, blocks, stride) in enumerate(RESNET50_STAGES, start=2):
            self._add_block(
                f"conv_block_{stage}",
                ConvBlock(channels, 3, filters, stride, self.dtype),
            )
            channels = filters[2]
            for b in range(1, blocks):
                self._add_block(
                    f"identity_block_{stage}_{b}",
                    IdentityBlock(channels, 3, filters, self.dtype),
                )
        self.fc = nn.Linear(channels, num_classes)
        flax_default_init_(self.fc)

    def _add_block(self, name: str, block: nn.Module) -> None:
        self.add_module(name, block)
        self.block_names.append(name)

    def forward(
        self, features, training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """f32 probabilities ``(batch, num_classes)`` from NHWC images;
        ``training=True`` normalises by the batch's statistics and moves
        the running ones.  The model has no dropout: ``generator`` is
        unused."""
        x = features["image"] if isinstance(features, dict) else features
        x = torch.as_tensor(x, device=self.fc.weight.device)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NHWC memory, read as NCHW
        x = F.relu(self.bn_conv1(conv(x, self.conv1, self.dtype), training))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, training)
        x = x.mean((2, 3))
        # up to f32 before the softmax, so that a bf16 model's loss is
        # stable
        return torch.softmax(dense(x, self.fc, self.dtype).float(), dim=-1)
