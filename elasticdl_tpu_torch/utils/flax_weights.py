"""Carry weights between the JAX package's flax parameters and the port's
torch modules.

Flax side: the flat name-keyed dict the JAX package exports and
checkpoints (``'/'``-joined parameter paths, ``tree_to_dict`` in
``elasticdl_tpu/utils/tree_utils.py``), e.g. ``block_0/attn/query/kernel``.
Torch side: the module's ``state_dict`` keys, e.g.
``blocks.0.attn.query.weight``.

Layout rules: a flax ``Dense`` kernel is ``(in, out)`` and a torch
``Linear.weight`` is ``(out, in)``; a ``DenseGeneral`` Q/K/V kernel is
``(embed, heads, head_dim)`` with bias ``(heads, head_dim)``, and the
attention ``out`` kernel is ``(heads, head_dim, embed)`` — the port's
``Linear`` holds them flattened to ``(heads*head_dim, embed)`` and
``(embed, heads*head_dim)``.  A flax ``Conv`` kernel is HWIO and a torch
``Conv2d.weight`` OIHW.  The conversion is exact both ways.

Beside the parameters, a model may carry state of the JAX package's
mutable collections: BatchNorm's running statistics are the
``batch_stats`` collection (``batch_stats/BatchNorm_0/mean``), module
buffers on the torch side.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.layers.attention import (
    MultiHeadSelfAttention,
    TransformerBlock,
)
from elasticdl_tpu_torch.models.long_seq_transformer import TransformerLM

PARAMS = "params"
BATCH_STATS = "batch_stats"

# the axes permutation that takes a flax kernel to torch's layout
_LINEAR = (1, 0)  # (in, out) -> (out, in)
_CONV = (3, 2, 0, 1)  # HWIO -> OIHW


class _Entry(NamedTuple):
    torch_key: str
    flax_key: str  # within its collection
    perm: tuple | None  # flax -> torch axes permutation (None: same layout)
    torch_shape: tuple
    flax_shape: tuple
    collection: str = PARAMS


def _to_torch(e: _Entry, arr: np.ndarray) -> np.ndarray:
    if e.perm is not None:
        # the flax array as the permutation's source shape, then permuted
        source = [e.torch_shape[e.perm.index(j)] for j in range(len(e.perm))]
        arr = np.transpose(arr.reshape(source), e.perm)
    return np.ascontiguousarray(arr.reshape(e.torch_shape))


def _to_flax(e: _Entry, arr: np.ndarray) -> np.ndarray:
    if e.perm is not None:
        arr = np.transpose(arr, np.argsort(e.perm))
    return np.ascontiguousarray(arr.reshape(e.flax_shape))


def _copy(t: str, f: str, tensor: torch.Tensor, collection=PARAMS) -> _Entry:
    shape = tuple(tensor.shape)
    return _Entry(t, f, None, shape, shape, collection)


def _linear(t: str, f: str, layer: nn.Linear, kernel_shape=None,
            bias_shape=None) -> list[_Entry]:
    out_f, in_f = layer.weight.shape
    return [
        _Entry(f"{t}.weight", f"{f}/kernel", _LINEAR, (out_f, in_f),
               kernel_shape or (in_f, out_f)),
        _Entry(f"{t}.bias", f"{f}/bias", None, (out_f,),
               bias_shape or (out_f,)),
    ]


def _conv(t: str, f: str, layer: nn.Conv2d) -> list[_Entry]:
    o, i, kh, kw = layer.weight.shape
    entries = [
        _Entry(f"{t}.weight", f"{f}/kernel", _CONV, (o, i, kh, kw),
               (kh, kw, i, o)),
    ]
    if layer.bias is not None:  # use_bias=False has no bias
        entries.append(_copy(f"{t}.bias", f"{f}/bias", layer.bias))
    return entries


def _batch_norm(t: str, f: str, layer) -> list[_Entry]:
    return [
        _copy(f"{t}.scale", f"{f}/scale", layer.scale),
        _copy(f"{t}.bias", f"{f}/bias", layer.bias),
        _copy(f"{t}.mean", f"{f}/mean", layer.mean, BATCH_STATS),
        _copy(f"{t}.var", f"{f}/var", layer.var, BATCH_STATS),
    ]


def _layer_norm(t: str, f: str, layer: nn.LayerNorm) -> list[_Entry]:
    return [
        _copy(f"{t}.weight", f"{f}/scale", layer.weight),
        _copy(f"{t}.bias", f"{f}/bias", layer.bias),
    ]


def _attention(t: str, f: str, attn: MultiHeadSelfAttention) -> list[_Entry]:
    embed = attn.out.out_features
    dh = attn.head_dim
    entries = []
    for name, heads in (
        ("query", attn.num_heads),
        ("key", attn.num_kv_heads),
        ("value", attn.num_kv_heads),
    ):
        entries += _linear(
            f"{t}{name}", f"{f}{name}", getattr(attn, name),
            kernel_shape=(embed, heads, dh), bias_shape=(heads, dh),
        )
    entries += _linear(
        f"{t}out", f"{f}out", attn.out, kernel_shape=(attn.num_heads, dh, embed)
    )
    return entries


def _block(t: str, f: str, block: TransformerBlock) -> list[_Entry]:
    return (
        _layer_norm(f"{t}ln1", f"{f}LayerNorm_0", block.ln1)
        + _attention(f"{t}attn.", f"{f}attn/", block.attn)
        + _layer_norm(f"{t}ln2", f"{f}LayerNorm_1", block.ln2)
        + _linear(f"{t}mlp_up", f"{f}mlp_up", block.mlp_up)
        + _linear(f"{t}mlp_down", f"{f}mlp_down", block.mlp_down)
    )


def _lm(model: TransformerLM) -> list[_Entry]:
    entries = [_copy("tok_embed.weight", "tok_embed/embedding", model.tok_embed.weight)]
    for i, block in enumerate(model.blocks):
        entries += _block(f"blocks.{i}.", f"block_{i}/", block)
    entries += _layer_norm("ln_f", "LayerNorm_0", model.ln_f)
    entries += _linear("lm_head", "lm_head", model.lm_head)
    return entries


def _mnist(model) -> list[_Entry]:
    # the Dense rows need no permutation: the model flattens NHWC
    # activations, in flax's (H, W, C) order
    return (
        _conv("conv_0", "Conv_0", model.conv_0)
        + _conv("conv_1", "Conv_1", model.conv_1)
        + _batch_norm("batch_norm", "BatchNorm_0", model.batch_norm)
        + _linear("dense", "Dense_0", model.dense)
    )


def _deepfm(model) -> list[_Entry]:
    # flax numbers the deep tower's layers in construction order: the
    # output layer is built first (Dense_0), the hidden one second
    return [
        _copy("embedding.embedding", "embedding/embedding",
              model.embedding.embedding),
        _copy("id_bias.embedding", "id_bias/embedding", model.id_bias.embedding),
        *_linear("dense_hidden", "Dense_1", model.dense_hidden),
        *_linear("dense_out", "Dense_0", model.dense_out),
    ]


def _resnet_block(t: str, block) -> list[_Entry]:
    entries = []
    for name, child in block.named_children():
        if isinstance(child, nn.Conv2d):
            entries += _conv(f"{t}.{name}", f"{t}/{name}", child)
        else:
            entries += _batch_norm(f"{t}.{name}", f"{t}/{name}", child)
    return entries


def _resnet(model) -> list[_Entry]:
    # the torch names are flax's: conv_block_2.conv_a is conv_block_2/conv_a
    entries = _conv("conv1", "conv1", model.conv1)
    entries += _batch_norm("bn_conv1", "bn_conv1", model.bn_conv1)
    for name in model.block_names:
        entries += _resnet_block(name, getattr(model, name))
    return entries + _linear("fc", "fc", model.fc)


def _cifar10(model) -> list[_Entry]:
    # flax numbers the convs and the BatchNorms in order; the flatten is
    # NHWC, as the mnist model's
    entries = []
    for i, (layer, norm) in enumerate(zip(model.convs, model.norms)):
        entries += _conv(f"convs.{i}", f"Conv_{i}", layer)
        entries += _batch_norm(f"norms.{i}", f"BatchNorm_{i}", norm)
    return entries + _linear("output", "output", model.output)


def _feature_column_dnn(model) -> list[_Entry]:
    entries = [
        _copy(f"dense_features.{name}.embedding",
              f"DenseFeatures_0/{name}/embedding", table.embedding)
        for name, table in model.dense_features.named_children()
    ]
    for i in range(3):
        entries += _linear(f"dense_{i}", f"Dense_{i}", getattr(model, f"dense_{i}"))
    return entries


def _entries(model: nn.Module) -> list[_Entry]:
    # imported here: the model modules import trainer.state, which
    # imports this module
    from elasticdl_tpu_torch.models._tabular import FeatureColumnDNN
    from elasticdl_tpu_torch.models.cifar10_functional_api import Cifar10CNN
    from elasticdl_tpu_torch.models.deepfm_functional_api import DeepFM
    from elasticdl_tpu_torch.models.mnist_functional_api import MnistCNN
    from elasticdl_tpu_torch.models.odps_iris_dnn_model import IrisDNN
    from elasticdl_tpu_torch.models.resnet50_model import ResNet50

    if isinstance(model, TransformerLM):
        return _lm(model)
    if isinstance(model, MnistCNN):
        return _mnist(model)
    if isinstance(model, DeepFM):
        return _deepfm(model)
    if isinstance(model, ResNet50):
        return _resnet(model)
    if isinstance(model, Cifar10CNN):
        return _cifar10(model)
    if isinstance(model, FeatureColumnDNN):
        return _feature_column_dnn(model)
    if isinstance(model, IrisDNN):
        return _linear("output", "output", model.output)
    if isinstance(model, TransformerBlock):
        return _block("", "", model)
    if isinstance(model, MultiHeadSelfAttention):
        return _attention("", "", model)
    raise TypeError(f"no flax weight mapping for {type(model).__name__}")


def param_entries(model: nn.Module) -> list[_Entry]:
    """The model's parameter mapping: one entry per parameter, its torch
    ``state_dict`` key beside its flax name."""
    return [e for e in _entries(model) if e.collection == PARAMS]


def _load(entries, flat, what) -> dict[str, torch.Tensor]:
    state = {}
    for e in entries:
        if e.flax_key not in flat:
            raise KeyError(f"flax {what} lack {e.flax_key!r}")
        # a copy: the tensor owns its memory, whatever holds ``flat``
        arr = np.array(flat[e.flax_key], dtype=np.float32)
        if arr.shape != e.flax_shape:
            raise ValueError(
                f"shape mismatch for {e.flax_key!r}: flax {arr.shape} vs "
                f"model {e.flax_shape}"
            )
        state[e.torch_key] = torch.from_numpy(_to_torch(e, arr))
    extra = set(flat) - {e.flax_key for e in entries}
    if extra:
        raise KeyError(f"flax {what} the model lacks: {sorted(extra)}")
    return state


def torch_state_from_flax(
    flat: dict[str, np.ndarray], model: nn.Module,
    flat_state: dict[str, np.ndarray] | None = None,
) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` from flat flax parameter arrays
    and, when ``flat_state`` is given, its collections' arrays (keyed
    with the collection, ``batch_stats/BatchNorm_0/mean``); with
    ``flat_state=None`` the model's buffers are left out.  Raises on a
    missing name, a shape that disagrees, or a name the model does not
    have."""
    entries = _entries(model)
    state = _load([e for e in entries if e.collection == PARAMS], flat, "parameters")
    if flat_state is not None:
        stateful = [
            e._replace(flax_key=f"{e.collection}/{e.flax_key}")
            for e in entries if e.collection != PARAMS
        ]
        state.update(_load(stateful, flat_state, "model state"))
    return state


def _host(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().to("cpu", torch.float32, copy=True).numpy()


def flax_flat_from_torch(model: nn.Module, skip=()) -> dict[str, np.ndarray]:
    """The inverse: flat flax-named f32 parameter arrays from ``model``'s
    weights, each a host copy that no later update of the model
    changes; flax names in ``skip`` are left out."""
    state = model.state_dict()
    return {
        e.flax_key: _to_flax(e, _host(state[e.torch_key]))
        for e in param_entries(model) if e.flax_key not in skip
    }


def flax_state_from_torch(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's state beside its parameters (BatchNorm's running
    statistics) as the JAX package flattens its mutable collections:
    ``batch_stats/BatchNorm_0/mean`` -> f32 host copy.  Empty for a
    model without such state."""
    state = model.state_dict()
    return {
        f"{e.collection}/{e.flax_key}": _to_flax(e, _host(state[e.torch_key]))
        for e in _entries(model) if e.collection != PARAMS
    }
