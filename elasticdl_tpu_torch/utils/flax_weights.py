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
``(embed, heads*head_dim)``.  The conversion is exact both ways.
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


class _Entry(NamedTuple):
    torch_key: str
    flax_key: str
    transpose: bool  # a Linear weight: flax holds its transpose
    torch_shape: tuple
    flax_shape: tuple


def _linear(t: str, f: str, layer: nn.Linear, kernel_shape=None,
            bias_shape=None) -> list[_Entry]:
    out_f, in_f = layer.weight.shape
    return [
        _Entry(f"{t}.weight", f"{f}/kernel", True, (out_f, in_f),
               kernel_shape or (in_f, out_f)),
        _Entry(f"{t}.bias", f"{f}/bias", False, (out_f,),
               bias_shape or (out_f,)),
    ]


def _layer_norm(t: str, f: str, layer: nn.LayerNorm) -> list[_Entry]:
    shape = tuple(layer.normalized_shape)
    return [
        _Entry(f"{t}.weight", f"{f}/scale", False, shape, shape),
        _Entry(f"{t}.bias", f"{f}/bias", False, shape, shape),
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
    shape = tuple(model.tok_embed.weight.shape)
    entries = [
        _Entry("tok_embed.weight", "tok_embed/embedding", False, shape, shape),
    ]
    for i, block in enumerate(model.blocks):
        entries += _block(f"blocks.{i}.", f"block_{i}/", block)
    entries += _layer_norm("ln_f", "LayerNorm_0", model.ln_f)
    entries += _linear("lm_head", "lm_head", model.lm_head)
    return entries


def _entries(model: nn.Module) -> list[_Entry]:
    if isinstance(model, TransformerLM):
        return _lm(model)
    if isinstance(model, TransformerBlock):
        return _block("", "", model)
    if isinstance(model, MultiHeadSelfAttention):
        return _attention("", "", model)
    raise TypeError(f"no flax weight mapping for {type(model).__name__}")


def torch_state_from_flax(
    flat: dict[str, np.ndarray], model: nn.Module
) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` from flat flax parameter arrays.
    Raises on a missing name, a shape that disagrees, or a name the
    model does not have."""
    state = {}
    entries = _entries(model)
    for e in entries:
        if e.flax_key not in flat:
            raise KeyError(f"flax parameters lack {e.flax_key!r}")
        arr = np.asarray(flat[e.flax_key], dtype=np.float32)
        if arr.shape != e.flax_shape:
            raise ValueError(
                f"shape mismatch for {e.flax_key!r}: flax {arr.shape} vs "
                f"model {e.flax_shape}"
            )
        if e.transpose:
            arr = arr.reshape(e.torch_shape[::-1]).T
        state[e.torch_key] = torch.from_numpy(
            np.ascontiguousarray(arr.reshape(e.torch_shape))
        )
    extra = set(flat) - {e.flax_key for e in entries}
    if extra:
        raise KeyError(f"flax parameters the model lacks: {sorted(extra)}")
    return state


def flax_flat_from_torch(model: nn.Module) -> dict[str, np.ndarray]:
    """The inverse: flat flax-named f32 arrays from ``model``'s weights,
    each a host copy that no later update of the model changes."""
    state = model.state_dict()
    flat = {}
    for e in _entries(model):
        arr = state[e.torch_key].detach().to("cpu", torch.float32, copy=True).numpy()
        if e.transpose:
            arr = arr.T
        flat[e.flax_key] = np.ascontiguousarray(arr.reshape(e.flax_shape))
    return flat
