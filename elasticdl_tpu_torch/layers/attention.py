"""Attention layers over the port's kernels.

The counterpart of ``elasticdl_tpu/layers/attention.py``.
``MultiHeadSelfAttention`` projects QKV and calls
:func:`elasticdl_tpu_torch.ops.attention.attention` (the flash kernel on
CUDA, its plain version on the CPU).

Mixed precision follows flax: parameters stay f32; with ``dtype`` set,
each projection casts its input AND its f32 weight to the compute dtype
(as flax's ``promote_dtype`` does inside ``Dense``/``DenseGeneral``), and
LayerNorm reduces in f32 and casts its output to the compute dtype.
Flax details the port matches: LayerNorm ``epsilon=1e-6`` (torch's
default is 1e-5) and the tanh approximation of GELU.

Dropout draws its mask from an explicit ``torch.Generator`` that the
train step seeds from ``(seed, step)`` (:func:`dropout_generator`), the
counterpart of the JAX package's ``fold_in(PRNGKey(0), step)``: a step's
masks are the same whenever it is replayed and fresh at every step.  The
bits differ from JAX's.

Decode mode (``decode=True``, ``max_decode_len``) attends one token per
call over a KV cache, as the JAX layer's ``_decode_attend`` does.  The
flax ``cache`` collection becomes an explicit :class:`KVCache` that the
caller creates and passes in (plain tensors, no hidden module state);
the cursor ``decode_pos`` is the caller's too (the LM's one cursor).
The decode attention is plain torch ops in f32, as in JAX, where it is
jnp outside any Pallas kernel.

Not ported yet: the MoE MLP (``num_experts > 0`` raises).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.ops import attention as attention_ops
from elasticdl_tpu_torch.parallel import elastic

# flax nn.LayerNorm's default epsilon
LAYER_NORM_EPS = 1e-6


def compute_dtype(dtype, x: torch.Tensor) -> torch.dtype:
    """The dtype a flax layer computes in: ``dtype`` when set, else the
    promotion of the input with the f32 parameters."""
    if dtype is not None:
        return dtype
    return torch.promote_types(x.dtype, torch.float32)


def dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias cast to the compute dtype
    (flax ``Dense`` with ``dtype=``; parameters stay f32)."""
    dt = compute_dtype(dtype, x)
    bias = layer.bias.to(dt) if layer.bias is not None else None
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics and normalisation in f32,
    output cast to the compute dtype."""
    y = F.layer_norm(
        x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps
    )
    return y.to(compute_dtype(dtype, x))


def to_torch_dtype(dtype):
    """``None``, a torch dtype, or a name such as ``"bfloat16"`` (the
    form a manifest's ``model_params`` carries)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def dropout_seed(step: int, seed: int = 0) -> int:
    """The seed of training step ``step``'s dropout generator, from
    ``(seed, step)`` through numpy's ``SeedSequence``, so neighbouring
    steps get unrelated streams."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def dropout_generator(step: int, device, seed: int = 0) -> torch.Generator:
    """The dropout generator of training step ``step``, seeded with
    :func:`dropout_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(dropout_seed(step, seed))
    return gen


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None):
    """flax ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``; the mask
    comes from ``generator``.  ``generator=None`` means inference: ``x``
    unchanged.  In a data-parallel step (``parallel/elastic.py``) the mask
    is the global batch's, cut to this process's rows."""
    if rate == 0.0 or generator is None:
        return x
    rows = elastic.current_rows()
    if rows is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        # a data-parallel step draws the global batch's mask and keeps its
        # own rows, so the masks are those of one process on the batch
        shape = (rows.total,) + tuple(x.shape[1:])
        keep = torch.rand(shape, generator=generator, device=x.device)[rows.start:rows.stop] >= rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


@dataclass
class KVCache:
    """One attention layer's decode cache: ``k`` and ``v`` of shape
    ``(batch, max_decode_len, kv_heads, head_dim)`` in the compute dtype
    (the JAX layer's ``cache/k`` and ``cache/v``).  A decode call writes
    its step's K/V at the cursor in place."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def empty(cls, batch: int, max_decode_len: int, kv_heads: int,
              head_dim: int, dtype, device=None) -> "KVCache":
        shape = (batch, max_decode_len, kv_heads, head_dim)
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )


class MultiHeadSelfAttention(nn.Module):
    """x: (batch, seq, embed) -> (batch, seq, embed).  ``num_kv_heads``
    > 0 gives grouped-query attention (fewer K/V heads than Q heads).
    ``decode=True``: one token per call, attending over ``cache`` (a
    :class:`KVCache` of ``max_decode_len`` positions) up to and
    including ``decode_pos``."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        causal: bool = False,
        num_kv_heads: int = 0,
        dtype=None,
        decode: bool = False,
        max_decode_len: int = 0,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"embed dim {embed_dim} not divisible by {num_heads} heads"
            )
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.dtype = to_torch_dtype(dtype)
        self.decode = decode
        self.max_decode_len = max_decode_len
        q_width = num_heads * self.head_dim
        kv_width = self.num_kv_heads * self.head_dim
        self.query = nn.Linear(embed_dim, q_width)
        self.key = nn.Linear(embed_dim, kv_width)
        self.value = nn.Linear(embed_dim, kv_width)
        self.out = nn.Linear(q_width, embed_dim)

    def empty_cache(self, batch: int, dtype, device=None) -> KVCache:
        """A zeroed :class:`KVCache` for this layer's decode mode."""
        if not self.max_decode_len:
            raise ValueError("decode=True needs max_decode_len")
        return KVCache.empty(
            batch, self.max_decode_len, self.num_kv_heads, self.head_dim,
            dtype, device,
        )

    def forward(
        self, x: torch.Tensor, decode_pos: int | None = None,
        cache: KVCache | None = None,
    ) -> torch.Tensor:
        batch, seq, _ = x.shape

        def proj(layer, heads):
            return dense(x, layer, self.dtype).view(
                batch, seq, heads, self.head_dim
            )

        q = proj(self.query, self.num_heads)
        k = proj(self.key, self.num_kv_heads)
        v = proj(self.value, self.num_kv_heads)
        if self.decode:
            if decode_pos is None:
                raise ValueError("decode mode needs decode_pos")
            out = self._decode_attend(q, k, v, decode_pos, cache)
        else:
            out = attention_ops.attention(q, k, v, causal=self.causal)
        out = out.to(x.dtype).reshape(batch, seq, self.num_heads * self.head_dim)
        return dense(out, self.out, self.dtype)

    def _decode_attend(self, q, k, v, pos: int, cache: KVCache | None):
        """One decode step: write this step's K/V into ``cache`` at
        ``pos``, then attend the single query over the filled prefix
        (positions past the cursor are masked), in f32."""
        if not self.max_decode_len:
            raise ValueError("decode=True needs max_decode_len")
        if q.shape[1] != 1:
            raise ValueError(
                f"decode mode consumes one token per call, got seq {q.shape[1]}"
            )
        if cache is None:
            raise ValueError("decode mode needs the layer's KVCache")
        cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
        kf, vf = attention_ops.repeat_kv_heads(q, cache.k, cache.v)
        scale = 1.0 / torch.sqrt(torch.tensor(self.head_dim, dtype=torch.float32))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * scale.to(q.device)
        # the filled prefix, this step included
        valid = torch.arange(self.max_decode_len, device=q.device) <= pos
        scores = torch.where(valid, scores, attention_ops._NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vf.float())
        return out.to(q.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm block: LayerNorm -> attention -> residual, LayerNorm ->
    dense MLP (GELU, tanh form) -> residual.  Dropout applies only when
    the caller passes a ``generator`` (training)."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        mlp_ratio: int = 4,
        causal: bool = False,
        dropout_rate: float = 0.0,
        num_experts: int = 0,
        num_kv_heads: int = 0,
        dtype=None,
        decode: bool = False,
        max_decode_len: int = 0,
    ):
        super().__init__()
        if num_experts > 0:
            raise NotImplementedError(
                "the MoE MLP (num_experts > 0) is not ported yet"
            )
        self.dtype = to_torch_dtype(dtype)
        self.ln1 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.attn = MultiHeadSelfAttention(
            embed_dim, num_heads, causal=causal, num_kv_heads=num_kv_heads,
            dtype=dtype, decode=decode, max_decode_len=max_decode_len,
        )
        self.ln2 = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.mlp_up = nn.Linear(embed_dim, embed_dim * mlp_ratio)
        self.mlp_down = nn.Linear(embed_dim * mlp_ratio, embed_dim)
        self.dropout_rate = dropout_rate

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None,
        decode_pos: int | None = None, cache: KVCache | None = None,
    ) -> torch.Tensor:
        y = self.attn(
            layer_norm(x, self.ln1, self.dtype), decode_pos=decode_pos, cache=cache
        )
        x = x + dropout(y, self.dropout_rate, generator)
        y = layer_norm(x, self.ln2, self.dtype)
        y = F.gelu(dense(y, self.mlp_up, self.dtype), approximate="tanh")
        y = dense(y, self.mlp_down, self.dtype)
        return x + dropout(y, self.dropout_rate, generator)


def sinusoidal_positions(
    seq_len: int, dim: int, device=None
) -> torch.Tensor:
    """Fixed sinusoidal position encoding (seq, dim), f32."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / dim)
    )
    enc = torch.zeros((seq_len, dim), dtype=torch.float32, device=device)
    enc[:, 0::2] = torch.sin(pos * div)
    enc[:, 1::2] = torch.cos(pos * div)
    return enc
