"""Embedding layers; the counterpart of ``elasticdl_tpu/layers/embedding.py``.

A table is one ``(rows, dim)`` parameter, looked up with a gather inside
the step; its gradient is the ordinary dense one, so the optimizer
treats it like any other parameter.  Rows are padded up to a multiple of
``vocab_pad_multiple`` as in the JAX package (the padded rows are never
looked up, so their gradients stay zero).

The mask contract is the JAX package's: an id below 0 (the ``PAD_ID``
of padded-sparse input) or at or past the table's rows gives a zero
vector and exactly zero gradient.  ``F.embedding`` alone would raise on
such an id (a device assert on CUDA), and clipping it would read and
train the last row.

Sparse (ragged) input is a fixed-width ``(batch, max_ids)`` id array
padded with ``PAD_ID``, plus optional weights.

Not here yet: the distribution policy (``auto_partition_rules``,
``_preferred_axes``), which comes with the port's sharded embeddings.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

PAD_ID = -1

Combiner = ("sum", "mean", "sqrtn")

# the JAX package's initializer names
UNIFORM, NORMAL, ZEROS, ONES = "uniform", "normal", "zeros", "ones"


def resolve_initializer(name_or_fn) -> Callable:
    """An in-place initializer ``fn(tensor)`` for the JAX package's
    initializer names, drawing from flax's distributions (flax's
    ``uniform(scale=0.05)`` is U[0, 0.05))."""
    if callable(name_or_fn):
        return name_or_fn
    name = str(name_or_fn).lower()
    if name in (UNIFORM, "random_uniform"):
        return lambda t: nn.init.uniform_(t, 0.0, 0.05)
    if name in (NORMAL, "random_normal"):
        return lambda t: nn.init.normal_(t, 0.0, 0.05)
    if name == ZEROS:
        return nn.init.zeros_
    if name == ONES:
        return nn.init.ones_
    if name == "glorot_uniform":
        return nn.init.xavier_uniform_
    raise ValueError(f"unknown embedding initializer: {name_or_fn!r}")


def _in_range(table: torch.Tensor, ids: torch.Tensor):
    """``(mask, safe_ids)``: which ids address a row, and the ids with
    every other one replaced by row 0 (read, then weighted by 0)."""
    mask = (ids >= 0) & (ids < table.shape[0])
    return mask, torch.where(mask, ids, torch.zeros_like(ids))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Dense lookup: ``ids`` of any shape -> ``ids.shape + (dim,)``; an
    out-of-range id gives a zero vector and zero gradient."""
    mask, safe = _in_range(table, ids)
    out = F.embedding(safe, table)
    return out * mask.unsqueeze(-1).to(out.dtype)


def safe_embedding_lookup_sparse(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    combiner: str = "mean",
) -> torch.Tensor:
    """Combined lookup over padded-sparse ids: ``(batch, max_ids)`` ids
    (and optional weights) -> ``(batch, dim)`` by ``combiner`` (sum,
    mean or sqrtn); a row with no id in range gives zeros.  Out-of-range
    ids leave the combine and take no gradient."""
    if combiner not in Combiner:
        raise ValueError(f"combiner must be one of {Combiner}, got {combiner}")
    in_range, safe = _in_range(table, ids)
    mask = in_range.to(table.dtype)
    emb = F.embedding(safe, table)  # (b, k, d)
    w = mask if weights is None else weights.to(table.dtype) * mask
    summed = torch.einsum("bk,bkd->bd", w, emb)
    if combiner == "sum":
        return summed
    if combiner == "mean":
        denom = w.sum(-1)
    else:  # sqrtn
        denom = torch.sqrt((w * w).sum(-1))
    return summed / torch.clamp(denom, min=1e-12)[:, None]


def _as_ids(ids) -> torch.Tensor:
    """Ids as int32 or int64 (narrower wire dtypes widen here, on the
    device that holds them)."""
    ids = torch.as_tensor(ids)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    return ids


def padded_rows(input_dim: int, vocab_pad_multiple: int) -> int:
    m = max(1, vocab_pad_multiple)
    return -(-input_dim // m) * m


class Embedding(nn.Module):
    """The JAX package's ``Embedding``: dense ids -> per-id vectors; with
    a ``combiner``, ``(batch, max_ids)`` padded ids -> one combined row
    per example.  The table is the parameter ``embedding`` (flax's
    name), of ``padded_input_dim`` rows."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        embeddings_initializer=UNIFORM,
        combiner: str | None = None,
        dtype=torch.float32,
        vocab_pad_multiple: int = 1,
    ):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.padded_input_dim = padded_rows(input_dim, vocab_pad_multiple)
        self.embedding = nn.Parameter(
            torch.empty(self.padded_input_dim, output_dim, dtype=dtype)
        )
        with torch.no_grad():
            resolve_initializer(embeddings_initializer)(self.embedding)

    def forward(self, ids, weights=None) -> torch.Tensor:
        ids = _as_ids(ids)
        if self.combiner is not None:
            if ids.ndim != 2:
                raise ValueError(
                    "combiner lookup expects (batch, max_ids) padded ids, "
                    f"got shape {tuple(ids.shape)}"
                )
            return safe_embedding_lookup_sparse(
                self.embedding, ids, weights, self.combiner
            )
        return embedding_lookup(self.embedding, ids)


class SparseEmbedding(Embedding):
    """A combiner embedding whose table is declared shard-eligible (the
    JAX package's ``SparseEmbedding``); on one device it is
    :class:`Embedding` with a combiner (``sum`` by default)."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        combiner: str = "sum",
        embeddings_initializer=UNIFORM,
        dtype=torch.float32,
        vocab_pad_multiple: int = 1,
    ):
        super().__init__(
            input_dim, output_dim, embeddings_initializer, combiner, dtype,
            vocab_pad_multiple,
        )
