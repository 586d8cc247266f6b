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

A table is built where :func:`tables_on` says (the job's device; the
CPU by default): on a card it is allocated and filled there from a
device generator seeded from the CPU generator, so a 100M-row table
never passes through host memory; on the CPU it is filled as before.
In a world whose model's ``sharding_rules`` row-shard a table, each
process holds only its rows and a lookup exchanges ids and rows with
their owners (``embeddings/sharded.py``; the layer's ``shard``).

Not here yet: the size-triggered distribution policy
(``auto_partition_rules``, ``_preferred_axes``), which needs the mesh
axes of slice 8.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

PAD_ID = -1

Combiner = ("sum", "mean", "sqrtn")

# the JAX package's initializer names
UNIFORM, NORMAL, ZEROS, ONES = "uniform", "normal", "zeros", "ones"


def resolve_initializer(name_or_fn) -> Callable:
    """An in-place initializer ``fn(tensor, generator=None)`` for the JAX
    package's initializer names, drawing from flax's distributions
    (flax's ``uniform(scale=0.05)`` is U[0, 0.05)); a callable is
    returned as it is and called with the tensor alone."""
    if callable(name_or_fn):
        return name_or_fn
    name = str(name_or_fn).lower()
    if name in (UNIFORM, "random_uniform"):
        return lambda t, generator=None: nn.init.uniform_(t, 0.0, 0.05, generator=generator)
    if name in (NORMAL, "random_normal"):
        return lambda t, generator=None: nn.init.normal_(t, 0.0, 0.05, generator=generator)
    if name == ZEROS:
        return lambda t, generator=None: nn.init.zeros_(t)
    if name == ONES:
        return lambda t, generator=None: nn.init.ones_(t)
    if name == "glorot_uniform":
        return lambda t, generator=None: nn.init.xavier_uniform_(t, generator=generator)
    raise ValueError(f"unknown embedding initializer: {name_or_fn!r}")


# where tables are built (tables_on); None: the CPU
_table_device: torch.device | None = None


@contextlib.contextmanager
def tables_on(device):
    """Within: every :class:`Embedding` built allocates and fills its
    table on ``device`` (None or the CPU: as ever, on the CPU)."""
    global _table_device
    previous = _table_device
    _table_device = None if device is None else torch.device(device)
    try:
        yield
    finally:
        _table_device = previous


def _new_table(rows: int, dim: int, dtype, initializer) -> torch.Tensor:
    """A ``(rows, dim)`` table filled by ``initializer`` where
    :func:`tables_on` says.  On a card the fill draws from a device
    generator whose seed is one draw of the CPU generator, so a seeded
    build (``torch.manual_seed``) gives every process the same table."""
    device = _table_device
    if device is None or device.type == "cpu":
        table = torch.empty(rows, dim, dtype=dtype)
        with torch.no_grad():
            resolve_initializer(initializer)(table)
        return table
    table = torch.empty(rows, dim, dtype=dtype, device=device)
    init = resolve_initializer(initializer)
    with torch.no_grad():
        if callable(initializer):
            init(table)
        else:
            seed = int(torch.randint(0, 2**62, (1,)).item())
            init(table, generator=torch.Generator(device=device).manual_seed(seed))
    return table


def _in_range(num_rows: int, ids: torch.Tensor):
    """``(mask, safe_ids)``: which ids address one of ``num_rows`` rows,
    and the ids with every other one replaced by row 0 (read, then
    weighted by 0)."""
    mask = (ids >= 0) & (ids < num_rows)
    return mask, torch.where(mask, ids, torch.zeros_like(ids))


def _gather(table: torch.Tensor, safe: torch.Tensor, shard=None) -> torch.Tensor:
    """The rows of in-range ids: a local gather, or through the owners
    of a row-sharded table (``embeddings/sharded.py``)."""
    if shard is None:
        return F.embedding(safe, table)
    from elasticdl_tpu_torch.embeddings.sharded import exchange_lookup

    return exchange_lookup(table, safe, shard)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, shard=None) -> torch.Tensor:
    """Dense lookup: ``ids`` of any shape -> ``ids.shape + (dim,)``; an
    out-of-range id gives a zero vector and zero gradient.  ``shard``:
    ``table`` holds only this process's rows of that row-sharded
    table."""
    mask, safe = _in_range(table.shape[0] if shard is None else shard.num_rows, ids)
    out = _gather(table, safe, shard)
    return out * mask.unsqueeze(-1).to(out.dtype)


def safe_embedding_lookup_sparse(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    combiner: str = "mean",
    shard=None,
) -> torch.Tensor:
    """Combined lookup over padded-sparse ids: ``(batch, max_ids)`` ids
    (and optional weights) -> ``(batch, dim)`` by ``combiner`` (sum,
    mean or sqrtn); a row with no id in range gives zeros.  Out-of-range
    ids leave the combine and take no gradient.  ``shard`` as in
    :func:`embedding_lookup`."""
    if combiner not in Combiner:
        raise ValueError(f"combiner must be one of {Combiner}, got {combiner}")
    in_range, safe = _in_range(table.shape[0] if shard is None else shard.num_rows, ids)
    mask = in_range.to(table.dtype)
    emb = _gather(table, safe, shard)  # (b, k, d)
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
    name), of ``padded_input_dim`` rows; ``shard`` is set when a world
    row-shards it (the parameter then holds this process's rows)."""

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
            _new_table(self.padded_input_dim, output_dim, dtype, embeddings_initializer)
        )
        self.shard = None

    def forward(self, ids, weights=None) -> torch.Tensor:
        ids = _as_ids(ids)
        if self.combiner is not None:
            if ids.ndim != 2:
                raise ValueError(
                    "combiner lookup expects (batch, max_ids) padded ids, "
                    f"got shape {tuple(ids.shape)}"
                )
            return safe_embedding_lookup_sparse(
                self.embedding, ids, weights, self.combiner, self.shard
            )
        return embedding_lookup(self.embedding, ids, self.shard)


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
