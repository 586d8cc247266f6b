"""Feature columns: the tabular-feature spec shared by the host and the
device; the port of ``elasticdl_tpu/feature_column/feature_column.py``.

A column has two halves:

- the host half (:func:`transform_features`), a numpy copy of the JAX
  package's: string hashing, vocabulary lookup and dtype coercion on
  numpy batches, in the data pipeline.  Strings never reach the device.
- the device half (:class:`DenseFeatures`), an ``nn.Module`` built from
  the column tuple: embedding lookups (a ``layers.embedding.Embedding``
  submodule per embedding column, named after the column, as flax names
  it), one-hot and multi-hot encodings and the concatenation, in column
  order.

Categorical columns give int32 id arrays with ``-1`` for a missing or
out-of-vocabulary value; the embedding and indicator encodings treat
negative ids as absent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.utils.hash_utils import string_to_id


@dataclasses.dataclass(frozen=True)
class NumericColumn:
    key: str
    shape: tuple = (1,)
    dtype: Any = np.float32
    normalizer_fn: Optional[Callable] = None

    @property
    def name(self) -> str:
        return self.key

    def transform(self, features: dict) -> np.ndarray:
        return np.asarray(features[self.key]).astype(self.dtype)


@dataclasses.dataclass(frozen=True)
class BucketizedColumn:
    source: NumericColumn
    boundaries: tuple

    @property
    def key(self) -> str:
        return self.source.key

    @property
    def name(self) -> str:
        return f"{self.key}_bucketized"

    @property
    def num_buckets(self) -> int:
        return len(self.boundaries) + 1

    def transform(self, features: dict) -> np.ndarray:
        x = self.source.transform(features)
        return np.digitize(x, self.boundaries).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class HashedCategoricalColumn:
    key: str
    hash_bucket_size: int

    @property
    def name(self) -> str:
        return self.key

    @property
    def num_buckets(self) -> int:
        return self.hash_bucket_size

    def transform(self, features: dict) -> np.ndarray:
        vals = np.asarray(features[self.key])
        if vals.dtype.kind in ("U", "S", "O"):
            flat = np.array(
                [
                    string_to_id(
                        v.decode() if isinstance(v, bytes) else str(v),
                        self.hash_bucket_size,
                    )
                    for v in vals.reshape(-1)
                ],
                dtype=np.int32,
            )
            return flat.reshape(vals.shape)
        return (vals.astype(np.int64) % self.hash_bucket_size).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class VocabularyCategoricalColumn:
    key: str
    vocabulary: tuple

    def __post_init__(self):
        # transform runs per batch on the input hot path; build the
        # vocab->index table once
        object.__setattr__(
            self, "_table", {v: i for i, v in enumerate(self.vocabulary)}
        )

    @property
    def name(self) -> str:
        return self.key

    @property
    def num_buckets(self) -> int:
        return len(self.vocabulary)

    def transform(self, features: dict) -> np.ndarray:
        table = self._table
        vals = np.asarray(features[self.key])

        def _lookup(v):
            if isinstance(v, bytes):
                v = v.decode()
            return table.get(v, -1)  # OOV -> -1 (absent)

        flat = np.array(
            [_lookup(v) for v in vals.reshape(-1)], dtype=np.int32
        )
        return flat.reshape(vals.shape)


@dataclasses.dataclass(frozen=True)
class IdentityCategoricalColumn:
    key: str
    num_buckets: int

    @property
    def name(self) -> str:
        return self.key

    def transform(self, features: dict) -> np.ndarray:
        vals = np.asarray(features[self.key]).astype(np.int64)
        # out-of-range -> -1 (absent), like TF with default_value unset
        vals = np.where(
            (vals >= 0) & (vals < self.num_buckets), vals, -1
        )
        return vals.astype(np.int32)


CategoricalColumn = (
    HashedCategoricalColumn,
    VocabularyCategoricalColumn,
    IdentityCategoricalColumn,
    BucketizedColumn,
)


@dataclasses.dataclass(frozen=True)
class EmbeddingColumn:
    categorical: Any
    dimension: int
    combiner: str = "mean"
    initializer: Any = "uniform"

    @property
    def key(self) -> str:
        return self.categorical.key

    @property
    def name(self) -> str:
        return f"{self.categorical.name}_embedding"

    def transform(self, features: dict) -> np.ndarray:
        return self.categorical.transform(features)


@dataclasses.dataclass(frozen=True)
class IndicatorColumn:
    categorical: Any

    @property
    def key(self) -> str:
        return self.categorical.key

    @property
    def name(self) -> str:
        return f"{self.categorical.name}_indicator"

    def transform(self, features: dict) -> np.ndarray:
        return self.categorical.transform(features)


# ---- factory functions (tf.feature_column-compatible names) ----------------


def numeric_column(key, shape=(1,), dtype=np.float32, normalizer_fn=None):
    return NumericColumn(key, tuple(np.ravel(shape)), dtype, normalizer_fn)


def bucketized_column(source: NumericColumn, boundaries: Sequence[float]):
    return BucketizedColumn(source, tuple(boundaries))


def categorical_column_with_hash_bucket(key, hash_bucket_size, dtype=None):
    return HashedCategoricalColumn(key, int(hash_bucket_size))


def categorical_column_with_vocabulary_list(key, vocabulary_list):
    return VocabularyCategoricalColumn(key, tuple(vocabulary_list))


def categorical_column_with_identity(key, num_buckets):
    return IdentityCategoricalColumn(key, int(num_buckets))


def embedding_column(
    categorical_column, dimension, combiner="mean", initializer="uniform"
):
    """An embedding of ``categorical_column``'s ids: a
    ``layers.embedding.Embedding`` table in :class:`DenseFeatures`."""
    return EmbeddingColumn(
        categorical_column, int(dimension), combiner, initializer
    )


def indicator_column(categorical_column):
    return IndicatorColumn(categorical_column)


def transform_features(columns, features: dict) -> dict:
    """The host half: a raw feature dict to numeric and int arrays keyed
    by *column name* (a numeric and a bucketized view of ``age`` do not
    clobber each other), run in ``dataset_fn`` or ``batch_parse`` on
    numpy arrays.  String-valued source keys are dropped, so that the
    batch can be placed on the device."""
    out = {
        k: v
        for k, v in features.items()
        if np.asarray(v).dtype.kind not in ("U", "S", "O")
    }
    for col in columns:
        out[col.name] = col.transform(features)
    return out


def _one_hot(ids: torch.Tensor, depth: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an id outside ``[0, depth)`` gives a row of
    zeros (``F.one_hot`` would raise)."""
    return (ids.unsqueeze(-1) == torch.arange(depth, device=ids.device)).to(dtype)


def column_width(col) -> int:
    """The width of ``col``'s part of :class:`DenseFeatures`' output."""
    if isinstance(col, NumericColumn):
        return math.prod(col.shape)
    if isinstance(col, EmbeddingColumn):
        return col.dimension
    if isinstance(col, IndicatorColumn):
        return col.categorical.num_buckets
    if isinstance(col, BucketizedColumn):
        return col.num_buckets * math.prod(col.source.shape)
    raise TypeError(
        f"column {col!r} cannot be used directly in DenseFeatures; wrap "
        "categorical columns in embedding_column or indicator_column"
    )


class DenseFeatures(nn.Module):
    """The device half: ``tf.keras.layers.DenseFeatures``.

    Takes :func:`transform_features`' output and gives the concatenated
    ``(batch, output_dim)`` float tensor, in the given column order.
    Each embedding column is an ``Embedding`` submodule named after the
    column (``thal_embedding``), with the column's initializer and
    combiner."""

    def __init__(self, columns: tuple, dtype=torch.float32):
        super().__init__()
        self.columns = tuple(columns)
        self.dtype = dtype
        self.output_dim = sum(column_width(c) for c in self.columns)
        for col in self.columns:
            if isinstance(col, EmbeddingColumn):
                self.add_module(col.name, Embedding(
                    input_dim=col.categorical.num_buckets,
                    output_dim=col.dimension,
                    embeddings_initializer=col.initializer,
                    combiner=col.combiner,
                    dtype=dtype,
                ))

    def forward(self, features: dict, device=None) -> torch.Tensor:
        """``device``: where to place a column that arrives as a host
        array (the columns on the device stay there)."""
        outputs = []
        batch = None
        for col in self.columns:
            # transform_features keys by column name; a raw source-key
            # batch serves the columns whose transform is identity-like
            x = features[col.name] if col.name in features else features[col.key]
            x = torch.as_tensor(x, device=device)
            batch = x.shape[0] if batch is None else batch
            if isinstance(col, NumericColumn):
                x = x.to(self.dtype).reshape(batch, -1)
                if col.normalizer_fn is not None:
                    x = col.normalizer_fn(x)
                outputs.append(x)
            elif isinstance(col, EmbeddingColumn):
                outputs.append(getattr(self, col.name)(x.reshape(batch, -1)))
            elif isinstance(col, IndicatorColumn):
                ids = x.reshape(batch, -1)
                onehot = _one_hot(
                    torch.clamp(ids, min=0), col.categorical.num_buckets, self.dtype
                )
                onehot = onehot * (ids >= 0).unsqueeze(-1).to(self.dtype)
                outputs.append(onehot.sum(1))  # multi-hot over the bag
            else:  # bucketized: __init__'s column_width refused any other
                ids = x.reshape(batch, -1)
                outputs.append(
                    _one_hot(ids, col.num_buckets, self.dtype).reshape(batch, -1)
                )
        return torch.cat(outputs, dim=-1)
