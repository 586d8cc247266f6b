"""Data reader contract and the example record codec; the counterpart of
``elasticdl_tpu/data/reader.py`` without its native decode paths.

``create_shards()`` output is exactly the shard dict the task dispatcher
slices into tasks, and ``read_records(task)`` yields the raw records of
one task's range.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

from elasticdl_tpu_torch.utils.tensor import (
    deserialize_tensors,
    ndarray_to_tensor,
    serialize_tensors,
)


@dataclass
class Metadata:
    """Schema info a reader can surface to ``dataset_fn``."""

    column_names: list[str] = field(default_factory=list)
    column_dtypes: dict[str, Any] = field(default_factory=dict)
    extra: dict = field(default_factory=dict)


class AbstractDataReader(abc.ABC):
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @abc.abstractmethod
    def read_records(self, task) -> Iterator:
        """Yield the raw records of ``task``'s range [task.start, task.end)."""

    @abc.abstractmethod
    def create_shards(self) -> dict[str, tuple[int, int]]:
        """Map shard_name -> (start_index, num_records)."""

    @property
    def metadata(self) -> Metadata:
        return Metadata()


def encode_example(features: dict[str, np.ndarray]) -> bytes:
    """Standard record payload: a named-tensor dict in the EDL tensor
    frames of ``utils/tensor.py``."""
    return serialize_tensors(
        {k: ndarray_to_tensor(k, v) for k, v in features.items()}
    )


def decode_example(payload: bytes) -> dict[str, np.ndarray]:
    return {k: t.values for k, t in deserialize_tensors(payload).items()}


def decode_example_batch(payloads) -> dict[str, np.ndarray]:
    """Decode N example payloads into ONE batched feature dict: the
    per-record decode stacked, which is what the JAX package's native
    batch decoder returns and what it falls back to."""
    payloads = list(payloads)
    if not payloads:
        return {}
    decoded = [decode_example(p) for p in payloads]
    return {k: np.stack([d[k] for d in decoded]) for k in decoded[0]}
