"""Data reader contract and the example record codec; the counterpart of
``elasticdl_tpu/data/reader.py``, with its native batch decode.

``create_shards()`` output is exactly the shard dict the task dispatcher
slices into tasks, and ``read_records(task)`` yields the raw records of
one task's range.
"""

from __future__ import annotations

import abc
import ctypes
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.utils.tensor import (
    _dtype_name,
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
    vectorized counterpart of ``decode_example`` + ``np.stack``.

    When the native codec is loaded and every record matches the first
    record's schema, one C call decodes the whole batch (one memcpy per
    record and feature, into preallocated ``(N, ...)`` arrays); without
    the codec, or on any schema drift, the records are decoded one by
    one into the same arrays."""
    payloads = list(payloads)
    if not payloads:
        return {}
    first = decode_example(payloads[0])
    n = len(payloads)
    if n == 1:
        return {k: v[np.newaxis, ...] for k, v in first.items()}

    out = _native_decode_batch(payloads, first)
    if out is not None:
        return out
    decoded = [first] + [decode_example(p) for p in payloads[1:]]
    return {k: np.stack([d[k] for d in decoded]) for k in first}


def _native_decode_batch(
    payloads: list, first: dict[str, np.ndarray]
) -> dict[str, np.ndarray] | None:
    """One-FFI-call decode of the whole batch; None = take the per-record
    decode."""
    n = len(payloads)
    buf = b"".join(payloads)
    offsets = (ctypes.c_uint64 * (n + 1))()
    pos = 0
    for i, p in enumerate(payloads):
        offsets[i] = pos
        pos += len(p)
    offsets[n] = pos
    return _native_decode_concat(buf, offsets, n, first)


def decode_concat_batch(
    buf, lengths, template: dict[str, np.ndarray]
) -> dict[str, np.ndarray] | None:
    """Decode records already CONCATENATED in ``buf`` (record ``i`` is
    ``lengths[i]`` bytes) against ``template``'s schema: the zero-copy
    half of the fused scan+decode path, where ``buf``/``lengths`` are
    what the scanner's ``next_chunk`` returns, so a task's records go
    from disk to batched arrays with no per-record Python object.
    ``None`` = native codec not loaded, or a record off the schema."""
    n = len(lengths)
    if n == 0:
        return {}
    offs = np.empty(n + 1, dtype=np.uint64)
    offs[0] = 0
    np.cumsum(np.asarray(lengths, dtype=np.uint64), out=offs[1:])
    if isinstance(buf, np.ndarray):
        buf = buf.ctypes.data  # zero-copy: pass the buffer's address
    return _native_decode_concat(
        buf, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, template
    )


def _native_decode_concat(
    buf, offsets, n: int, first: dict[str, np.ndarray]
) -> dict[str, np.ndarray] | None:
    lib = recordio.native_lib()
    if lib is None or len(first) == 0 or len(first) > 64:
        return None

    # the naming the frame headers were written with: any drift between
    # writer and matcher would force the per-record path
    names = list(first)
    try:
        dtypes = [_dtype_name(first[k].dtype) for k in names]
    except ValueError:  # a dtype outside the wire format
        return None

    c_names = (ctypes.c_char_p * len(names))(
        *[k.encode("utf-8") for k in names]
    )
    c_dtypes = (ctypes.c_char_p * len(names))(
        *[d.encode("utf-8") for d in dtypes]
    )
    flat_shapes = [d for k in names for d in first[k].shape]
    c_shapes = (ctypes.c_int64 * max(1, len(flat_shapes)))(*flat_shapes)
    c_ndims = (ctypes.c_int32 * len(names))(*[first[k].ndim for k in names])
    c_row_bytes = (ctypes.c_uint64 * len(names))(
        *[first[k].nbytes for k in names]
    )
    out = {
        k: np.empty((n,) + first[k].shape, dtype=first[k].dtype)
        for k in names
    }
    c_outs = (ctypes.c_void_p * len(names))(
        *[out[k].ctypes.data for k in names]
    )
    rc = lib.edl_decode_batch(
        buf, offsets, n, len(names), c_names, c_dtypes, c_shapes, c_ndims,
        c_row_bytes, c_outs,
    )
    return out if rc == 0 else None
