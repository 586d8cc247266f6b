"""The EDL tensor wire format; a copy of ``elasticdl_tpu/utils/tensor.py``.

Example records (``data/reader.py::encode_example``) are frames of this
format, so the port reads and writes the JAX package's records byte for
byte.  A frame is

    [u32 header_len][header json][raw data bytes][raw indices bytes?]

A ``Tensor`` is dense (``indices is None``) or sparse row-slices
(``indices`` holds row ids).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import ml_dtypes
import numpy as np

_HEADER_STRUCT = struct.Struct("<I")

_SUPPORTED_DTYPES = frozenset(
    {
        "bool",
        "int8",
        "int16",
        "int32",
        "int64",
        "uint8",
        "uint16",
        "uint32",
        "uint64",
        "float16",
        "float32",
        "float64",
        "bfloat16",
    }
)


def _dtype_name(dtype) -> str:
    name = np.dtype(dtype).name if dtype != "bfloat16" else "bfloat16"
    # ml_dtypes registers bfloat16 with numpy under this name
    if name not in _SUPPORTED_DTYPES:
        raise ValueError(f"unsupported tensor dtype: {name}")
    return name


def _np_dtype(name: str):
    if name == "bfloat16":
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


@dataclass
class Tensor:
    """A named dense or row-sparse tensor.

    values: ndarray of the dense values, or the gathered rows for sparse.
    indices: None for dense; 1-D int64 row ids for sparse row-slices.
    """

    name: str
    values: np.ndarray
    indices: np.ndarray | None = None

    def __post_init__(self):
        self.values = np.asarray(self.values)
        if self.indices is not None:
            self.indices = np.asarray(self.indices, dtype=np.int64)
            if self.indices.ndim != 1:
                raise ValueError("indices must be 1-D row ids")
            if self.values.shape[0] != self.indices.shape[0]:
                raise ValueError(
                    "row count mismatch: values %s vs indices %s"
                    % (self.values.shape, self.indices.shape)
                )

    @property
    def is_sparse(self) -> bool:
        return self.indices is not None

    def to_bytes(self) -> bytes:
        values = self.values
        if not values.flags["C_CONTIGUOUS"]:
            # np.ascontiguousarray would promote 0-d arrays to 1-d, so
            # only call it when needed
            values = np.ascontiguousarray(values)
        header = {
            "name": self.name,
            "dtype": _dtype_name(values.dtype),
            "shape": list(values.shape),
            "sparse": self.is_sparse,
        }
        parts = []
        if self.is_sparse:
            idx = self.indices
            if not idx.flags["C_CONTIGUOUS"]:
                idx = np.ascontiguousarray(idx)
            header["num_indices"] = int(idx.shape[0])
            parts.append(idx.tobytes())
        hdr = json.dumps(header).encode("utf-8")
        return b"".join(
            [_HEADER_STRUCT.pack(len(hdr)), hdr, values.tobytes()] + parts
        )

    @classmethod
    def from_bytes(cls, buf: bytes | memoryview) -> "Tensor":
        buf = memoryview(buf)
        (hdr_len,) = _HEADER_STRUCT.unpack_from(buf, 0)
        header = json.loads(bytes(buf[4 : 4 + hdr_len]).decode("utf-8"))
        dtype = _np_dtype(header["dtype"])
        shape = tuple(header["shape"])
        nbytes = int(np.prod(shape)) * dtype.itemsize if shape else dtype.itemsize
        start = 4 + hdr_len
        values = np.frombuffer(
            buf[start : start + nbytes], dtype=dtype
        ).reshape(shape)
        indices = None
        if header.get("sparse"):
            n = header["num_indices"]
            indices = np.frombuffer(
                buf[start + nbytes : start + nbytes + 8 * n], dtype=np.int64
            )
        return cls(
            header["name"], values.copy(),
            None if indices is None else indices.copy(),
        )


def serialize_tensors(tensors: dict[str, Tensor] | list[Tensor]) -> bytes:
    """Frame a collection of tensors: [u32 count] then length-prefixed
    frames."""
    if isinstance(tensors, dict):
        tensors = list(tensors.values())
    frames = [t.to_bytes() for t in tensors]
    out = [_HEADER_STRUCT.pack(len(frames))]
    for f in frames:
        out.append(_HEADER_STRUCT.pack(len(f)))
        out.append(f)
    return b"".join(out)


def deserialize_tensors(buf: bytes | memoryview) -> dict[str, Tensor]:
    buf = memoryview(buf)
    (count,) = _HEADER_STRUCT.unpack_from(buf, 0)
    offset = 4
    out: dict[str, Tensor] = {}
    for _ in range(count):
        (flen,) = _HEADER_STRUCT.unpack_from(buf, offset)
        offset += 4
        t = Tensor.from_bytes(buf[offset : offset + flen])
        offset += flen
        out[t.name] = t
    return out


def ndarray_to_tensor(name: str, array, indices=None) -> Tensor:
    return Tensor(name, np.asarray(array), indices)
