"""State-shard wire format: one host's share of the state as bytes; the
counterpart of ``elasticdl_tpu/replication/blob.py``.

A shard is the ``(dense, parts)`` pair ``parallel/elastic.py::
state_checkpoint_parts`` produces: ``dense`` maps a checkpoint name to a
whole array (the chief's share), ``parts`` maps a table name to the
``(ids, rows)`` this host owns.  The JAX package encodes it with
msgpack; the port with the frame layout of ``rpc/messages.py``:

    [u32 header_len][header json][array 0 bytes][array 1 bytes]...

where the header lists each array's name, dtype name (bf16 included,
as ``utils/tensor.py`` names it), shape and byte length, in frame
order.  Arrays travel as their raw C-order bytes.

Torn-transfer detection: a shard travels with its CRC32
(:func:`blob_checksum`); receivers (the peer store on push, the master
on harvest, the worker on restore) verify before committing, so a
truncated or bit-flipped payload is skipped, never restored.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from elasticdl_tpu_torch.utils.tensor import _dtype_name, _np_dtype

_U32 = struct.Struct("<I")


def _entry(arr: np.ndarray, frames: list) -> list:
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # ascontiguousarray would make a 0-d array 1-d
    frames.append(arr.reshape(-1).view(np.uint8).data if arr.size else b"")
    return [_dtype_name(arr.dtype), list(arr.shape), arr.nbytes]


def encode_snapshot(dense: dict, parts: dict) -> bytes:
    """Serialize one host's state shard to bytes."""
    frames: list = []
    header = {
        "dense": [[name, *_entry(arr, frames)] for name, arr in dense.items()],
        "parts": [
            [name, _entry(ids, frames), _entry(rows, frames)]
            for name, (ids, rows) in parts.items()
        ],
    }
    head = json.dumps(header).encode("utf-8")
    return b"".join([_U32.pack(len(head)), head, *frames])


def decode_snapshot(blob: bytes) -> tuple[dict, dict]:
    """Inverse of :func:`encode_snapshot`.  The arrays are read-only
    views of ``blob``; a truncated blob raises ``ValueError``."""
    view = memoryview(blob)
    (head_len,) = _U32.unpack_from(view, 0)
    header = json.loads(bytes(view[4 : 4 + head_len]).decode("utf-8"))
    offset = 4 + head_len

    def take(dtype: str, shape: list, nbytes: int) -> np.ndarray:
        nonlocal offset
        if offset + nbytes > len(view):
            raise ValueError(
                f"snapshot of {len(view)} bytes is shorter than its header says"
            )
        arr = np.frombuffer(view[offset : offset + nbytes], dtype=_np_dtype(dtype))
        offset += nbytes
        return arr.reshape(shape)

    dense = {name: take(*spec) for name, *spec in header["dense"]}
    parts = {name: (take(*ids), take(*rows)) for name, ids, rows in header["parts"]}
    if offset != len(view):
        raise ValueError(f"snapshot of {len(view)} bytes, header accounts for {offset}")
    return dense, parts


def blob_checksum(blob: bytes) -> str:
    """CRC32 as 8 hex chars: cheap enough for every push, strong enough
    to catch truncation and torn writes (not an integrity MAC)."""
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


def merge_snapshots(snapshots: list[tuple[dict, dict]]) -> tuple[dict, dict]:
    """Union per-host shards into one full checkpoint view.

    Dense leaves are replicated, so shards either agree or only one
    (the chief's) carries them: last writer wins.  Table parts carry
    disjoint row ranges per owning host, so same-name parts concatenate.
    """
    dense: dict = {}
    ids_acc: dict[str, list[np.ndarray]] = {}
    rows_acc: dict[str, list[np.ndarray]] = {}
    for shard_dense, shard_parts in snapshots:
        dense.update(shard_dense)
        for name, (ids, rows) in shard_parts.items():
            ids_acc.setdefault(name, []).append(ids)
            rows_acc.setdefault(name, []).append(rows)
    parts = {
        name: (
            np.concatenate(ids_acc[name]),
            np.concatenate(rows_acc[name], axis=0),
        )
        for name in ids_acc
    }
    return dense, parts
