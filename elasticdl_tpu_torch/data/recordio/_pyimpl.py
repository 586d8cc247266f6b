"""Pure-Python implementation of the EDLIO container; a copy of
``elasticdl_tpu/data/recordio/_pyimpl.py``.

The format is the JAX package's (``elasticdl_tpu/data/recordio/FORMAT.md``):
files either package writes, the other reads.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator

_FRAME = struct.Struct("<II")  # payload_len, crc32
_FOOTER = struct.Struct("<QQII")  # index_offset, num_records, version, magic
MAGIC = 0x45444C49
VERSION = 1
FOOTER_SIZE = _FOOTER.size


class CorruptFileError(Exception):
    pass


class Writer:
    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "wb")
        self._offsets: list[int] = []
        self._pos = 0
        self._closed = False

    def write(self, payload: bytes):
        if self._closed:
            raise ValueError("writer is closed")
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        self._offsets.append(self._pos)
        frame = _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        self._f.write(frame)
        self._f.write(payload)
        self._pos += len(frame) + len(payload)

    def close(self):
        if self._closed:
            return
        index_offset = self._pos
        for off in self._offsets:
            self._f.write(struct.pack("<Q", off))
        self._f.write(
            _FOOTER.pack(index_offset, len(self._offsets), VERSION, MAGIC)
        )
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_footer(f) -> tuple[int, int]:
    f.seek(0, os.SEEK_END)
    size = f.tell()
    if size < FOOTER_SIZE:
        raise CorruptFileError("file smaller than footer")
    f.seek(size - FOOTER_SIZE)
    index_offset, num_records, version, magic = _FOOTER.unpack(
        f.read(FOOTER_SIZE)
    )
    if magic != MAGIC:
        raise CorruptFileError("bad magic (not an EDLIO file or truncated)")
    if version != VERSION:
        raise CorruptFileError(f"unsupported EDLIO version {version}")
    return index_offset, num_records


def num_records(path: str) -> int:
    with open(path, "rb") as f:
        return _read_footer(f)[1]


class Scanner:
    """Ranged scan: yields records [start, start+length) of the file.

    ``length < 0`` means 'to the end'.  Mirrors the access pattern of the
    reference's ``recordio.Scanner(shard, start, len)``.
    """

    def __init__(self, path: str, start: int = 0, length: int = -1):
        self._f = open(path, "rb")
        try:
            index_offset, total = _read_footer(self._f)
        except Exception:
            self._f.close()
            raise
        if start < 0 or start > total:
            self._f.close()
            raise IndexError(f"start {start} out of range 0..{total}")
        self._remaining = (total - start) if length < 0 else min(
            length, total - start
        )
        if self._remaining > 0:
            self._f.seek(index_offset + 8 * start)
            (first_off,) = struct.unpack("<Q", self._f.read(8))
            self._f.seek(first_off)

    def record(self) -> bytes | None:
        """Next record payload, or None when the range is exhausted."""
        if self._remaining <= 0:
            return None
        header = self._f.read(_FRAME.size)
        if len(header) < _FRAME.size:
            raise CorruptFileError("truncated frame header")
        length, crc = _FRAME.unpack(header)
        payload = self._f.read(length)
        if len(payload) < length:
            raise CorruptFileError("truncated payload")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise CorruptFileError("crc mismatch")
        self._remaining -= 1
        return payload

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.record()
            if rec is None:
                return
            yield rec

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
