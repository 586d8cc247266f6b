"""EDLIO: the seekable record container of
``elasticdl_tpu/data/recordio/``, with its ``Writer``,
``Scanner(path, start, length)`` and ``num_records(path)`` face.

The port has the pure-Python codec only; the JAX package's C++ codec
(``_native.cc``) and the vectorized decode it enables come with a later
slice.  Both write and read the same files.
"""

from __future__ import annotations

from elasticdl_tpu_torch.data.recordio._pyimpl import (
    CorruptFileError,
    Scanner,
    Writer,
    num_records,
)

__all__ = ["Writer", "Scanner", "num_records", "CorruptFileError"]
