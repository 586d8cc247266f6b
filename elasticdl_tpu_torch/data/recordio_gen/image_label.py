"""Convert image/label datasets into EDLIO shards; the port of
``elasticdl_tpu/data/recordio_gen/image_label.py`` (pure numpy).

It writes per-split shards (``{dir}/{dataset}/{train,test}/data-NNNNN``)
from LOCAL copies of the datasets in their native distribution formats:

- IDX (the classic ``train-images-idx3-ubyte[.gz]`` files of MNIST /
  Fashion-MNIST), parsed directly from the binary format;
- ``.npz`` archives with ``x_train/y_train/x_test/y_test`` arrays (the
  layout keras's dataset cache uses).

Output schema matches the model zoo (synthetic.py): ``image`` uint8,
``label`` int64.

Usage::

    python -m elasticdl_tpu_torch.data.recordio_gen.image_label OUT_DIR \
        --dataset mnist --source /path/to/idx_dir_or_npz
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import sys

import numpy as np

from elasticdl_tpu_torch.data.recordio_gen._writers import write_shards
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# canonical IDX file basenames per split (gz or raw)
_IDX_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX-format file (optionally gzipped).

    Format: 2 zero bytes, a dtype code, a dims count, then big-endian
    uint32 sizes per dim, then the raw values.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero1, zero2, dtype_code, ndim = struct.unpack("BBBB", f.read(4))
        if zero1 != 0 or zero2 != 0:
            raise ValueError(f"not an IDX file: {path}")
        if dtype_code not in _IDX_DTYPES:
            raise ValueError(f"unknown IDX dtype 0x{dtype_code:02x}: {path}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=_IDX_DTYPES[dtype_code])
        if data.size != int(np.prod(shape)):
            raise ValueError(
                f"IDX payload size mismatch in {path}: "
                f"{data.size} values for shape {shape}"
            )
        return data.reshape(shape)


def _find_idx(source_dir: str, basename: str) -> str | None:
    for candidate in (basename, basename + ".gz"):
        path = os.path.join(source_dir, candidate)
        if os.path.exists(path):
            return path
    return None


def load_source(source: str) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Load ``{split: (x, y)}`` from an IDX directory or an npz file."""
    if os.path.isfile(source) and source.endswith(".npz"):
        with np.load(source) as z:
            out = {}
            for split, (xk, yk) in {
                "train": ("x_train", "y_train"),
                "test": ("x_test", "y_test"),
            }.items():
                if xk in z.files and yk in z.files:
                    out[split] = (np.asarray(z[xk]), np.asarray(z[yk]))
            if not out:
                raise ValueError(
                    f"{source} has none of x_train/y_train/x_test/y_test"
                )
            return out
    if os.path.isdir(source):
        out = {}
        for split, (img_base, lbl_base) in _IDX_FILES.items():
            img = _find_idx(source, img_base)
            lbl = _find_idx(source, lbl_base)
            if img and lbl:
                out[split] = (read_idx(img), read_idx(lbl))
        if not out:
            raise ValueError(f"no IDX files found under {source}")
        return out
    raise ValueError(f"source must be an IDX directory or .npz: {source!r}")


def convert(
    x: np.ndarray,
    y: np.ndarray,
    out_dir: str,
    records_per_shard: int = 16 * 1024,
    fraction: float = 1.0,
) -> int:
    """Write ``(x, y)`` pairs as EDLIO shards ``data-NNNNN.edlio``."""
    if len(x) != len(y):
        raise ValueError(f"images/labels length mismatch: {len(x)}/{len(y)}")
    total = int(len(x) * fraction)
    written = write_shards(
        out_dir,
        (
            {
                "image": np.asarray(x[row], dtype=np.uint8),
                "label": np.int64(np.asarray(y[row]).reshape(())),
            }
            for row in range(total)
        ),
        records_per_shard,
    )
    logger.info(
        "Wrote %d of %d records under %s", written, len(x), out_dir
    )
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert image datasets (IDX or npz) into EDLIO shards"
    )
    parser.add_argument("dir", help="Output directory")
    parser.add_argument(
        "--dataset",
        choices=["mnist", "fashion_mnist", "cifar10"],
        default="mnist",
    )
    parser.add_argument(
        "--source",
        required=True,
        help="IDX directory or .npz archive with the dataset",
    )
    parser.add_argument("--records_per_shard", type=int, default=16 * 1024)
    parser.add_argument(
        "--fraction",
        type=float,
        default=1.0,
        help="Fraction of each split to convert",
    )
    args = parser.parse_args(argv)
    splits = load_source(args.source)
    for split, (x, y) in splits.items():
        convert(
            x,
            y,
            os.path.join(args.dir, args.dataset, split),
            records_per_shard=args.records_per_shard,
            fraction=args.fraction,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
