"""Shard-writing helpers of the recordio_gen converters; a copy of
``elasticdl_tpu/data/recordio_gen/_writers.py``: examples into rotating
EDLIO shards, and the shuffled train/test split, with the JAX package's
shard names and rotation.
"""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data.reader import encode_example


def write_shards(
    out_dir: str,
    examples,
    records_per_shard: int = 8192,
    prefix: str = "data",
    encode=encode_example,
) -> int:
    """Write an iterable of example dicts (or pre-encoded bytes when
    ``encode`` is None) into ``{out_dir}/{prefix}-NNNNN.edlio`` shards of
    ``records_per_shard`` records; returns the record count."""
    if records_per_shard <= 0:
        raise ValueError(
            f"records_per_shard must be positive, got {records_per_shard}"
        )
    os.makedirs(out_dir, exist_ok=True)
    shard, writer, written = 0, None, 0
    try:
        for ex in examples:
            if written % records_per_shard == 0:
                if writer is not None:
                    writer.close()
                writer = recordio.Writer(
                    os.path.join(out_dir, f"{prefix}-{shard:05d}.edlio")
                )
                shard += 1
            writer.write(encode(ex) if encode is not None else ex)
            written += 1
    finally:
        if writer is not None:
            writer.close()
    return written


def write_train_test_split(
    out_dir: str,
    examples: list,
    eval_fraction: float,
    seed: int = 0,
    records_per_shard: int = 8192,
) -> str:
    """Shuffle ``examples`` and write ``{out_dir}/train`` and
    ``{out_dir}/test`` shard directories (test gets ``eval_fraction``)."""
    order = np.random.RandomState(seed).permutation(len(examples))
    n_eval = int(len(examples) * eval_fraction)
    write_shards(
        os.path.join(out_dir, "train"),
        (examples[i] for i in order[n_eval:]),
        records_per_shard,
    )
    if n_eval:
        write_shards(
            os.path.join(out_dir, "test"),
            (examples[i] for i in order[:n_eval]),
            records_per_shard,
        )
    return out_dir
