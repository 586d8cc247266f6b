"""Batch shaping shared by training and serving; a copy of the one
function the serving slice needs from ``elasticdl_tpu/trainer/stacking.py``."""

from __future__ import annotations


def canonical_batch_rows(minibatch_size: int, divisor: int) -> int:
    """THE canonical per-step batch shape: ``minibatch_size`` rounded up
    to the batch divisor, so one padded-and-masked shape serves full
    batches, ragged tails and shard divisibility."""
    div = max(1, int(divisor))
    return max(div, -(-int(minibatch_size) // div) * div)
