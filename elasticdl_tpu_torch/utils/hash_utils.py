"""Deterministic hashing; a copy of ``elasticdl_tpu/utils/hash_utils.py``.

sha256-based string -> bucket mapping (the feature columns' string
hashing) and id-mod mapping of embedding rows to shards, the JAX
package's functions, so that both packages hash a string to the same
bucket.
"""

from __future__ import annotations

import hashlib

import numpy as np


def string_to_id(name: str, num_shards: int) -> int:
    """Stable shard index for a named parameter (sha256 mod N)."""
    if num_shards <= 0:
        raise ValueError("num_shards must be positive, got %d" % num_shards)
    digest = hashlib.sha256(name.encode("utf-8")).hexdigest()
    return int(digest, 16) % num_shards


def int_to_id(value: int, num_shards: int) -> int:
    """Shard index for an embedding row id (id mod N)."""
    return int(value) % num_shards


def scatter_ids(ids: np.ndarray, num_shards: int) -> list[np.ndarray]:
    """Group a 1-D id array by owning shard; returns per-shard id arrays.

    Vectorized counterpart of the reference's per-id Python loop
    (``hash_utils.py:13`` scatter_embedding_vector).
    """
    ids = np.asarray(ids)
    shard = ids % num_shards
    return [ids[shard == i] for i in range(num_shards)]


def scatter_with_positions(
    ids: np.ndarray, num_shards: int
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Group ids by shard, also returning original positions for re-gather."""
    ids = np.asarray(ids)
    shard = ids % num_shards
    grouped, positions = [], []
    for i in range(num_shards):
        mask = shard == i
        grouped.append(ids[mask])
        positions.append(np.nonzero(mask)[0])
    return grouped, positions
