"""Sharded embedding tables; the port of ``elasticdl_tpu/embeddings/``.

- :func:`sharded_table_rules` row-partitions declared tables over the
  world (ep > tp > fsdp, falling back to dp, the one axis every elastic
  world has; the port's worlds have only dp until slice 8);
- :func:`plan_placement` admits a table onto the card when it fits the
  measured free device memory, else onto the host-RAM spill tier gated
  on the host's measured headroom, and raises
  :class:`EmbeddingAdmissionError` when neither admits it;
- ``sharded.py`` holds a row-sharded table in a world: each process its
  rows, lookups through an id and row exchange with the owners.

The spill tier (``spill.py``: ``ShardedHostTable``,
``SpillEmbeddingRuntime``) is not ported yet.
"""

from elasticdl_tpu_torch.embeddings.planner import (
    DEVICE_BUDGET_ENV,
    HOST_SHARE_ENV,
    EmbeddingAdmissionError,
    Placement,
    device_budget_bytes,
    embedding_axis,
    owning_shard,
    plan_placement,
    shard_row_ranges,
    sharded_table_rules,
)

__all__ = [
    "DEVICE_BUDGET_ENV",
    "HOST_SHARE_ENV",
    "EmbeddingAdmissionError",
    "Placement",
    "device_budget_bytes",
    "embedding_axis",
    "owning_shard",
    "plan_placement",
    "shard_row_ranges",
    "sharded_table_rules",
]
