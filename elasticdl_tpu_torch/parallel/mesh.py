"""The process-to-slice map; the part of ``elasticdl_tpu/parallel/mesh.py``
that the port's multi-slice worlds need.

A world of ``--num_slices`` slices is one flat ``torch.distributed``
process group; what the slices change is which processes a whole-slice
loss takes together.  :func:`slice_assignments` is the one map of
processes to slices: the instance manager assigns ``--slice_id`` from
it, and the replica ring (``replication/replicator.py``) keeps every
shard's replica off its owner's slice with it, so no two layers can
disagree about where a process lives.

Left out until slice 8 (sequence, tensor and pipeline parallelism):
the device mesh, its sharding axes and the hybrid ICI/DCN planning
(``plan_dcn_axes``, ``order_devices_hybrid``).
"""

from __future__ import annotations


def slice_assignments(num_processes: int, num_slices: int) -> list[int]:
    """The process -> slice map: contiguous blocks, earlier slices taking
    the remainder (``np.array_split``'s rule)."""
    if num_processes <= 0:
        return []
    num_slices = max(1, min(int(num_slices), num_processes))
    out: list[int] = []
    base, extra = divmod(num_processes, num_slices)
    for s in range(num_slices):
        out.extend([s] * (base + (1 if s < extra else 0)))
    return out
