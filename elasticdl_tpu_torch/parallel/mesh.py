"""The process-to-slice map; the part of ``elasticdl_tpu/parallel/mesh.py``
that the port's multi-slice worlds need.

A world of ``--num_slices`` slices is one flat ``torch.distributed``
process group; what the slices change is which processes a whole-slice
loss takes together.  :func:`slice_assignments` is the one map of
processes to slices: the instance manager assigns ``--slice_id`` from
it, and the replica ring (``replication/replicator.py``) keeps every
shard's replica off its owner's slice with it, so no two layers can
disagree about where a process lives.

The port's worlds have one axis, ``dp``, over their processes:
:func:`world_mesh` is that mesh as a model's ``sharding_rules(mesh)``
hook reads it (``axis_names`` and ``shape``, as a JAX ``Mesh``), and a
:class:`Rule` is one of the hook's entries (a flax parameter path
pattern and its partition spec, a tuple standing in for JAX's
``PartitionSpec``).

Left out until slice 8 (sequence, tensor and pipeline parallelism):
the device mesh's other axes and the hybrid ICI/DCN planning
(``plan_dcn_axes``, ``order_devices_hybrid``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class MeshAxis:
    """The JAX package's logical mesh-axis names."""

    DP = "dp"
    FSDP = "fsdp"
    TP = "tp"
    SP = "sp"
    EP = "ep"
    PP = "pp"


@dataclass(frozen=True)
class WorldMesh:
    """A world's logical mesh: ``dp`` over its processes."""

    num_processes: int

    @property
    def axis_names(self) -> tuple:
        return (MeshAxis.DP,)

    @property
    def shape(self) -> dict:
        return {MeshAxis.DP: int(self.num_processes)}


def world_mesh(num_processes: int = 1) -> WorldMesh:
    return WorldMesh(max(1, int(num_processes)))


class Rule:
    """One sharding rule: parameters whose flax path ``pattern`` matches
    (searched, as JAX's ``Rule``) take ``spec``, a tuple of one mesh axis
    or None per dimension (``("dp", None)``: rows over ``dp``)."""

    def __init__(self, pattern: str, spec: tuple):
        self.regex = re.compile(pattern)
        self.spec = tuple(spec)

    def matches(self, path: str) -> bool:
        return self.regex.search(path) is not None

    def __repr__(self) -> str:
        return f"Rule({self.regex.pattern!r}, {self.spec!r})"


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
