"""Placement planning for sharded embedding tables; the port of
``elasticdl_tpu/embeddings/planner.py``.

It answers the questions the reference answered with its parameter
server's topology:

1. Which mesh axis row-shards a declared table (:func:`embedding_axis`,
   :func:`sharded_table_rules`): the first of ep > tp > fsdp > dp whose
   size is above 1 and divides the rows.  A declared sharded table falls
   back to ``dp``, the one axis every elastic world has, so it re-shards
   across a re-formation.  The port's worlds have only ``dp``
   (``parallel/mesh.py::world_mesh``) until slice 8, and a
   single-process world gets no rule: the table stays whole.
2. Which tier holds the rows (:func:`plan_placement`): the card when
   the table fits the measured free device memory, else the host-RAM
   spill tier when ``HOST_SHARE`` of the host's measured availability
   admits it; neither raises :class:`EmbeddingAdmissionError` and emits
   ``embedding_spill_fault``.  The spill tier itself (``spill.py``) is
   not ported yet.
3. Who owns which rows (:func:`shard_row_ranges`): contiguous
   ``np.array_split`` ranges, the lowest indices taking the remainder.
"""

from __future__ import annotations

import dataclasses
import os
import re

from elasticdl_tpu_torch.parallel.mesh import MeshAxis, Rule
from elasticdl_tpu_torch.telemetry import memory as memory_ledger
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# the device tier's byte budget, overriding the measured free memory (the
# CPU has no device budget, so without it the device tier admits all)
DEVICE_BUDGET_ENV = "ELASTICDL_TPU_EMBEDDING_DEVICE_BUDGET_BYTES"

# the share of the host's MemAvailable a spill table may claim
HOST_SHARE_ENV = "ELASTICDL_TPU_EMBEDDING_HOST_SHARE"
DEFAULT_HOST_SHARE = 0.5


class EmbeddingAdmissionError(RuntimeError):
    """Neither the device budget nor host-RAM headroom admits the table."""


def shard_row_ranges(num_rows: int, num_hosts: int) -> list[tuple[int, int]]:
    """Contiguous per-host row ranges ``[(lo, hi), ...]`` covering
    ``[0, num_rows)``, ``np.array_split``'s rule: the first
    ``num_rows % num_hosts`` hosts carry one extra row."""
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    if num_rows < 0:
        raise ValueError(f"num_rows must be >= 0, got {num_rows}")
    base, extra = divmod(num_rows, num_hosts)
    ranges = []
    lo = 0
    for host in range(num_hosts):
        hi = lo + base + (1 if host < extra else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def owning_shard(row: int, ranges) -> int:
    """Index of the shard whose range contains ``row``."""
    for i, (lo, hi) in enumerate(ranges):
        if lo <= row < hi:
            return i
    raise ValueError(f"row {row} outside all shard ranges {ranges}")


def embedding_axis(mesh, rows: int | None = None, allow_dp: bool = True):
    """The mesh axis that row-shards declared tables: the first of
    ep > tp > fsdp > dp of size > 1 that divides ``rows`` (when given);
    None when none fits (a single-process world: the table stays whole
    and a lookup is a local gather)."""
    axes = [MeshAxis.EP, MeshAxis.TP, MeshAxis.FSDP]
    if allow_dp:
        axes.append(MeshAxis.DP)
    for axis in axes:
        if axis not in mesh.axis_names or mesh.shape[axis] <= 1:
            continue
        if rows is not None and rows % mesh.shape[axis] != 0:
            continue
        return axis
    return None


def sharded_table_rules(mesh, tables: dict, allow_dp: bool = True) -> list:
    """Rules row-partitioning each declared table: ``tables`` maps a
    table's flax parameter path (``"embedding/embedding"``) to its
    padded row count; each becomes ``Rule(r"(^|/)<path>$", (axis,
    None))`` over :func:`embedding_axis`.  A table no axis fits is
    skipped (it stays whole)."""
    rules = []
    for path, rows in tables.items():
        axis = embedding_axis(mesh, rows=rows, allow_dp=allow_dp)
        if axis is None:
            logger.warning(
                "sharded_table_rules: no mesh axis divides %s rows of %r; "
                "leaving it replicated",
                rows, path,
            )
            continue
        rules.append(Rule(r"(^|/)" + re.escape(path) + "$", (axis, None)))
    return rules


# ---- tier admission ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """One table's admission decision: the tier that holds the rows and
    the measured budgets it was made against."""

    tier: str  # "device" | "spill"
    table_bytes: int
    device_budget_bytes: int | None
    host_available_bytes: int | None
    reason: str


def _host_share() -> float:
    raw = os.environ.get(HOST_SHARE_ENV, "")
    try:
        return float(raw) if raw else DEFAULT_HOST_SHARE
    except ValueError:
        return DEFAULT_HOST_SHARE


def device_budget_bytes() -> int | None:
    """Free memory summed over this process's visible cards
    (``torch.cuda.mem_get_info``), or the env override; None without a
    card and without the override (an unknowable budget admits)."""
    raw = os.environ.get(DEVICE_BUDGET_ENV, "")
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            pass
    import torch

    if not torch.cuda.is_available():
        return None
    total = 0
    for index in range(torch.cuda.device_count()):
        free, _total = torch.cuda.mem_get_info(index)
        total += int(free)
    return total


def plan_placement(
    table_bytes: int,
    name: str = "",
    prefer: str = "device",
    emit=None,
) -> Placement:
    """Admit a table onto a tier or refuse loudly: the device tier first
    (unless ``prefer="spill"``) when the bytes fit the measured free
    device memory (or that budget is unknowable), then the spill tier
    when they fit ``HOST_SHARE`` of the host's measured MemAvailable.
    Neither emits ``embedding_spill_fault`` (through ``emit``, default
    the worker's event hook) and raises."""
    budget = device_budget_bytes()
    if prefer != "spill" and (budget is None or table_bytes <= budget):
        return Placement(
            tier="device",
            table_bytes=table_bytes,
            device_budget_bytes=budget,
            host_available_bytes=None,
            reason="fits device budget"
            if budget is not None
            else "device budget unknowable; admitted",
        )
    health = memory_ledger.host_memory_health()
    available = health.get("host_available_bytes")
    share = _host_share()
    if available is None or table_bytes <= available * share:
        return Placement(
            tier="spill",
            table_bytes=table_bytes,
            device_budget_bytes=budget,
            host_available_bytes=available,
            reason=f"fits {share:.2f} of host MemAvailable"
            if available is not None
            else "host availability unknowable; admitted",
        )
    if emit is None:
        from elasticdl_tpu_torch.telemetry.worker_hooks import emit_event

        emit = emit_event
    try:
        from elasticdl_tpu_torch.telemetry.events import EVENT_EMBEDDING_SPILL_FAULT

        emit(
            EVENT_EMBEDDING_SPILL_FAULT,
            table=name,
            table_bytes=int(table_bytes),
            device_budget_bytes=budget,
            host_available_bytes=available,
            host_share=share,
        )
    except Exception:  # noqa: BLE001 — telemetry never raises into admission
        logger.exception("embedding_spill_fault emit failed")
    raise EmbeddingAdmissionError(
        f"table {name or '<unnamed>'} ({table_bytes} bytes) fits neither "
        f"the device budget ({budget}) nor {share:.2f} of host "
        f"MemAvailable ({available}); shard wider or shrink the table"
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
