"""The monotone max-merges; the part of ``elasticdl_tpu/utils/merge.py``
the port uses: the master's heartbeat fan-in and the serving router's
probe-beat fan-in.

Workers ship process-lifetime monotone counters on the heartbeat (the
RPC outcome totals of ``rpc/stats.py``), and serving replicas ship
theirs, with per-phase latency totals, on every ``serving_status``
reply.  Beats can be reordered or duplicated, so the receiving merge
must be ``max``, never ``sum`` or overwrite: a stale beat can then never
walk an exposed total backward, and a duplicate is absorbed.
"""

from __future__ import annotations


def max_merge_counters(
    merged: dict[str, int],
    update: dict,
    watch: frozenset[str] | set[str] = frozenset(),
    totals: dict[str, int] | None = None,
) -> bool:
    """Max-merge ``update`` into ``merged`` in place.

    Non-int values are skipped (wire payloads are untrusted).  Returns
    True when any ``watch`` key ROSE above its merged value.
    ``totals``, when given, accumulates each rise's delta (the
    fleet-wide aggregate).
    """
    rose = False
    for key, value in update.items():
        try:
            value = int(value)
        except (TypeError, ValueError):
            continue
        old = merged.get(key, 0)
        if value > old:
            if key in watch:
                rose = True
            if totals is not None:
                totals[key] = totals.get(key, 0) + (value - old)
            merged[key] = value
    return rose


def max_merge_phase_stats(
    merged: dict[str, dict],
    update: dict,
    totals: dict[str, dict] | None = None,
) -> None:
    """Max-merge step-anatomy phase totals in place.

    Shape: ``{phase: {"ms": float, "count": int, "buckets": {str(bound):
    int}}}`` — ms, count and every log bucket are each monotone per
    worker, so each merges independently by max.  A malformed phase
    entry is skipped whole; a malformed bucket value skips the rest of
    that phase's entry (same tolerance the servicer always had).
    ``totals``, when given, accumulates every slot's rise delta — the
    fleet-wide aggregate (the router's fleet totals).
    """
    for phase, stats in update.items():
        if not isinstance(stats, dict):
            continue
        slot = merged.setdefault(
            phase, {"ms": 0.0, "count": 0, "buckets": {}}
        )
        agg = (
            None
            if totals is None
            else totals.setdefault(
                phase, {"ms": 0.0, "count": 0, "buckets": {}}
            )
        )
        try:
            ms = float(stats.get("ms", 0.0))
            if ms > slot["ms"]:
                if agg is not None:
                    agg["ms"] += ms - slot["ms"]
                slot["ms"] = ms
            count = int(stats.get("count", 0))
            if count > slot["count"]:
                if agg is not None:
                    agg["count"] += count - slot["count"]
                slot["count"] = count
            for bound, n in (stats.get("buckets") or {}).items():
                n = int(n)
                old = slot["buckets"].get(bound, 0)
                if n > old:
                    if agg is not None:
                        agg["buckets"][bound] = (
                            agg["buckets"].get(bound, 0) + (n - old)
                        )
                    slot["buckets"][bound] = n
        except (TypeError, ValueError):
            continue
