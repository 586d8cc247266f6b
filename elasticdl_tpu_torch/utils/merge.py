"""The heartbeat's monotone max-merge; the part of
``elasticdl_tpu/utils/merge.py`` the port's servicer uses.

Workers ship process-lifetime monotone counters on the heartbeat (the
RPC outcome totals of ``rpc/stats.py``).  Beats can be reordered or
duplicated, so the server-side merge must be ``max``, never ``sum`` or
overwrite: a stale beat can then never walk an exposed total backward,
and a duplicate is absorbed.
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
