"""The run report's sections that the chaos harness embeds: the first
part of ``elasticdl_tpu/telemetry/report.py`` (the rest comes with slice
10).

- :func:`multislice_section`: every whole-slice loss, mesh resize and
  autoscale decision, and the replica pushes of multi-slice worlds by
  source slice;
- :func:`master_ha_section`: one entry per master restart (the step gap
  of the outage, the journal replay, the re-homes and their leases);
- :func:`replication_section`: pushes and hosts covered per generation,
  the freshest shard versions, harvests and restores from peer RAM.

Each reads a list of event records: the JAX package's telemetry event
log, whose records name themselves under ``"event"``, or the port's chaos
event log, whose observations do under ``"observation"`` (and whose
workers stamp ``cluster_version`` where JAX's stamp ``generation``).
Both shapes are read; on the JAX shape each section returns what the
JAX package's does.  The port's log differs in three ways the sections
absorb: its ``master_restart`` carries the replay (``replay_secs``,
``pending``, ``active``) that JAX logs apart as ``journal_replay``; its
``worker_rehome`` lists the leases kept and requeued, where JAX counts
them, and also records the refused (fenced) handshakes, which are not
re-homes; and it has no ``step`` samples until slice 10, so an outage's
step gap is None.
"""

from __future__ import annotations

from collections import defaultdict


def _kind(event: dict):
    return event.get("event") or event.get("observation")


def _generation(event: dict):
    return event.get("generation", event.get("cluster_version", 0))


def _count(value) -> int:
    return len(value) if isinstance(value, (list, tuple)) else int(value or 0)


def multislice_section(events: list[dict]) -> dict | None:
    """The slice-topology timeline; None when the run never touched the
    slice machinery."""
    losses = []
    resizes = []
    decisions = []
    pushes_by_slice: dict[str, int] = defaultdict(int)
    for event in events:
        kind = _kind(event)
        if kind == "slice_loss":
            losses.append(
                {
                    "generation": event.get("generation"),
                    "lost_slices": event.get("lost_slices"),
                    "dead_workers": event.get("dead_workers"),
                    "old_slices": event.get("old_slices"),
                    "new_slices": event.get("new_slices"),
                    "parked": event.get("parked"),
                }
            )
        elif kind == "mesh_resize":
            resizes.append(
                {
                    "generation": event.get("generation"),
                    "old_world_size": event.get("old_world_size"),
                    "new_world_size": event.get("new_world_size"),
                    "old_slices": event.get("old_slices"),
                    "new_slices": event.get("new_slices"),
                    "dcn": event.get("dcn"),
                }
            )
        elif kind == "autoscale_decision":
            decisions.append(
                {
                    "generation": event.get("generation"),
                    "action": event.get("action"),
                    "from_slices": event.get("from_slices"),
                    "to_slices": event.get("to_slices"),
                    "reason": event.get("reason"),
                }
            )
        elif kind == "replica_push" and int(event.get("num_slices", 1) or 1) > 1:
            pushes_by_slice[str(event.get("source_slice"))] += 1
    if not (losses or resizes or decisions or pushes_by_slice):
        return None
    return {
        "slice_losses": losses,
        "mesh_resizes": resizes,
        "autoscale_decisions": decisions,
        "replica_pushes_by_source_slice": dict(pushes_by_slice),
    }


def _replay(restart: dict, replays: list[dict], at: float, until: float) -> tuple:
    """(seconds, pending, active) of the journal replay of the master
    life that ``restart`` began."""
    replay = next((e for e in replays if at <= e.get("monotonic", 0.0) < until), None)
    if replay is not None:
        return replay.get("duration_secs"), replay.get("pending"), replay.get("active")
    if "replay_secs" in restart:  # the port's restart carries its replay
        return restart.get("replay_secs"), restart.get("pending"), restart.get("active")
    return None, None, None


def master_ha_section(events: list[dict]) -> dict | None:
    """Master-downtime stats, one entry per ``master_restart``: the step
    gap the outage caused (the last ``step`` sample before the restore
    began to the first after), the journal replay, and the outcome of
    every re-home.  None when no master restarted."""
    restarts = sorted(
        (
            e for e in events
            if _kind(e) == "master_restart" and e.get("monotonic") is not None
        ),
        key=lambda e: e["monotonic"],
    )
    if not restarts:
        return None
    steps = [
        e["monotonic"] for e in events
        if _kind(e) == "step" and e.get("monotonic") is not None
    ]
    replays = sorted(
        (e for e in events if _kind(e) == "journal_replay"),
        key=lambda e: e.get("monotonic", 0.0),
    )
    rehomes = sorted(
        (
            e for e in events
            if _kind(e) == "worker_rehome" and e.get("accepted", True) is not False
        ),
        key=lambda e: e.get("monotonic", 0.0),
    )
    entries = []
    bounds = [r["monotonic"] for r in restarts[1:]] + [float("inf")]
    for restart, until in zip(restarts, bounds):
        at = restart["monotonic"]
        last_before = max((t for t in steps if t <= at), default=None)
        first_after = min((t for t in steps if t >= at), default=None)
        replay_secs, pending, active = _replay(restart, replays, at, until)
        mine = [e for e in rehomes if at <= e.get("monotonic", 0.0) < until]
        entries.append(
            {
                "generation": restart.get("generation"),
                "downtime_secs": round(first_after - last_before, 6)
                if last_before is not None and first_after is not None
                else None,
                "journal_replay_secs": replay_secs,
                "pending_tasks_restored": pending,
                "active_leases_restored": active,
                "workers_rehomed": sorted(e.get("worker_id") for e in mine),
                "leases_kept": sum(_count(e.get("kept", 0)) for e in mine),
                "leases_requeued": sum(_count(e.get("requeued", 0)) for e in mine),
            }
        )
    measured = [e["downtime_secs"] for e in entries if e["downtime_secs"] is not None]
    return {
        "restarts": entries,
        "total_downtime_secs": round(sum(measured), 6) if measured else None,
    }


def replication_section(events: list[dict]) -> dict | None:
    """Replica coverage: pushes and hosts covered per generation, the
    freshest shard versions, harvests, and restores from peer RAM.  None
    when the run never replicated."""
    pushes: dict[int, int] = defaultdict(int)
    hosts: dict[int, set] = defaultdict(set)
    versions: dict[int, int] = {}
    restores = []
    harvests = []
    for event in events:
        kind = _kind(event)
        gen = _generation(event)
        if kind == "replica_push":
            pushes[gen] += 1
            if event.get("source") is not None:
                hosts[gen].add(event["source"])
            versions[gen] = max(versions.get(gen, -1), event.get("step", -1))
        elif kind == "replica_restore":
            restores.append({"generation": gen, "step": event.get("step")})
        elif kind == "replica_harvest":
            harvests.append(
                {
                    "generation": gen,
                    "complete": event.get("complete"),
                    "version": event.get("version"),
                }
            )
    if not (pushes or restores or harvests):
        return None
    return {
        "pushes_by_generation": dict(pushes),
        "hosts_covered_by_generation": {g: sorted(h) for g, h in hosts.items()},
        "shard_versions_by_generation": versions,
        "restores": restores,
        "harvests": harvests,
    }
