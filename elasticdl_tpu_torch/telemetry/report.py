"""The run report's sections: the part of ``elasticdl_tpu/telemetry/report.py``
that the port's runs feed (the report CLI and its other sections come
with slice 10b-2).

- :func:`goodput_section`: the step anatomy's ledger per generation
  (``telemetry/anatomy.py``'s ``step_anatomy`` events): the phases'
  totals, shares and p50/p95/p99, the sum-exact residual check, a
  measured ``e2e_vs_roofline``, MFU (or why it is absent) and the
  stragglers;
- :func:`multislice_section`: every whole-slice loss, mesh resize and
  autoscale decision, and the replica pushes of multi-slice worlds by
  source slice;
- :func:`master_ha_section`: one entry per master restart (the step gap
  of the outage, the journal replay, the re-homes and their leases);
- :func:`replication_section`: pushes and hosts covered per generation,
  the freshest shard versions, harvests and restores from peer RAM;
- :func:`streaming_section`: the watermarks, the lag's percentiles and
  the freshness ledger of the live pushes, and :func:`streaming_lines`,
  its text as the JAX report CLI renders it;
- :func:`trace_section`: the causal trace's analysis of a telemetry
  directory that holds a span log (``telemetry/trace.py``: the
  re-formation's phases, stragglers, steady state), as the JAX report
  puts it under a run's ``trace``.

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
re-homes.  The port's master writes ``master_restart`` and
``worker_rehome`` to both logs when ``--telemetry_dir`` is set; a run's
events may hold both, and each restart and re-home is counted once (the
telemetry log's record wins).
"""

from __future__ import annotations

import math
import os
from collections import defaultdict


def percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — exact over raw samples,
    no interpolation surprises in tiny runs."""
    if not samples:
        raise ValueError("no samples")
    ordered = sorted(samples)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


# step-anatomy goodput: the phase taxonomy the events carry (one
# definition site: telemetry/anatomy.py); device-path = everything the
# dispatch spends on the device side of the pipeline
_GOODPUT_DEVICE_PATH = ("assemble", "h2d_transfer", "device_compute")
_GOODPUT_STRAGGLER_FACTOR = 1.5


def _phase_samples(anat_events: list[dict]) -> dict[str, list[float]]:
    from elasticdl_tpu_torch.telemetry.anatomy import ALL_PHASES

    samples: dict[str, list[float]] = {}
    for event in anat_events:
        for phase in ALL_PHASES:
            value = event.get(f"{phase}_ms")
            if value is not None:
                samples.setdefault(phase, []).append(float(value))
    return samples


def _goodput_generation(anat_events: list[dict]) -> dict:
    """Goodput stats for ONE generation's ``step_anatomy`` events."""
    samples = _phase_samples(anat_events)
    wall_ms = sum(float(e.get("wall_ms", 0.0)) for e in anat_events)
    records = sum(int(e.get("records", 0)) for e in anat_events)
    steps = sum(int(e.get("steps", 0)) for e in anat_events)
    phases = {}
    for phase, values in samples.items():
        total = sum(values)
        phases[phase] = {
            "total_ms": round(total, 3),
            "share": round(total / wall_ms, 4) if wall_ms else None,
            "p50_ms": round(percentile(values, 50), 3),
            "p95_ms": round(percentile(values, 95), 3),
            "p99_ms": round(percentile(values, 99), 3),
        }
    # the sum-exact contract, verified not assumed: the per-event
    # residual between wall and the phase sum (incl. untracked) is
    # float noise only
    residual = max(
        (
            abs(
                float(e.get("wall_ms", 0.0))
                - sum(
                    float(e.get(f"{p}_ms", 0.0))
                    for p in samples
                )
            )
            for e in anat_events
        ),
        default=0.0,
    )
    host_ms = sum(samples.get("host_fetch", []))
    device_path_ms = sum(
        sum(samples.get(p, [])) for p in _GOODPUT_DEVICE_PATH
    )
    untracked_ms = sum(samples.get("untracked", []))
    out = {
        "dispatches": len(anat_events),
        "steps": steps,
        "records": records,
        "wall_ms_total": round(wall_ms, 3),
        "phases": phases,
        "max_sum_residual_ms": round(residual, 6),
        "untracked_share": round(untracked_ms / wall_ms, 4)
        if wall_ms
        else None,
        # live e2e-vs-roofline: the binding path's busy time (host
        # fetch wait vs the device path) over end-to-end wall — 1.0
        # means zero overlap slack, the same meaning as bench.py's
        # budget ratio but MEASURED per dispatch instead of inferred
        # from separate ceiling runs
        "e2e_vs_roofline": round(
            max(host_ms, device_path_ms) / wall_ms, 4
        )
        if wall_ms
        else None,
        "binding": (
            "host_fetch" if host_ms > device_path_ms else "device_path"
        ),
    }
    # async-dispatch overlap visibility: how much of device_compute was
    # the enqueue call vs waiting for results
    enqueue_ms = sum(float(e.get("enqueue_ms", 0.0)) for e in anat_events)
    ready_ms = sum(float(e.get("ready_wait_ms", 0.0)) for e in anat_events)
    if enqueue_ms or ready_ms:
        out["device_compute_split_ms"] = {
            "enqueue": round(enqueue_ms, 3),
            "ready_wait": round(ready_ms, 3),
        }
    # model-FLOPs MFU, when the model cost and the device peak are known
    flops = next(
        (
            e["flops_per_record"]
            for e in anat_events
            if e.get("flops_per_record")
        ),
        None,
    )
    peak = next(
        (
            e["peak_flops_per_chip"]
            for e in anat_events
            if e.get("peak_flops_per_chip")
        ),
        None,
    )
    n_chips = next(
        (e["n_chips"] for e in anat_events if e.get("n_chips")), 1
    )
    device_secs = sum(samples.get("device_compute", [])) / 1000.0
    if flops is None:
        out["mfu"] = None
        out["mfu_reason"] = "model FLOPs unknown (not in the zoo cost table)"
    elif peak is None:
        out["mfu"] = None
        out["mfu_reason"] = (
            "device peak FLOPs unknown "
            "(set ELASTICDL_TPU_PEAK_FLOPS_PER_CHIP)"
        )
    elif device_secs <= 0:
        out["mfu"] = None
        out["mfu_reason"] = "no device_compute time measured"
    else:
        out["mfu"] = round(
            flops * records / (device_secs * peak * n_chips), 4
        )
    # per-host straggler attribution: whose device_compute vs
    # host_fetch lags the fleet — the "which worker, which phase"
    # answer the barrier-wait split alone can't give
    by_worker: dict = defaultdict(list)
    for event in anat_events:
        by_worker[event.get("worker_id", 0)].append(event)
    if len(by_worker) > 1:
        # a straggler is a worker whose dispatch WALL lags the fleet
        # (each phase alone can be bimodal across a healthy fleet);
        # the lagging phase then names WHY — compute-bound vs
        # input-bound — which is the actionable half of the answer
        gen_wall = percentile(
            [float(e.get("wall_ms", 0.0)) for e in anat_events], 50
        )
        gen_compute = percentile(
            samples.get("device_compute", [0.0]), 50
        )
        gen_fetch = percentile(samples.get("host_fetch", [0.0]), 50)
        workers = {}
        for worker_id, worker_events in sorted(by_worker.items()):
            worker_samples = _phase_samples(worker_events)
            wall_p50 = percentile(
                [float(e.get("wall_ms", 0.0)) for e in worker_events], 50
            )
            compute_p50 = percentile(
                worker_samples.get("device_compute", [0.0]), 50
            )
            fetch_p50 = percentile(
                worker_samples.get("host_fetch", [0.0]), 50
            )
            entry = {
                "wall_p50_ms": round(wall_p50, 3),
                "device_compute_p50_ms": round(compute_p50, 3),
                "host_fetch_p50_ms": round(fetch_p50, 3),
                "straggler": bool(
                    gen_wall
                    and wall_p50 > _GOODPUT_STRAGGLER_FACTOR * gen_wall
                ),
            }
            if entry["straggler"]:
                compute_lag = (
                    compute_p50 / gen_compute if gen_compute else 0.0
                )
                fetch_lag = fetch_p50 / gen_fetch if gen_fetch else 0.0
                entry["lagging_phase"] = (
                    "device_compute"
                    if compute_lag >= fetch_lag
                    else "host_fetch"
                )
            workers[worker_id] = entry
        out["workers"] = workers
    return out


def goodput_section(events: list[dict]) -> dict | None:
    """Live goodput ledger from per-dispatch ``step_anatomy`` events
    (telemetry/anatomy.py): per-generation phase percentiles, the
    sum-exact residual check, a MEASURED ``e2e_vs_roofline``, MFU for
    zoo models with known costs, and per-host straggler attribution.
    None (key absent) when the run never recorded anatomy, so
    anatomy-less reports are unchanged."""
    anat = [e for e in events if e.get("event") == "step_anatomy"]
    if not anat:
        return None
    by_gen: dict[int, list[dict]] = defaultdict(list)
    for event in anat:
        by_gen[event.get("generation", 0)].append(event)
    generations = {
        gen: _goodput_generation(by_gen[gen]) for gen in sorted(by_gen)
    }
    overall = _goodput_generation(anat)
    return {"generations": generations, "overall": overall}


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


def _one_log(events: list[dict], kind: str) -> list[dict]:
    """The records of ``kind``, from one log: the telemetry log's
    (``"event"``) where it has any, else the chaos log's."""
    found = [e for e in events if _kind(e) == kind]
    telemetry = [e for e in found if "event" in e]
    return telemetry or found


def master_ha_section(events: list[dict]) -> dict | None:
    """Master-downtime stats, one entry per ``master_restart``: the step
    gap the outage caused (the last ``step`` sample before the restore
    began to the first after), the journal replay, and the outcome of
    every re-home.  None when no master restarted."""
    restarts = sorted(
        (
            e for e in _one_log(events, "master_restart")
            if e.get("monotonic") is not None
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
            e for e in _one_log(events, "worker_rehome")
            if e.get("accepted", True) is not False
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


def streaming_section(events: list[dict]) -> dict | None:
    """A streaming run's aggregate: the watermarks' progress from the
    ``stream_watermark`` and ``stream_lag`` ticks (the last pair, the
    lag's percentiles and maximum: the bounded-lag evidence) and the
    freshness ledger, one row per ``live_push`` with the trained
    watermark at the swap beside the source watermark (``staleness``:
    how many records behind the source the served model was when it went
    live).  None when the run never streamed."""
    ticks = sorted(
        (e for e in events if e.get("event") == "stream_watermark"),
        key=lambda e: e.get("monotonic", 0.0),
    )
    lags = [
        float(e["lag_records"])
        for e in events
        if e.get("event") == "stream_lag" and "lag_records" in e
    ]
    pushes = sorted(
        (e for e in events if e.get("event") == "live_push"),
        key=lambda e: e.get("monotonic", 0.0),
    )
    if not ticks and not lags and not pushes:
        return None
    out: dict = {"watermark_ticks": len(ticks)}
    if ticks:
        last = ticks[-1]
        out["source_watermark"] = int(last.get("source_watermark", 0))
        out["trained_watermark"] = int(last.get("trained_watermark", 0))
        out["closed"] = bool(last.get("closed", False))
    if lags:
        out["lag_records"] = {
            "max": int(max(lags)),
            "p50": round(percentile(lags, 50), 1),
            "p95": round(percentile(lags, 95), 1),
            "last": int(lags[-1]),
        }
    if pushes:
        accepted = [e for e in pushes if e.get("accepted")]
        staleness = [int(e.get("staleness", 0)) for e in accepted]
        out["freshness"] = {
            "pushes": len(pushes),
            "accepted": len(accepted),
            "refused": len(pushes) - len(accepted),
            "max_staleness_records": max(staleness) if staleness else None,
            "ledger": [
                {
                    "model_version": e.get("model_version"),
                    "trained_watermark": e.get("trained_watermark"),
                    "source_watermark": e.get("source_watermark"),
                    "staleness": e.get("staleness"),
                    "accepted": bool(e.get("accepted")),
                    "swap_ms": e.get("swap_ms"),
                    "monotonic": e.get("monotonic"),
                }
                for e in pushes
            ],
        }
    return out


def streaming_lines(streaming: dict) -> list[str]:
    """:func:`streaming_section`'s text: the lines the JAX report CLI
    prints for a run's streaming section."""
    lines = [
        "streaming: trained watermark {} / source {}{}".format(
            streaming.get("trained_watermark", "?"),
            streaming.get("source_watermark", "?"),
            " (source closed)" if streaming.get("closed") else "",
        )
    ]
    lag = streaming.get("lag_records")
    if lag:
        lines.append(
            "  lag: max {} p50 {} p95 {} last {} record(s)".format(
                lag["max"], lag["p50"], lag["p95"], lag["last"]
            )
        )
    fresh = streaming.get("freshness")
    if fresh:
        lines.append(
            "  freshness: {} push(es), {} accepted, {} refused, "
            "max staleness {} record(s)".format(
                fresh["pushes"], fresh["accepted"], fresh["refused"],
                fresh["max_staleness_records"],
            )
        )
        for row in fresh["ledger"]:
            lines.append(
                "    push v{}: trained {} / source {} (staleness {}){}".format(
                    row["model_version"], row["trained_watermark"],
                    row["source_watermark"], row["staleness"],
                    "" if row["accepted"] else "  REFUSED",
                )
            )
    return lines


def trace_section(telemetry_dir: str) -> dict | None:
    """``telemetry/trace.py``'s analysis of ``telemetry_dir`` when the
    run also wrote a span log there, else None: a run's ``trace`` entry
    in the JAX report."""
    from elasticdl_tpu_torch.telemetry.trace import analyze_telemetry_dir
    from elasticdl_tpu_torch.telemetry.tracing import SPANS_FILENAME

    if not os.path.exists(os.path.join(telemetry_dir, SPANS_FILENAME)):
        return None
    return analyze_telemetry_dir(telemetry_dir)

