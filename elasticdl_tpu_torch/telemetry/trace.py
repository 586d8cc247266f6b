"""Trace CLI: Perfetto export + reform critical-path analysis; the
counterpart of ``elasticdl_tpu/telemetry/trace.py``.  Its output for the
same span and event files equals the JAX package's, so either CLI reads
either package's telemetry directory.

::

    python -m elasticdl_tpu_torch.telemetry.trace export <run_dir> [--output f]
    python -m elasticdl_tpu_torch.telemetry.trace analyze <run_dir> [--json]

``<run_dir>`` is any directory tree holding telemetry logs (the same
contract as ``telemetry.report``): each ``spans.jsonl`` /
``events.jsonl`` pair written by one run is analyzed independently.

``export`` emits Chrome trace-event JSON (viewable at ui.perfetto.dev or
``chrome://tracing``): every span becomes a complete ("X") event, every
worker ``step`` sample becomes an "X" event on its worker's track, and
lifecycle events become instants — one track per worker per generation,
plus a master track, so a re-formation reads as the old generation's
tracks ending, the master's reform phases, and the new generation's
tracks starting.

``analyze`` computes:

- the **reform-downtime critical path**: each inter-generation gap (the
  downtime ``telemetry.report`` measures: last step of generation N to
  first step of generation N+1) broken into named phases —
  ``death_detection`` (gap start to the reform root span),
  ``quiesce_recover`` (fence + task recovery span), ``world_relaunch``
  (kill + respawn span), ``world_join`` (the new world's
  process-group handshake spans), ``checkpoint_restore`` (state
  restore spans of the new generation) and ``warmup_compile`` (the
  remainder up to the first step — compile + first dispatch).  Phases
  are attributed by a boundary sweep over the clamped span intervals
  (later pipeline stages win overlaps), so the named phases plus
  ``unattributed`` sum EXACTLY to the downtime and ``coverage`` is the
  attributed fraction.
- a per-generation **straggler report**: each worker's median step time
  vs the generation median (outliers flagged), and the wait-vs-work
  split at the lockstep barrier — for every step index that multiple
  workers executed, the slowest worker bounds the barrier, so
  ``wait = slowest - own`` accumulates the time a worker spent blocked
  on peers rather than computing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

from elasticdl_tpu_torch.telemetry.events import EVENTS_FILENAME, read_jsonl
from elasticdl_tpu_torch.telemetry.tracing import (
    SPAN_CHECKPOINT_RESTORE,
    SPAN_COMPILE,
    SPAN_JOURNAL_REPLAY,
    SPAN_MASTER_RESTART,
    SPAN_MESH_RESIZE,
    SPAN_PREDICT_REQUEST,
    SPAN_REFORM,
    SPAN_REFORM_FENCE,
    SPAN_REFORM_RELAUNCH,
    SPAN_REPLICA_HARVEST,
    SPAN_REPLICA_RESTORE,
    SPAN_RPC_DEGRADED,
    SPAN_SERVING_DISPATCH,
    SPAN_SERVING_ENGINE,
    SPAN_SERVING_QUEUE,
    SPAN_SERVING_REROUTE,
    SPAN_SERVING_ROUTE,
    SPAN_TRAINER_BUILD,
    SPAN_WORKER_REHOME,
    SPAN_WORLD_INITIALIZE,
    SPAN_WORLD_JOIN,
    SPANS_FILENAME,
)

# a reform span can open marginally before the victim's last step lands
# in the log (step events stamp step START) — tolerate this much skew
# when matching a reform trace to a downtime gap
_GAP_MATCH_SLACK_SECS = 5.0

# a worker whose median step time exceeds the generation median by this
# factor is a straggler
_STRAGGLER_FACTOR = 1.5

TRACE_FILENAME = "trace.json"


def _find_dirs(run_dir: str) -> list[str]:
    """Directories holding at least one telemetry log (each is one run)."""
    found = set()
    for root, _dirs, files in os.walk(run_dir):
        if SPANS_FILENAME in files or EVENTS_FILENAME in files:
            found.add(root)
    return sorted(found)


def _load_run(telemetry_dir: str) -> tuple[list[dict], list[dict]]:
    spans = read_jsonl(os.path.join(telemetry_dir, SPANS_FILENAME))
    events = read_jsonl(os.path.join(telemetry_dir, EVENTS_FILENAME))
    return spans, events


# ---- export -----------------------------------------------------------------


class _Tracks:
    """Stable pid assignment: one Chrome 'process' per (run, actor,
    generation) so Perfetto renders one track per worker per generation."""

    def __init__(self):
        self._pids: dict[tuple, int] = {}
        self.metadata: list[dict] = []

    def pid(self, run: str, role: str, worker_id, generation) -> int:
        prefix = f"{run} " if run else ""
        if role == "master":
            key = (run, "master", None)
            label = f"{prefix}master"
        elif role in ("router", "client"):
            # singleton serving actors: one track each (a router has no
            # generations — its lifetime IS the fleet's)
            key = (run, role, None)
            label = f"{prefix}{role}"
        elif role == "replica":
            # one track per serving replica, so a request's trace reads
            # client -> router -> replica N top to bottom
            key = (run, "replica", worker_id)
            label = f"{prefix}replica {worker_id}"
        else:
            key = (run, worker_id, generation)
            label = f"{prefix}worker {worker_id} gen {generation}"
        pid = self._pids.get(key)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[key] = pid
            self.metadata.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": label},
                }
            )
            self.metadata.append(
                {
                    "name": "process_sort_index",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"sort_index": pid},
                }
            )
        return pid


def build_chrome_trace(run_dir: str) -> dict:
    """Chrome trace-event JSON for every run under ``run_dir``."""
    tracks = _Tracks()
    trace_events: list[dict] = []
    for telemetry_dir in _find_dirs(run_dir):
        run = os.path.relpath(telemetry_dir, run_dir)
        run = "" if run == "." else run
        spans, events = _load_run(telemetry_dir)
        for span in spans:
            start = span.get("start")
            end = span.get("end")
            if start is None or end is None:
                continue
            role = span.get("role", "worker")
            pid = tracks.pid(
                run, role, span.get("worker_id", 0), span.get("generation", 0)
            )
            args = {
                k: v
                for k, v in span.items()
                if k not in ("span", "start", "end", "time")
            }
            trace_events.append(
                {
                    "name": span.get("span", "span"),
                    "cat": role,
                    "ph": "X",
                    "ts": round(start * 1e6, 3),
                    "dur": round(max(0.0, end - start) * 1e6, 3),
                    "pid": pid,
                    "tid": int(span.get("process_id", 0) or 0),
                    "args": args,
                }
            )
        for event in events:
            name = event.get("event", "")
            at = event.get("monotonic")
            if at is None:
                continue
            if name == "step":
                dur = float(event.get("duration_secs") or 0.0)
                pid = tracks.pid(
                    run,
                    "worker",
                    event.get("worker_id", 0),
                    event.get("generation", 0),
                )
                trace_events.append(
                    {
                        "name": "step",
                        "cat": "step",
                        "ph": "X",
                        # duration measures the PREVIOUS interval; the
                        # slice ends at this sample's timestamp
                        "ts": round((at - dur) * 1e6, 3),
                        "dur": round(dur * 1e6, 3),
                        "pid": pid,
                        "tid": int(event.get("process_id", 0) or 0),
                        "args": {
                            "step": event.get("step"),
                            "records": event.get("records"),
                        },
                    }
                )
            else:
                pid = tracks.pid(run, "master", None, None)
                trace_events.append(
                    {
                        "name": name,
                        "cat": "lifecycle",
                        "ph": "i",
                        "s": "g",
                        "ts": round(at * 1e6, 3),
                        "pid": pid,
                        "tid": 0,
                        "args": {
                            k: v
                            for k, v in event.items()
                            if k not in ("event", "time", "monotonic")
                        },
                    }
                )
    return {
        "displayTimeUnit": "ms",
        "traceEvents": tracks.metadata + trace_events,
    }


# ---- analyze ----------------------------------------------------------------


def _steps_by_generation(events: list[dict]) -> dict[int, list[dict]]:
    by_gen: dict[int, list[dict]] = defaultdict(list)
    for event in events:
        if event.get("event") == "step" and event.get("monotonic") is not None:
            by_gen[event.get("generation", 0)].append(event)
    for steps in by_gen.values():
        steps.sort(key=lambda e: e["monotonic"])
    return by_gen


def _spans_named(spans: list[dict], *names: str) -> list[dict]:
    wanted = set(names)
    return [
        s
        for s in spans
        if s.get("span") in wanted
        and s.get("start") is not None
        and s.get("end") is not None
    ]


def _merged_window(spans: list[dict]) -> tuple[float, float] | None:
    if not spans:
        return None
    return (
        min(s["start"] for s in spans),
        max(s["end"] for s in spans),
    )


def _phase_intervals(
    spans: list[dict], gap_start: float, gap_end: float, to_generation: int
) -> list[tuple[str, float, float]]:
    """Candidate (phase, start, end) intervals for one downtime gap, in
    pipeline order.  Boundaries are clamped later by the sweep."""
    intervals: list[tuple[str, float, float]] = []
    reform = next(
        (
            s
            for s in sorted(
                _spans_named(spans, SPAN_REFORM), key=lambda s: s["start"]
            )
            if gap_start - _GAP_MATCH_SLACK_SECS <= s["start"] <= gap_end
        ),
        None,
    )
    # degraded-network windows (netem rpc_degraded spans): the period a
    # link was injected slow/blackholed.  Listed right after
    # death_detection so it REFINES the detection segment — the sweep's
    # later-stage-wins rule keeps every reform phase on top of it —
    # and clamped to the reform start: the eviction resolves the
    # degradation as far as this gap's pipeline is concerned.
    degraded = _merged_window(
        [
            s
            for s in _spans_named(spans, SPAN_RPC_DEGRADED)
            if s["end"] > gap_start - _GAP_MATCH_SLACK_SECS
            and s["start"] < gap_end
        ]
    )
    if reform is not None:
        intervals.append(("death_detection", gap_start, reform["start"]))
        if degraded:
            intervals.append(
                (
                    "degraded_network",
                    degraded[0],
                    min(degraded[1], reform["start"]),
                )
            )
        children = [
            s
            for s in spans
            if s.get("trace_id") == reform.get("trace_id")
            and s.get("span_id") != reform.get("span_id")
        ]
        # the replica harvest runs between the generation bump and the
        # fence loop (Master._stage_replica_restore), so it slots before
        # quiesce_recover in pipeline order
        harvest = _merged_window(
            _spans_named(children, SPAN_REPLICA_HARVEST)
        )
        if harvest:
            intervals.append(("replica_harvest", harvest[0], harvest[1]))
        fence = _merged_window(_spans_named(children, SPAN_REFORM_FENCE))
        if fence:
            intervals.append(("quiesce_recover", fence[0], fence[1]))
        relaunch = _merged_window(
            _spans_named(children, SPAN_REFORM_RELAUNCH)
        )
        if relaunch:
            intervals.append(("world_relaunch", relaunch[0], relaunch[1]))
    elif degraded:
        # no reform span matched the gap: the degraded window is still
        # the best name for the time it covers
        intervals.append(("degraded_network", degraded[0], degraded[1]))
    join_spans = [
        s
        for s in _spans_named(spans, SPAN_WORLD_JOIN, SPAN_WORLD_INITIALIZE)
        if s.get("generation", -1) == to_generation
        and gap_start - _GAP_MATCH_SLACK_SECS <= s["start"] <= gap_end
    ]
    join = _merged_window(join_spans)
    if join:
        intervals.append(("world_join", join[0], join[1]))
    for phase, span_name in (
        ("trainer_build", SPAN_TRAINER_BUILD),
        ("checkpoint_restore", SPAN_CHECKPOINT_RESTORE),
        # a replica-served reform has this phase INSTEAD of the disk
        # checkpoint_restore — restore came from the master's staged
        # peer-RAM harvest, not from a checkpoint read
        ("replica_restore", SPAN_REPLICA_RESTORE),
        # measured backend compiles (telemetry/compile_tracker.py):
        # listed LAST so the sweep attributes real compile time to
        # warmup_compile even where it overlaps trainer_build/restore —
        # the phase stops being a mere inferred remainder
        ("warmup_compile", SPAN_COMPILE),
    ):
        window = _merged_window(
            [
                s
                for s in _spans_named(spans, span_name)
                if s.get("generation", -1) == to_generation
                and gap_start - _GAP_MATCH_SLACK_SECS
                <= s["start"]
                <= gap_end
            ]
        )
        if window:
            intervals.append((phase, window[0], window[1]))
    return intervals


# uncovered time BETWEEN known phases is named for what the pipeline is
# doing there: after the relaunch span the master is waiting on process
# spawn; after the join the worker is re-initializing (model spec, data
# reader, first lease); after the build/restore it is compiling the step
_BRIDGE_AFTER = {
    "degraded_network": "death_detection",
    "replica_harvest": "quiesce_recover",
    "world_relaunch": "worker_spawn",
    "world_join": "worker_init",
    "trainer_build": "warmup_compile",
    "checkpoint_restore": "warmup_compile",
    "replica_restore": "warmup_compile",
    "warmup_compile": "warmup_compile",
}


def _attribute_gap(
    intervals: list[tuple[str, float, float]],
    gap_start: float,
    gap_end: float,
    tail_name: str = "warmup_compile",
    bridge: dict[str, str] | None = None,
) -> dict[str, float]:
    """Boundary sweep: every instant of the gap goes to the LAST listed
    phase covering it; time after every known phase is ``tail_name``
    (for a reform gap: the new world warming up); time covered by
    nothing before that is bridged via ``bridge`` or ``unattributed``.
    Values sum to the gap exactly."""
    if bridge is None:
        bridge = _BRIDGE_AFTER
    clamped = [
        (name, max(gap_start, lo), min(gap_end, hi))
        for name, lo, hi in intervals
        if min(gap_end, hi) > max(gap_start, lo)
    ]
    phases: dict[str, float] = defaultdict(float)
    # the tail after the last KNOWN phase is the new world warming up —
    # but only when there is at least one known phase; with no span
    # evidence at all the whole gap is honestly unattributed
    last_known_end = (
        max(hi for _n, _lo, hi in clamped) if clamped else None
    )
    bounds = sorted(
        {gap_start, gap_end}
        | ({last_known_end} if last_known_end is not None else set())
        | {b for _n, lo, hi in clamped for b in (lo, hi)}
    )
    for lo, hi in zip(bounds, bounds[1:]):
        mid = (lo + hi) / 2.0
        owner = None
        for name, ilo, ihi in clamped:  # later pipeline stages win
            if ilo <= mid < ihi:
                owner = name
        if owner is None and last_known_end is not None:
            if mid >= last_known_end:
                owner = tail_name
            else:
                # between two known phases: name the segment for what
                # the pipeline is doing after the preceding phase
                preceding = None
                preceding_end = None
                for name, _ilo, ihi in clamped:
                    if ihi <= mid and (
                        preceding_end is None or ihi > preceding_end
                    ):
                        preceding, preceding_end = name, ihi
                owner = bridge.get(preceding)
        if owner is None:
            owner = "unattributed"
        phases[owner] += hi - lo
    return dict(phases)


# uncovered time inside a master outage: after the restore span the
# master is serving but workers have not noticed the new boot id yet
# (heartbeat cadence); after the last re-home the world is re-leasing
# and dispatching again
_MASTER_OUTAGE_BRIDGE = {
    "master_restore": "rehome_wait",
    "journal_replay": "rehome_wait",
    "worker_rehome": "resume_dispatch",
}


def _master_outages(spans: list[dict], events: list[dict]) -> list[dict]:
    """Master-downtime attribution (master high availability): each
    ``master_restart`` span (restore start -> serving) anchors one
    outage.  The measured gap is the worker step stall around it — last
    ``step`` event at/before the restore began to the first at/after
    the master served again, the same measure ``telemetry.report`` uses
    — broken into named phases: ``master_down`` (death to relaunch),
    ``journal_replay``, ``master_restore`` (the rest of coming up),
    ``worker_rehome`` (lease-reconciliation handshakes), ``rehome_wait``
    / ``resume_dispatch`` (bridged idle).  The boundary sweep guarantees
    the phases sum EXACTLY to the measured gap."""
    restarts = sorted(
        _spans_named(spans, SPAN_MASTER_RESTART), key=lambda s: s["start"]
    )
    if not restarts:
        return []
    step_times = sorted(
        e["monotonic"]
        for e in events
        if e.get("event") == "step" and e.get("monotonic") is not None
    )
    outages = []
    for restart in restarts:
        gap_start = next(
            (
                t
                for t in reversed(step_times)
                if t <= restart["start"]
            ),
            restart["start"],
        )
        gap_end = next(
            (t for t in step_times if t >= restart["end"]), restart["end"]
        )
        intervals: list[tuple[str, float, float]] = [
            ("master_down", gap_start, restart["start"]),
            ("master_restore", restart["start"], restart["end"]),
        ]
        for phase, name in (
            ("journal_replay", SPAN_JOURNAL_REPLAY),
            ("worker_rehome", SPAN_WORKER_REHOME),
        ):
            window = _merged_window(
                [
                    s
                    for s in _spans_named(spans, name)
                    if restart["start"] - _GAP_MATCH_SLACK_SECS
                    <= s["start"]
                    <= gap_end
                ]
            )
            if window:
                intervals.append((phase, window[0], window[1]))
        downtime = max(0.0, gap_end - gap_start)
        phases = (
            _attribute_gap(
                intervals,
                gap_start,
                gap_end,
                tail_name="resume_dispatch",
                bridge=_MASTER_OUTAGE_BRIDGE,
            )
            if downtime > 0
            else {}
        )
        attributed = sum(
            v for k, v in phases.items() if k != "unattributed"
        )
        outages.append(
            {
                "generation": restart.get("generation"),
                "downtime_secs": round(downtime, 6),
                "phases_secs": {
                    k: round(v, 6) for k, v in sorted(phases.items())
                },
                "coverage": round(attributed / downtime, 4)
                if downtime
                else None,
            }
        )
    return outages


def _percentile(samples: list[float], q: float) -> float:
    import math

    ordered = sorted(samples)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


def _straggler_report(steps: list[dict]) -> dict:
    """Per-worker outliers + wait-vs-work split for ONE generation."""
    durations = [
        e["duration_secs"]
        for e in steps
        if e.get("duration_secs") is not None
    ]
    if not durations:
        return {}
    gen_median = _percentile(durations, 50)
    by_worker: dict[int, list[dict]] = defaultdict(list)
    for e in steps:
        if e.get("duration_secs") is not None:
            by_worker[e.get("worker_id", 0)].append(e)
    workers = {}
    for worker_id, events in sorted(by_worker.items()):
        own = [e["duration_secs"] for e in events]
        median = _percentile(own, 50)
        workers[worker_id] = {
            "steps": len(own),
            "median_step_ms": round(median * 1000.0, 3),
            "vs_generation_median": round(median / gen_median, 3)
            if gen_median
            else None,
            "straggler": bool(
                gen_median and median > _STRAGGLER_FACTOR * gen_median
            ),
        }
    # wait-vs-work at the lockstep barrier: for each step index executed
    # by >1 worker, the slowest bounds the barrier — everyone else waited
    by_step: dict[int, list[dict]] = defaultdict(list)
    for e in steps:
        if e.get("duration_secs") is not None and e.get("step") is not None:
            by_step[e["step"]].append(e)
    work: dict[int, float] = defaultdict(float)
    wait: dict[int, float] = defaultdict(float)
    barrier_steps = 0
    for _step, entries in by_step.items():
        if len(entries) < 2:
            continue
        barrier_steps += 1
        slowest = max(e["duration_secs"] for e in entries)
        for e in entries:
            worker = e.get("worker_id", 0)
            work[worker] += e["duration_secs"]
            wait[worker] += slowest - e["duration_secs"]
    for worker_id, stats in workers.items():
        if worker_id in work:
            total = work[worker_id] + wait[worker_id]
            stats["barrier_work_secs"] = round(work[worker_id], 6)
            stats["barrier_wait_secs"] = round(wait[worker_id], 6)
            stats["barrier_wait_pct"] = (
                round(wait[worker_id] / total * 100.0, 2) if total else 0.0
            )
    return {
        "generation_median_step_ms": round(gen_median * 1000.0, 3),
        "barrier_steps_compared": barrier_steps,
        "workers": workers,
    }


def _steady_state(events: list[dict]) -> dict:
    """Per-generation step-anatomy phase totals — where a NORMAL
    (non-reform) step's time goes, with the same sum-exact residual
    contract (`untracked` is tracked, not dropped).  Empty when the run
    never recorded anatomy (--step_anatomy off)."""
    from elasticdl_tpu_torch.telemetry.anatomy import ALL_PHASES

    by_gen: dict[int, list[dict]] = defaultdict(list)
    for event in events:
        if event.get("event") == "step_anatomy":
            by_gen[event.get("generation", 0)].append(event)
    out = {}
    for gen in sorted(by_gen):
        gen_events = by_gen[gen]
        wall_ms = sum(float(e.get("wall_ms", 0.0)) for e in gen_events)
        phases = {}
        for phase in ALL_PHASES:
            total = sum(
                float(e.get(f"{phase}_ms", 0.0)) for e in gen_events
            )
            if total:
                phases[phase] = {
                    "total_ms": round(total, 3),
                    "share": round(total / wall_ms, 4) if wall_ms else None,
                }
        out[gen] = {
            "dispatches": len(gen_events),
            "steps": sum(int(e.get("steps", 0)) for e in gen_events),
            "wall_ms_total": round(wall_ms, 3),
            "phases": phases,
        }
    return out


# uncovered time inside a predict request, named for what the pipeline
# is doing after the preceding phase: after routing the request sits in
# the replica queue, after queueing it computes, after compute the
# response returns through router to client
_SERVING_BRIDGE = {
    "route": "queue_wait",
    "queue_wait": "compute",
    "compute": "response_return",
}


def _serving_critical_path(spans: list[dict]) -> dict:
    """Per-request critical path of the serving plane: each
    ``predict_request`` root's wall is attributed over its trace's
    router/replica child spans with the SAME sum-exact boundary sweep
    the reform analysis uses — route, queue_wait, compute, the
    response's return leg, and honest ``unattributed`` for traces with
    missing children.  Sums (per trace AND in total) equal the measured
    request wall exactly."""
    roots = [
        s
        for s in _spans_named(spans, SPAN_PREDICT_REQUEST)
        if s.get("start") is not None and s.get("end") is not None
    ]
    if not roots:
        return {}
    by_trace: dict[str, list[dict]] = defaultdict(list)
    for span in spans:
        if span.get("trace_id"):
            by_trace[span["trace_id"]].append(span)
    totals: dict[str, float] = defaultdict(float)
    wall_total = 0.0
    reroutes = 0
    for root in sorted(roots, key=lambda s: s["start"]):
        members = [
            s
            for s in by_trace.get(root.get("trace_id"), [])
            if s is not root
            and s.get("start") is not None
            and s.get("end") is not None
        ]
        # pipeline order (later listed wins overlaps): the route span
        # covers the whole downstream RPC, so the replica's finer
        # queue/compute split takes the overlap and "route" keeps only
        # the router's own pick/transport time
        intervals = []
        for span in members:
            if span.get("span") in (
                SPAN_SERVING_ROUTE,
                SPAN_SERVING_REROUTE,
            ):
                intervals.append(("route", span["start"], span["end"]))
                if span.get("span") == SPAN_SERVING_REROUTE:
                    reroutes += 1
        for span in members:
            if span.get("span") == SPAN_SERVING_QUEUE:
                intervals.append(
                    ("queue_wait", span["start"], span["end"])
                )
        for span in members:
            if span.get("span") == SPAN_SERVING_ENGINE:
                intervals.append(("compute", span["start"], span["end"]))
        phases = _attribute_gap(
            intervals,
            root["start"],
            root["end"],
            tail_name="response_return",
            bridge=_SERVING_BRIDGE,
        )
        for name, secs in phases.items():
            totals[name] += secs
        wall_total += max(0.0, root["end"] - root["start"])
    dispatches = _spans_named(spans, SPAN_SERVING_DISPATCH)
    attributed = sum(
        v for k, v in totals.items() if k != "unattributed"
    )
    return {
        "requests": len(roots),
        "reroutes": reroutes,
        "wall_secs_total": round(wall_total, 6),
        "phases_secs": {
            k: round(v, 6) for k, v in sorted(totals.items())
        },
        "coverage": round(attributed / wall_total, 4)
        if wall_total
        else None,
        "dispatch_groups": len(dispatches),
        "linked_dispatch_groups": sum(
            1 for s in dispatches if s.get("links")
        ),
    }


def analyze_telemetry_dir(telemetry_dir: str) -> dict:
    """Analysis of ONE run's spans+events pair (pure function of the
    logs; the unit tests drive it with canned files)."""
    spans, events = _load_run(telemetry_dir)
    by_gen = _steps_by_generation(events)
    ordered = sorted(by_gen)

    reform_downtime = []
    for prev, nxt in zip(ordered, ordered[1:]):
        gap_start = by_gen[prev][-1]["monotonic"]
        gap_end = by_gen[nxt][0]["monotonic"]
        downtime = max(0.0, gap_end - gap_start)
        phases = (
            _attribute_gap(
                _phase_intervals(spans, gap_start, gap_end, nxt),
                gap_start,
                gap_end,
            )
            if downtime > 0
            else {}
        )
        attributed = sum(
            v for k, v in phases.items() if k != "unattributed"
        )
        reform_downtime.append(
            {
                "from_generation": prev,
                "to_generation": nxt,
                "downtime_secs": round(downtime, 6),
                "phases_secs": {
                    k: round(v, 6) for k, v in sorted(phases.items())
                },
                "coverage": round(attributed / downtime, 4)
                if downtime
                else None,
            }
        )

    straggler_reports = (
        (gen, _straggler_report(by_gen[gen])) for gen in ordered
    )
    stragglers = {gen: rep for gen, rep in straggler_reports if rep}

    recovered_links = sum(
        1 for s in spans if s.get("recovered") and s.get("trace_id")
    )
    # steady-state (non-reform) mode: the same phase discipline the
    # reform attribution applies to downtime, applied to NORMAL steps —
    # per-generation step-anatomy phase totals (from the complete
    # per-dispatch events; the sampled step_anatomy spans render the
    # same breakdown on the Perfetto timeline)
    steady_state = _steady_state(events)
    # slice-granular elasticity: every hybrid-mesh resize the run's
    # re-formations performed (a separate listing — the resize re-plan
    # runs inside the reform window, so it is NOT a new downtime phase
    # and the sum-exact phase attribution above is untouched)
    mesh_resizes = [
        {
            "generation": s.get("generation"),
            "old_world_size": s.get("old_world_size"),
            "new_world_size": s.get("new_world_size"),
            "old_slices": s.get("old_slices"),
            "new_slices": s.get("new_slices"),
            "plan_secs": round(s["end"] - s["start"], 6),
        }
        for s in sorted(
            _spans_named(spans, SPAN_MESH_RESIZE),
            key=lambda s: s["start"],
        )
    ]
    out = {
        "spans_total": len(spans),
        "traces_total": len({s.get("trace_id") for s in spans}),
        "recovered_task_spans": recovered_links,
        "reform_downtime": reform_downtime,
        "master_outage": _master_outages(spans, events),
        "mesh_resizes": mesh_resizes,
        "stragglers": stragglers,
    }
    if steady_state:
        out["steady_state"] = steady_state
    serving = _serving_critical_path(spans)
    if serving:
        out["serving"] = serving
    return out


def analyze_run_dir(run_dir: str) -> dict:
    runs = {}
    for telemetry_dir in _find_dirs(run_dir):
        rel = os.path.relpath(telemetry_dir, run_dir)
        runs["." if rel == "." else rel] = analyze_telemetry_dir(
            telemetry_dir
        )
    return {"run_dir": run_dir, "runs": runs}


# ---- CLI --------------------------------------------------------------------


def _format_analysis(report: dict) -> str:
    lines = [f"Trace analysis: {report['run_dir']}"]
    if not report["runs"]:
        lines.append("no telemetry logs found (spans.jsonl / events.jsonl)")
    for rel, run in report["runs"].items():
        lines.append(
            f"== {rel} ==  spans={run['spans_total']} "
            f"traces={run['traces_total']} "
            f"recovered_task_spans={run['recovered_task_spans']}"
        )
        for gap in run["reform_downtime"]:
            lines.append(
                "reform gen{}->gen{}: downtime {:.2f}s  coverage {}".format(
                    gap["from_generation"],
                    gap["to_generation"],
                    gap["downtime_secs"],
                    f"{gap['coverage'] * 100:.0f}%"
                    if gap["coverage"] is not None
                    else "n/a",
                )
            )
            for phase, secs in gap["phases_secs"].items():
                lines.append(f"  {phase:<20s} {secs:8.3f}s")
        for outage in run.get("master_outage", []):
            lines.append(
                "master outage (gen {}): downtime {:.2f}s  coverage "
                "{}".format(
                    outage["generation"],
                    outage["downtime_secs"],
                    f"{outage['coverage'] * 100:.0f}%"
                    if outage["coverage"] is not None
                    else "n/a",
                )
            )
            for phase, secs in outage["phases_secs"].items():
                lines.append(f"  {phase:<20s} {secs:8.3f}s")
        for resize in run.get("mesh_resizes", []):
            lines.append(
                "mesh resize (gen {}): {} procs / {} slice(s) -> {} "
                "procs / {} slice(s)".format(
                    resize["generation"],
                    resize["old_world_size"],
                    resize["old_slices"],
                    resize["new_world_size"],
                    resize["new_slices"],
                )
            )
        for gen, g in (run.get("steady_state") or {}).items():
            lines.append(
                "steady state gen {}: {} dispatches / {} steps, "
                "{:.1f}ms".format(
                    gen,
                    g["dispatches"],
                    g["steps"],
                    g["wall_ms_total"],
                )
            )
            for phase, stats in g["phases"].items():
                lines.append(
                    "  {:<20s} {:9.1f}ms ({:5.1f}%)".format(
                        phase,
                        stats["total_ms"],
                        (stats["share"] or 0.0) * 100.0,
                    )
                )
        serving = run.get("serving")
        if serving:
            lines.append(
                "serving: {} request(s) / {} reroute(s), wall {:.3f}s, "
                "coverage {}".format(
                    serving["requests"],
                    serving["reroutes"],
                    serving["wall_secs_total"],
                    f"{serving['coverage'] * 100:.0f}%"
                    if serving["coverage"] is not None
                    else "n/a",
                )
            )
            for phase, secs in serving["phases_secs"].items():
                lines.append(f"  {phase:<20s} {secs:8.3f}s")
            lines.append(
                "  dispatch groups: {} ({} linked)".format(
                    serving["dispatch_groups"],
                    serving["linked_dispatch_groups"],
                )
            )
        for gen, stats in run["stragglers"].items():
            for worker, w in stats["workers"].items():
                flag = "  STRAGGLER" if w["straggler"] else ""
                wait = (
                    f"  wait {w['barrier_wait_pct']:.0f}%"
                    if "barrier_wait_pct" in w
                    else ""
                )
                lines.append(
                    f"gen {gen} worker {worker}: median "
                    f"{w['median_step_ms']:.1f}ms "
                    f"({w['vs_generation_median']}x gen median)"
                    f"{wait}{flag}"
                )
    return "\n".join(lines)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.telemetry.trace",
        description="Export (Perfetto) and analyze distributed traces",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    exp = sub.add_parser(
        "export", help="Emit Chrome trace-event JSON for Perfetto"
    )
    exp.add_argument("run_dir")
    exp.add_argument(
        "--output",
        default="",
        help=f"Output path (default <run_dir>/{TRACE_FILENAME})",
    )
    ana = sub.add_parser(
        "analyze",
        help="Reform critical path + per-generation straggler report",
    )
    ana.add_argument("run_dir")
    ana.add_argument("--json", action="store_true")
    ana.add_argument(
        "--output", default="", help="Also write the JSON report here"
    )
    return parser


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"not a directory: {args.run_dir}", file=sys.stderr)
        return 2
    if args.command == "export":
        trace = build_chrome_trace(args.run_dir)
        out = args.output or os.path.join(args.run_dir, TRACE_FILENAME)
        with open(out, "w", encoding="utf-8") as f:
            json.dump(trace, f)
            f.write("\n")
        print(
            f"wrote {out} ({len(trace['traceEvents'])} events) — open at "
            "https://ui.perfetto.dev or chrome://tracing"
        )
        return 0
    report = analyze_run_dir(args.run_dir)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(_format_analysis(report))
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, default=str)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
