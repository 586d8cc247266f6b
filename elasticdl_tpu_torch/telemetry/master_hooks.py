"""Master-side telemetry: one object that owns the metrics registry and
the event log; the counterpart of
``elasticdl_tpu/telemetry/master_hooks.py``.

The master attaches it as a task-dispatcher observer, a servicer
version observer and the re-formation path's collaborator, so the
elastic lifecycle is measured through the observers the chaos checker
already rides, with nothing added to the hot loop.  Point-in-time values
(queue depths, epoch, live workers, the heartbeat-shipped phase,
staging and RPC totals, the workers' ``time_<bucket>_ms`` buckets) are
refreshed at scrape time by a collect callback, so the run loop pays
nothing for ``/metrics`` being up.

It also owns the master's span tracer (``telemetry/tracing.py``): one
``task_lifecycle`` span per lease, a recovered task's linked into its
original trace; a ``reform`` trace per re-formation whose context the
relaunched workers' ``world_join`` spans adopt; and the re-home, slice
loss, resize, autoscale and live-push spans.

The families of the JAX package that wait for slice 10b-2 are not
registered here: the memory ledger's ``elasticdl_memory_bytes``, the SLO
watchdog's ``elasticdl_slo_*``, the TensorBoard mirror, and the heartbeat
fan-in and sweep counters (the port's servicer applies each beat
inline).  In watermark-lease mode the stream's
gauges (``elasticdl_stream_lag_records``, ``elasticdl_stream_watermark``)
are refreshed at scrape time, :meth:`MasterTelemetry.stream_tick`
writes the watermark pair and the lag, and
:meth:`MasterTelemetry.live_push` the freshness ledger's rows.
"""

from __future__ import annotations

import os
import time

from elasticdl_tpu_torch.telemetry.events import (
    EVENT_AUTOSCALE_DECISION,
    EVENT_JOB_END,
    EVENT_JOB_START,
    EVENT_JOURNAL_REPLAY,
    EVENT_LIVE_PUSH,
    EVENT_MASTER_RESTART,
    EVENT_MESH_RESIZE,
    EVENT_REFORM_COMPLETE,
    EVENT_REFORM_LATENCY,
    EVENT_REFORM_START,
    EVENT_REPLICA_HARVEST,
    EVENT_SLICE_LOSS,
    EVENT_STREAM_LAG,
    EVENT_STREAM_WATERMARK,
    EVENT_TASK_DISPATCH,
    EVENT_TASK_DONE,
    EVENT_TASK_RECOVERED,
    EVENT_WORKER_DEAD,
    EVENT_WORKER_REHOME,
    EVENTS_FILENAME,
    EventLog,
)
from elasticdl_tpu_torch.telemetry.registry import MetricsRegistry
from elasticdl_tpu_torch.telemetry.tracing import (
    SPAN_AUTOSCALE_DECISION,
    SPAN_LIVE_PUSH,
    SPAN_MESH_RESIZE,
    SPAN_REFORM,
    SPAN_SLICE_LOSS,
    SPAN_TASK_LIFECYCLE,
    SPAN_WORKER_REHOME,
    SPANS_FILENAME,
    SpanRecorder,
    gen_trace_id,
    sample_rate_from_env,
)

# family names referenced from more than one code path live here, so
# that each is registered at one call site
_TASKS_DISPATCHED = "elasticdl_tasks_dispatched_total"
_TASKS_COMPLETED = "elasticdl_tasks_completed_total"
_WORKER_TIME_MS = "elasticdl_worker_time_ms_total"
_WORKER_HB_AGE = "elasticdl_worker_heartbeat_age_secs"

# the per-worker label budget of /metrics: a fleet at or under it has one
# heartbeat-age series per worker; above it the series collapse into
# aggregate children (worker="max", worker="p50")
WORKER_SERIES_MAX_ENV = "ELASTICDL_TPU_WORKER_SERIES_MAX"
DEFAULT_WORKER_SERIES_MAX = 64


def worker_series_budget() -> int:
    raw = os.environ.get(WORKER_SERIES_MAX_ENV, "")
    try:
        return int(raw) if raw else DEFAULT_WORKER_SERIES_MAX
    except ValueError:
        return DEFAULT_WORKER_SERIES_MAX


class MasterTelemetry:
    def __init__(
        self, telemetry_dir: str = "", registry=None, trace_sample_rate: float | None = None
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        # async: the master emits from the dispatcher's observer calls,
        # under its lock, so a disk write there would queue every
        # worker's RPC behind it
        self.events = EventLog(
            os.path.join(telemetry_dir, EVENTS_FILENAME) if telemetry_dir else "",
            async_writes=True,
        )
        # the span tracer buffers in memory (the observer calls run under
        # the dispatcher's lock); with no directory it writes nothing but
        # stays usable, so the re-formation path never branches
        self.tracer = SpanRecorder(
            os.path.join(telemetry_dir, SPANS_FILENAME) if telemetry_dir else "",
            role="master",
            sample_rate=(
                trace_sample_rate if trace_sample_rate is not None
                else sample_rate_from_env()
            ),
        )
        # task_id -> its open dispatch (root) span; id(task) -> the newest
        # root span's context, so a recovered task's next span links into
        # its original trace (the re-queued Task object survives the
        # re-lease, so its identity is stable while the task lives)
        self._task_spans: dict[int, object] = {}
        self._task_trace_links: dict[int, dict] = {}
        self._reform_span = None
        r = self.registry

        def per_type(name, help_text):
            # the training child exists from the first scrape
            return r.counter(name, help_text, labels={"type": "training"})

        per_type(_TASKS_DISPATCHED, "Task leases handed to workers")
        per_type(_TASKS_COMPLETED, "Tasks reported successfully")
        self._tasks_recovered = r.counter(
            "elasticdl_tasks_recovered_total",
            "Tasks re-queued after failure, lease timeout or worker death",
        )
        self._records = r.counter(
            "elasticdl_records_processed_total",
            "Records covered by successfully completed tasks",
        )
        self._model_version = r.gauge(
            "elasticdl_model_version", "Highest model version reported"
        )
        self._generation = r.gauge(
            "elasticdl_cluster_generation",
            "World generation (bumped by every re-formation)",
        )
        self._workers_live = r.gauge(
            "elasticdl_workers_live", "Workers with a live heartbeat"
        )
        self._workers_dead = r.counter(
            "elasticdl_workers_dead_total",
            "Workers declared dead (heartbeat miss or process exit)",
        )
        self._reforms = r.counter("elasticdl_reforms_total", "World re-formations")
        self._reform_downtime = r.histogram(
            "elasticdl_reform_downtime_seconds",
            "Failure detection to first step-task pull of the new world",
        )
        self._tasks_pending = r.gauge(
            "elasticdl_tasks_pending", "Tasks queued, not leased"
        )
        self._tasks_active = r.gauge(
            "elasticdl_tasks_active", "Tasks currently leased"
        )
        self._epoch = r.gauge("elasticdl_epoch", "Current training epoch")
        # compiles of this process and the worker-reported deltas
        # (telemetry/compile_tracker.py): flat after warm-up
        self._compiles = r.counter(
            "elasticdl_compile_total",
            "Graph captures and new dispatch shapes (master process + "
            "worker-reported)",
        )
        self._rpc_retries = r.counter(
            "elasticdl_rpc_retries_total",
            "Worker RPC backoff re-sends (heartbeat-shipped totals)",
        )
        self._rpc_deadline_exceeded = r.counter(
            "elasticdl_rpc_deadline_exceeded_total",
            "Worker RPC attempts that expired their deadline",
        )
        self._rpc_unavailable = r.counter(
            "elasticdl_rpc_unavailable_total",
            "Worker RPC attempts that failed UNAVAILABLE",
        )
        self._rpc_reports_deduped = r.counter(
            "elasticdl_rpc_reports_deduped_total",
            "Task reports dropped by task-id dedup (duplicate delivery "
            "or stale lease)",
        )
        self._rpc_eval_deduped = r.counter(
            "elasticdl_rpc_eval_reports_deduped_total",
            "Eval-metric reports dropped as duplicate deliveries of a "
            "still-active lease",
        )
        # per-method handler latency, a child per method seen
        self._rpc_latency_children: dict = {}
        from elasticdl_tpu_torch.telemetry import compile_tracker

        self._compile_tracker = compile_tracker
        self._task_d = None
        self._servicer = None
        # the (source, trained) watermark pair last written: an idle
        # stream writes nothing
        self._last_stream_emit: tuple | None = None
        r.add_collect_callback(self._collect)

    # ---- wiring ------------------------------------------------------------

    def attach(self, task_dispatcher, servicer):
        self._task_d = task_dispatcher
        self._servicer = servicer
        task_dispatcher.add_observer(self)
        servicer.add_version_observer(self.on_version_report)
        servicer.set_trace_provider(self.trace_for_task)
        # the transport's server seam: the latest attached master wins
        from elasticdl_tpu_torch.rpc import service as rpc_service

        rpc_service.set_server_rpc_observer(self.observe_rpc)

    def observe_rpc(self, method: str, seconds: float):
        """Server-seam hook: one handler run of ``method``."""
        hist = self._rpc_latency_children.get(method)
        if hist is None:
            hist = self.registry.histogram(
                "elasticdl_rpc_latency_seconds",
                "Server-side RPC handler latency by method",
                labels={"method": method},
            )
            self._rpc_latency_children[method] = hist
        hist.observe(seconds)

    def trace_for_task(self, task_id: int) -> dict:
        """The dispatch span's trace context of an active lease: what the
        servicer stamps on its TaskResponse."""
        span = self._task_spans.get(task_id)
        return span.context if span is not None else {}

    def _collect(self, _registry):
        """Scrape-time refresh of the point-in-time values."""
        compiles = self._compile_tracker.compile_count()
        if self._task_d is not None:
            snap = self._task_d.snapshot()
            self._tasks_pending.set(snap["pending"] + snap["pending_eval"])
            self._tasks_active.set(len(snap["active"]))
            self._epoch.set(snap["epoch"])
            from elasticdl_tpu_torch.telemetry.compile_tracker import COMPILE_COUNT_KEY
            from elasticdl_tpu_torch.utils.constants import TaskType

            # workers ship compile deltas with every report kind: sum the
            # exec counters of all task types (the training snapshot
            # also gives the time buckets)
            exec_metrics = {}
            for task_type in TaskType:
                snapshot = self._task_d.exec_metrics_snapshot(task_type)
                compiles += snapshot.get(COMPILE_COUNT_KEY, 0)
                if task_type == TaskType.TRAINING:
                    exec_metrics = snapshot
            for key, value in exec_metrics.items():
                if key.startswith("time_") and key.endswith("_ms"):
                    self.registry.counter(
                        _WORKER_TIME_MS,
                        "Worker wall-clock buckets (utils.timing_utils)",
                        labels={"bucket": key[len("time_") : -len("_ms")]},
                    ).set_total(value)
            # the streaming backlog: the one registration site of the
            # stream gauges, absent in epoch mode
            if self._task_d.streaming:
                status = self._task_d.stream_status()
                self.registry.gauge(
                    "elasticdl_stream_lag_records",
                    "Streaming backlog: source watermark minus "
                    "trained watermark, in records",
                ).set(status["lag"])
                for role in ("source", "trained"):
                    self.registry.gauge(
                        "elasticdl_stream_watermark",
                        "Stream watermarks by role (source=records "
                        "published, trained=gap-free trained prefix)",
                        labels={"role": role},
                    ).set(status[f"{role}_watermark"])
        # monotone: a re-formed generation's fresh per-process counters
        # never walk the exposed total back
        self._compiles.set_total(compiles)
        if self._servicer is None:
            return
        self._workers_live.set(len(self._servicer.live_workers()))
        self._generation.set(self._servicer.cluster_version)
        totals = self._servicer.rpc_stats_totals()
        self._rpc_retries.set_total(totals.get("retries", 0))
        self._rpc_deadline_exceeded.set_total(totals.get("deadline_exceeded", 0))
        self._rpc_unavailable.set_total(totals.get("unavailable", 0))
        self._rpc_eval_deduped.set_total(self._servicer.duplicate_eval_drops)
        # step-anatomy phase totals (heartbeat-shipped,
        # telemetry/anatomy.py): a monotone ms counter and a mirrored
        # bucket histogram per phase, registered here alone
        for phase, agg in self._servicer.phase_stats_totals().items():
            self.registry.counter(
                "elasticdl_step_phase_ms_total",
                "Per-dispatch phase wall time by phase "
                "(host_fetch/assemble/h2d_transfer/device_compute/"
                "step_bookkeeping/untracked)",
                labels={"phase": phase},
            ).set_total(agg.get("ms", 0.0))
            self.registry.histogram(
                "elasticdl_step_phase_seconds",
                "Per-dispatch phase duration distribution by phase",
                labels={"phase": phase},
            ).set_totals(
                agg.get("buckets", {}),
                agg.get("ms", 0.0) / 1000.0,
                agg.get("count", 0),
            )
        self._collect_worker_ages()
        # device-prefetch staging totals (heartbeat-shipped,
        # trainer/device_pipeline.py)
        prefetch_totals = self._servicer.prefetch_stats_totals()
        if prefetch_totals:
            self.registry.counter(
                "elasticdl_device_prefetch_groups_total",
                "Dispatch groups staged onto device by the prefetch thread",
            ).set_total(prefetch_totals.get("groups", 0))
            self.registry.counter(
                "elasticdl_device_prefetch_stall_ms_total",
                "Consumer-visible wait for a staged group (the residual "
                "h2d stall after overlap)",
            ).set_total(prefetch_totals.get("stall_ms", 0))
            self.registry.counter(
                "elasticdl_device_prefetch_stage_ms_total",
                "Background staging time overlapped with device compute",
            ).set_total(prefetch_totals.get("stage_ms", 0))
            self.registry.counter(
                "elasticdl_boundary_stall_ms_total",
                "Device-idle time between the last retire of one task and "
                "the first dispatch of the next",
            ).set_total(prefetch_totals.get("boundary_stall_ms", 0))

    def _collect_worker_ages(self):
        """Per-worker heartbeat-age series, bounded: at or under the
        series budget one labeled gauge per worker; above it the
        aggregate children worker="max" and worker="p50".  Stale
        children are pruned, so the exposition holds no dead series."""
        ages = self._servicer.heartbeat_ages()
        if len(ages) <= worker_series_budget():
            series = {str(wid): age for wid, age in ages.items()}
        else:
            ordered = sorted(ages.values())
            series = {"max": ordered[-1], "p50": ordered[len(ordered) // 2]}
        self.registry.prune_children(
            _WORKER_HB_AGE, [{"worker": key} for key in series]
        )
        for key, value in series.items():
            self.registry.gauge(
                "elasticdl_worker_heartbeat_age_secs",
                "Seconds since each worker's last heartbeat (per-worker "
                "under the series budget, aggregate max/p50 above it)",
                labels={"worker": key},
            ).set(value)

    def build_health_fn(self, job_type: str, instance_manager_fn=lambda: None):
        """The ``/healthz`` payload closure: generation, live workers,
        model version, quiesce, the step-progress age, the degraded-link
        flag and the host memory headroom."""
        servicer = self._servicer

        def health() -> dict:
            from elasticdl_tpu_torch.telemetry.memory import host_memory_health

            im = instance_manager_fn()
            live = (
                im.worker_ids()
                if im is not None
                else (servicer.live_workers() if servicer else [])
            )
            quiescing = bool(servicer and servicer.is_quiescing)
            # progress against liveness: a hung job keeps heartbeating
            # while last_step_age_secs grows
            step_age = servicer.last_step_age_secs() if servicer is not None else None
            return {
                "status": "quiescing" if quiescing else "ok",
                "job_type": job_type,
                "generation": servicer.cluster_version if servicer else 0,
                "model_version": servicer.get_model_version() if servicer else 0,
                "live_workers": sorted(live),
                "num_live_workers": len(live),
                "quiescing": quiescing,
                "last_step_age_secs": round(step_age, 3)
                if step_age is not None
                else None,
                "degraded_network": bool(
                    servicer is not None and servicer.network_degraded()
                ),
                "memory": host_memory_health(),
            }

        return health

    # ---- TaskDispatcher observer -------------------------------------------

    def on_task_leased(self, task_id, worker_id, task):
        type_name = task.type.name.lower()
        self.registry.counter(_TASKS_DISPATCHED, labels={"type": type_name}).inc()
        # one task is one trace: its first lease opens a root trace, a
        # re-lease (a failed report, a lease timeout, a dead worker) a
        # root span inside the original trace, parented to the previous
        # attempt's span, so `trace analyze` follows it across the fault
        link = self._task_trace_links.get(id(task))
        span = self.tracer.start_span(
            SPAN_TASK_LIFECYCLE,
            trace_ctx=link if link is not None else {"trace_id": gen_trace_id(), "span_id": ""},
            task_id=task_id,
            worker_id=worker_id,
            type=type_name,
            shard=task.shard_name,
            recovered=link is not None,
        )
        self._task_spans[task_id] = span
        self._task_trace_links[id(task)] = span.context
        self.events.emit(
            EVENT_TASK_DISPATCH,
            task_id=task_id,
            worker_id=worker_id,
            type=type_name,
            shard=task.shard_name,
            records=task.num_records,
            trace_id=span.trace_id,
        )

    def on_task_done(self, task_id, task, worker_id, success, exec_counters=None):
        type_name = task.type.name.lower()
        span = self._task_spans.pop(task_id, None)
        if span is not None:
            span.end(success=bool(success))
        if success:
            # the trace is complete: a freed Task's identity must never
            # alias a later task's trace
            self._task_trace_links.pop(id(task), None)
            self.registry.counter(_TASKS_COMPLETED, labels={"type": type_name}).inc()
            self._records.inc(task.num_records)
            self.events.emit(
                EVENT_TASK_DONE,
                task_id=task_id,
                worker_id=worker_id,
                type=type_name,
                records=task.num_records,
                **{
                    k: v
                    for k, v in (exec_counters or {}).items()
                    if k.startswith("time_")
                },
            )
        else:
            self._tasks_recovered.inc()
            self.events.emit(
                EVENT_TASK_RECOVERED,
                task_id=task_id,
                worker_id=worker_id,
                type=type_name,
                records=task.num_records,
                reason="report_failed",
            )

    def on_task_reported(self, task_id, task, success, counted):
        """Every report outcome: a ``counted=False`` report was dropped by
        the dispatcher's task-id dedup (a duplicate delivery or a stale
        lease)."""
        if not counted:
            self._rpc_reports_deduped.inc()

    def on_task_reclaimed(self, task_id, task):
        span = self._task_spans.pop(task_id, None)
        if span is not None:
            span.end(success=False, reclaimed=True)
        self._tasks_recovered.inc()
        self.events.emit(
            EVENT_TASK_RECOVERED,
            task_id=task_id,
            type=task.type.name.lower(),
            records=task.num_records,
            reason="lease_timeout",
        )

    # ---- servicer and master lifecycle -------------------------------------

    def on_version_report(self, worker_id, model_version):
        if model_version > self._model_version.value:
            self._model_version.set(model_version)

    def job_start(self, job_type: str, num_workers: int):
        self.events.emit(EVENT_JOB_START, job_type=job_type, num_workers=num_workers)

    def job_end(self, rc: int):
        self.events.emit(EVENT_JOB_END, rc=rc)
        self.events.flush()
        self.tracer.flush()

    def worker_dead(self, worker_ids, generation: int):
        self._workers_dead.inc(len(worker_ids))
        for worker_id in worker_ids:
            self.events.emit(EVENT_WORKER_DEAD, worker_id=worker_id, generation=generation)

    def reform_start(self, generation, dead, reason, old_world_size):
        self._generation.set(generation)
        # every re-formation is one trace: its root opens here, the fence
        # and relaunch spans of Master._reform_lockstep are its children,
        # and the relaunched workers' world_join spans adopt it by env
        self._reform_span = self.tracer.start_span(
            SPAN_REFORM,
            trace_ctx={"trace_id": gen_trace_id(), "span_id": ""},
            generation=generation,
            reason=reason,
            dead_workers=sorted(dead),
        )
        self.events.emit(
            EVENT_REFORM_START,
            generation=generation,
            dead_workers=sorted(dead),
            reason=reason,
            old_world_size=old_world_size,
            trace_id=self._reform_span.trace_id,
        )

    def reform_trace_context(self) -> dict:
        """The open re-formation's trace context ({} outside one)."""
        span = self._reform_span
        return span.context if span is not None else {}

    def reform_complete(self, generation, old_world_size, new_world_size):
        self._reforms.inc()
        span, self._reform_span = self._reform_span, None
        if span is not None:
            span.end(new_world_size=new_world_size)
        self.events.emit(
            EVENT_REFORM_COMPLETE,
            generation=generation,
            old_world_size=old_world_size,
            new_world_size=new_world_size,
        )

    def reform_latency(self, generation, latency_secs: float):
        self._reform_downtime.observe(latency_secs)
        self.events.emit(
            EVENT_REFORM_LATENCY, generation=generation, latency_secs=latency_secs
        )
        # the re-formation's trace is complete: make its spans durable
        # even if the job later dies uncleanly
        self.tracer.flush()

    def reform_failed(self, generation):
        """The relaunch gave up (the re-formation budget is spent): the
        re-formation's trace closes with the failure."""
        span, self._reform_span = self._reform_span, None
        if span is not None:
            span.end(failed=True)
        self.tracer.flush()

    def master_restart(self, generation: int):
        """The master process starts restored from its journal; emitted
        at the restore's start, the end of the master-down phase."""
        self.events.emit(EVENT_MASTER_RESTART, generation=generation)

    def journal_replay(
        self, generation: int, duration_secs: float, pending: int, active: int,
        epoch: int, stage_lost: bool = False,
    ):
        """The journal's replay finished."""
        self.events.emit(
            EVENT_JOURNAL_REPLAY,
            generation=generation,
            duration_secs=duration_secs,
            pending=pending,
            active=active,
            epoch=epoch,
            stage_lost=stage_lost,
        )

    def worker_rehome(
        self, worker_id: int, generation: int, kept: int, requeued: int, started_at: float,
    ):
        """One worker re-homed onto the restarted master, with its lease
        reconciliation; its span covers the handshake."""
        self.events.emit(
            EVENT_WORKER_REHOME,
            worker_id=worker_id,
            generation=generation,
            kept=kept,
            requeued=requeued,
        )
        self.tracer.record_span(
            SPAN_WORKER_REHOME, started_at, time.monotonic(), generation=generation,
            worker_id=worker_id, kept=kept, requeued=requeued,
        )

    def slice_loss(
        self, generation: int, lost_slices: list, dead_workers: list,
        old_slices: int, new_slices: int, parked: bool, started_at: float,
        trace_ctx: dict | None = None,
    ):
        """A whole slice's processes died: the span covers the failure's
        detection to the re-plan, inside the re-formation's trace."""
        self.events.emit(
            EVENT_SLICE_LOSS,
            generation=generation,
            lost_slices=list(lost_slices),
            dead_workers=list(dead_workers),
            old_slices=old_slices,
            new_slices=new_slices,
            parked=bool(parked),
        )
        self.tracer.record_span(
            SPAN_SLICE_LOSS, started_at, time.monotonic(), trace_ctx=trace_ctx,
            generation=generation, lost_slices=list(lost_slices), new_slices=new_slices,
            parked=bool(parked),
        )

    def mesh_resize(
        self, generation: int, old_world_size: int, new_world_size: int,
        old_slices: int, new_slices: int, dcn: dict | None, started_at: float,
        trace_ctx: dict | None = None,
    ):
        """The next world was resized (``dcn``: the JAX package's DCN
        plan; the port's world is one flat process group, so empty)."""
        self.events.emit(
            EVENT_MESH_RESIZE,
            generation=generation,
            old_world_size=old_world_size,
            new_world_size=new_world_size,
            old_slices=old_slices,
            new_slices=new_slices,
            dcn=dict(dcn or {}),
        )
        self.tracer.record_span(
            SPAN_MESH_RESIZE, started_at, time.monotonic(), trace_ctx=trace_ctx,
            generation=generation, old_world_size=old_world_size,
            new_world_size=new_world_size, old_slices=old_slices, new_slices=new_slices,
        )
        self.tracer.flush()

    def autoscale_decision(
        self, generation: int, started_at: float, action: str, from_slices: int,
        to_slices: int, reason: str, p95_step_ms=None, backlog=None,
    ):
        """The autoscaler crossed its SLO and asked for a resize."""
        self.events.emit(
            EVENT_AUTOSCALE_DECISION,
            generation=generation,
            action=action,
            from_slices=from_slices,
            to_slices=to_slices,
            reason=reason,
            p95_step_ms=p95_step_ms,
            backlog=backlog,
        )
        self.tracer.record_span(
            SPAN_AUTOSCALE_DECISION, started_at, time.monotonic(), generation=generation,
            action=action, from_slices=from_slices, to_slices=to_slices,
        )

    def replica_harvest(self, generation, complete: bool, version, sources: int):
        """A re-formation's replica harvest: ``complete=False`` sends the
        new generation to the disk fallback."""
        self.events.emit(
            EVENT_REPLICA_HARVEST,
            generation=generation,
            complete=bool(complete),
            version=version,
            sources=sources,
        )

    def stream_tick(self, status: dict):
        """A run-loop tick in watermark-lease mode: the watermark pair
        and the lag derived from it, written only when the (source,
        trained) pair moved, so an idle stream adds nothing to the log."""
        key = (status["source_watermark"], status["trained_watermark"])
        if key == self._last_stream_emit:
            return
        self._last_stream_emit = key
        self.events.emit(
            EVENT_STREAM_WATERMARK,
            source_watermark=status["source_watermark"],
            trained_watermark=status["trained_watermark"],
            next_offset=status["next_offset"],
            closed=bool(status["closed"]),
        )
        self.events.emit(
            EVENT_STREAM_LAG,
            lag_records=status["lag"],
            source_watermark=status["source_watermark"],
            trained_watermark=status["trained_watermark"],
        )

    def live_push(
        self,
        *,
        model_version: int,
        trained_watermark: int,
        source_watermark: int,
        accepted: bool,
        replica: str,
        swap_ms: float,
        started_at: float,
        reason: str = "",
    ):
        """One live train-to-serve push: a row of the freshness ledger.
        ``staleness``: the records the served model is behind the source
        when it goes live; the span runs from ``started_at`` (the
        harvest's start) to the swap's answer."""
        self.registry.counter(
            "elasticdl_stream_live_push_total",
            "Live train->serve pushes (replica-ring commit fanned into "
            "serving swap_state_dicts); accepted= marks the stale-"
            "refused ones",
            labels={"accepted": "true" if accepted else "false"},
        ).inc()
        self.events.emit(
            EVENT_LIVE_PUSH,
            model_version=model_version,
            trained_watermark=trained_watermark,
            source_watermark=source_watermark,
            staleness=max(0, source_watermark - trained_watermark),
            accepted=bool(accepted),
            replica=replica,
            swap_ms=swap_ms,
            reason=reason,
        )
        self.tracer.record_span(
            SPAN_LIVE_PUSH, started_at, time.monotonic(), model_version=model_version,
            trained_watermark=trained_watermark, accepted=bool(accepted), replica=replica,
        )
