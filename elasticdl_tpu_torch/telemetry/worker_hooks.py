"""Worker-side telemetry: per-step samples and lifecycle events into the
shared event log; the counterpart of
``elasticdl_tpu/telemetry/worker_hooks.py``.

Installed once per process when the master exports
``ELASTICDL_TPU_TELEMETRY_DIR`` into the worker's environment, or
directly by an in-process runtime (the Local executor).

Overhead: when telemetry is not installed the per-step path is one early
return (a module global load and a ``None`` check, no clock read);
``tests/test_torch_anatomy.py`` holds this with a poisoned clock.

:func:`record_step` is called at each step's start (from the runtimes'
pre-batch hook).  Each call emits a ``step`` event stamped with the
step, generation and worker and the duration of the previous interval;
the first call after install has no interval.  A re-formed world is a
new process with a fresh recorder, so the report derives a
re-formation's downtime from the gap between the last ``step`` of
generation N and the first of N+1.
"""

from __future__ import annotations

import os
import time

from elasticdl_tpu_torch.telemetry.events import EVENT_STEP, EventLog

TELEMETRY_DIR_ENV = "ELASTICDL_TPU_TELEMETRY_DIR"

_active: "StepRecorder | None" = None


class StepRecorder:
    def __init__(
        self,
        events: EventLog,
        worker_id: int = 0,
        process_id: int = 0,
        generation: int = 0,
    ):
        self._events = events
        self._worker_id = worker_id
        self._process_id = process_id
        self._generation = generation
        self._last_at: float | None = None

    @property
    def events(self) -> EventLog:
        return self._events

    def record_step(self, step: int, records: int = 0):
        now = time.monotonic()
        last, self._last_at = self._last_at, now
        fields = dict(
            step=int(step),
            generation=self._generation,
            worker_id=self._worker_id,
            process_id=self._process_id,
            records=int(records),
        )
        if last is not None:
            fields["duration_secs"] = now - last
        self._events.emit(EVENT_STEP, **fields)

    def emit(self, event: str, **fields):
        self._events.emit(
            event,
            generation=self._generation,
            worker_id=self._worker_id,
            process_id=self._process_id,
            **fields,
        )


# ---- module-level install + zero-cost-when-disabled accessors ---------------


def install(
    telemetry_dir: str,
    worker_id: int = 0,
    process_id: int = 0,
    generation: int = 0,
) -> StepRecorder | None:
    """Install the process-wide recorder writing to
    ``<telemetry_dir>/events.jsonl``; returns it.  Without a dir any
    recorder of an earlier run in this process is cleared, and None is
    returned."""
    global _active
    if not telemetry_dir:
        _active = None
        return None
    from elasticdl_tpu_torch.telemetry.events import EVENTS_FILENAME

    _active = StepRecorder(
        EventLog(os.path.join(telemetry_dir, EVENTS_FILENAME)),
        worker_id=worker_id,
        process_id=process_id,
        generation=generation,
    )
    return _active


def install_from_env(
    worker_id: int = 0, process_id: int = 0, generation: int = 0
) -> StepRecorder | None:
    """Install from ``ELASTICDL_TPU_TELEMETRY_DIR`` (worker subprocess
    entry); no-op when the master did not configure telemetry."""
    return install(
        os.environ.get(TELEMETRY_DIR_ENV, ""),
        worker_id=worker_id,
        process_id=process_id,
        generation=generation,
    )


def uninstall():
    global _active
    _active = None


def get_recorder() -> StepRecorder | None:
    return _active


def record_step(step: int, records: int = 0):
    """THE hot-path hook: one global load + None check when disabled."""
    recorder = _active
    if recorder is None:
        return
    recorder.record_step(step, records)


def emit_event(event: str, **fields):
    """Process-scoped lifecycle emission (checkpoint save/restore, chaos
    fault mirror); no-op without an installed recorder."""
    recorder = _active
    if recorder is None:
        return
    recorder.emit(event, **fields)


def publish_timing(timing):
    """Route the :class:`~elasticdl_tpu_torch.utils.timing_utils.Timing`
    bucket totals into the event log (a ``worker_timing`` event with
    ``time_<bucket>_ms`` fields), so that the report sees them from a
    runtime that sends no task reports (the Local executor).  Workers
    also ship per-task deltas to the master as exec counters, which it
    mirrors onto ``elasticdl_worker_time_ms_total``."""
    recorder = _active
    if recorder is None:
        return
    from elasticdl_tpu_torch.telemetry.events import EVENT_WORKER_TIMING

    totals = timing.totals_ms()
    if totals:
        recorder.emit(EVENT_WORKER_TIMING, **totals)
