"""Profiler windows on ``torch.profiler``: flag-armed at launch, or on
demand at run time; the counterpart of ``elasticdl_tpu/utils/profiling.py``
(which captures with ``jax.profiler``).

A window traces the host's operators, and on a card its CUDA kernels,
for a few training steps, and writes one Chrome trace
(``<host>.<pid>.pt.trace.json``, readable at ui.perfetto.dev or by
TensorBoard's profile plugin) into the window's directory.  Two ways
to open one:

1. **Launch flags** — ``--profile_dir d --profile_steps N`` traces steps
   [start, start + N) into ``d`` (past the first steps' captures and
   warm-up).
2. **On demand** — the ``request_profile`` master RPC arms a window on a
   RUNNING job: the command rides down on heartbeat responses
   (``HeartbeatResponse.profile``), :func:`apply_profile_command` calls
   :meth:`StepProfiler.arm`, and the next training step opens an
   ``N``-step capture into the telemetry dir.  Workers dedupe by
   ``window_id`` (monotone per master), so the command may be
   re-delivered or re-sent every beat and is absorbed.

Both paths emit the same ``profile_window_open``/``profile_window_close``
events and the ``profile_window`` span, so the capture window can be
located on the same timeline as the distributed trace.

Disabled cost: with no window pending or open, :meth:`on_step` is one
attribute load and a ``not x`` check.  Thread model: :meth:`arm` is
called from the heartbeat thread, :meth:`on_step` from the training
thread — the engaged flag is the lock-free gate, everything behind it
synchronizes on a small lock.
"""

from __future__ import annotations

import os
import socket
import threading

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# subdirectory of the telemetry dir an on-demand capture lands in when
# the request names no explicit out_dir
PROFILE_SUBDIR = "profile"

# the open capture of this process, (profile, out_dir): one at a time,
# as jax.profiler allows one
_session: tuple | None = None


def start_trace(out_dir: str, device=None):
    """Open a ``torch.profiler`` capture that writes into ``out_dir`` at
    :func:`stop_trace`; CUDA kernels too when ``device`` is a card."""
    global _session
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _session is not None:
        raise RuntimeError("a profiler capture is already open in this process")
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _session = (prof, out_dir, len(activities) > 1)


def stop_trace() -> str:
    """Close the open capture (after the card finished what it was
    given) and write its Chrome trace; the trace's path."""
    global _session
    import torch

    if _session is None:
        raise RuntimeError("no profiler capture is open in this process")
    (prof, out_dir, cuda), _session = _session, None
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(out_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


class StepProfiler:
    """Capture step windows with ``torch.profiler`` (:func:`start_trace`).

    ``on_step()`` is called once per step by the training loop and counts
    calls SINCE PROCESS START (not the model version — a checkpoint-
    resumed run at version 10000 still warms up before its window).
    ``device``: the job's device; a card's kernels are traced too.  The
    flag-armed window starts at call ``start_step`` (past compile +
    warmup) and stops ``num_steps`` later; an :meth:`arm`-ed window
    starts at the NEXT call.  One window at a time; idle (nothing
    pending or tracing) it is one attribute load per step.
    """

    def __init__(
        self,
        out_dir: str | None,
        start_step: int = 5,
        num_steps: int = 5,
        device=None,
    ):
        self._device = device
        self._lock = threading.Lock()
        self._seen = 0  # guarded-by: _lock
        self._tracing = False  # guarded-by: _lock (writes)
        self._out_dir = ""  # dir of the OPEN window  # guarded-by: _lock
        self._stop_at = 0  # last in-window call index  # guarded-by: _lock
        self._opened_at = 0  # guarded-by: _lock
        self._window_id: int | None = None  # guarded-by: _lock
        self._window_span = None  # guarded-by: _lock
        # flag-armed window (never opened yet when _flag_dir non-empty)
        self._flag_dir = out_dir or ""  # guarded-by: _lock
        self._flag_start = start_step
        self._flag_num = num_steps
        self._flag_ever_armed = bool(out_dir)
        # on-demand window waiting to open  # guarded-by: _lock
        self._pending: dict | None = None
        # replay dedup: the largest window id ever armed
        self._last_window_id = 0  # guarded-by: _lock
        # lock-free hot gate: True iff a window is pending or open.
        # Writes happen under _lock; the training thread's stale read
        # costs at most one extra locked call
        self._engaged = bool(out_dir)

    # ---- runtime arming (heartbeat thread) ---------------------------------

    def arm(
        self,
        out_dir: str,
        num_steps: int = 5,
        window_id: int | None = None,
    ) -> bool:
        """Arm an on-demand window opening at the next ``on_step``.
        Returns False when absorbed (a replayed ``window_id``) or
        refused (a window is already pending/open — the caller retries
        on a later beat; an unconsumed id stays armable)."""
        if not out_dir:
            return False
        with self._lock:
            if window_id is not None and window_id <= self._last_window_id:
                return False  # replayed command: absorbed
            if self._tracing or self._pending is not None:
                return False  # one window at a time; retry later
            if window_id is not None:
                self._last_window_id = window_id
            self._pending = {
                "out_dir": out_dir,
                "num_steps": max(1, int(num_steps)),
                "window_id": window_id,
            }
            self._engaged = True
        logger.info(
            "Profiler: on-demand window armed (%d steps into %s)",
            max(1, int(num_steps)),
            out_dir,
        )
        return True

    # ---- the per-step hook (training thread) -------------------------------

    def on_step(self, _step=None):
        """Count one training step (the argument is accepted and ignored
        for call-site readability); one attribute load when idle."""
        if not self._engaged:
            return
        self._on_step_engaged()

    def _on_step_engaged(self):
        with self._lock:
            self._seen += 1
            if not self._tracing:
                if self._pending is not None:
                    pending, self._pending = self._pending, None
                    self._open_window_locked(
                        pending["out_dir"],
                        self._seen + pending["num_steps"] - 1,
                        pending["window_id"],
                    )
                elif self._flag_dir and self._seen > self._flag_start:
                    flag_dir, self._flag_dir = self._flag_dir, ""
                    self._open_window_locked(
                        flag_dir,
                        self._flag_start + self._flag_num,
                        None,
                    )
            elif self._seen > self._stop_at:
                self._close_window_locked()
            self._refresh_engaged_locked()

    # lock-holding: _lock
    def _refresh_engaged_locked(self):
        self._engaged = bool(
            self._tracing or self._pending is not None or self._flag_dir
        )

    # lock-holding: _lock
    def _open_window_locked(self, out_dir: str, stop_at: int, window_id):
        try:
            start_trace(out_dir, self._device)
        except Exception:  # noqa: BLE001 — a failed capture (another
            # trace active, unwritable dir) must not kill the training
            # thread; the window is abandoned
            logger.exception("Profiler: start_trace failed")
            return
        self._tracing = True
        self._out_dir = out_dir
        self._stop_at = stop_at
        self._opened_at = self._seen
        self._window_id = window_id
        # telemetry marker + span so the profiler window can be
        # located on the SAME timeline as the distributed trace (both
        # no-ops when telemetry/tracing is not installed)
        from elasticdl_tpu_torch.telemetry import tracing as _trace
        from elasticdl_tpu_torch.telemetry import worker_hooks
        from elasticdl_tpu_torch.telemetry.events import EVENT_PROFILE_WINDOW_OPEN

        fields = dict(at_call=self._seen, out_dir=out_dir)
        if window_id is not None:
            fields["window_id"] = int(window_id)
        worker_hooks.emit_event(EVENT_PROFILE_WINDOW_OPEN, **fields)
        tracer = _trace.get_tracer()
        if tracer is not None:
            self._window_span = tracer.start_span(
                _trace.SPAN_PROFILE_WINDOW, out_dir=out_dir
            )
        logger.info(
            "Profiler: tracing %d steps into %s",
            self._stop_at - self._seen + 1,
            out_dir,
        )

    # lock-holding: _lock
    def _close_window_locked(self):
        try:
            stop_trace()
        except Exception:  # noqa: BLE001 — a torn capture must not kill
            # the training thread
            logger.exception("Profiler: stop_trace failed")
        self._tracing = False
        from elasticdl_tpu_torch.telemetry import worker_hooks
        from elasticdl_tpu_torch.telemetry.events import EVENT_PROFILE_WINDOW_CLOSE

        fields = dict(
            at_call=self._seen,
            out_dir=self._out_dir,
            steps=self._seen - self._opened_at,
        )
        if self._window_id is not None:
            fields["window_id"] = int(self._window_id)
        worker_hooks.emit_event(EVENT_PROFILE_WINDOW_CLOSE, **fields)
        if self._window_span is not None:
            self._window_span.end(steps=self._seen - self._opened_at)
            self._window_span = None
        logger.info("Profiler: trace written to %s", self._out_dir)
        self._window_id = None
        self._out_dir = ""

    def stop(self):
        """Idempotent; called at loop exit so a short run still flushes
        a partial window (and warns when a flag window never opened)."""
        with self._lock:
            if self._tracing:
                self._close_window_locked()
            elif self._flag_dir and self._flag_ever_armed:
                logger.warning(
                    "Profiler: window never opened — the run had %d "
                    "steps but tracing starts after step %d "
                    "(--profile_steps only sets the window length)",
                    self._seen,
                    self._flag_start,
                )
            self._flag_dir = ""
            self._flag_ever_armed = False
            self._pending = None
            self._refresh_engaged_locked()


def apply_profile_command(
    profiler: StepProfiler,
    command: dict,
    telemetry_dir: str = "",
    tag: str = "",
) -> bool:
    """Arm ``profiler`` from a heartbeat-borne ``request_profile``
    command (the worker side of the round trip).  The capture lands in
    the command's ``out_dir`` or ``<telemetry_dir>/profile``, under a
    per-window (and per-process, via ``tag``) subdirectory so
    concurrent workers on one host never interleave trace files.
    Absorbed replays (seen window ids) return False — THE dedup that
    lets the master redistribute the command on every beat."""
    if not command or not isinstance(command, dict):
        return False
    try:
        window_id = int(command.get("window_id", 0))
    except (TypeError, ValueError):
        return False
    if window_id <= 0:
        return False
    base = str(command.get("out_dir") or "") or (
        os.path.join(telemetry_dir, PROFILE_SUBDIR) if telemetry_dir else ""
    )
    if not base:
        return False
    leaf = f"window_{window_id}" + (f"_{tag}" if tag else "")
    try:
        num_steps = int(command.get("num_steps", 5))
    except (TypeError, ValueError):
        num_steps = 5
    return profiler.arm(
        os.path.join(base, leaf), num_steps=num_steps, window_id=window_id
    )
