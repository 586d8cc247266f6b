"""Per-dispatch step anatomy: every dispatch group's wall time split into
named, non-overlapping phases; the counterpart of
``elasticdl_tpu/telemetry/anatomy.py``.

The phases, measured on the dispatching thread:

- ``host_fetch``: waiting on the reader and decode pipeline (the time
  the consumer blocked in ``next()``);
- ``assemble``: pad and stack to the canonical shape (host numpy);
- ``h2d_transfer``: the copies of the batch to the device, waited for.
  With ``--device_prefetch`` (``trainer/device_pipeline.py``) assembly
  and placement run on a staging thread and a CUDA stream of their own
  while the previous group computes, so the consumer-visible
  ``h2d_transfer`` is the wait for a staged group and its copy, the
  stall left after the overlap;
- ``device_compute``: the dispatch to its end on the device, as two
  segments recorded beside the phase: ``enqueue`` (the launches or the
  graph replay returning) and ``ready_wait`` (the wait on the stream the
  dispatch ran on, :func:`timed_device_dispatch`);
- ``step_bookkeeping``: the per-step hooks, reports and the milestone
  hooks (checkpoint, evaluation) after the group.

Sum-exact: the phases are disjoint intervals inside the dispatch window,
and the residual (the loop's glue between them) is a phase of its own,
``untracked``, so::

    host_fetch + assemble + h2d_transfer + device_compute
      + step_bookkeeping + untracked  ==  the dispatch's wall time

Two consumers: the workers ship monotone per-phase totals and bucket
counts on the heartbeat (:meth:`AnatomyRecorder.heartbeat_snapshot`),
which the master mirrors onto ``elasticdl_step_phase_ms_total{phase=}``
and the ``elasticdl_step_phase_seconds`` histogram
(``telemetry/master_hooks.py``); and every dispatch emits a
``step_anatomy`` event into the telemetry event log, from which
``telemetry/report.py::goodput_section`` computes ``e2e_vs_roofline``,
the phase percentiles, MFU and stragglers.  (The JAX package also
records sampled ``step_anatomy`` spans; the port's tracing comes with
slice 10b.)

Enablement: ``--step_anatomy``, forwarded to workers as
``ELASTICDL_TPU_STEP_ANATOMY`` (never argv).  With no recorder installed
the runtimes take one branch per dispatch path and read no clock.  With
one, every dispatch waits for its device work, so the feature changes
what it measures: no rate may be timed in a window that has it on.  The
retire-behind window of ``--device_prefetch`` collapses to 1 under it
(``device_pipeline.stage_depth``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from elasticdl_tpu_torch.telemetry.registry import STEP_LATENCY_BUCKETS

STEP_ANATOMY_ENV = "ELASTICDL_TPU_STEP_ANATOMY"
PEAK_FLOPS_ENV = "ELASTICDL_TPU_PEAK_FLOPS_PER_CHIP"

# ---- phase vocabulary (one definition site) ----------------------------------

PHASE_HOST_FETCH = "host_fetch"
PHASE_ASSEMBLE = "assemble"
PHASE_H2D_TRANSFER = "h2d_transfer"
PHASE_DEVICE_COMPUTE = "device_compute"
PHASE_STEP_BOOKKEEPING = "step_bookkeeping"
PHASE_UNTRACKED = "untracked"
# a served request's phases: queue_wait (submit to its first dispatch
# group) then the batch phases and d2h_transfer, with the same residual
PHASE_QUEUE_WAIT = "queue_wait"
PHASE_D2H_TRANSFER = "d2h_transfer"
# the device-idle time between the last retire of one task and the first
# dispatch of the next (trainer/device_pipeline.py): a counter, not a
# member of the per-dispatch phases, since it spans dispatch windows
PHASE_BOUNDARY_STALL = "boundary_stall"

# the timed phases, in pipeline order
TRACKED_PHASES = (
    PHASE_HOST_FETCH,
    PHASE_ASSEMBLE,
    PHASE_H2D_TRANSFER,
    PHASE_DEVICE_COMPUTE,
    PHASE_STEP_BOOKKEEPING,
)
ALL_PHASES = TRACKED_PHASES + (PHASE_UNTRACKED,)

# a serving request's phases, in pipeline order (serving/engine.py)
SERVING_REQUEST_PHASES = (
    PHASE_QUEUE_WAIT,
    PHASE_ASSEMBLE,
    PHASE_H2D_TRANSFER,
    PHASE_DEVICE_COMPUTE,
    PHASE_D2H_TRANSFER,
)

# device_compute's segments (event fields beside the phases: they sum to
# device_compute, they do not add to it)
SUB_ENQUEUE = "enqueue"
SUB_READY_WAIT = "ready_wait"


def _cuda_stream(device):
    """The current CUDA stream of ``device``, or None off the card."""
    if device is None or getattr(device, "type", None) != "cuda":
        return None
    import torch

    return torch.cuda.current_stream(device)


def wait_for_device(device):
    """Wait for the work queued on ``device``'s current stream (nothing
    off the card): what makes a phase hold its device work, not just its
    launches."""
    stream = _cuda_stream(device)
    if stream is not None:
        stream.synchronize()


def timed_device_dispatch(recorder, dispatch, device=None):
    """The instrumented device dispatch: ``dispatch()``'s call is the
    ``enqueue`` segment of ``device_compute``, and the wait on the stream
    it ran on (``device``'s current stream, taken before the call: eager
    launches and a CUDA graph's replay both go there) is ``ready_wait``.
    One definition site for the split, so that enqueue + ready_wait ==
    device_compute at every call site.  Returns the dispatch's outputs."""
    stream = _cuda_stream(device)
    with recorder.phase(PHASE_DEVICE_COMPUTE, sub=SUB_ENQUEUE):
        out = dispatch()
    with recorder.phase(PHASE_DEVICE_COMPUTE, sub=SUB_READY_WAIT):
        if stream is not None:
            stream.synchronize()
    return out


# ---- model FLOPs (goodput MFU) ------------------------------------------------
#
# Training FLOPs per record (forward + backward, about 3x the forward)
# of the zoo models whose cost is a closed form of their fixed
# architecture, keyed by the model module (the first dotted part of
# --model_def).  A model whose cost depends on its parameters (the
# transformer's sequence length) has none, and the report says why MFU
# is absent instead of inventing it.
MODEL_FLOPS_PER_RECORD = {
    # Conv(32,3x3)@26x26 + Conv(64,3x3)@24x24 + Dense(9216->10), x3 for
    # fwd+bwd: ~2.2e7 fwd MACs -> ~6.6e7 train FLOPs
    "mnist_functional_api": 6.6e7,
    "mnist_subclass": 6.6e7,
    # ResNet-50 @224: ~4.1 GFLOPs forward -> ~1.23e10 train FLOPs
    "imagenet_resnet50": 1.23e10,
}

# dense bf16 peak FLOP/s of one device by torch.cuda.get_device_name();
# used only when ELASTICDL_TPU_PEAK_FLOPS_PER_CHIP is not pinned.  H100
# SXM: 989.4 TFLOP/s dense bf16 (NVIDIA's H100 datasheet)
_PEAK_FLOPS_BY_DEVICE_NAME = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def model_flops_per_record(model_def: str) -> float | None:
    """The known training FLOPs per record of ``--model_def``, or None."""
    module = (model_def or "").split(".", 1)[0]
    return MODEL_FLOPS_PER_RECORD.get(module)


def peak_flops_per_chip(device=None) -> float | None:
    """Peak FLOP/s of one device: the env pin wins, then the device-name
    table for a CUDA ``device``; None otherwise (the CPU has no honest
    peak)."""
    raw = os.environ.get(PEAK_FLOPS_ENV, "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    if device is None or getattr(device, "type", None) != "cuda":
        return None
    import torch

    return _PEAK_FLOPS_BY_DEVICE_NAME.get(torch.cuda.get_device_name(device))


def _world_devices() -> int:
    """Devices of the job: the ``torch.distributed`` world's size (one
    device per process), or 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return max(1, dist.get_world_size())
    return 1


def _bucket_index(secs: float) -> int:
    for i, bound in enumerate(STEP_LATENCY_BUCKETS):
        if secs <= bound:
            return i
    return len(STEP_LATENCY_BUCKETS)  # the +Inf slot


class AnatomyRecorder:
    """Per-process phase timer, one dispatch group at a time: phase
    intervals accumulate on the dispatching thread, and :meth:`commit`
    closes the window, derives ``untracked`` as the exact residual, and
    fans out to the event log and the heartbeat totals.  The heartbeat
    thread reads the totals, so they sit behind a lock; the open
    window is the dispatching thread's alone.

    Identity (worker, process, generation) is not kept here: the
    installed ``worker_hooks.StepRecorder`` stamps the events."""

    def __init__(self, flops_per_record: float | None = None, device=None):
        self._flops_per_record = flops_per_record
        self._peak_flops = peak_flops_per_chip(device)
        self._n_chips = _world_devices()
        # the open window: [(phase, start, end)] and the segment sums
        self._intervals: list[tuple[str, float, float]] = []
        self._subs: dict[str, float] = {}
        # heartbeat-shipped totals: phase -> [secs, count, per-bucket
        # counts over STEP_LATENCY_BUCKETS + Inf]
        self._lock = threading.Lock()
        self._totals: dict[str, list] = {}  # guarded-by: _lock
        self.dispatches = 0

    # ---- per-dispatch measurement (the dispatching thread) -----------------

    def wrap_fetches(self, iterable):
        """Wrap a batch stream so that every ``next()``, the wait on the
        host pipeline, lands in ``host_fetch`` of the open window."""
        it = iter(iterable)
        while True:
            t0 = time.monotonic()
            try:
                item = next(it)
            except StopIteration:
                return
            self._intervals.append((PHASE_HOST_FETCH, t0, time.monotonic()))
            yield item

    @contextlib.contextmanager
    def phase(self, name: str, sub: str | None = None):
        """Attribute the block's wall time to ``name``; ``sub`` also
        records it under a device_compute segment."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            self._intervals.append((name, t0, t1))
            if sub is not None:
                self._subs[sub] = self._subs.get(sub, 0.0) + (t1 - t0)

    def wrapped_hook(self, hook):
        """A ``pre_batch``-style hook timed as ``step_bookkeeping``, so
        that it cannot leak into ``untracked``; None for None."""
        if hook is None:
            return None

        def timed(*args, **kwargs):
            with self.phase(PHASE_STEP_BOOKKEEPING):
                return hook(*args, **kwargs)

        return timed

    def commit(self, steps: int = 1, records: int = 0, step=None):
        """Close the open window: the wall is its first interval's start
        to now, ``untracked`` the wall less the timed phases; the result
        goes to the event log and the totals.  A window with no interval
        is a no-op."""
        intervals, self._intervals = self._intervals, []
        subs, self._subs = self._subs, {}
        if not intervals:
            return None
        now = time.monotonic()
        window_start = min(t0 for _n, t0, _t1 in intervals)
        wall = now - window_start
        phases = {}
        for name, t0, t1 in intervals:
            phases[name] = phases.get(name, 0.0) + (t1 - t0)
        tracked = sum(phases.values())
        phases[PHASE_UNTRACKED] = max(0.0, wall - tracked)
        self.dispatches += 1
        with self._lock:
            for name, secs in phases.items():
                slot = self._totals.get(name)
                if slot is None:
                    slot = self._totals[name] = [
                        0.0,
                        0,
                        [0] * (len(STEP_LATENCY_BUCKETS) + 1),
                    ]
                slot[0] += secs
                slot[1] += 1
                slot[2][_bucket_index(secs)] += 1
        self._emit_event(phases, subs, wall, steps, records, step)
        return phases

    def _emit_event(self, phases, subs, wall, steps, records, step):
        from elasticdl_tpu_torch.telemetry import worker_hooks
        from elasticdl_tpu_torch.telemetry.events import EVENT_STEP_ANATOMY

        fields = {
            "steps": int(steps),
            "records": int(records),
            "wall_ms": wall * 1000.0,
        }
        if step is not None:
            fields["step"] = int(step)
        for name, secs in phases.items():
            fields[f"{name}_ms"] = secs * 1000.0
        for name, secs in subs.items():
            fields[f"{name}_ms"] = secs * 1000.0
        if self._flops_per_record is not None:
            fields["flops_per_record"] = self._flops_per_record
        if self._peak_flops is not None:
            fields["peak_flops_per_chip"] = self._peak_flops
        fields["n_chips"] = self._n_chips
        worker_hooks.emit_event(EVENT_STEP_ANATOMY, **fields)

    # ---- heartbeat shipping (any thread) ------------------------------------

    def heartbeat_snapshot(self) -> dict:
        """Monotone per-phase totals for ``HeartbeatRequest.phases``:
        ``{phase: {"ms": float, "count": int, "buckets": {str(secs):
        int}}}`` (string bucket keys, ``"inf"`` the overflow slot, as the
        JAX package ships them)."""
        with self._lock:
            out = {}
            for name, (secs, count, buckets) in self._totals.items():
                bucket_map = {
                    str(bound): n
                    for bound, n in zip(STEP_LATENCY_BUCKETS, buckets)
                    if n
                }
                if buckets[-1]:
                    bucket_map["inf"] = buckets[-1]
                out[name] = {
                    "ms": secs * 1000.0,
                    "count": count,
                    "buckets": bucket_map,
                }
            return out


# ---- the process-wide recorder: free when off ---------------------------------

_active: AnatomyRecorder | None = None


def install(model_def: str = "", device=None) -> AnatomyRecorder:
    global _active
    _active = AnatomyRecorder(
        flops_per_record=model_flops_per_record(model_def), device=device
    )
    return _active


def install_if_enabled(flag, model_def: str = "", device=None) -> AnatomyRecorder | None:
    """Install when ``--step_anatomy`` or the forwarded
    ``ELASTICDL_TPU_STEP_ANATOMY`` asks for it; otherwise clear any
    recorder left by an earlier run in this process."""
    if not flag and not os.environ.get(STEP_ANATOMY_ENV, ""):
        uninstall()
        return None
    return install(model_def=model_def, device=device)


def install_from_env(model_def: str = "", device=None) -> AnatomyRecorder | None:
    """A worker process's entry: install only when the master exported
    the enabling variable."""
    return install_if_enabled(None, model_def=model_def, device=device)


def uninstall():
    global _active
    _active = None


def get_recorder() -> AnatomyRecorder | None:
    """The runtimes' seam: None (one global load, no clock read) unless
    anatomy was installed; they branch once on it per dispatch path."""
    return _active


def heartbeat_snapshot() -> dict:
    """The phase totals for the heartbeat; ``{}`` when off."""
    recorder = _active
    if recorder is None:
        return {}
    return recorder.heartbeat_snapshot()
