"""Worker-side fault injector; a copy of ``elasticdl_tpu/chaos/hooks.py``.

The master's harness exports two environment variables to every worker
subprocess (via the instance manager's env plumbing):

- ``ELASTICDL_TPU_CHAOS_PLAN`` — path to the JSON fault plan;
- ``ELASTICDL_TPU_CHAOS_EVENTS`` — path of the shared JSONL event log.

The lockstep runtime installs one :class:`ChaosInjector` per process
(:meth:`install_from_env`), scoped by its world identity ``(process_id,
cluster_version)``.  Hook points are deliberately tiny and free when no
plan is installed:

- :func:`on_step` — once per minibatch with the trainer's step; fires
  step-armed faults (self-SIGKILL for preemptions — a real preemption
  gives no grace — or opening a window fault);
- :func:`heartbeat_suppressed` — the heartbeat thread skips sends while
  a DROP_HEARTBEAT window is open;
- :func:`wrap_batches` — the host-pipeline delay shim;
- :func:`notify_checkpoint_save` / :func:`notify_checkpoint_restore` —
  checkpoint-path events (and the KILL_IN_CHECKPOINT fault), called by
  :mod:`elasticdl_tpu_torch.trainer.checkpointing`;
- :func:`notify_replica_push` / :func:`record_replica_push` /
  :func:`notify_replica_restore` — the replication path's
  (``replication/replicator.py``): the KILL_DURING_REPLICATION fault
  before a push leaves, then an observation of each push (its version,
  checksum, bytes, costs and whether the neighbor accepted it) and of a
  restore from peer RAM.  The JAX package writes the push and restore
  to its telemetry event log; the port's chaos event log
  carries them, so ``chaos/invariants.py::check_replication_no_lost_steps``
  reads one log.

Every firing is appended to the event log *before* the fault acts
(a process about to SIGKILL itself can't report afterwards), with both
wall-clock and monotonic timestamps — CLOCK_MONOTONIC is machine-wide,
so the master-side harness can subtract worker event times from its own
monotonic readings to get detection latency.
"""

from __future__ import annotations

import json
import os
import signal
import time

from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind, FaultPlan
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

PLAN_ENV = "ELASTICDL_TPU_CHAOS_PLAN"
EVENTS_ENV = "ELASTICDL_TPU_CHAOS_EVENTS"

_active: "ChaosInjector | None" = None


def append_event(path: str, event: dict, fsync: bool = False):
    """THE event-log writer (injector firings, observations, master-side
    capacity faults all share it).  One small line per event; O_APPEND
    keeps concurrent writers from interleaving within a line.  ``fsync``
    for events that must survive the writer's own imminent SIGKILL."""
    if not path:
        return
    try:
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(event) + "\n")
            if fsync:
                f.flush()
                os.fsync(f.fileno())
    except OSError:
        logger.exception("Chaos event log write failed")


class ChaosInjector:
    def __init__(
        self,
        plan: FaultPlan,
        process_id: int,
        cluster_version: int,
        worker_id: int,
        events_path: str = "",
        slice_id: int = 0,
    ):
        self._process_id = process_id
        self._cluster_version = cluster_version
        self._worker_id = worker_id
        self._slice_id = slice_id
        self._events_path = events_path
        # faults this process may fire in this world generation; a
        # SLICE_LOSS fault arms on every process OF ITS SLICE (the
        # whole-slice preemption: they all reach at_step together and
        # die together)
        self._pending: list[Fault] = [
            f
            for f in plan.worker_faults()
            if f.cluster_version == cluster_version
            and (f.process_id is None or f.process_id == process_id)
            and (f.slice_id is None or f.slice_id == slice_id)
        ]
        # open windows: fault -> monotonic deadline
        self._heartbeat_block_until = 0.0
        self._delay_until = 0.0
        self._delay_ms = 0.0

    # ---- event log ---------------------------------------------------------

    def _record(self, fault: Fault, **extra):
        event = {
            "fault_id": fault.fault_id,
            "kind": fault.kind,
            "process_id": self._process_id,
            "worker_id": self._worker_id,
            "cluster_version": self._cluster_version,
            "time": time.time(),
            "monotonic": time.monotonic(),
            **extra,
        }
        logger.warning("CHAOS firing %s: %s", fault.fault_id, event)
        # mirrored into the telemetry event log first (a no-op without
        # it), with this record's stamps, so a report reads one firing
        from elasticdl_tpu_torch.telemetry import worker_hooks

        worker_hooks.emit_event(
            "fault_injected", fault_id=fault.fault_id, kind=fault.kind,
            time=event["time"], monotonic=event["monotonic"], **extra,
        )
        # fsync: a firing may be the process's last act before SIGKILL
        append_event(self._events_path, event, fsync=True)

    # ---- hook points -------------------------------------------------------

    # faults that fire from their own dedicated hook point, never at a
    # step boundary
    _HOOK_FIRED = frozenset(
        {FaultKind.KILL_IN_CHECKPOINT, FaultKind.KILL_DURING_REPLICATION}
    )

    def on_step(self, step: int):
        """Called once per minibatch with the trainer's current step.
        KILL_IN_CHECKPOINT / KILL_DURING_REPLICATION are excluded: they
        fire from the checkpoint-save / replica-push hooks, never at a
        step boundary."""
        if not self._pending:
            return
        due = [
            f
            for f in self._pending
            if step >= f.at_step and f.kind not in self._HOOK_FIRED
        ]
        for fault in due:
            self._pending.remove(fault)
            self._fire(fault, step)

    def _fire(self, fault: Fault, step: int):
        if fault.kind in (
            FaultKind.PREEMPT,
            FaultKind.KILL_COORDINATOR,
            FaultKind.SLICE_LOSS,
        ):
            extra = (
                {"slice_id": self._slice_id}
                if fault.kind == FaultKind.SLICE_LOSS
                else {}
            )
            self._record(fault, step=step, **extra)
            # a preemption gives no grace: no atexit, no finally blocks,
            # no checkpoint flush — exactly what SIGKILL delivers (a
            # SLICE_LOSS is the same death on every process of the slice)
            os.kill(os.getpid(), signal.SIGKILL)
        elif fault.kind == FaultKind.DROP_HEARTBEAT:
            self._record(fault, step=step)
            self._heartbeat_block_until = (
                time.monotonic() + fault.duration_secs
            )
            # a silent worker must go FULLY silent: step-task pulls are
            # implicit heartbeats (servicer.get_step_task), so a worker
            # that keeps training is correctly never declared dead.
            # Stall the training thread for the window too — the
            # injected failure is a frozen process (the SIGSTOP k8s
            # cannot see), not a dropped beat packet.
            time.sleep(fault.duration_secs)
        elif fault.kind == FaultKind.DELAY_BATCHES:
            self._record(fault, step=step)
            self._delay_until = time.monotonic() + fault.duration_secs
            self._delay_ms = fault.delay_ms

    def heartbeat_suppressed(self) -> bool:
        return time.monotonic() < self._heartbeat_block_until

    def wrap_batches(self, batches):
        """Yield-through shim adding the active per-batch delay (models a
        stalled host input pipeline; host-side only, never touches device
        dispatch order, so lockstep schedule agreement is preserved —
        every process yields the same stream, just later)."""
        for batch in batches:
            if self._delay_ms and time.monotonic() < self._delay_until:
                time.sleep(self._delay_ms / 1000.0)
            yield batch

    def on_checkpoint_save(self, version: int):
        for fault in list(self._pending):
            if (
                fault.kind == FaultKind.KILL_IN_CHECKPOINT
                and version >= fault.at_step
            ):
                self._pending.remove(fault)
                self._record(fault, step=version, phase="checkpoint_save")
                os.kill(os.getpid(), signal.SIGKILL)

    def on_checkpoint_restore(self, version: int):
        """Restore is an observation point only (the event log is how the
        harness proves a re-formed world actually resumed from state)."""
        self._record_observation("checkpoint_restore", version=version)

    def on_replica_push(self, version: int):
        """Replication hook: fires after the local snapshot commit,
        before the ring-neighbor push — the exact window where a
        preemption leaves the replica set incomplete."""
        for fault in list(self._pending):
            if (
                fault.kind == FaultKind.KILL_DURING_REPLICATION
                and version >= fault.at_step
            ):
                self._pending.remove(fault)
                self._record(fault, step=version, phase="replica_push")
                os.kill(os.getpid(), signal.SIGKILL)

    def on_replica_pushed(self, version: int, **fields):
        """Observation point: one replication's push (sent or not)."""
        self._record_observation("replica_push", step=version, **fields)

    def on_replica_restore(self, version: int, **fields):
        """Observation point: a re-formed world resumed from peer RAM
        (vs the disk observation ``checkpoint_restore``)."""
        self._record_observation(
            "replica_restore", version=version, step=version, **fields
        )

    def _record_observation(self, what: str, **extra):
        append_event(
            self._events_path,
            {
                "observation": what,
                "process_id": self._process_id,
                "worker_id": self._worker_id,
                "cluster_version": self._cluster_version,
                "time": time.time(),
                "monotonic": time.monotonic(),
                **extra,
            },
        )


# ---- module-level install + no-op-safe accessors ---------------------------


def install_from_env(
    process_id: int,
    cluster_version: int,
    worker_id: int,
    slice_id: int = 0,
) -> ChaosInjector | None:
    """Install the process-wide injector if a plan is in the
    environment; returns it (or None).  Called by the worker runtime
    once its world identity is known."""
    global _active
    plan_path = os.environ.get(PLAN_ENV, "")
    if not plan_path:
        return None
    try:
        plan = FaultPlan.load(plan_path)
    except (OSError, ValueError, KeyError) as ex:
        logger.error("Ignoring unreadable chaos plan %s: %s", plan_path, ex)
        return None
    _active = ChaosInjector(
        plan,
        process_id=process_id,
        cluster_version=cluster_version,
        worker_id=worker_id,
        events_path=os.environ.get(EVENTS_ENV, ""),
        slice_id=slice_id,
    )
    logger.warning(
        "Chaos plan %r installed (process %d, generation %d): %d fault(s) "
        "armed",
        plan.name,
        process_id,
        cluster_version,
        len(_active._pending),
    )
    return _active


def get_injector() -> ChaosInjector | None:
    return _active


def notify_checkpoint_save(version: int):
    """Checkpoint-save hook (trainer/checkpointing.py); no-op without an
    installed injector."""
    if _active is not None:
        _active.on_checkpoint_save(version)


def notify_checkpoint_restore(version: int):
    if _active is not None:
        _active.on_checkpoint_restore(version)


def notify_replica_push(version: int):
    """Replica-push hook (replication.replicator); no-op without an
    installed injector."""
    if _active is not None:
        _active.on_replica_push(version)


def record_replica_push(version: int, **fields):
    """Replica-push observation, after the push; no-op without an
    installed injector."""
    if _active is not None:
        _active.on_replica_pushed(version, **fields)


def notify_replica_restore(version: int, **fields):
    if _active is not None:
        _active.on_replica_restore(version, **fields)
