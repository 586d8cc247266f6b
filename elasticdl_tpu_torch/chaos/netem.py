"""Transport-level network fault injection (gray failures, not deaths);
the counterpart of ``elasticdl_tpu/chaos/netem.py`` on the port's socket
transport.

A process fault is clean: the peer vanishes and the call fails
``UNAVAILABLE``.  A gray one is not: a link goes slow or silent, a
retried call is delivered twice, one direction of a connection dies
while the other lives.  This module injects those at the two seams every
call of ``rpc/service.py`` passes:

- **client seam** (``RpcClient._invoke``, every attempt, retries
  included): per-method latency with seeded jitter (NET_DELAY),
  drop-with-hang (NET_BLACKHOLE: silence until the call's deadline turns
  it into DEADLINE_EXCEEDED; with no deadline, a hang bounded by the
  fault's window), an injected UNAVAILABLE (NET_UNAVAILABLE), and the
  one-way partition (NET_PARTITION: ``direction="request"`` drops the
  request before the server sees it, ``direction="response"`` lets it
  execute and drops only the reply, so every retry re-delivers a landed
  request);
- **server seam** (the socket server's dispatch): duplicate delivery
  (NET_DUPLICATE: the handler runs the request twice and the first
  response is discarded, as after a lost reply and a retry).

Faults arm from the plan (``ELASTICDL_TPU_CHAOS_PLAN``) with the same
generation fence as the worker-side hooks, by **matched-call index**
(``Fault.at_step`` = matched calls to skip), not by step.  Jitter draws
from a ``random.Random`` seeded by (plan seed, process id, fault id), as
in the JAX package, so one plan gives the same delays in both.

The injected errors are the port's own :class:`RpcError` codes; the JAX
package's wear ``grpc.RpcError``'s surface.  Every firing is recorded to
the chaos event log with an fsync (the process may be about to die of
it), and mirrored into the telemetry event log as ``rpc_fault_injected``
(by the master-side shim's sink, or a worker's ``worker_hooks``).  The
JAX package also opens an ``rpc_degraded`` span for a window fault: the
port's spans come with slice 10b.  An armed worker also records its RPC outcome counters
after each failure (``rpc_stats`` observations): a worker that the fault
gets evicted never ships them on a heartbeat, so the harness merges them
as a heartbeat would; the JAX report counts only what heartbeats
shipped.
"""

from __future__ import annotations

import os
import random
import threading
import time

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind, FaultPlan
from elasticdl_tpu_torch.rpc.service import RpcError, StatusCode
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# window kinds stay open duration_secs from their first matched call;
# per-call kinds affect the next `count` matched calls
_WINDOW_KINDS = frozenset(
    {FaultKind.NET_DELAY, FaultKind.NET_BLACKHOLE, FaultKind.NET_PARTITION}
)
_DEFAULT_WINDOW_SECS = 10.0

# hang-poll granularity for a deadline-less blackhole (bounded by the
# fault window, so a run without deadlines still ends: the link "flaps
# back" and the request in flight dies with a reset)
_HANG_POLL_SECS = 0.05


class InjectedRpcError(RpcError):
    """A netem-injected failure: an :class:`RpcError` whose code the
    retry layer keys on, as any transport failure's."""


class _Armed:
    """One plan fault plus its arming state."""

    def __init__(self, fault: Fault, seed):
        self.fault = fault
        self.seen = 0  # matched calls observed (the arming counter)
        self.window_until: float | None = None
        self.remaining = max(1, int(fault.count or 1))
        self.rng = random.Random(f"{seed}:{fault.fault_id}")


class NetemShim:
    """The seam object ``rpc/service.py`` consults.

    One per process and world generation; ``faults`` are already filtered
    to this process, generation and side.  ``sleep`` and ``clock`` are
    injectable for deterministic tests."""

    def __init__(
        self,
        faults: list[Fault],
        *,
        plan_seed=None,
        process_id: int = 0,
        worker_id: int = 0,
        cluster_version: int = 0,
        events_path: str = "",
        telemetry_sink=None,
        sleep=time.sleep,
        clock=time.monotonic,
    ):
        self._process_id = process_id
        self._worker_id = worker_id
        self._cluster_version = cluster_version
        self._events_path = events_path
        self._telemetry_sink = telemetry_sink
        self._sleep = sleep
        self._clock = clock
        self._lock = threading.Lock()
        seed = f"{plan_seed}:{process_id}"
        self._armed = [_Armed(f, seed) for f in faults]

    @property
    def armed_count(self) -> int:
        with self._lock:
            return len(self._armed)

    def set_telemetry_sink(self, sink):
        """Rebind the master-side sink ``sink(event, **fields)`` each
        firing is mirrored to (a relaunched master's), keeping the shim:
        a rebuilt shim would reset its arming counters and fire exhausted
        faults again."""
        self._telemetry_sink = sink

    # ---- matching ----------------------------------------------------------

    def _consult(self, method: str):
        """``(armed, fired_now)`` for the fault that governs this call, or
        ``(None, False)``.  The counters change under the lock; recording
        and sleeping happen in the caller, outside it."""
        now = self._clock()
        with self._lock:
            for armed in list(self._armed):
                fault = armed.fault
                if fault.method and fault.method != method:
                    continue
                if fault.kind in _WINDOW_KINDS:
                    if armed.window_until is None:
                        armed.seen += 1
                        if armed.seen <= fault.at_step:
                            continue
                        armed.window_until = now + (
                            fault.duration_secs or _DEFAULT_WINDOW_SECS
                        )
                        return armed, True
                    if now >= armed.window_until:
                        # the window closed, the link healed: retire the
                        # fault and let the others match
                        self._armed.remove(armed)
                        continue
                    return armed, False
                # per-call kinds (duplicate, unavailable)
                armed.seen += 1
                if armed.seen <= fault.at_step:
                    continue
                armed.remaining -= 1
                if armed.remaining <= 0:
                    self._armed.remove(armed)
                return armed, True
        return None, False

    # ---- recording ----------------------------------------------------------

    def _record(self, armed: _Armed, method: str, **extra):
        fault = armed.fault
        event = {
            "fault_id": fault.fault_id,
            "kind": fault.kind,
            "method": method or fault.method,
            "process_id": self._process_id,
            "worker_id": self._worker_id,
            "cluster_version": self._cluster_version,
            "time": time.time(),
            "monotonic": time.monotonic(),
            **extra,
        }
        logger.warning("CHAOS netem firing %s: %s", fault.fault_id, event)
        # the telemetry mirror: the master-side shim's sink, or this
        # worker process's recorder (a no-op when telemetry is off).  A
        # failure here must not reach the caller through the RPC seam
        fields = {
            k: v for k, v in event.items()
            if k not in ("fault_id", "worker_id", "process_id")
        }
        try:
            if self._telemetry_sink is not None:
                self._telemetry_sink(
                    "rpc_fault_injected", fault_id=fault.fault_id, **fields
                )
            else:
                from elasticdl_tpu_torch.telemetry import worker_hooks

                worker_hooks.emit_event(
                    "rpc_fault_injected", fault_id=fault.fault_id, **fields
                )
        except Exception:  # noqa: BLE001 — telemetry never breaks injection
            logger.exception("Netem telemetry mirror failed")
        # fsync: a blackholed worker may be about to die of this fault
        chaos_hooks.append_event(self._events_path, event, fsync=True)

    # ---- client seam --------------------------------------------------------

    def client_call(self, service: str, method: str, invoke, timeout):
        armed, fired = self._consult(method)
        if armed is None:
            return invoke()
        fault = armed.fault
        if fired and fault.kind in _WINDOW_KINDS:
            self._record(armed, method, duration_secs=fault.duration_secs)
        if fault.kind == FaultKind.NET_DELAY:
            # seeded jitter: uniform in [0, delay/2) on top of the base
            delay = (
                fault.delay_ms + armed.rng.uniform(0.0, fault.delay_ms / 2.0)
            ) / 1000.0
            if timeout is not None and delay >= timeout:
                # a delay past the deadline IS a deadline expiry on a real
                # link (the late request is taken as dropped)
                self._sleep(timeout)
                raise InjectedRpcError(
                    StatusCode.DEADLINE_EXCEEDED,
                    f"netem: injected delay exceeded the deadline "
                    f"({fault.fault_id}/{method})",
                )
            self._sleep(delay)
            return invoke()
        if fault.kind == FaultKind.NET_UNAVAILABLE:
            self._record(armed, method)
            raise InjectedRpcError(
                StatusCode.UNAVAILABLE,
                f"netem: injected UNAVAILABLE ({fault.fault_id})",
            )
        if fault.kind == FaultKind.NET_PARTITION and fault.direction == "response":
            # the request lands and executes; only the reply dies, so a
            # retry re-delivers it for real
            invoke()
        # a blackhole or a request-direction partition drops the request:
        # the caller gets silence, not an error (_hang always raises)
        self._hang(armed, method, timeout)

    def _hang(self, armed: _Armed, method: str, timeout):
        fault = armed.fault
        if timeout is not None:
            self._sleep(timeout)
            raise InjectedRpcError(
                StatusCode.DEADLINE_EXCEEDED,
                f"netem: call dropped, deadline expired ({fault.fault_id}/{method})",
            )
        # no deadline: the hang --rpc_deadline_secs exists to prevent,
        # bounded by the window; when the link comes back the request in
        # flight dies with a reset
        while self._clock() < (armed.window_until or 0.0):
            self._sleep(_HANG_POLL_SECS)
        raise InjectedRpcError(
            StatusCode.UNAVAILABLE,
            f"netem: connection reset at blackhole window close "
            f"({fault.fault_id}/{method})",
        )

    # ---- server seam --------------------------------------------------------

    def server_call(self, service: str, method: str, handler, request):
        armed, _fired = self._consult(method)
        if armed is None or armed.fault.kind != FaultKind.NET_DUPLICATE:
            return handler(request)
        self._record(armed, method, remaining=armed.remaining)
        # duplicate delivery: the first execution's response is discarded
        # (the client never saw it) and the second answers; a servicer's
        # dedup must make the pair one effect
        handler(request)
        return handler(request)


# ---- install / uninstall ----------------------------------------------------


def install_from_env(process_id: int, cluster_version: int, worker_id: int) -> NetemShim | None:
    """A worker process's entry: arm the plan's client-seam network faults
    for this process and generation at the RPC client.  No plan, or no
    fault for this process, installs nothing and the transport is
    unchanged.  A plan that cannot be read raises (the JAX worker logs it
    and runs without its faults)."""
    plan_path = os.environ.get(chaos_hooks.PLAN_ENV, "")
    if not plan_path:
        return None
    plan = FaultPlan.load(plan_path)
    faults = [
        f
        for f in plan.network_client_faults()
        if f.cluster_version == cluster_version
        and (f.process_id is None or f.process_id == process_id)
    ]
    if not faults:
        return None
    shim = NetemShim(
        faults,
        plan_seed=plan.seed,
        process_id=process_id,
        worker_id=worker_id,
        cluster_version=cluster_version,
        events_path=os.environ.get(chaos_hooks.EVENTS_ENV, ""),
    )
    from elasticdl_tpu_torch.rpc import service as rpc_service
    from elasticdl_tpu_torch.rpc import stats as rpc_stats

    rpc_service.set_client_fault_shim(shim)
    events_path = os.environ.get(chaos_hooks.EVENTS_ENV, "")
    if events_path:
        # the RPC outcome counters outlive this process in the event log:
        # a worker the fault gets evicted never ships them on a heartbeat
        def record(totals):
            chaos_hooks.append_event(events_path, {
                "observation": "rpc_stats",
                "process_id": process_id,
                "worker_id": worker_id,
                "cluster_version": cluster_version,
                "time": time.time(),
                "monotonic": time.monotonic(),
                "rpc": totals,
            })

        rpc_stats.set_observer(record)
    logger.warning(
        "Chaos netem armed (process %d, generation %d): %d network fault(s) "
        "at the client seam", process_id, cluster_version, len(faults),
    )
    return shim


def install_master_from_plan(
    plan: FaultPlan, events_path: str = "", telemetry_sink=None
) -> NetemShim | None:
    """The master's entry (the chaos harness runs the master in process):
    arm the plan's server-seam faults, so that duplicate delivery runs the
    request twice in the master's own handler.  A server cannot tell its
    callers apart, so ``process_id`` does not apply; its fence is its own
    arming state: the harness installs it once per run and keeps it across
    master lives, so an exhausted fault never fires again after a
    MASTER_KILL relaunch."""
    faults = plan.network_server_faults()
    if not faults:
        return None
    shim = NetemShim(
        faults, plan_seed=plan.seed, events_path=events_path, telemetry_sink=telemetry_sink,
    )
    from elasticdl_tpu_torch.rpc import service as rpc_service

    rpc_service.set_server_fault_shim(shim)
    logger.warning(
        "Chaos netem armed (master): %d network fault(s) at the server seam", len(faults)
    )
    return shim


def uninstall():
    """Clear both seams (between a chaos run and its fault-free baseline
    in one process; module globals would leak otherwise)."""
    from elasticdl_tpu_torch.rpc import service as rpc_service
    from elasticdl_tpu_torch.rpc import stats as rpc_stats

    rpc_service.set_client_fault_shim(None)
    rpc_service.set_server_fault_shim(None)
    rpc_stats.set_observer(None)
