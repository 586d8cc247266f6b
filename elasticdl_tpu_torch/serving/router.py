"""The serving front door: lease-style routing and eviction; the
counterpart of ``elasticdl_tpu/serving/router.py``.

The router is the serving plane's "master": it owns the replica
registry the way the training master owns worker liveness — a
monotonic last-seen timestamp per replica, refreshed by a background
``serving_status`` probe beat (the serving heartbeat), with replicas
evicted from rotation after ``evict_after_secs`` of silence and
re-admitted the moment a probe lands again (gray failure is not death:
an evicted replica is only FORGOTTEN after ``forget_after_secs``).

Routing is lease-style least-outstanding: each in-flight request holds
a slot on its replica (the lease); a replica's death with leases held
is absorbed by re-sending — ``predict`` is classified read-only in
``rpc/idempotency.py``, so the retry cannot double any effect.  Model
swaps fan out to every registered replica and report per-replica
outcomes; ``swap_model`` is a versioned put, so a replica that already
took the version absorbs the re-delivery.

Each routing attempt of a traced request is a span of that request's
trace (:meth:`ServingRouter._route_span`).  The JAX router also ticks an
SLO watchdog after each probe sweep; that comes to the port with slice
10b-2 (:attr:`watchdog` stays None unless a caller sets one).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc.service import _retryable_error
from elasticdl_tpu_torch.serving.replica import ServingClient
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.merge import (
    max_merge_counters,
    max_merge_phase_stats,
)

DEFAULT_EVICT_AFTER_SECS = 10.0
DEFAULT_FORGET_AFTER_SECS = 120.0
# per-request routing attempts across DISTINCT replicas before giving up
MAX_ROUTE_ATTEMPTS = 3


class _ReplicaHandle:
    __slots__ = (
        "replica_id",
        "addr",
        "client",
        "outstanding",
        "last_seen",
        "last_status",
        "counters",
        "phases",
        "memory",
        "memory_at",
        "swap_unreachable",
    )

    def __init__(self, replica_id: int, addr: str, client: ServingClient):
        self.replica_id = replica_id
        self.addr = addr
        self.client = client
        self.outstanding = 0  # guarded-by: router._lock
        self.last_seen = time.monotonic()  # guarded-by: router._lock
        self.last_status: msg.ServingStatusResponse | None = None
        # probe-beat fan-in state: monotone counters and per-phase
        # totals max-merged from serving_status payloads (a probe that
        # raced an older snapshot cannot roll a counter back), memory
        # ledger last-writer-wins by its own stamp  # guarded-by: _lock
        self.counters: dict[str, int] = {}
        self.phases: dict[str, dict] = {}
        self.memory: dict = {}
        self.memory_at: float = -1.0
        # set when the last swap fan-out could not reach this replica;
        # cleared by the next successful probe (the replica is back —
        # the watchdog's swap_unreachable signal recovers)
        self.swap_unreachable = False  # guarded-by: _lock


def _retryable_failure(ex) -> bool:
    """Outage-class transport failures worth re-routing (the same set
    the control-plane retry loop backs off on)."""
    return _retryable_error(ex)


class ServingRouter:
    """The front door: implements the SAME servicer protocol as a
    replica (predict / serving_status / swap_model), so one endpoint
    serves whether it fronts 1 replica or 40."""

    def __init__(
        self,
        deadlines=None,
        evict_after_secs: float = DEFAULT_EVICT_AFTER_SECS,
        forget_after_secs: float = DEFAULT_FORGET_AFTER_SECS,
        probe_interval_secs: float = 1.0,
    ):
        self._deadlines = deadlines
        self._evict_after = float(evict_after_secs)
        self._forget_after = float(forget_after_secs)
        self._probe_interval = max(0.05, float(probe_interval_secs))
        self._lock = threading.Lock()
        self._replicas: dict[int, _ReplicaHandle] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        # fleet-wide running totals, maintained INCREMENTALLY by the
        # per-replica merges (never recomputed by iterating replicas —
        # a forgotten replica's contribution survives, so fleet totals
        # stay monotone across evictions)  # guarded-by: _lock
        self._fleet_counters: dict[str, int] = {}
        self._fleet_phases: dict[str, dict] = {}
        # optional SLO watchdog (anything with ``tick()``), ticked at
        # the end of every probe sweep; the port's serving/watchdog.py
        # comes with slice 10b-2, so nothing sets it yet
        self.watchdog = None

    # ---- registry ----------------------------------------------------------

    def add_replica(self, addr: str) -> int:
        client = ServingClient(addr, deadlines=self._deadlines)
        with self._lock:
            replica_id = self._next_id
            self._next_id += 1
            self._replicas[replica_id] = _ReplicaHandle(
                replica_id, addr, client
            )
        logger.info("Serving router: replica %d at %s", replica_id, addr)
        return replica_id

    def remove_replica(self, replica_id: int):
        with self._lock:
            handle = self._replicas.pop(replica_id, None)
        if handle is not None:
            try:
                handle.client.close()
            except Exception:  # noqa: BLE001 — closing a dead channel
                pass

    def live_replicas(self) -> list[int]:
        now = time.monotonic()
        with self._lock:
            return [
                h.replica_id
                for h in self._replicas.values()
                if now - h.last_seen <= self._evict_after
            ]

    # ---- the probe beat (liveness) ------------------------------------------

    def start(self):
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="serving-router-probe", daemon=True
        )
        self._probe_thread.start()
        return self

    def probe_once(self):
        """One liveness sweep (the thread loops this; tests drive it
        directly): refresh last_seen per replica, forget replicas silent
        past the forget horizon.  Probes run CONCURRENTLY: a dead
        replica blocks its probe for the full RPC deadline, and a
        serial sweep would let two dead replicas delay a healthy
        replica's refresh past the eviction horizon — a partial failure
        escalated into a spurious fleet-wide eviction."""
        with self._lock:
            handles = list(self._replicas.values())
        now = time.monotonic()

        def probe(handle):
            try:
                status = handle.client.serving_status(
                    msg.ServingStatusRequest()
                )
            except Exception:  # noqa: BLE001 — a dead replica IS the
                # signal; the eviction horizon decides, not one failure
                return
            self._absorb_status(handle, status)

        if handles:
            with ThreadPoolExecutor(
                max_workers=min(8, len(handles))
            ) as pool:
                list(pool.map(probe, handles))
        with self._lock:
            forgotten = [
                rid
                for rid, h in self._replicas.items()
                if now - h.last_seen > self._forget_after
            ]
        for rid in forgotten:
            logger.warning(
                "Serving router: forgetting replica %d (silent > %.0fs)",
                rid,
                self._forget_after,
            )
            self.remove_replica(rid)
        watchdog = self.watchdog
        if watchdog is not None:
            try:
                watchdog.tick()
            except Exception:  # noqa: BLE001 — the watchdog observes
                # the beat; a watchdog bug must not kill the beat
                logger.exception("Serving SLO watchdog tick failed")

    def _absorb_status(self, handle, status):
        """Fold one serving_status payload into the handle's merged
        state and the fleet totals (the probe-beat fan-in): counters
        and phase totals are MONOTONE on the replica, so a stale
        payload racing a fresher one max-merges to a no-op; the memory
        ledger snapshot is a gauge and goes last-writer-wins on its
        own ``at`` stamp, never the arrival order."""
        with self._lock:
            handle.last_seen = time.monotonic()
            handle.last_status = status
            handle.swap_unreachable = False
            if status.counters:
                max_merge_counters(
                    handle.counters,
                    status.counters,
                    totals=self._fleet_counters,
                )
            if status.phases:
                max_merge_phase_stats(
                    handle.phases,
                    status.phases,
                    totals=self._fleet_phases,
                )
            if status.memory:
                at = float(status.memory.get("at", 0.0))
                if at >= handle.memory_at:
                    handle.memory = status.memory
                    handle.memory_at = at

    def _probe_loop(self):
        while not self._stop.wait(self._probe_interval):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the beat must not die
                logger.exception("Serving router probe sweep failed")

    # ---- routing -----------------------------------------------------------

    def _pick(self, exclude: set[int]) -> _ReplicaHandle | None:
        """Least-outstanding live replica not yet tried; takes the
        lease (outstanding += 1) under the lock."""
        now = time.monotonic()
        with self._lock:
            candidates = [
                h
                for h in self._replicas.values()
                if h.replica_id not in exclude
                and now - h.last_seen <= self._evict_after
            ]
            if not candidates:
                return None
            handle = min(candidates, key=lambda h: h.outstanding)
            handle.outstanding += 1
            return handle

    def _release(self, handle: _ReplicaHandle, ok: bool):
        with self._lock:
            handle.outstanding = max(0, handle.outstanding - 1)
            if ok:
                handle.last_seen = time.monotonic()

    def _route_span(self, ctx, attempt, t0, replica_id, error="", **attrs):
        """One routing attempt as a child span of the request's trace:
        the first attempt is ``route``, every retry ``reroute``, both in
        the same trace, so a re-sent request stays one trace with its
        detour visible.  An untraced request skips the tracer."""
        if not ctx:
            return
        from elasticdl_tpu_torch.telemetry import tracing

        tracer = tracing.get_tracer()
        if tracer is None:
            return
        name = tracing.SPAN_SERVING_ROUTE if attempt == 0 else tracing.SPAN_SERVING_REROUTE
        attrs = dict(attrs, replica_id=int(replica_id), attempt=int(attempt))
        if error:
            attrs["error"] = error
        tracer.record_span(name, t0, time.monotonic(), trace_ctx=ctx, **attrs)

    def predict(self, request: msg.PredictRequest) -> msg.PredictResponse:
        tried: set[int] = set()
        ctx = request.trace or None
        last_error = "no live serving replicas"
        for attempt in range(MAX_ROUTE_ATTEMPTS):
            t0 = time.monotonic()
            handle = self._pick(tried)
            if handle is None:
                break
            tried.add(handle.replica_id)
            try:
                response = handle.client.predict(request)
            except Exception as ex:  # noqa: BLE001 — transport failures
                # route around; anything else is a bug worth surfacing
                self._release(handle, ok=False)
                if not _retryable_failure(ex):
                    raise
                last_error = f"replica {handle.replica_id}: {ex}"
                self._route_span(
                    ctx, attempt, t0, handle.replica_id, error=last_error
                )
                continue
            self._release(handle, ok=True)
            if response.error and response.retryable:
                # an overloaded replica sheds; try a less loaded one
                last_error = (
                    f"replica {handle.replica_id}: {response.error}"
                )
                self._route_span(
                    ctx, attempt, t0, handle.replica_id, error=last_error
                )
                continue
            self._route_span(ctx, attempt, t0, handle.replica_id)
            return response
        return msg.PredictResponse(error=last_error, retryable=True)

    def serving_status(
        self, request: msg.ServingStatusRequest
    ) -> msg.ServingStatusResponse:
        """Aggregate status: max model version across live replicas (the
        fleet converges there), summed counters, per-replica detail.

        Statuses are fetched LIVE and CONCURRENTLY (the read doubles as
        a probe): the beat's cached copy can lag by a probe interval,
        which is enough to misreport a counter a caller is gating on
        (the serving smoke reads each replica's version after a swap), and
        a serial fan-out would add a full RPC deadline per dead replica
        to every /healthz read.  The cache serves only as the fallback
        for a replica that fails the live read."""
        now = time.monotonic()
        with self._lock:
            handles = list(self._replicas.values())

        def fetch(h):
            try:
                return h, h.client.serving_status(request)
            except Exception:  # noqa: BLE001 — fall back to the beat's
                # cached copy; the eviction horizon decides liveness
                return h, None

        fetched = []
        if handles:
            with ThreadPoolExecutor(
                max_workers=min(8, len(handles))
            ) as pool:
                fetched = list(pool.map(fetch, handles))
        live = []
        for h, status in fetched:
            if status is not None:
                self._absorb_status(h, status)
                live.append(h)
            elif (
                now - h.last_seen <= self._evict_after
                and h.last_status is not None
            ):
                live.append(h)
        out = msg.ServingStatusResponse(replica_id=-1)
        for h in live:
            s = h.last_status
            out.model_version = max(out.model_version, s.model_version)
            out.compile_count += s.compile_count
            out.requests += s.requests
            out.rows += s.rows
            out.rejected += s.rejected
            out.swaps += s.swaps
            out.queue_rows += s.queue_rows
            out.canonical_rows = s.canonical_rows
            if request.detail:
                out.replicas.append(
                    {
                        "replica_id": h.replica_id,
                        "addr": h.addr,
                        "model_version": s.model_version,
                        "requests": s.requests,
                        "queue_rows": s.queue_rows,
                        "outstanding": h.outstanding,
                    }
                )
        return out

    def swap_model(self, request: msg.SwapModelRequest) -> msg.SwapModelResponse:
        """Fan the swap to every REGISTERED replica (evicted ones too —
        if they come back they must come back current).

        ``accepted`` means the fleet is consistently at the version:
        every replica was reachable AND either took the swap or refused
        it as STALE (already at/past the version — how a re-delivered
        swap is absorbed, the versioned-put contract).  An unreachable
        replica or a non-stale refusal (wrong model, bad export) makes
        the fan-out not-accepted."""
        with self._lock:
            handles = list(self._replicas.values())
        ctx = request.trace or None
        outcomes = []
        all_converged = bool(handles)
        version = -1
        for handle in handles:
            # every fan-out leg is a ``route`` child of the SWAP's
            # trace (one swap = one trace): the replica's model_swap
            # span parents into the same trace via request.trace, so
            # the export shows which leg ran where
            t0 = time.monotonic()
            try:
                response = handle.client.swap_model(request)
            except Exception as ex:  # noqa: BLE001 — an unreachable
                # replica's swap outcome is reported, not raised
                all_converged = False
                with self._lock:
                    handle.swap_unreachable = True
                outcomes.append(
                    {
                        "replica_id": handle.replica_id,
                        "accepted": False,
                        "absorbed": False,
                        "reason": f"unreachable: {ex}",
                    }
                )
                self._route_span(
                    ctx,
                    0,
                    t0,
                    handle.replica_id,
                    error="unreachable",
                    method="swap_model",
                )
                continue
            self._route_span(
                ctx, 0, t0, handle.replica_id, method="swap_model"
            )
            # a stale refusal IS convergence: the replica already
            # serves this version or newer (replay absorbed) — read
            # from the structured field, never the reason wording
            absorbed = not response.accepted and response.stale
            if not (response.accepted or absorbed):
                all_converged = False
            version = max(version, response.model_version)
            outcomes.append(
                {
                    "replica_id": handle.replica_id,
                    "accepted": response.accepted,
                    "absorbed": absorbed,
                    "reason": response.reason,
                }
            )
        return msg.SwapModelResponse(
            accepted=all_converged,
            model_version=version,
            reason=""
            if all_converged
            else "; ".join(o["reason"] for o in outcomes if o["reason"])
            or "no replicas registered",
            replicas=outcomes,
        )

    # ---- observability read side --------------------------------------------

    def fleet_snapshot(self) -> dict:
        """Consistent point-in-time copy of the fan-in state — the ONE
        read the JAX package's fleet metrics, /healthz and SLO watchdog
        consume (one lock hold, no RPCs: everything here arrived on the
        probe beat).  Counters/phases are copied so callers can diff
        ticks without racing the next merge."""
        now = time.monotonic()
        with self._lock:
            replicas = {}
            for rid, h in self._replicas.items():
                age = max(0.0, now - h.last_seen)
                status = h.last_status
                replicas[rid] = {
                    "replica_id": rid,
                    "addr": h.addr,
                    "outstanding": int(h.outstanding),
                    "last_probe_age_secs": age,
                    "live": age <= self._evict_after,
                    # countdown to eviction (0 == already evicted):
                    # /healthz shows how close each replica is to
                    # dropping out of rotation
                    "evict_in_secs": max(0.0, self._evict_after - age),
                    "queue_rows": int(status.queue_rows) if status else 0,
                    "model_version": (
                        int(status.model_version) if status else -1
                    ),
                    "counters": dict(h.counters),
                    "phases": {
                        phase: {
                            "ms": slot["ms"],
                            "count": slot["count"],
                            "buckets": dict(slot["buckets"]),
                        }
                        for phase, slot in h.phases.items()
                    },
                    "memory": h.memory,
                    "swap_unreachable": bool(h.swap_unreachable),
                }
            return {
                "at": now,
                "replicas": replicas,
                "live": [
                    rid for rid, r in replicas.items() if r["live"]
                ],
                "counters": dict(self._fleet_counters),
                "phases": {
                    phase: {
                        "ms": slot["ms"],
                        "count": slot["count"],
                        "buckets": dict(slot["buckets"]),
                    }
                    for phase, slot in self._fleet_phases.items()
                },
            }

    def close(self):
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
        with self._lock:
            handles, self._replicas = list(self._replicas.values()), {}
        for handle in handles:
            try:
                handle.client.close()
            except Exception:  # noqa: BLE001
                pass
