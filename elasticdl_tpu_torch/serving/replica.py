"""One serving worker: engine + micro-batcher + dispatch thread, behind
the port's RPC transport; the counterpart of
``elasticdl_tpu/serving/replica.py``.

The replica binds the serving method table (:data:`SERVING_METHODS`)
through the same socket transport the control plane uses
(``rpc/service.py::create_server`` with its own service name), so it
shares the control plane's per-method deadlines, retry loop and message
cap.  Requests and responses are the wire messages of
``rpc/messages.py``: features and outputs travel packed
(``pack_array_tree``), in process as over the socket, so a caller in
the same process calls :meth:`ServingReplicaServicer.predict` with the
same request it would send.

Threads: the transport's handler threads submit tickets and block on
them; ONE dispatch thread drains the batcher into the engine.
``serving_status`` is the liveness probe the router beats on (read-only,
retry-safe); its ``compile_count`` is, in the port, the count of input
shapes the engine has dispatched (the JAX package counts XLA compiles),
which compile-once serving keeps at 1.  ``swap_model`` swaps from an
export directory or from an inline replication blob (``payload``).
"""

from __future__ import annotations

import threading

import torch

from elasticdl_tpu_torch.replication.blob import decode_snapshot
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc.service import RpcClient, create_server
from elasticdl_tpu_torch.serving.batcher import (
    MicroBatcher,
    ServingError,
    ServingOverloadError,
    ServingShutdownError,
)
from elasticdl_tpu_torch.serving.engine import STALE_SWAP_PREFIX, ServingEngine
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

SERVING_SERVICE_NAME = "elasticdl_tpu.Serving"

# the serving method table (every name classified in rpc/idempotency.py)
SERVING_METHODS = (
    "predict",
    "serving_status",
    "swap_model",
)

# predict is read-only, status is read-only, swap is a versioned put:
# the whole table is retry-safe, so routers and clients opt it all in
SERVING_RETRYABLE_METHODS = frozenset(SERVING_METHODS)

# a request's wait inside ONE replica is bounded by the batcher wait +
# dispatch time; the ticket wait below is a backstop for a wedged
# dispatch thread, not a latency target
TICKET_WAIT_SECS = 60.0


class ServingReplicaServicer:
    """Transport-agnostic servicer: tests and in-process callers call
    its methods directly, the socket server wraps them."""

    def __init__(self, engine: ServingEngine, batcher: MicroBatcher,
                 replica_id: int = 0):
        self.engine = engine
        self.batcher = batcher
        self.replica_id = int(replica_id)

    def predict(self, request: msg.PredictRequest) -> msg.PredictResponse:
        try:
            features = msg.unpack_array_tree(request.features)
            if not self.engine.built:
                # cold start: build + LOCK the feature spec from this
                # request BEFORE anything enters the queue — otherwise a
                # malformed concurrent first request could coalesce into
                # (and poison) a valid request's dispatch group
                self.engine.ensure_built(features)
            features = self.engine.conform(features)
            ticket = self.batcher.submit(request.request_id, features)
        except ServingOverloadError as ex:
            # rejected == load shed by the bounded queue, ONLY: a
            # malformed request lands in errors below
            self.engine.rejected += 1
            return msg.PredictResponse(error=str(ex), retryable=True)
        except ServingError as ex:
            self.engine.errors += 1
            return msg.PredictResponse(
                error=str(ex), retryable=bool(getattr(ex, "retryable", False))
            )
        except Exception as ex:  # noqa: BLE001 — malformed payloads must
            # answer, not kill the handler thread
            self.engine.errors += 1
            return msg.PredictResponse(error=f"bad request: {ex}")
        try:
            outputs = ticket.result(TICKET_WAIT_SECS)
        except ServingError as ex:
            if isinstance(ex, ServingShutdownError):
                # a failed dispatch group was counted by the engine; a
                # ticket the closing batcher failed was not
                self.engine.errors += 1
            return msg.PredictResponse(
                error=str(ex), retryable=bool(getattr(ex, "retryable", False))
            )
        except TimeoutError as ex:
            self.engine.errors += 1
            return msg.PredictResponse(error=str(ex), retryable=True)
        except Exception as ex:  # noqa: BLE001 — dispatch errors carry
            # over (the engine counted them)
            return msg.PredictResponse(error=f"dispatch failed: {ex}")
        phases_ms = {
            name: secs * 1000.0 for name, secs in ticket.phases_secs.items()
        }
        phases_ms["total_ms"] = ticket.total_secs() * 1000.0
        return msg.PredictResponse(
            outputs=msg.pack_array_tree(outputs),
            model_version=int(ticket.model_version),
            rows=int(ticket.rows),
            phases=phases_ms,
        )

    def serving_status(
        self, request: msg.ServingStatusRequest
    ) -> msg.ServingStatusResponse:
        engine = self.engine
        return msg.ServingStatusResponse(
            replica_id=self.replica_id,
            model_version=int(engine.version),
            compile_count=int(engine.shapes_dispatched),
            requests=int(engine.requests_served),
            rows=int(engine.rows_served),
            rejected=int(engine.rejected),
            swaps=int(engine.swaps_applied),
            queue_rows=int(self.batcher.queue_rows()),
            canonical_rows=int(engine.canonical_rows),
            counters=engine.counters_snapshot(),
            phases=engine.phase_totals_snapshot(),
        )

    def swap_model(self, request: msg.SwapModelRequest) -> msg.SwapModelResponse:
        try:
            if request.payload:
                # a live push: the payload IS the model, an encoded
                # replication blob swapped in without touching disk.
                # The same versioned-put guard as the export path
                dense, _parts = decode_snapshot(request.payload)
                prefix = "params/"
                flat_params = {
                    k[len(prefix):]: v
                    for k, v in dense.items()
                    if k.startswith(prefix)
                }
                flat_state = {
                    k: v for k, v in dense.items() if not k.startswith(prefix)
                }
                accepted, version, reason = self.engine.swap_state_dicts(
                    flat_params,
                    flat_state,
                    int(request.version),
                    source=request.source or "live-push",
                )
            else:
                accepted, version, reason = self.engine.swap_from_export(
                    request.model_dir, min_version=request.min_version
                )
        except (OSError, ValueError, KeyError) as ex:
            return msg.SwapModelResponse(
                accepted=False,
                model_version=int(self.engine.version),
                reason=f"swap failed: {ex}",
            )
        return msg.SwapModelResponse(
            accepted=accepted,
            model_version=int(version),
            reason=reason,
            stale=reason.startswith(STALE_SWAP_PREFIX),
        )


class ServingReplica:
    """The running replica: the dispatch thread and, with ``port`` (0
    picks a free one), the socket server.  ``start``/``close`` bracket
    its lifetime; without a port it serves in process only."""

    def __init__(
        self,
        model_dir: str,
        canonical_rows: int,
        max_wait_secs: float = 0.002,
        device: str | torch.device = "cuda",
        max_queue_rows: int | None = None,
        replica_id: int = 0,
        port: int | None = None,
    ):
        self.engine = ServingEngine(
            model_dir, canonical_rows, device=device, replica_id=replica_id
        )
        self.batcher = MicroBatcher(
            canonical_rows,
            max_wait_secs=max_wait_secs,
            max_queue_rows=max_queue_rows,
        )
        self.servicer = ServingReplicaServicer(
            self.engine, self.batcher, replica_id=replica_id
        )
        self._port_requested = port
        self._server = None
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()

    @property
    def port(self) -> int | None:
        """The bound port (None without a server)."""
        return None if self._server is None else self._server.port

    def start(self):
        self._thread = threading.Thread(
            target=self._dispatch_loop,
            name=f"serving-dispatch-{self.servicer.replica_id}",
            daemon=True,
        )
        self._thread.start()
        if self._port_requested is not None:
            self._server = create_server(
                self.servicer,
                self._port_requested,
                methods=SERVING_METHODS,
                service_name=SERVING_SERVICE_NAME,
            )
            self._server.start()
            logger.info(
                "Serving replica %d up on port %d (%s)",
                self.servicer.replica_id,
                self.port,
                self.engine.device,
            )
        else:
            logger.info("Serving replica started on %s", self.engine.device)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def predict(self, request: msg.PredictRequest) -> msg.PredictResponse:
        return self.servicer.predict(request)

    def _dispatch_loop(self):
        while not self._stopping.is_set():
            group = self.batcher.next_group(0.05)
            if group is None:
                continue
            self.engine.run_group(group)

    def close(self, grace: float = 1.0):
        self._stopping.set()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._server is not None:
            self._server.stop(grace)


class ServingClient(RpcClient):
    """Client stub over the serving method table — the router's
    downstream hop and ``predict --serving_addr``'s upstream.  An
    :class:`~elasticdl_tpu_torch.rpc.service.RpcClient`, so deadlines,
    retries and the message cap apply as on the control plane."""

    def __init__(self, addr: str, retry=None, deadlines=None):
        super().__init__(
            addr,
            methods=SERVING_METHODS,
            retry=retry,
            retryable_methods=SERVING_RETRYABLE_METHODS,
            deadlines=deadlines,
        )

    def predict(self, request: msg.PredictRequest) -> msg.PredictResponse:
        return self._call("predict", request)

    def serving_status(
        self, request: msg.ServingStatusRequest | None = None
    ) -> msg.ServingStatusResponse:
        return self._call(
            "serving_status", request or msg.ServingStatusRequest()
        )

    def swap_model(self, request: msg.SwapModelRequest) -> msg.SwapModelResponse:
        return self._call("swap_model", request)
