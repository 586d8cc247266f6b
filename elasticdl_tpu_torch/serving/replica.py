"""One serving worker: engine + micro-batcher + dispatch thread, in process.

The counterpart of ``elasticdl_tpu/serving/replica.py`` without its
transport: requests and responses are plain dataclasses carrying numpy
feature trees, and callers invoke :meth:`ServingReplicaServicer.predict`
directly (the JAX package wraps the same servicer in gRPC + msgpack,
which comes to the port in a later slice, with ``serving_status``,
``swap_model`` and the router).

Threads: any number of request threads submit tickets and block on
them; ONE dispatch thread drains the batcher into the engine.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import torch

from elasticdl_tpu_torch.serving.batcher import (
    MicroBatcher,
    ServingError,
    ServingOverloadError,
)
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# a request's wait inside ONE replica is bounded by the batcher wait +
# dispatch time; the ticket wait below is a backstop for a wedged
# dispatch thread, not a latency target
TICKET_WAIT_SECS = 60.0


@dataclass
class PredictRequest:
    """One inference request: ``rows`` rows of features (any row count —
    the micro-batcher coalesces/splits them into the canonical shape)."""

    request_id: str = ""
    features: Any = None  # numpy array or dict of numpy arrays
    rows: int = 0


@dataclass
class PredictResponse:
    outputs: Any = None  # numpy array or dict of numpy arrays
    model_version: int = -1
    rows: int = 0
    # sum-exact per-request anatomy, ms keyed by serving phase name
    # (queue_wait/assemble/h2d_transfer/device_compute/d2h_transfer/
    # untracked) plus total_ms; empty on error responses
    phases: dict = field(default_factory=dict)
    # non-empty = the request failed; retryable errors are marked
    error: str = ""
    retryable: bool = False


class ServingReplicaServicer:
    """Transport-agnostic servicer: tests and in-process callers call
    :meth:`predict` directly."""

    def __init__(self, engine: ServingEngine, batcher: MicroBatcher):
        self.engine = engine
        self.batcher = batcher
        self.rejected = 0

    def predict(self, request: PredictRequest) -> PredictResponse:
        try:
            features = request.features
            if not self.engine.built:
                # cold start: build + LOCK the feature spec from this
                # request BEFORE anything enters the queue — otherwise a
                # malformed concurrent first request could coalesce into
                # (and poison) a valid request's dispatch group
                self.engine.ensure_built(features)
            features = self.engine.conform(features)
            ticket = self.batcher.submit(request.request_id, features)
        except ServingOverloadError as ex:
            self.rejected += 1
            return PredictResponse(error=str(ex), retryable=True)
        except ServingError as ex:
            self.engine.errors += 1
            return PredictResponse(
                error=str(ex), retryable=bool(getattr(ex, "retryable", False))
            )
        except Exception as ex:  # noqa: BLE001 — malformed payloads must
            # answer, not kill the handler thread
            return PredictResponse(error=f"bad request: {ex}")
        try:
            outputs = ticket.result(TICKET_WAIT_SECS)
        except ServingError as ex:
            return PredictResponse(
                error=str(ex), retryable=bool(getattr(ex, "retryable", False))
            )
        except TimeoutError as ex:
            return PredictResponse(error=str(ex), retryable=True)
        except Exception as ex:  # noqa: BLE001 — dispatch errors carry over
            return PredictResponse(error=f"dispatch failed: {ex}")
        phases_ms = {
            name: secs * 1000.0 for name, secs in ticket.phases_secs.items()
        }
        phases_ms["total_ms"] = ticket.total_secs() * 1000.0
        return PredictResponse(
            outputs=outputs,
            model_version=int(ticket.model_version),
            rows=int(ticket.rows),
            phases=phases_ms,
        )


class ServingReplica:
    """The running replica: ``start`` launches the dispatch thread,
    ``close`` drains it."""

    def __init__(
        self,
        model_dir: str,
        canonical_rows: int,
        max_wait_secs: float = 0.002,
        device: str | torch.device = "cuda",
    ):
        self.engine = ServingEngine(
            model_dir, canonical_rows, device=device
        )
        self.batcher = MicroBatcher(canonical_rows, max_wait_secs=max_wait_secs)
        self.servicer = ServingReplicaServicer(self.engine, self.batcher)
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()

    def start(self):
        self._thread = threading.Thread(
            target=self._dispatch_loop,
            name="serving-dispatch",
            daemon=True,
        )
        self._thread.start()
        logger.info("Serving replica started on %s", self.engine.device)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def predict(self, request: PredictRequest) -> PredictResponse:
        return self.servicer.predict(request)

    def _dispatch_loop(self):
        while not self._stopping.is_set():
            group = self.batcher.next_group(0.05)
            if group is None:
                continue
            self.engine.run_group(group)

    def close(self):
        self._stopping.set()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
