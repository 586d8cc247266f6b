"""The control plane's transport: a threaded TCP server for a servicer
object and the clients that call it; the counterpart of
``elasticdl_tpu/rpc/service.py``, on sockets where the JAX package
rides gRPC.

Each call is one connection carrying one request and one response:

    request:  [u32 method_len][method utf-8][u64 len][message frame]
    response: [u8 status][u64 len][message frame, or utf-8 details]

where a message frame is ``rpc/messages.py::encode``'s and an empty one
means ``None``.  Handlers delegate to a transport-agnostic servicer
(``master/servicer.py``), the same object tests call directly.  Status
codes keep gRPC's names: a refused or dropped connection is
``UNAVAILABLE``, a timed-out call ``DEADLINE_EXCEEDED`` (both retryable,
``rpc/retry.py``), an unknown method ``UNIMPLEMENTED``, a handler
that raised ``INTERNAL``, and a request over the message cap
``RESOURCE_EXHAUSTED`` (raised by the client before it sends, as gRPC's
client refuses a message over its send limit).

A server carries one servicer's method table: the master's
(:data:`_METHODS`, the default) or another's, such as the replica
service's (``replication/service.py``: ``push_replica``,
``fetch_replica``), bound through the same :func:`create_server` and
called through the same :class:`RpcClient` with its own table.
"""

from __future__ import annotations

import enum
import socket
import socketserver
import struct
import threading
import traceback

from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import stats as rpc_stats
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

SERVICE_NAME = "elasticdl_tpu.Master"

# the master's control-plane methods the port's workers call
_METHODS = (
    "get_task",
    "get_step_task",
    "report_task_result",
    "report_version",
    "report_evaluation_metrics",
    "heartbeat",
    "get_world_assignment",
    "get_restore_state",
    "rehome_worker",
)

# every master method here is retry-safe (rpc/retry.py's contract), so
# the MasterClient opts them all in when a retry policy is installed
MASTER_RETRYABLE_METHODS = frozenset(_METHODS)

# the JAX package's 256 MB message cap (utils/constants.py GRPC)
MAX_MESSAGE_BYTES = 256 * 1024 * 1024

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


class StatusCode(enum.Enum):
    OK = 0
    UNAVAILABLE = 14
    DEADLINE_EXCEEDED = 4
    RESOURCE_EXHAUSTED = 8
    UNIMPLEMENTED = 12
    INTERNAL = 13


_RETRYABLE_CODES = frozenset(
    {StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED}
)


class RpcError(Exception):
    """A failed call, with gRPC's ``code()``/``details()`` surface."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


def _retryable_error(ex) -> bool:
    code = getattr(ex, "code", None)
    return callable(code) and code() in _RETRYABLE_CODES


def _note_rpc_failure(ex):
    """Mirror an outage-class failure into the process-local stats the
    heartbeat ships to the master."""
    code = getattr(ex, "code", None)
    if callable(code):
        rpc_stats.note_failure(code().name.lower())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError(f"connection closed after {got} of {n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_sized(sock: socket.socket) -> bytes:
    (length,) = _U64.unpack(_recv_exact(sock, _U64.size))
    if length > MAX_MESSAGE_BYTES:
        raise ConnectionError(f"message of {length} bytes over the cap")
    return _recv_exact(sock, length)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        server = self.server
        sock = self.request
        try:
            (name_len,) = _U32.unpack(_recv_exact(sock, _U32.size))
            name = _recv_exact(sock, name_len).decode("utf-8")
            payload = _recv_sized(sock)
        except (ConnectionError, OSError):
            return
        status, body = StatusCode.OK, b""
        if name not in server.methods:
            status = StatusCode.UNIMPLEMENTED
            body = f"{server.service_name}/{name}".encode("utf-8")
        else:
            try:
                request = msg.decode(payload)
                response = getattr(server.servicer, name)(request)
                body = msg.encode(response) if response is not None else b""
            except Exception:  # noqa: BLE001 — reported to the caller
                status = StatusCode.INTERNAL
                body = traceback.format_exc().encode("utf-8")
                logger.exception("RPC handler %s failed", name)
        try:
            sock.sendall(_U8.pack(status.value) + _U64.pack(len(body)) + body)
        except OSError:
            pass  # the caller gave up (its deadline): nothing to tell


class _ThreadingServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class RpcServer:
    """A servicer behind a threaded TCP server on ``port`` (0 picks a free
    one); ``start`` serves on a daemon thread, ``stop`` closes it."""

    def __init__(self, servicer, port: int, methods, service_name: str):
        self._server = _ThreadingServer(("", port), _Handler)
        self._server.servicer = servicer
        self._server.methods = frozenset(methods)
        self._server.service_name = service_name
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="rpc-server",
            daemon=True,
        )
        self._thread.start()

    def stop(self, grace: float | None = None):
        """Stop accepting calls and close the socket; handlers still
        running finish on their own threads."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=grace)
            self._thread = None
        self._server.server_close()


def create_server(
    servicer,
    port: int,
    methods: tuple[str, ...] = _METHODS,
    service_name: str = SERVICE_NAME,
) -> RpcServer:
    """Bind a servicer (not started yet: call ``start``)."""
    server = RpcServer(servicer, port, methods, service_name)
    logger.info("%s server bound to port %d", service_name, server.port)
    return server


def _split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "localhost", int(port)


class RpcClient:
    """A stub over the socket transport, the counterpart of the JAX
    package's ``RpcClient``.

    ``retry`` (a :class:`~elasticdl_tpu_torch.rpc.retry.RetryPolicy`)
    makes outage-class failures (UNAVAILABLE / DEADLINE_EXCEEDED) back
    off and re-send instead of raising — only for methods named in
    ``retryable_methods`` (default: the read-only subset).
    ``resolve_addr`` is the re-resolve hook: called after repeated
    failures, and a changed address becomes the one later attempts
    connect to — how a worker follows a master relaunched on another
    port (the JAX client rebuilds its channel; a socket client has only
    the address tuple to swap).  ``deadlines`` (a
    :class:`~elasticdl_tpu_torch.rpc.deadline.DeadlinePolicy`) gives
    each call a timeout when the caller passes none.  With none of the
    three, a call fails fast and may wait forever."""

    # failed attempts between re-resolve probes (the first probe fires
    # early so a fast master relaunch is caught within ~2 backoffs)
    _RERESOLVE_EVERY = 2

    def __init__(
        self,
        addr: str,
        methods: tuple[str, ...] = _METHODS,
        retry=None,
        retryable_methods: frozenset[str] | set[str] | None = None,
        deadlines=None,
        resolve_addr=None,
    ):
        self._addr = _split_addr(addr)  # guarded-by: _addr_lock (writes)
        self._addr_lock = threading.Lock()
        self._resolve_addr = resolve_addr
        self._methods = tuple(methods)
        self._retry = retry
        self._deadlines = deadlines
        if retryable_methods is None:
            from elasticdl_tpu_torch.rpc.retry import DEFAULT_IDEMPOTENT

            retryable_methods = DEFAULT_IDEMPOTENT
        self._retryable = frozenset(retryable_methods) & set(methods)

    @property
    def addr(self) -> str:
        host, port = self._addr
        return f"{host}:{port}"

    def _maybe_reresolve(self, attempt: int):
        """on_retry hook: every few failures, re-read the master address
        and connect there from the next attempt on if it moved."""
        if self._resolve_addr is None or attempt % self._RERESOLVE_EVERY != 0:
            return
        try:
            addr = self._resolve_addr()
        except Exception:  # noqa: BLE001 — a broken resolver must not
            # end the retry loop; the old address may still come back
            logger.exception("Master address re-resolution failed")
            return
        if not addr:
            return
        new = _split_addr(addr)
        with self._addr_lock:
            if new == self._addr:
                return
            logger.warning(
                "Master address changed %s -> %s; reconnecting", self.addr, addr
            )
            self._addr = new

    def _invoke(self, name: str, payload: bytes, timeout: float | None) -> bytes:
        """One wire attempt."""
        method = name.encode("utf-8")
        try:
            # one read: a concurrent re-resolve swaps the whole tuple
            with socket.create_connection(self._addr, timeout=timeout) as sock:
                sock.sendall(
                    _U32.pack(len(method)) + method
                    + _U64.pack(len(payload)) + payload
                )
                (status,) = _U8.unpack(_recv_exact(sock, _U8.size))
                body = _recv_sized(sock)
        except socket.timeout as ex:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, f"{name}: {ex}") from ex
        except OSError as ex:  # refused, reset, closed mid-call
            raise RpcError(StatusCode.UNAVAILABLE, f"{name}: {ex}") from ex
        code = StatusCode(status)
        if code != StatusCode.OK:
            raise RpcError(code, body.decode("utf-8", "replace"))
        return body

    def _call(self, name, request, timeout: float | None = None):
        if name not in self._methods:
            raise RpcError(StatusCode.UNIMPLEMENTED, name)
        if timeout is None and self._deadlines is not None:
            timeout = self._deadlines.deadline_for(name)
        payload = msg.encode(request)
        if len(payload) > MAX_MESSAGE_BYTES:
            # the server would drop it unread: refuse it here, loudly,
            # and never as a retryable outage
            raise RpcError(
                StatusCode.RESOURCE_EXHAUSTED,
                f"{name}: a request of {len(payload)} bytes is over the "
                f"{MAX_MESSAGE_BYTES}-byte message cap",
            )
        if self._retry is None or name not in self._retryable:
            try:
                out = self._invoke(name, payload, timeout)
            except Exception as ex:  # noqa: BLE001 — re-raised below
                _note_rpc_failure(ex)
                raise
            return msg.decode(out) if out else None
        from elasticdl_tpu_torch.rpc.retry import call_with_retry

        def is_retryable(ex):
            retryable = _retryable_error(ex)
            if retryable:
                _note_rpc_failure(ex)
            return retryable

        def on_retry(attempt, _ex):
            rpc_stats.note_retry()
            self._maybe_reresolve(attempt)

        out = call_with_retry(
            lambda: self._invoke(name, payload, timeout),
            self._retry,
            is_retryable=is_retryable,
            on_retry=on_retry,
        )
        return msg.decode(out) if out else None


class MasterClient(RpcClient):
    """Worker-side stub with the servicer's method names and dataclasses,
    so worker code is the same over the wire or in process."""

    def get_task(self, request: msg.GetTaskRequest) -> msg.TaskResponse:
        return self._call("get_task", request)

    def get_step_task(self, request: msg.GetStepTaskRequest) -> msg.TaskResponse:
        return self._call("get_step_task", request)

    def report_task_result(self, request: msg.ReportTaskResultRequest):
        return self._call("report_task_result", request)

    def report_version(self, request: msg.ReportVersionRequest):
        return self._call("report_version", request)

    def report_evaluation_metrics(self, request: msg.ReportEvaluationMetricsRequest):
        return self._call("report_evaluation_metrics", request)

    def heartbeat(self, request: msg.HeartbeatRequest) -> msg.HeartbeatResponse:
        return self._call("heartbeat", request)

    def get_world_assignment(
        self, request: msg.GetWorldAssignmentRequest
    ) -> msg.WorldAssignmentResponse:
        return self._call("get_world_assignment", request)

    def get_restore_state(
        self, request: msg.GetRestoreStateRequest
    ) -> msg.RestoreStateResponse:
        return self._call("get_restore_state", request)

    def rehome_worker(self, request: msg.RehomeRequest) -> msg.RehomeResponse:
        return self._call("rehome_worker", request)
