"""The master's telemetry HTTP endpoint, ``/metrics`` and ``/healthz``;
the counterpart of ``elasticdl_tpu/telemetry/httpd.py``.

A standard-library ``ThreadingHTTPServer`` on a daemon thread: a scrape
never touches the control-plane port or the run loop.  ``/metrics``
serves the registry's Prometheus text; ``/healthz`` a JSON snapshot from
a caller's callable (generation, live workers, model version, quiesce),
so the server holds no master state.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryHTTPServer:
    def __init__(
        self,
        registry,
        health_fn=None,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        """``host`` defaults to loopback: the endpoint is unauthenticated,
        so exposing it beyond the machine (``--metrics_host 0.0.0.0`` for
        a k8s scrape sidecar) is an explicit operator decision."""
        self._registry = registry
        self._health_fn = health_fn
        self._requested_port = port
        self._host = host
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int | None:
        return self._server.server_address[1] if self._server else None

    def start(self):
        registry, health_fn = self._registry, self._health_fn

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = registry.exposition().encode("utf-8")
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif path == "/healthz":
                    payload = health_fn() if health_fn is not None else {}
                    body = json.dumps(payload).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrape noise does not belong in the job log

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="telemetry-http",
            daemon=True,
        )
        self._thread.start()
        logger.info("Telemetry endpoint on :%d (/metrics, /healthz)", self.port)

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
