"""``python -m elasticdl_tpu_torch.serving.main`` — the prediction
service; the counterpart of ``elasticdl_tpu/serving/main.py``.

Two roles, one binary (the master/worker spawn pattern):

- **frontend** (default): binds the router on ``--port``, spawns
  ``--num_replicas`` replica subprocesses, registers them as their port
  files land, and runs the liveness probe beat.  ``--addr_file``
  publishes the bound address atomically, so a caller discovers an
  ephemeral port without parsing logs.  The frontend never touches the
  device: it passes ``--device`` on to its replicas.
- **replica** (spawned): engine + micro-batcher + dispatch thread on
  ``--device`` (``cuda``, the default, or ``cpu``) behind its own port,
  written to ``--port_file``; with ``--watch_model`` it hot-swaps when a
  newer export lands in ``--model_dir``.

Replicas never outlive their frontend: a frontend that fails to start,
or gets SIGTERM or SIGINT, terminates them, and a replica whose parent
is gone (a frontend killed outright) stops by itself.

Every flag defaults to a served-locally-sane value; the serving CLI is
its own argparse surface.  ``--telemetry_dir`` (or the inherited
``ELASTICDL_TPU_TELEMETRY_DIR``) installs the span tracer in the
frontend (role ``router``) and in each replica (role ``replica``, by
env), so one predict request is one trace in ``spans.jsonl``.  The
other telemetry flags (``--metrics_port``, ``--metrics_addr_file``,
``--slo_config``) parse as in the JAX package and raise
``NotImplementedError`` when set: the port's serving metrics, /healthz
and SLO watchdog come with slice 10b-2.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

DEFAULT_MAX_WAIT_MS = 2.0
DEFAULT_DEADLINE_SECS = 5.0
PORT_FILE_WAIT_SECS = 120.0

_TELEMETRY = (
    "it comes with slice 10b-2, serving metrics and the SLO watchdog "
    "(ROADMAP.md queue 1)"
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="elasticdl_tpu_torch.serving",
        description="ElasticDL serving on PyTorch",
    )
    parser.add_argument(
        "--model_dir",
        required=True,
        help="Exported model directory (manifest.json + params.npz)",
    )
    parser.add_argument(
        "--port",
        type=int,
        default=0,
        help="Front-door port (0 = ephemeral; see --addr_file)",
    )
    parser.add_argument(
        "--num_replicas",
        type=int,
        default=1,
        help="Serving worker subprocesses behind the router",
    )
    parser.add_argument(
        "--minibatch_size",
        type=int,
        default=64,
        help="The canonical batch shape every dispatch is padded to",
    )
    parser.add_argument(
        "--max_wait_ms",
        type=float,
        default=DEFAULT_MAX_WAIT_MS,
        help=(
            "Micro-batch coalescing window: how long the oldest queued "
            "row may wait for the batch to fill (0 = dispatch "
            "immediately)"
        ),
    )
    parser.add_argument(
        "--max_queue_rows",
        type=int,
        default=0,
        help=(
            "Bounded-queue row cap per replica; beyond it requests are "
            "shed with a retryable overload error (0 = 32 batches)"
        ),
    )
    parser.add_argument(
        "--rpc_deadline_secs",
        type=float,
        default=DEFAULT_DEADLINE_SECS,
        help="Per-call deadline router->replica (liveness floor)",
    )
    parser.add_argument(
        "--evict_after_secs",
        type=float,
        default=10.0,
        help="Evict a replica from rotation after this much probe silence",
    )
    parser.add_argument(
        "--watch_model",
        action="store_true",
        help=(
            "Poll --model_dir's manifest and hot-swap when a newer "
            "model_version lands (the train->serve loop)"
        ),
    )
    parser.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="Where the replicas run the model (the frontend uses none)",
    )
    parser.add_argument(
        "--metrics_port",
        type=int,
        default=-1,
        help="/metrics + /healthz port (not ported: slice 10b-2)",
    )
    parser.add_argument(
        "--slo_config", default="", help="SLO watchdog (not ported: slice 10b-2)"
    )
    parser.add_argument(
        "--telemetry_dir", default="",
        help="Write the serving spans (spans.jsonl) into this directory",
    )
    parser.add_argument("--addr_file", default="")
    parser.add_argument(
        "--metrics_addr_file", default="", help="not ported: slice 10b-2"
    )
    # spawned-replica internals
    parser.add_argument("--role", default="frontend", choices=["frontend", "replica"])
    parser.add_argument("--replica_id", type=int, default=0)
    parser.add_argument("--port_file", default="")
    return parser


def check_ported_flags(args) -> None:
    """Raise ``NotImplementedError`` naming the first telemetry flag set
    to anything but its default."""
    for flag, unset in (
        ("metrics_port", lambda v: v < 0),
        ("metrics_addr_file", lambda v: not v),
        ("slo_config", lambda v: not v),
    ):
        value = getattr(args, flag)
        if not unset(value):
            raise NotImplementedError(
                f"--{flag}={value!r} is not ported: {_TELEMETRY}"
            )


def _write_atomic(path: str, text: str):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


def _canonical_rows(minibatch_size: int) -> int:
    from elasticdl_tpu_torch.trainer.stacking import canonical_batch_rows

    # a replica serves on one device: the batch divisor is 1
    return canonical_batch_rows(minibatch_size, 1)


def _wait_for_signal(still_ok=lambda: True):
    """Block until SIGTERM or SIGINT, or until ``still_ok()`` is False."""
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop.set())
    while not stop.wait(0.5):
        if not still_ok():
            return


def _install_telemetry(args) -> str:
    """The span tracer of this serving process, from ``--telemetry_dir``
    or the inherited env; the directory ("" for none).  Spans carry the
    serving role, so the trace export lays out one track per replica
    and one for the router."""
    from elasticdl_tpu_torch.telemetry import tracing, worker_hooks

    telemetry_dir = args.telemetry_dir or os.environ.get(worker_hooks.TELEMETRY_DIR_ENV, "")
    tracing.install(
        telemetry_dir,
        role="replica" if args.role == "replica" else "router",
        worker_id=args.replica_id,
    )
    return telemetry_dir


# ---- replica role ------------------------------------------------------------


def run_replica(args) -> int:
    from elasticdl_tpu_torch.serving.engine import ExportDirWatcher
    from elasticdl_tpu_torch.serving.replica import ServingReplica
    from elasticdl_tpu_torch.telemetry import tracing

    _install_telemetry(args)
    parent = os.getppid()
    replica = ServingReplica(
        args.model_dir,
        _canonical_rows(args.minibatch_size),
        max_wait_secs=args.max_wait_ms / 1000.0,
        device=args.device,
        max_queue_rows=args.max_queue_rows or None,
        replica_id=args.replica_id,
        port=args.port,
    ).start()
    watcher = None
    try:
        if args.port_file:
            _write_atomic(args.port_file, str(replica.port))
        if args.watch_model:
            watcher = ExportDirWatcher(replica.engine, args.model_dir)
            watcher.start()
        # a frontend killed outright cannot terminate its replicas: a
        # replica whose parent is gone stops by itself
        _wait_for_signal(lambda: os.getppid() == parent)
    finally:
        if watcher is not None:
            watcher.close()
        replica.close()
        # the replica buffers its queue, engine and dispatch spans: a
        # graceful stop must not strand the tail of the request traces
        tracing.flush()
    return 0


# ---- frontend role -----------------------------------------------------------


def _replica_argv(args, i: int, workdir: str) -> list[str]:
    """A spawned replica's exact command line — pure, so a test can pin
    it: the JAX package's, with this package's module and ``--device``
    at the end.  Observability settings never travel here."""
    argv = [
        sys.executable,
        "-m",
        "elasticdl_tpu_torch.serving.main",
        "--role",
        "replica",
        "--replica_id",
        str(i),
        "--model_dir",
        args.model_dir,
        "--port",
        "0",
        "--port_file",
        os.path.join(workdir, f"replica_{i}.port"),
        "--minibatch_size",
        str(args.minibatch_size),
        "--max_wait_ms",
        str(args.max_wait_ms),
        "--max_queue_rows",
        str(args.max_queue_rows),
        "--metrics_port",
        "-1",
    ]
    if args.watch_model:
        argv.append("--watch_model")
    argv += ["--device", args.device]
    return argv


def _spawn_replicas(args, workdir: str) -> list[subprocess.Popen]:
    env = None
    if args.telemetry_dir:
        # by env, as the JAX frontend passes it: the argv stays the same
        from elasticdl_tpu_torch.telemetry.worker_hooks import TELEMETRY_DIR_ENV

        env = dict(os.environ, **{TELEMETRY_DIR_ENV: args.telemetry_dir})
    return [
        subprocess.Popen(_replica_argv(args, i, workdir), env=env)
        for i in range(args.num_replicas)
    ]


def _await_ports(workdir: str, n: int, procs) -> list[int]:
    deadline = time.monotonic() + PORT_FILE_WAIT_SECS
    ports: list[int | None] = [None] * n
    while time.monotonic() < deadline:
        for i in range(n):
            if ports[i] is not None:
                continue
            path = os.path.join(workdir, f"replica_{i}.port")
            try:
                with open(path, encoding="utf-8") as f:
                    ports[i] = int(f.read().strip())
            except (OSError, ValueError):
                pass
        if all(p is not None for p in ports):
            return ports  # type: ignore[return-value]
        for i, proc in enumerate(procs):
            if proc.poll() is not None and ports[i] is None:
                raise RuntimeError(
                    f"serving replica {i} exited rc={proc.returncode} "
                    "before binding its port"
                )
        time.sleep(0.1)
    raise RuntimeError(f"serving replicas not up after {PORT_FILE_WAIT_SECS}s")


def _stop_replicas(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run_frontend(args) -> int:
    from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
    from elasticdl_tpu_torch.rpc.service import create_server
    from elasticdl_tpu_torch.serving.replica import (
        SERVING_METHODS,
        SERVING_SERVICE_NAME,
    )
    from elasticdl_tpu_torch.serving.router import ServingRouter
    from elasticdl_tpu_torch.telemetry import tracing

    _install_telemetry(args)
    deadlines = (
        DeadlinePolicy.from_secs(args.rpc_deadline_secs)
        if args.rpc_deadline_secs
        else None
    )
    router = ServingRouter(
        deadlines=deadlines, evict_after_secs=args.evict_after_secs
    )
    # a SIGTERM while starting up unwinds through the finally below
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, _frame: sys.exit(128 + signum))
    workdir = tempfile.mkdtemp(prefix="edl_serving_")
    procs = _spawn_replicas(args, workdir)
    server = None
    try:
        # EVERY startup step sits inside this try: a bind failure (port
        # taken), a router error, anything — the spawned replica
        # subprocesses must never outlive a frontend that dies before
        # its signal-driven shutdown loop
        ports = _await_ports(workdir, args.num_replicas, procs)
        for port in ports:
            router.add_replica(f"localhost:{port}")
        router.probe_once()  # seed liveness before the first request
        router.start()
        server = create_server(
            router,
            args.port,
            methods=SERVING_METHODS,
            service_name=SERVING_SERVICE_NAME,
        )
        server.start()
        if args.addr_file:
            _write_atomic(args.addr_file, f"localhost:{server.port}")
        logger.info(
            "Serving frontend up on port %d (%d replicas on %s: %s)",
            server.port,
            len(ports),
            args.device,
            ports,
        )

        def replicas_alive() -> bool:
            nonlocal procs
            exited = [p for p in procs if p.poll() is not None]
            for proc in exited:
                logger.warning(
                    "Serving replica exited rc=%d (router will evict it; "
                    "remaining replicas keep serving)",
                    proc.returncode,
                )
            procs = [p for p in procs if p.poll() is None]
            return True

        _wait_for_signal(replicas_alive)
    finally:
        if server is not None:
            server.stop(1.0)
        router.close()
        _stop_replicas(procs)
        shutil.rmtree(workdir, ignore_errors=True)
        # the router's route spans survive a graceful stop too
        tracing.flush()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_ported_flags(args)
    if args.role == "replica":
        return run_replica(args)
    return run_frontend(args)


if __name__ == "__main__":
    sys.exit(main())
