"""The structured event log of a run (append-only JSONL); the counterpart
of ``elasticdl_tpu/telemetry/events.py``.

One file per run (``<telemetry_dir>/events.jsonl``), shared by the
master and every worker process through ``O_APPEND``: one ``write`` per
line, so lines of concurrent writers never interleave, and a torn last
line of a killed writer is skipped on read.  The master journal reads
and rotates through the same helpers (:func:`rotate_if_needed`,
:func:`read_jsonl`).

Every record carries ``time`` (wall clock), ``monotonic`` (the
machine-wide ``CLOCK_MONOTONIC``: processes of one host subtract across
each other) and ``event``; the lifecycle context (``generation``,
``step``, ``worker_id``, ...) rides as flat keys.  The event names are
the JAX package's, defined once below; the port emits the ones of its
ported features.

Long logs must not fill the disk: once the active JSONL crosses the size
cap it is shifted to ``<path>.1`` (older shards move to ``.2``, ``.3``,
...; the oldest beyond ``ROTATE_KEEP_SHARDS`` is overwritten).  Rotation
is rename-based so concurrent O_APPEND writers stay correct: a writer
holding the pre-rotation fd keeps appending into the renamed shard, and
a racing second rotation just loses the rename.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# ---- event vocabulary (one definition site per name) ------------------------

EVENT_JOB_START = "job_start"
EVENT_JOB_END = "job_end"
EVENT_STEP = "step"
EVENT_TASK_DISPATCH = "task_dispatch"
EVENT_TASK_DONE = "task_done"
EVENT_TASK_RECOVERED = "task_recovered"
EVENT_WORKER_DEAD = "worker_dead"
EVENT_QUIESCE_BEGIN = "quiesce_begin"
EVENT_QUIESCE_END = "quiesce_end"
EVENT_REFORM_START = "reform_start"
EVENT_REFORM_COMPLETE = "reform_complete"
EVENT_REFORM_LATENCY = "reform_latency"
EVENT_WORKER_TIMING = "worker_timing"
EVENT_CHECKPOINT_SAVE = "checkpoint_save"
EVENT_CHECKPOINT_RESTORE = "checkpoint_restore"
EVENT_FAULT_INJECTED = "fault_injected"
EVENT_PROFILE_WINDOW_OPEN = "profile_window_open"
EVENT_PROFILE_WINDOW_CLOSE = "profile_window_close"
# peer state replication (replication/): a worker pushed its
# state shard to its ring neighbor / the master harvested a complete
# replica set during reform / a re-formed world restored from peer RAM
EVENT_REPLICA_PUSH = "replica_push"
EVENT_REPLICA_HARVEST = "replica_harvest"
EVENT_REPLICA_RESTORE = "replica_restore"
# master high availability (master/journal.py): a master process came up
# restored from the control-plane journal / finished replaying it / a
# worker that outlived the outage re-homed onto the restarted master
EVENT_MASTER_RESTART = "master_restart"
EVENT_JOURNAL_REPLAY = "journal_replay"
EVENT_WORKER_REHOME = "worker_rehome"
# slice-granular elasticity: a whole slice's processes died (reform
# shrinks to the survivors, or parks below --min_slices) / the hybrid
# mesh was re-planned for a new slice set (dp axis resized over DCN) /
# the autoscaler requested a grow/shrink on an SLO crossing
EVENT_SLICE_LOSS = "slice_loss"
EVENT_MESH_RESIZE = "mesh_resize"
EVENT_AUTOSCALE_DECISION = "autoscale_decision"
# network chaos (chaos/netem.py): a transport-level fault fired at the
# RPC seam — injected latency window, blackhole, duplicate delivery,
# UNAVAILABLE, or one-way partition (distinct from fault_injected: the
# process lives, only its link degrades)
EVENT_RPC_FAULT_INJECTED = "rpc_fault_injected"
# step anatomy (telemetry/anatomy.py): one event per dispatch group
# carrying the sum-exact phase decomposition (host_fetch / assemble /
# h2d_transfer / device_compute / step_bookkeeping / untracked, in ms)
# — the data the report's goodput section is computed from
EVENT_STEP_ANATOMY = "step_anatomy"
# online serving plane (serving/): one event per completed
# predict request carrying its sum-exact phase decomposition
# (queue_wait / assemble / h2d_transfer / device_compute / d2h_transfer
# / untracked, in ms) / a replica hot-swapped its model state to a new
# version with in-flight requests still draining on the old one
EVENT_SERVING_REQUEST = "serving_request"
EVENT_MODEL_SWAP = "model_swap"
# fleet-scale control-plane simulation (fleetsim, slice 11): one
# event per injected mass fault (mass preemption wave, rolling slice
# loss, master kill) with its virtual firing time — the source of the
# report's control-plane scale section fault timeline
EVENT_FLEET_FAULT = "fleet_fault"
# memory observability plane (telemetry/memory.py): one event per
# ledger sample (periodic + phase edges: reform, model swap,
# checkpoint) carrying per-component bytes, peaks, host RSS and the
# explicit unaccounted residual / host MemAvailable crossed below the
# pressure fraction (entered=True) or recovered above it
EVENT_MEMORY_SAMPLE = "memory_sample"
EVENT_MEMORY_PRESSURE = "memory_pressure"
# sharded embedding subsystem (embeddings): one event per
# host-tier pull of unique rows into the fixed-capacity device
# minitable (the XLA-era pull_embedding_vector) with row/byte counts /
# a table admission FAILED — neither the device budget nor the host-RAM
# headroom (memory ledger) admits it, so the caller must shrink or
# re-place the table rather than walk the host into OOM
EVENT_EMBEDDING_GATHER = "embedding_gather"
EVENT_EMBEDDING_SPILL_FAULT = "embedding_spill_fault"
# SLO watchdog plane (telemetry/slo.py + telemetry/incident.py): a
# burn-rate detector fired (violation) / cleared through the
# hysteresis band (recovered); an incident opened on the first
# violation of an unhealthy episode / closed when every objective
# recovered, pointing at the incidents/incident_<n>.json postmortem
EVENT_SLO_VIOLATION = "slo_violation"
EVENT_SLO_RECOVERED = "slo_recovered"
EVENT_INCIDENT_OPEN = "incident_open"
EVENT_INCIDENT_CLOSE = "incident_close"
# streaming subsystem (streaming, slice 9): one event per master
# poll tick in watermark-lease mode carrying the source/trained
# watermark pair (stream_watermark) and the lag derived from it
# (stream_lag — the autoscaler's backlog signal and the bounded-lag
# chaos invariant's evidence); one event per live train->serve push
# (live_push) stamping trained-watermark-at-swap vs source watermark —
# the freshness ledger's rows (staleness = source - trained at push)
EVENT_STREAM_WATERMARK = "stream_watermark"
EVENT_STREAM_LAG = "stream_lag"
EVENT_LIVE_PUSH = "live_push"

EVENTS_FILENAME = "events.jsonl"

ROTATE_MAX_BYTES = 64 * 1024 * 1024
ROTATE_KEEP_SHARDS = 3
ROTATE_MAX_MB_ENV = "ELASTICDL_TPU_TELEMETRY_LOG_MAX_MB"


def rotate_if_needed(
    path: str,
    max_bytes: int | None = None,
    keep_shards: int | None = None,
):
    """Shift ``path`` into numbered shards once it crosses the cap."""
    if not path:
        return
    if max_bytes is None:
        try:
            max_bytes = int(
                float(os.environ.get(ROTATE_MAX_MB_ENV, 0)) * 1024 * 1024
            ) or ROTATE_MAX_BYTES
        except ValueError:
            max_bytes = ROTATE_MAX_BYTES
    keep = keep_shards if keep_shards is not None else ROTATE_KEEP_SHARDS
    try:
        if os.path.getsize(path) < max_bytes:
            return
    except OSError:
        return
    try:
        for i in range(keep - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")
    except OSError:
        # a concurrent writer rotated first; its shift already applied
        pass


def _shard_paths(path: str) -> list[str]:
    """All shards of one log, oldest first (highest index), active last."""
    shards = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        shards.append(f"{path}.{i}")
        i += 1
    shards.reverse()
    if os.path.exists(path):
        shards.append(path)
    return shards


class EventLog:
    """Append-only JSONL writer; a no-path log swallows every emit, so
    callers never branch on whether telemetry is configured.

    ``async_writes=True`` moves the disk write to a daemon thread: the
    master emits from under the TaskDispatcher lock (observer
    callbacks), so a synchronous write there would serialize every
    worker's get-task/report RPC behind file I/O.  Timestamps are taken
    at EMIT time either way; ``flush()`` drains the queue (the master
    calls it at job end).  Workers keep the default synchronous write —
    their emits are on the training thread only, and a SIGKILL'd
    process (chaos preempt) must not lose its final queued events.
    """

    def __init__(self, path: str = "", async_writes: bool = False):
        self._path = path
        self._async = async_writes and bool(path)
        self._queue: queue.SimpleQueue | None = None
        self._thread: threading.Thread | None = None
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        if self._async:
            self._queue = queue.SimpleQueue()
            self._thread = threading.Thread(
                target=self._drain, name="telemetry-events", daemon=True
            )
            self._thread.start()

    @property
    def path(self) -> str:
        return self._path

    @property
    def enabled(self) -> bool:
        return bool(self._path)

    def emit(self, event: str, **fields):
        if not self._path:
            return
        record = {
            "time": time.time(),
            "monotonic": time.monotonic(),
            "event": event,
            **fields,
        }
        if self._async:
            self._queue.put(record)
        else:
            self._write(record)

    def flush(self, timeout: float = 5.0):
        """Block until everything queued so far is on disk (async logs
        only; a synchronous log is always flushed)."""
        if not self._async:
            return
        done = threading.Event()
        self._queue.put(done)
        done.wait(timeout)

    def _drain(self):
        while True:
            item = self._queue.get()
            if isinstance(item, threading.Event):
                item.set()
                continue
            self._write(item)

    def _write(self, record: dict):
        try:
            rotate_if_needed(self._path)
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            logger.exception("Telemetry event log write failed")


def read_jsonl(path: str) -> list[dict]:
    """Parse one JSONL log INCLUDING its rotated shards (oldest first);
    torn lines (a writer killed mid-write) are skipped."""
    records: list[dict] = []
    for shard in _shard_paths(path):
        try:
            with open(shard, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return records


def read_events(path: str) -> list[dict]:
    """The event log's reader (the JAX package's name for it)."""
    return read_jsonl(path)
