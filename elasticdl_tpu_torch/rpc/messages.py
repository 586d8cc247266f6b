"""Control-plane and serving message types; the dataclasses of
``elasticdl_tpu/rpc/messages.py`` that the workers, the replica service
and the serving plane use, with the same field names and defaults.

The JAX package serializes them with msgpack.  The port's codec is the
standard library's: one frame is

    [u32 header_len][header json][tensor frame 0][tensor frame 1]...

The header holds the message kind, its fields (``dataclasses.asdict``)
and the byte length of each frame.  A ``utils.tensor.Tensor`` anywhere
inside a field's dicts or lists leaves the JSON as ``{"__tensor__": i}``
and rides as raw frame ``i`` (``Tensor.to_bytes``); a ``bytes`` value (a
replica shard's payload) leaves it as ``{"__bytes__": i}`` and rides as
frame ``i`` unchanged.  So neither is ever text-encoded.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field, fields

import numpy as np

from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.tensor import (
    Tensor,
    deserialize_tensors,
    serialize_tensors,
)

_U32 = struct.Struct("<I")
_TENSOR_KEY = "__tensor__"
_BYTES_KEY = "__bytes__"


@dataclass
class GetTaskRequest:
    worker_id: int
    task_type: int = -1  # -1 = any; TaskType.EVALUATION for eval-only pulls
    trace: dict = field(default_factory=dict)


@dataclass
class TaskResponse:
    """A leased task (or WAIT/empty sentinel).

    ``task_id == -1`` with ``type == WAIT`` means poll again later;
    ``task_id == -1`` with ``type == -1`` means the job is complete.
    """

    task_id: int = -1
    shard_name: str = ""
    start: int = 0
    end: int = 0
    type: int = -1
    model_version: int = -1
    minibatch_size: int = 0
    extended: dict = field(default_factory=dict)
    trace: dict = field(default_factory=dict)

    @property
    def is_wait(self) -> bool:
        return self.task_id == -1 and self.type == int(TaskType.WAIT)

    @property
    def is_empty(self) -> bool:
        return self.task_id == -1 and self.type == -1


@dataclass
class GetStepTaskRequest:
    """Lockstep task pull: every process of one world requests the same
    increasing ``seq``, and the master resolves each seq to one task
    once and memoizes the answer, so every process sees the same task
    stream.  ``cluster_version`` fences stale worlds after a
    re-formation."""

    seq: int
    worker_id: int
    cluster_version: int = 0


@dataclass
class ReportTaskResultRequest:
    task_id: int
    err_message: str = ""
    exec_counters: dict = field(default_factory=dict)
    trace: dict = field(default_factory=dict)


@dataclass
class ReportVersionRequest:
    model_version: int
    worker_id: int = 0


@dataclass
class ReportEvaluationMetricsRequest:
    """An evaluation task's outputs and labels, for the master to
    accumulate its metrics.  ``task_id`` is the lease guard: the master
    drops a report whose lease is no longer active, and a second report
    for the same lease.  ``evaluated_version``: the step of the state
    the worker evaluated with."""

    model_outputs: dict = field(default_factory=dict)  # name -> Tensor
    labels: Tensor | None = None
    model_version: int = -1
    task_id: int = -1
    evaluated_version: int = -1


@dataclass
class HeartbeatRequest:
    """The JAX package's heartbeat, every field kept.  The port's workers
    fill ``worker_id``, ``step``, ``timestamp``, ``rpc`` (the client's
    outcome totals, ``rpc/stats.py``), ``prefetch`` (the device
    pipeline's staging totals), ``phases`` (the step anatomy's totals,
    ``{}`` without ``--step_anatomy``) and, with ``--replication``,
    ``replica`` (the replicator's advertisement: its replica server's
    address and holdings); ``memory`` comes with slice 10b-2's ledger, and
    stays empty."""

    worker_id: int
    step: int = 0
    timestamp: float = 0.0
    replica: dict = field(default_factory=dict)
    rpc: dict = field(default_factory=dict)
    phases: dict = field(default_factory=dict)
    prefetch: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)


@dataclass
class HeartbeatResponse:
    """``boot_id`` names the master PROCESS that answered (empty unless
    ``--master_journal_dir`` is set): a worker that sees it change has
    outlived a master, and re-homes (``RehomeRequest``)."""

    accepted: bool = True
    should_quiesce: bool = False
    cluster_version: int = 0
    replica_peers: dict = field(default_factory=dict)
    boot_id: str = ""
    profile: dict = field(default_factory=dict)


@dataclass
class RehomeRequest:
    """Worker -> restarted master: the re-homing handshake.

    ``lease_ids`` are the task leases this worker still holds in
    flight; ``cluster_version`` is the world generation it belongs to
    (the fence: a stale generation is rejected); ``pid`` lets a local
    master ADOPT the orphaned process (the previous master spawned it,
    so the restarted one holds no handle)."""

    worker_id: int
    cluster_version: int = 0
    pid: int = 0
    lease_ids: list = field(default_factory=list)


@dataclass
class RehomeResponse:
    # False = the generation fence rejected the worker (stale world)
    accepted: bool = False
    cluster_version: int = 0
    boot_id: str = ""
    # the presented leases the master re-accepted; the worker drops any
    # lease NOT in this list (its report would be dropped, and the task
    # trains from the queue exactly once)
    accepted_leases: list = field(default_factory=list)


@dataclass
class GetWorldAssignmentRequest:
    """Hot-standby poll: a warm worker asks whether it has been given a
    place in a (re-)formed world.  ``standby_id`` is the identity the
    instance manager addressed the assignment to."""

    standby_id: str


@dataclass
class WorldAssignmentResponse:
    has: bool = False
    # True once the job is shutting down: the standby exits cleanly
    shutdown: bool = False
    worker_id: int = 0
    coordinator_addr: str = ""
    num_processes: int = 1
    process_id: int = 0
    cluster_version: int = 0
    # slice coordinates of a multi-slice world
    slice_id: int = 0
    num_slices: int = 1
    trace: dict = field(default_factory=dict)


@dataclass
class PushReplicaRequest:
    """Ring-neighbor state push (worker -> worker, replica service).

    ``payload`` is one encoded state shard (``replication/blob.py``);
    ``checksum`` lets the receiver detect a torn transfer and refuse to
    commit it; ``generation`` fences pushes from stale worlds.
    """

    source: int  # process index whose state shard this is
    version: int  # model version the shard was snapshotted at
    generation: int = 0
    checksum: str = ""
    payload: bytes = b""


@dataclass
class PushReplicaResponse:
    accepted: bool = False
    reason: str = ""


@dataclass
class FetchReplicaRequest:
    """Master-side harvest pull (master -> worker, replica service).
    ``probe=True`` returns metadata only (version/generation/checksum
    plus every retained version), so the harvester can pick a complete
    replica set before moving any payload bytes.  ``version=-1`` means
    the newest retained shard; a specific version fetches exactly that
    one (an older shard may be the only COMPLETE set left)."""

    source: int
    probe: bool = False
    version: int = -1


@dataclass
class FetchReplicaResponse:
    has: bool = False
    source: int = -1
    version: int = -1
    generation: int = -1
    checksum: str = ""
    payload: bytes = b""
    # every version the store retains for this source (probe responses)
    versions: list = field(default_factory=list)


@dataclass
class GetRestoreStateRequest:
    """A re-formed world asks the master for the harvested in-memory
    replica set.  ``cluster_version`` fences the stage: only the
    generation the harvest was staged FOR may restore from it."""

    cluster_version: int
    process_id: int = 0


@dataclass
class RestoreStateResponse:
    has: bool = False
    version: int = -1
    checksum: str = ""
    payload: bytes = b""


# ---- serving plane (serving/) -----------------------------------------------
#
# Feature/output trees ride as tensor frames like the eval-metrics
# payload: ``pack_array_tree``/``unpack_array_tree`` flatten a bare
# ndarray or a {name: ndarray} dict into the serialize_tensors form (a
# bare array travels under the reserved name below; bf16 leaves as
# ``ml_dtypes.bfloat16``), and the packed bytes ride the message as one
# raw frame, never text-encoded.

BARE_ARRAY_KEY = "__bare__"


def pack_array_tree(tree) -> bytes:
    """Serialize a bare ndarray or a flat {name: ndarray} dict."""
    if isinstance(tree, dict):
        named = {
            str(k): Tensor(str(k), np.asarray(v)) for k, v in tree.items()
        }
    else:
        named = {BARE_ARRAY_KEY: Tensor(BARE_ARRAY_KEY, np.asarray(tree))}
    return serialize_tensors(named)


def unpack_array_tree(buf: bytes):
    """Inverse of :func:`pack_array_tree`."""
    tensors = deserialize_tensors(buf)
    if set(tensors) == {BARE_ARRAY_KEY}:
        return tensors[BARE_ARRAY_KEY].values
    return {name: t.values for name, t in tensors.items()}


@dataclass
class PredictRequest:
    """One inference request: ``rows`` rows of features (any row count —
    the replica's micro-batcher coalesces/splits them into the one
    canonical batch shape).  ``request_id`` is the client-chosen
    identity (router retries re-send the SAME id; predict is read-only
    so a re-delivery is harmless either way)."""

    request_id: str = ""
    features: bytes = b""  # pack_array_tree frames
    rows: int = 0
    # trace context ({"trace_id", "span_id"}) of the client's root
    # span, which the router's and the replica's spans parent into
    trace: dict = field(default_factory=dict)


@dataclass
class PredictResponse:
    outputs: bytes = b""  # pack_array_tree frames
    model_version: int = -1
    rows: int = 0
    # sum-exact per-request anatomy, ms keyed by serving phase name
    # (queue_wait/assemble/h2d_transfer/device_compute/d2h_transfer/
    # untracked) plus total_ms; empty on error responses
    phases: dict = field(default_factory=dict)
    # non-empty = the request failed (overload, shape mismatch, ...);
    # the error classes a client may retry are marked retryable=True
    error: str = ""
    retryable: bool = False


@dataclass
class ServingStatusRequest:
    """Replica/router status snapshot; doubles as the liveness probe."""

    detail: bool = False
    # trace context of the caller (probe beats omit it)
    trace: dict = field(default_factory=dict)


@dataclass
class ServingStatusResponse:
    replica_id: int = -1
    model_version: int = -1
    # the JAX package's process-wide XLA compile count; the port has no
    # compiler to count and reports the distinct input shapes its engine
    # has dispatched: 1 across steady-state traffic, whatever the
    # request-size mix (the one canonical shape)
    compile_count: int = 0
    requests: int = 0
    rows: int = 0
    rejected: int = 0
    swaps: int = 0
    queue_rows: int = 0
    canonical_rows: int = 0
    # router responses: one status dict per live replica (detail=True)
    replicas: list = field(default_factory=list)
    # probe-beat telemetry fan-in (the heartbeat pattern riding the RPC
    # that keeps flowing — here the liveness probe itself):
    # monotone request/error counters since process start.  The router
    # max-merges per replica (utils/merge.max_merge_counters), so
    # duplicated or reordered probe replies are absorbed.  Empty when
    # nothing was counted yet
    counters: dict = field(default_factory=dict)
    # monotone per-phase {ms, count, buckets} serving-request totals in
    # the step-anatomy heartbeat shape (bucket keys stringified for the
    # wire), max-merged per replica (the router's SLO watchdog, which
    # reads them in the JAX package, comes with slice 10b-2)
    phases: dict = field(default_factory=dict)
    # memory-ledger snapshot {"at", "current", "peak"} — NON-monotone,
    # merged last-writer-wins.  The port's ledger comes with slice 10b-2,
    # so its replicas leave it empty
    memory: dict = field(default_factory=dict)


@dataclass
class SwapModelRequest:
    """Hot-swap the served model.  ``model_dir`` names an export
    directory (manifest + npz); ``min_version`` guards staleness — the
    replica refuses a swap that would not advance its version, which is
    what makes the method a safe versioned-put under re-delivery."""

    model_dir: str = ""
    min_version: int = -1
    # trace context of the operator's swap request: each replica's
    # model_swap span parents into it
    trace: dict = field(default_factory=dict)
    # live train->serve push (streaming subsystem): a non-empty
    # ``payload`` carries an encoded replica snapshot
    # (replication/blob.py) to swap from directly — no export dir, no
    # disk.  ``version`` stamps the swap (the versioned-put guard is
    # unchanged: a version <= the served one is refused as stale);
    # ``source`` labels provenance; the two watermarks ride along for
    # the streaming slice's freshness telemetry.  All default-valued
    payload: bytes = b""
    version: int = -1
    source: str = ""
    trained_watermark: int = -1
    source_watermark: int = -1


@dataclass
class SwapModelResponse:
    accepted: bool = False
    model_version: int = -1
    reason: str = ""
    # structured staleness marker: True when the refusal means "already
    # at/past this version" — the absorbed-replay case of the
    # versioned-put contract.  A FIELD, not a reason-string prefix, so
    # the router's convergence logic cannot be broken by rewording
    stale: bool = False
    # router fan-out: per-replica outcomes
    replicas: list = field(default_factory=list)


@dataclass
class RequestProfileRequest:
    """Arm an on-demand profiler window on the running job: the master
    rides the command down on every heartbeat response until the
    distribution TTL lapses, and each worker opens one
    ``num_steps``-step capture into its telemetry dir (or ``out_dir``
    when given).  Arming while a window is already being distributed is
    absorbed (the response carries the existing window id), so a
    re-delivered arm is safe to retry."""

    num_steps: int = 5
    out_dir: str = ""


@dataclass
class RequestProfileResponse:
    accepted: bool = False
    window_id: int = 0
    reason: str = ""


MESSAGE_TYPES = {
    cls.__name__: cls
    for cls in (
        GetTaskRequest,
        TaskResponse,
        GetStepTaskRequest,
        ReportTaskResultRequest,
        ReportVersionRequest,
        ReportEvaluationMetricsRequest,
        HeartbeatRequest,
        HeartbeatResponse,
        RehomeRequest,
        RehomeResponse,
        GetWorldAssignmentRequest,
        WorldAssignmentResponse,
        PushReplicaRequest,
        PushReplicaResponse,
        FetchReplicaRequest,
        FetchReplicaResponse,
        GetRestoreStateRequest,
        RestoreStateResponse,
        PredictRequest,
        PredictResponse,
        ServingStatusRequest,
        ServingStatusResponse,
        SwapModelRequest,
        SwapModelResponse,
        RequestProfileRequest,
        RequestProfileResponse,
    )
}


def _pack(value, frames: list):
    if isinstance(value, Tensor):
        frames.append(value.to_bytes())
        return {_TENSOR_KEY: len(frames) - 1}
    if isinstance(value, (bytes, bytearray, memoryview)):
        frames.append(value)
        return {_BYTES_KEY: len(frames) - 1}
    if isinstance(value, dict):
        return {k: _pack(v, frames) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_pack(v, frames) for v in value]
    return value


def _unpack(value, frames: list):
    if isinstance(value, dict):
        if set(value) == {_TENSOR_KEY}:
            return Tensor.from_bytes(frames[value[_TENSOR_KEY]])
        if set(value) == {_BYTES_KEY}:
            return bytes(frames[value[_BYTES_KEY]])
        return {k: _unpack(v, frames) for k, v in value.items()}
    if isinstance(value, list):
        return [_unpack(v, frames) for v in value]
    return value


def encode(msg) -> bytes:
    """Serialize any message dataclass to one frame."""
    kind = type(msg).__name__
    if kind not in MESSAGE_TYPES:
        raise ValueError(f"not a control-plane message: {kind}")
    frames: list[bytes] = []
    body = {f.name: _pack(getattr(msg, f.name), frames) for f in fields(msg)}
    header = json.dumps(
        {"kind": kind, "body": body, "frames": [len(f) for f in frames]}
    ).encode("utf-8")
    return b"".join([_U32.pack(len(header)), header, *frames])


def decode(buf: bytes | memoryview):
    """Deserialize one frame back into its message dataclass."""
    buf = memoryview(buf)
    (header_len,) = _U32.unpack_from(buf, 0)
    header = json.loads(bytes(buf[4 : 4 + header_len]).decode("utf-8"))
    cls = MESSAGE_TYPES.get(header["kind"])
    if cls is None:
        raise ValueError(f"unknown message kind: {header['kind']}")
    frames, offset = [], 4 + header_len
    for length in header["frames"]:
        frames.append(buf[offset : offset + length])
        offset += length
    if offset != len(buf):
        raise ValueError(f"frame of {len(buf)} bytes, header accounts for {offset}")
    return cls(**{k: _unpack(v, frames) for k, v in header["body"].items()})


def task_to_response(
    task_id: int,
    task,
    model_version: int,
    minibatch_size: int,
    trace: dict | None = None,
) -> TaskResponse:
    return TaskResponse(
        task_id=task_id,
        shard_name=task.shard_name,
        start=task.start,
        end=task.end,
        type=int(task.type),
        model_version=task.model_version
        if task.type == TaskType.EVALUATION
        else model_version,
        minibatch_size=minibatch_size,
        extended=dict(task.extended),
        trace=dict(trace or {}),
    )

