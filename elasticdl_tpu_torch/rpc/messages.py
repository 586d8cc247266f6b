"""Control-plane message types; the dataclasses of
``elasticdl_tpu/rpc/messages.py`` that the lockstep path uses, with the
same field names and defaults.

The JAX package serializes them with msgpack.  The port's codec is the
standard library's: one frame is

    [u32 header_len][header json][tensor frame 0][tensor frame 1]...

The header holds the message kind, its fields (``dataclasses.asdict``)
and the byte length of each tensor frame.  A ``utils.tensor.Tensor``
anywhere inside a field's dicts or lists leaves the JSON as
``{"__tensor__": i}`` and rides as raw frame ``i`` (``Tensor.to_bytes``),
so tensor payloads are never text-encoded.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field, fields

from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.tensor import Tensor

_U32 = struct.Struct("<I")
_TENSOR_KEY = "__tensor__"


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
class HeartbeatRequest:
    """The JAX package's heartbeat, every field kept.  The port's workers
    fill ``worker_id``, ``step``, ``timestamp`` and ``rpc`` (the client's
    outcome totals, ``rpc/stats.py``); ``replica``, ``phases``,
    ``prefetch`` and ``memory`` come with the slices that port
    replication and telemetry, and stay empty."""

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
    accepted: bool = True
    should_quiesce: bool = False
    cluster_version: int = 0
    replica_peers: dict = field(default_factory=dict)
    boot_id: str = ""
    profile: dict = field(default_factory=dict)


MESSAGE_TYPES = {
    cls.__name__: cls
    for cls in (
        GetTaskRequest,
        TaskResponse,
        GetStepTaskRequest,
        ReportTaskResultRequest,
        ReportVersionRequest,
        HeartbeatRequest,
        HeartbeatResponse,
    )
}


def _pack(value, frames: list):
    if isinstance(value, Tensor):
        frames.append(value.to_bytes())
        return {_TENSOR_KEY: len(frames) - 1}
    if isinstance(value, dict):
        return {k: _pack(v, frames) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_pack(v, frames) for v in value]
    return value


def _unpack(value, frames: list):
    if isinstance(value, dict):
        if set(value) == {_TENSOR_KEY}:
            return Tensor.from_bytes(frames[value[_TENSOR_KEY]])
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

