"""The port's control-plane transport (``elasticdl_tpu_torch/rpc/``)
against the JAX package's, on the CPU.

- Every ported message keeps the JAX dataclass's field names and
  defaults, and round-trips the port's standard-library codec (a JSON
  header plus raw tensor frames), tensors included.
- A server and a ``MasterClient`` on localhost carry every master method
  to a real servicer, and map transport failures onto gRPC's status
  codes (UNAVAILABLE, DEADLINE_EXCEEDED, UNIMPLEMENTED, INTERNAL,
  RESOURCE_EXHAUSTED for a request or a reply over the message cap,
  never retried).
- Every method of the port's tables is classified in the port's copy of
  the idempotency registry, and no ``not-retryable`` one is retried.
- The copied retry and deadline rules behave as the JAX package's tests
  pin them: each rule's case runs against both packages' modules.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.rpc import deadline as jax_deadline
from elasticdl_tpu.rpc import messages as jax_msg
from elasticdl_tpu.rpc import retry as jax_retry
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.rpc import deadline as port_deadline
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import retry as port_retry
from elasticdl_tpu_torch.rpc import stats as rpc_stats
from elasticdl_tpu_torch.rpc.service import (
    MASTER_RETRYABLE_METHODS,
    MasterClient,
    RpcClient,
    RpcError,
    StatusCode,
    create_server,
)
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.tensor import Tensor

# one message of each ported kind, every field off its default
MESSAGES = [
    msg.GetTaskRequest(worker_id=3, task_type=1, trace={"trace_id": "t", "span_id": "s"}),
    msg.TaskResponse(
        task_id=7, shard_name="/d/mnist-000.edlio", start=64, end=128, type=0,
        model_version=12, minibatch_size=32, extended={"saved_model_path": "/o"},
        trace={"trace_id": "a"},
    ),
    msg.GetStepTaskRequest(seq=5, worker_id=2, cluster_version=1),
    msg.ReportTaskResultRequest(
        task_id=9, err_message="boom", exec_counters={"fail_count": 64},
        trace={"span_id": "x"},
    ),
    msg.ReportVersionRequest(model_version=40, worker_id=1),
    msg.ReportEvaluationMetricsRequest(
        model_outputs={"output": Tensor("output", np.eye(3, dtype=np.float32))},
        labels=Tensor("labels", np.arange(3, dtype=np.int64)), model_version=8,
        task_id=5, evaluated_version=9,
    ),
    msg.HeartbeatRequest(
        worker_id=4, step=17, timestamp=1234.5, replica={"addr": "h:1"},
        rpc={"retries": 2}, phases={"step": {"ms": 1.5, "count": 3}},
        prefetch={"groups": 2}, memory={"at": 1.0, "current": {"x": 5}},
    ),
    msg.HeartbeatResponse(
        accepted=False, should_quiesce=True, cluster_version=3,
        replica_peers={"0": "h:2"}, boot_id="b", profile={"window_id": 1},
    ),
    # the replica service's and the restore stage's messages: payloads
    # ride as raw byte frames
    msg.PushReplicaRequest(
        source=1, version=8, generation=2, checksum="0a1b2c3d", payload=b"\x00\xffshard",
    ),
    msg.PushReplicaResponse(accepted=True, reason="stale_version"),
    msg.FetchReplicaRequest(source=1, probe=True, version=6),
    msg.FetchReplicaResponse(
        has=True, source=1, version=6, generation=2, checksum="c",
        payload=b"\x01" * 7, versions=[4, 6],
    ),
    msg.GetRestoreStateRequest(cluster_version=3, process_id=1),
    msg.RestoreStateResponse(has=True, version=6, checksum="c", payload=b"state"),
    # the serving plane's: feature and output trees ride packed, as one
    # raw byte frame each
    msg.PredictRequest(
        request_id="r1", features=msg.pack_array_tree({"x": np.ones((2, 4), np.float32)}),
        rows=2, trace={"trace_id": "t"},
    ),
    msg.PredictResponse(
        outputs=msg.pack_array_tree(np.zeros((2, 3), np.float32)), model_version=7,
        rows=2, phases={"queue_wait": 0.5, "total_ms": 2.0}, error="e", retryable=True,
    ),
    msg.ServingStatusRequest(detail=True, trace={"span_id": "s"}),
    msg.ServingStatusResponse(
        replica_id=2, model_version=9, compile_count=1, requests=5, rows=11,
        rejected=1, swaps=2, queue_rows=3, canonical_rows=4,
        replicas=[{"replica_id": 0, "model_version": 9}], counters={"requests": 5},
        phases={"total": {"ms": 3.5, "count": 5, "buckets": {"0.01": 5}}},
        memory={"at": 1.0},
    ),
    msg.SwapModelRequest(
        model_dir="/m", min_version=3, trace={"trace_id": "t"}, payload=b"blob",
        version=12, source="live-push", trained_watermark=40, source_watermark=41,
    ),
    msg.SwapModelResponse(
        accepted=False, model_version=12, reason="stale swap: version 12 <= served 12",
        stale=True, replicas=[{"replica_id": 0, "absorbed": True}],
    ),
]


def _ids(m):
    return type(m).__name__


@pytest.mark.parametrize("message", MESSAGES, ids=_ids)
def test_message_fields_and_defaults_are_the_jax_packages(message):
    cls = type(message)
    jax_cls = getattr(jax_msg, cls.__name__)

    def shape(c):
        return [
            (f.name, f.default if f.default is not dataclasses.MISSING
             else (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else "required"))
            for f in dataclasses.fields(c)
        ]

    assert shape(cls) == shape(jax_cls)


def _same(a, b) -> bool:
    """Message equality, tensors compared by name, dtype and values."""
    if isinstance(a, Tensor):
        return (
            isinstance(b, Tensor) and a.name == b.name and a.values.dtype == b.values.dtype
            and np.array_equal(a.values, b.values)
        )
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)
        )
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("message", MESSAGES, ids=_ids)
def test_every_message_round_trips_the_codec(message):
    assert _same(msg.decode(msg.encode(message)), message)
    # defaults too (the sentinels WAIT and end-of-job are all defaults)
    cls = type(message)
    required = {
        f.name: 0 for f in dataclasses.fields(cls)
        if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
    }
    plain = cls(**required)
    assert msg.decode(msg.encode(plain)) == plain


def test_tensors_ride_as_raw_frames():
    values = np.arange(12, dtype=np.float32).reshape(3, 4)
    ids = np.array([5, 1, 9], np.int64)
    request = msg.HeartbeatRequest(
        worker_id=1,
        memory={"dense": Tensor("w", values), "rows": [Tensor("e", values, ids)]},
    )
    frame = msg.encode(request)
    # the tensor bytes are in the frame as they are, not text-encoded
    assert values.tobytes() in frame and ids.tobytes() in frame
    got = msg.decode(frame)
    np.testing.assert_array_equal(got.memory["dense"].values, values)
    sparse = got.memory["rows"][0]
    np.testing.assert_array_equal(sparse.values, values)
    np.testing.assert_array_equal(sparse.indices, ids)


def test_bytes_ride_as_raw_frames():
    payload = bytes(range(256)) * 64
    frame = msg.encode(msg.PushReplicaRequest(source=0, version=1, payload=payload))
    # the payload once, as it is: no base64 in the JSON header
    assert payload in frame and len(frame) < len(payload) + 256
    assert msg.decode(frame).payload == payload


def test_codec_refuses_foreign_and_torn_frames():
    with pytest.raises(ValueError, match="not a control-plane message"):
        msg.encode(object())
    frame = msg.encode(msg.ReportVersionRequest(model_version=1))
    with pytest.raises(ValueError, match="header accounts"):
        msg.decode(frame + b"x")
    bogus = frame.replace(b"ReportVersionRequest", b"ReportVersionRequesX")
    with pytest.raises(ValueError, match="unknown message kind"):
        msg.decode(bogus)


def test_task_to_response_matches_the_jax_packages():
    from elasticdl_tpu.master.task_dispatcher import Task as JaxTask
    from elasticdl_tpu_torch.master.task_dispatcher import Task

    for tt in (TaskType.TRAINING, TaskType.EVALUATION, TaskType.SAVE_MODEL):
        kw = dict(shard_name="s", start=3, end=9, type=tt, model_version=4)
        got = msg.task_to_response(11, Task(**kw), 7, 32)
        want = jax_msg.task_to_response(11, JaxTask(**kw), 7, 32)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---- a server and a client on localhost ----------------------------------


@pytest.fixture()
def served():
    dispatcher = TaskDispatcher({"s": (0, 64)}, records_per_task=32)
    servicer = MasterServicer(16, dispatcher)
    server = create_server(servicer, 0)
    server.start()
    client = MasterClient(f"localhost:{server.port}")
    yield servicer, dispatcher, client, server
    server.stop()


def test_client_carries_every_master_method(served):
    servicer, dispatcher, client, _server = served
    task = client.get_task(msg.GetTaskRequest(worker_id=0))
    assert (task.shard_name, task.end - task.start, task.minibatch_size) == ("s", 32, 16)
    step = client.get_step_task(msg.GetStepTaskRequest(seq=0, worker_id=1))
    # the two tasks of the shard, in the dispatcher's shuffled order
    assert {(task.start, task.end), (step.start, step.end)} == {(0, 32), (32, 64)}
    # memoized: a second process asking for seq 0 gets the same task
    assert client.get_step_task(msg.GetStepTaskRequest(seq=0, worker_id=2)) == step
    assert client.report_task_result(msg.ReportTaskResultRequest(task_id=task.task_id)) is None
    assert client.report_task_result(msg.ReportTaskResultRequest(task_id=step.task_id)) is None
    assert dispatcher.finished()
    assert client.report_version(msg.ReportVersionRequest(model_version=6, worker_id=0)) is None
    assert servicer.get_model_version() == 6
    # no evaluation service behind this servicer: accepted, accumulated
    # nowhere
    assert client.report_evaluation_metrics(msg.ReportEvaluationMetricsRequest(
        model_outputs={"output": Tensor("output", np.eye(2, dtype=np.float32))},
        labels=Tensor("labels", np.arange(2)),
    )) is None
    beat = client.heartbeat(msg.HeartbeatRequest(worker_id=5, rpc={"retries": 2}))
    assert beat == msg.HeartbeatResponse(cluster_version=0)
    assert servicer.rpc_stats_totals() == {"retries": 2}
    assert set(servicer.live_workers()) == {0, 1, 2, 5}
    # no restore stage: the disk-fallback answer
    assert client.get_restore_state(msg.GetRestoreStateRequest(cluster_version=0)) == (
        msg.RestoreStateResponse()
    )
    end = client.get_step_task(msg.GetStepTaskRequest(seq=1, worker_id=1))
    assert end.is_empty


def test_a_request_over_the_message_cap_fails_loudly(served, monkeypatch):
    """A request over the transport's cap (256 MiB, the JAX package's
    gRPC limit; shrunk here) is refused by the client before it is sent,
    as RESOURCE_EXHAUSTED, which no retry policy re-sends."""
    from elasticdl_tpu_torch.rpc import service

    servicer, _dispatcher, _client, server = served
    seen = []
    monkeypatch.setattr(servicer, "report_evaluation_metrics", seen.append, raising=False)
    monkeypatch.setattr(service, "MAX_MESSAGE_BYTES", 4096)
    client = MasterClient(
        f"localhost:{server.port}", retry=port_retry.RetryPolicy.from_budget(5.0),
        retryable_methods=MASTER_RETRYABLE_METHODS,
    )
    request = msg.ReportEvaluationMetricsRequest(
        model_outputs={"output": Tensor("output", np.zeros((64, 16), np.float32))},
        labels=Tensor("labels", np.zeros(64, np.int64)), task_id=1,
    )
    t0 = time.monotonic()
    with pytest.raises(RpcError) as err:
        client.report_evaluation_metrics(request)
    assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
    assert "message cap" in err.value.details()
    assert time.monotonic() - t0 < 1.0 and seen == []
    # under the cap, the same method is carried to the servicer
    small = msg.ReportEvaluationMetricsRequest(
        model_outputs={"output": Tensor("output", np.zeros((2, 4), np.float32))},
        labels=Tensor("labels", np.zeros(2, np.int64)), task_id=1,
    )
    client.report_evaluation_metrics(small)
    assert len(seen) == 1 and seen[0].task_id == 1


def test_a_reply_over_the_message_cap_is_resource_exhausted_once(served, monkeypatch):
    """A reply over the cap (shrunk here, so the reply stays small) is
    answered RESOURCE_EXHAUSTED with a short body naming the method and
    the size, as a gRPC server capped by its send limit answers: one
    error, the handler called once whatever the retry policy, and the
    server answers the next call."""
    from elasticdl_tpu_torch.rpc import service

    servicer, _dispatcher, _client, server = served
    calls = []

    def big_heartbeat(request):
        calls.append(request.worker_id)
        return msg.HeartbeatResponse(replica_peers={"pad": "x" * 8192})

    monkeypatch.setattr(servicer, "heartbeat", big_heartbeat)
    monkeypatch.setattr(service, "MAX_MESSAGE_BYTES", 4096)
    client = MasterClient(
        f"localhost:{server.port}", retry=port_retry.RetryPolicy.from_budget(5.0),
        retryable_methods=MASTER_RETRYABLE_METHODS,
    )
    with pytest.raises(RpcError) as err:
        client.heartbeat(msg.HeartbeatRequest(worker_id=3))
    assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
    details = err.value.details()
    assert "heartbeat" in details and "message cap" in details and len(details) < 256
    assert calls == [3]
    # the server's handler thread is up: the next call is answered
    task = client.get_step_task(msg.GetStepTaskRequest(seq=0, worker_id=1))
    assert (task.shard_name, task.end - task.start) == ("s", 32)


def test_a_reply_length_over_the_cap_is_never_unavailable(monkeypatch):
    """A client that reads a reply length over the cap (a server that
    does not check, such as an older one) raises RESOURCE_EXHAUSTED, not
    the retryable UNAVAILABLE a torn connection gives."""
    import socket
    import struct

    from elasticdl_tpu_torch.rpc import service

    listener = socket.create_server(("localhost", 0))
    port = listener.getsockname()[1]

    def serve_one():
        conn, _ = listener.accept()
        with conn:
            conn.recv(1 << 16)
            conn.sendall(struct.pack("<B", 0) + struct.pack("<Q", 8192) + b"x" * 8192)

    thread = threading.Thread(target=serve_one)
    thread.start()
    monkeypatch.setattr(service, "MAX_MESSAGE_BYTES", 4096)
    client = MasterClient(
        f"localhost:{port}", retry=port_retry.RetryPolicy.from_budget(5.0),
        retryable_methods=MASTER_RETRYABLE_METHODS,
    )
    with pytest.raises(RpcError) as err:
        client.heartbeat(msg.HeartbeatRequest(worker_id=0))
    thread.join()
    listener.close()
    assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED


def test_a_handlers_rpc_error_reaches_the_caller_with_its_code(served):
    """A servicer that raises an ``RpcError`` (a router passing on a
    replica's failure) answers with that error's code and details, not
    INTERNAL."""
    servicer, _dispatcher, client, _server = served

    def relayed(_request):
        raise RpcError(StatusCode.RESOURCE_EXHAUSTED, "downstream: over the cap")

    servicer.report_version = relayed
    with pytest.raises(RpcError) as err:
        client.report_version(msg.ReportVersionRequest(model_version=1))
    assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
    assert err.value.details() == "downstream: over the cap"


def _method_tables():
    """Every method table and retryable set of the port, by name."""
    from elasticdl_tpu_torch.replication.service import REPLICA_METHODS
    from elasticdl_tpu_torch.rpc import service
    from elasticdl_tpu_torch.serving import replica

    return {
        "master methods": service._METHODS,
        "master retryable": service.MASTER_RETRYABLE_METHODS,
        "default idempotent": port_retry.DEFAULT_IDEMPOTENT,
        "replica methods": REPLICA_METHODS,
        "serving methods": replica.SERVING_METHODS,
        "serving retryable": replica.SERVING_RETRYABLE_METHODS,
    }


@pytest.mark.parametrize("table", sorted(_method_tables()))
def test_every_method_is_classified_and_none_unsafe_is_retried(table):
    """The JAX package's rpc-contract rules on the port's tables, until
    the port's ``analysis/`` comes: every method of a method table or a
    retryable set has an entry in the idempotency registry, and no
    ``not-retryable`` method is in a retryable set."""
    from elasticdl_tpu.rpc import idempotency as jax_idem
    from elasticdl_tpu_torch.rpc import idempotency

    methods = _method_tables()[table]
    assert methods
    for method in methods:
        assert idempotency.classification(method) is not None, method
        # the same classification as the JAX package's
        assert idempotency.classification(method) == jax_idem.classification(method)
        if "retryable" in table or "idempotent" in table:
            assert idempotency.classification(method) != "not-retryable", method


def test_the_idempotency_registry_is_the_jax_packages():
    from elasticdl_tpu.rpc import idempotency as jax_idem
    from elasticdl_tpu_torch.rpc import idempotency

    assert {m: c for m, (c, _why) in idempotency.IDEMPOTENCY.items()} == {
        m: c for m, (c, _why) in jax_idem.IDEMPOTENCY.items()
    }
    assert all(why for _c, why in idempotency.IDEMPOTENCY.values())
    assert idempotency.classification("no_such_method") is None


def test_concurrent_calls_are_served(served):
    _servicer, _dispatcher, client, _server = served
    results = []

    def beat(i):
        results.append(client.heartbeat(msg.HeartbeatRequest(worker_id=i)).accepted)

    threads = [threading.Thread(target=beat, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [True] * 16


def test_status_codes_of_failed_calls(served):
    servicer, _dispatcher, client, server = served
    # a method the client knows but this server does not serve
    partial = create_server(servicer, 0, methods=("heartbeat",))
    partial.start()
    try:
        with pytest.raises(RpcError) as err:
            MasterClient(f"localhost:{partial.port}").report_version(
                msg.ReportVersionRequest(model_version=1)
            )
        assert err.value.code() == StatusCode.UNIMPLEMENTED
    finally:
        partial.stop()

    # the handler raised: INTERNAL, with the server's traceback
    def broken(_request):
        raise KeyError("no such task")

    servicer.report_version = broken
    with pytest.raises(RpcError) as err:
        client.report_version(msg.ReportVersionRequest(model_version=1))
    assert err.value.code() == StatusCode.INTERNAL and "no such task" in err.value.details()

    # a slow handler past the caller's deadline
    def slow(request):
        time.sleep(1.0)
        return msg.HeartbeatResponse()

    servicer.heartbeat = slow
    with pytest.raises(RpcError) as err:
        client._call("heartbeat", msg.HeartbeatRequest(worker_id=0), timeout=0.2)
    assert err.value.code() == StatusCode.DEADLINE_EXCEEDED

    # nobody listening any more
    server.stop()
    with pytest.raises(RpcError) as err:
        client.get_task(msg.GetTaskRequest(worker_id=0))
    assert err.value.code() == StatusCode.UNAVAILABLE


# ---- the retry and deadline rules, both packages ---------------------------

RETRY = {"jax": jax_retry, "port": port_retry}
DEADLINE = {"jax": jax_deadline, "port": port_deadline}
PACKAGES = ["jax", "port"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_delay_cap_grows_exponentially_and_is_bounded(pkg):
    policy = RETRY[pkg].RetryPolicy(base_delay_secs=0.1, max_delay_secs=2.0)
    assert policy.delay_cap(1) == pytest.approx(0.1)
    assert policy.delay_cap(2) == pytest.approx(0.2)
    assert policy.delay_cap(3) == pytest.approx(0.4)
    assert policy.delay_cap(30) == 2.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_call_with_retry_succeeds_after_transient_failures(pkg):
    r = RETRY[pkg]
    attempts, sleeps = [], []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise ConnectionError("down")
        return "ok"

    policy = r.RetryPolicy(max_attempts=5, base_delay_secs=0.01)
    assert r.call_with_retry(flaky, policy, sleep=sleeps.append) == "ok"
    assert len(attempts) == 3 and len(sleeps) == 2
    for i, delay in enumerate(sleeps, start=1):
        assert 0.0 <= delay <= policy.delay_cap(i)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_call_with_retry_exhausts_attempts_and_reraises(pkg):
    r = RETRY[pkg]

    def always_down():
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        r.call_with_retry(
            always_down, r.RetryPolicy(max_attempts=3, base_delay_secs=0.0),
            sleep=lambda _s: None,
        )


@pytest.mark.parametrize("pkg", PACKAGES)
def test_call_with_retry_nonretryable_raises_immediately(pkg):
    r = RETRY[pkg]
    attempts = []

    def fails():
        attempts.append(1)
        raise ValueError("bug, not outage")

    with pytest.raises(ValueError):
        r.call_with_retry(
            fails, r.RetryPolicy(max_attempts=10),
            is_retryable=lambda ex: isinstance(ex, ConnectionError),
            sleep=lambda _s: None,
        )
    assert len(attempts) == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_call_with_retry_honors_wall_budget(pkg):
    r = RETRY[pkg]
    clock = [0.0]

    def tick_sleep(secs):
        clock[0] += max(secs, 0.05)

    def always_down():
        clock[0] += 0.1
        raise ConnectionError("down")

    seen = []
    with pytest.raises(ConnectionError):
        r.call_with_retry(
            always_down, r.RetryPolicy.from_budget(1.0),
            on_retry=lambda attempt, _ex: seen.append(attempt),
            sleep=tick_sleep, clock=lambda: clock[0],
        )
    assert 2 <= len(seen) < 100 and clock[0] >= 1.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_default_idempotent_is_the_read_only_subset(pkg):
    idem = RETRY[pkg].DEFAULT_IDEMPOTENT
    assert "report_task_result" not in idem and "get_task" not in idem
    assert {"heartbeat", "get_step_task"} <= idem
    assert RETRY["port"].DEFAULT_IDEMPOTENT == RETRY["jax"].DEFAULT_IDEMPOTENT


@pytest.mark.parametrize("pkg", PACKAGES)
def test_on_retry_hook_raising_does_not_end_the_loop(pkg):
    r = RETRY[pkg]
    attempts = []

    def fn():
        attempts.append(1)
        if len(attempts) < 3:
            raise ValueError("boom")
        return "done"

    def bad_hook(attempt, ex):
        raise RuntimeError("hook died")

    out = r.call_with_retry(
        fn, r.RetryPolicy(max_attempts=5, base_delay_secs=0.0),
        on_retry=bad_hook, sleep=lambda s: None,
    )
    assert out == "done" and len(attempts) == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_deadline_expiring_exactly_between_attempts_ends_the_loop(pkg):
    r = RETRY[pkg]
    clock_values = iter([0.0, 10.0])

    def fn():
        raise ValueError("always")

    with pytest.raises(ValueError):
        r.call_with_retry(
            fn, r.RetryPolicy(max_attempts=100, total_timeout_secs=10.0),
            sleep=lambda s: None, clock=lambda: next(clock_values),
        )


@pytest.mark.parametrize("pkg", PACKAGES)
def test_total_timeout_clamps_the_final_backoff_sleep(pkg):
    r = RETRY[pkg]
    sleeps = []
    clock_values = iter([0.0, 5.0, 6.0, 99.0])

    class _MaxRng:
        def uniform(self, lo, hi):
            return hi

    def fn():
        raise ValueError("always")

    with pytest.raises(ValueError):
        r.call_with_retry(
            fn,
            r.RetryPolicy(
                max_attempts=100, base_delay_secs=50.0, max_delay_secs=50.0,
                total_timeout_secs=10.0,
            ),
            rng=_MaxRng(), sleep=sleeps.append, clock=lambda: next(clock_values),
        )
    assert sleeps == [4.0]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_deadline_policy_tiers(pkg):
    policy = DEADLINE[pkg].DeadlinePolicy.from_secs(1.0)
    assert policy.deadline_for("get_task") == 1.0
    assert policy.deadline_for("report_task_result") == 1.0
    assert policy.deadline_for("get_restore_state") == 30.0
    assert policy.deadline_for("push_replica") == 30.0
    assert DEADLINE[pkg].DeadlinePolicy.from_secs(5.0).deadline_for("fetch_replica") == 50.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_deadline_policy_from_env(pkg, monkeypatch):
    d = DEADLINE[pkg]
    monkeypatch.delenv(d.DEADLINE_SECS_ENV, raising=False)
    assert d.DeadlinePolicy.from_env() is None
    monkeypatch.setenv(d.DEADLINE_SECS_ENV, "2.5")
    assert d.DeadlinePolicy.from_env().control_secs == 2.5
    monkeypatch.setenv(d.DEADLINE_SECS_ENV, "not-a-number")
    assert d.DeadlinePolicy.from_env() is None


# ---- the client's retry and deadline wiring --------------------------------


def _client(retry=None, retryable=None, deadlines=None):
    return RpcClient(
        "localhost:1", retry=retry, retryable_methods=retryable, deadlines=deadlines
    )


def test_client_retries_only_retryable_methods():
    client = _client(port_retry.RetryPolicy(max_attempts=5, base_delay_secs=0.0), {"heartbeat"})
    calls = {"heartbeat": 0, "report_task_result": 0}

    def invoke(name, _payload, timeout):
        calls[name] += 1
        if calls[name] < 3:
            raise RpcError(StatusCode.UNAVAILABLE, "down")
        return msg.encode(msg.HeartbeatResponse(boot_id="b1"))

    client._invoke = invoke
    assert client._call("heartbeat", msg.HeartbeatRequest(worker_id=0)).boot_id == "b1"
    assert calls["heartbeat"] == 3
    with pytest.raises(RpcError):
        client._call("report_task_result", msg.ReportTaskResultRequest(task_id=1))
    assert calls["report_task_result"] == 1


def test_client_does_not_retry_non_outage_codes():
    client = _client(port_retry.RetryPolicy(max_attempts=5, base_delay_secs=0.0), {"heartbeat"})
    calls = []

    def invoke(name, _payload, timeout):
        calls.append(name)
        raise RpcError(StatusCode.INTERNAL, "bug")

    client._invoke = invoke
    with pytest.raises(RpcError):
        client._call("heartbeat", msg.HeartbeatRequest(worker_id=0))
    assert calls == ["heartbeat"]


def test_client_reconnect_hook_runs_before_each_retry_of_a_failed_call():
    client = _client(
        port_retry.RetryPolicy(max_attempts=10, base_delay_secs=0.0), MASTER_RETRYABLE_METHODS
    )
    order, down, hook_errors = [], {}, []

    def invoke(name, _payload, timeout):
        order.append(name)
        if down.get(name):
            down[name] -= 1
            raise RpcError(StatusCode.UNAVAILABLE, "down")
        return b""

    def hook():
        order.append("hook")
        if hook_errors:
            raise hook_errors.pop()

    client._invoke = invoke
    client.set_reconnect_hook(hook, exempt=("heartbeat",))
    request = msg.ReportTaskResultRequest(task_id=1)
    client._call("report_task_result", request)  # no failure: no hook
    assert order == ["report_task_result"]
    order.clear()
    down["report_task_result"] = 2
    client._call("report_task_result", request)
    assert order == ["report_task_result", "hook", "report_task_result", "hook", "report_task_result"]
    order.clear()
    down["heartbeat"] = 1  # an exempt method retries without the hook
    client._call("heartbeat", msg.HeartbeatRequest(worker_id=0))
    assert order == ["heartbeat", "heartbeat"]
    order.clear()
    # a hook's retryable error makes the call back off and try again
    down["get_task"], hook_errors[:] = 1, [RpcError(StatusCode.UNAVAILABLE, "re-homing")]
    client._call("get_task", msg.GetTaskRequest(worker_id=0))
    assert order == ["get_task", "hook", "hook", "get_task"]


def test_client_applies_per_method_deadlines_and_counts_failures():
    recorded = []

    def invoke(name, _payload, timeout):
        recorded.append(timeout)
        return msg.encode(msg.TaskResponse())

    client = _client(deadlines=port_deadline.DeadlinePolicy.from_secs(1.0))
    client._invoke = invoke
    client._call("get_task", msg.GetTaskRequest(worker_id=0))
    client._call("get_task", msg.GetTaskRequest(worker_id=0), timeout=9.0)
    assert recorded == [1.0, 9.0]
    plain = _client()
    plain._invoke = invoke
    plain._call("get_task", msg.GetTaskRequest(worker_id=0))
    assert recorded[-1] is None

    rpc_stats.reset_for_tests()
    retried = _client(
        port_retry.RetryPolicy(max_attempts=3, base_delay_secs=0.0),
        MASTER_RETRYABLE_METHODS,
    )
    attempts = []

    def flaky(name, _payload, timeout):
        attempts.append(1)
        if len(attempts) < 3:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "slow")
        return b""

    retried._invoke = flaky
    assert retried._call("report_version", msg.ReportVersionRequest(model_version=1)) is None
    assert rpc_stats.snapshot() == {"deadline_exceeded": 2, "retries": 2}
    rpc_stats.reset_for_tests()
