"""The port's netem (``elasticdl_tpu_torch/chaos/netem.py``) against the
JAX package's (``elasticdl_tpu/chaos/netem.py``), on the CPU.

The same faults and seeds go through both packages' ``NetemShim`` with
the same scripted clock: the delays slept, each call's outcome (its
value, or the status code's name of the injected error), the records of
the chaos event log (all fields but the wall and monotonic stamps) and
the faults still armed after each call must be equal, mirroring
``tests/test_netchaos.py:115-482``.  Then the port's seams on its socket
transport: a response-direction partition executes the request and drops
the reply, a request-direction one never executes it, a duplicated
``report_task_result`` is deduplicated by task id, and an armed worker's
RPC counters reach the event log.  No tolerance: every compared value is
equal exactly.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from elasticdl_tpu.chaos import hooks as jax_hooks
from elasticdl_tpu.chaos import netem as jax_netem
from elasticdl_tpu.chaos.plan import Fault as JaxFault
from elasticdl_tpu.chaos.plan import named_plan as jax_named_plan
from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.chaos import netem
from elasticdl_tpu_torch.chaos.invariants import InvariantChecker
from elasticdl_tpu_torch.chaos.netem import InjectedRpcError, NetemShim
from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind, named_plan
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import service as rpc_service
from elasticdl_tpu_torch.rpc import stats as rpc_stats
from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
from elasticdl_tpu_torch.rpc.retry import RetryPolicy
from elasticdl_tpu_torch.rpc.service import MASTER_RETRYABLE_METHODS, MasterClient, StatusCode
from elasticdl_tpu_torch.utils.constants import TaskType


@pytest.fixture(autouse=True)
def _clean_seams():
    """The module-global seams never leak between tests."""
    yield
    netem.uninstall()
    jax_netem.uninstall()
    rpc_stats.reset_for_tests()


# ---- both shims on one script -----------------------------------------------

# each case: the faults (Fault keyword arguments) and the calls, each
# (method, timeout, seconds the clock moves before it); a call of
# "server:<method>" goes through the server seam
CASES = {
    "delay_window_jitter_then_retire": (
        [dict(kind=FaultKind.NET_DELAY, fault_id="d", delay_ms=100.0, duration_secs=5.0, at_step=1)],
        [("m", None, 0.0), ("m", None, 0.0), ("m", 2.0, 1.0), ("m", None, 1.0), ("m", None, 4.0)],
    ),
    "delay_past_the_deadline": (
        [dict(kind=FaultKind.NET_DELAY, fault_id="d", delay_ms=2000.0, duration_secs=30.0)],
        [("m", 1.0, 0.0), ("m", 5.0, 0.0), ("m", None, 0.0)],
    ),
    "blackhole_with_deadline": (
        [dict(kind=FaultKind.NET_BLACKHOLE, fault_id="b", duration_secs=30.0, at_step=2)],
        [("m", 1.5, 0.0), ("m", 1.5, 0.0), ("m", 1.5, 0.0), ("m", 1.0, 10.0), ("m", 1.0, 25.0)],
    ),
    "blackhole_without_deadline_hangs_to_the_window": (
        [dict(kind=FaultKind.NET_BLACKHOLE, fault_id="b", duration_secs=2.0)],
        [("m", None, 0.0), ("m", None, 0.0)],
    ),
    "partition_response_executes": (
        [dict(kind=FaultKind.NET_PARTITION, fault_id="p", direction="response", duration_secs=3.0)],
        [("m", 0.5, 0.0), ("m", 0.5, 1.0), ("m", 0.5, 5.0)],
    ),
    "partition_request_never_executes": (
        [dict(kind=FaultKind.NET_PARTITION, fault_id="p", direction="request", duration_secs=3.0)],
        [("m", 0.5, 0.0), ("m", 0.5, 1.0), ("m", 0.5, 5.0)],
    ),
    "unavailable_count_and_at_step": (
        [dict(kind=FaultKind.NET_UNAVAILABLE, fault_id="u", at_step=1, count=2)],
        [("m", None, 0.0), ("m", None, 0.0), ("m", None, 0.0), ("m", None, 0.0)],
    ),
    "method_filter": (
        [dict(kind=FaultKind.NET_UNAVAILABLE, fault_id="u", method="report_task_result", count=1)],
        [("get_task", None, 0.0), ("report_task_result", None, 0.0), ("report_task_result", None, 0.0)],
    ),
    "two_faults_on_two_methods": (
        [
            dict(kind=FaultKind.NET_DELAY, fault_id="d", method="heartbeat", delay_ms=40.0,
                 duration_secs=2.0),
            dict(kind=FaultKind.NET_UNAVAILABLE, fault_id="u", method="get_task", at_step=1,
                 count=1),
        ],
        [("heartbeat", None, 0.0), ("get_task", None, 0.0), ("get_task", None, 0.5),
         ("heartbeat", None, 0.5), ("get_task", None, 0.0), ("heartbeat", None, 3.0)],
    ),
    "duplicate_delivery": (
        [dict(kind=FaultKind.NET_DUPLICATE, fault_id="dup", method="report_task_result",
              at_step=1, count=2)],
        [("server:report_task_result", None, 0.0), ("server:report_task_result", None, 0.0),
         ("server:report_version", None, 0.0), ("server:report_task_result", None, 0.0),
         ("server:report_task_result", None, 0.0)],
    ),
}


def _run_script(pkg: str, faults: list[dict], calls, seed, events_path: str) -> dict:
    """Drive one package's shim through ``calls`` on a scripted clock."""
    clock = [100.0]
    sleeps: list = []

    def sleep(secs):
        sleeps.append(round(secs, 12))
        clock[0] += max(secs, 0.01)

    fault_cls, shim_cls = (JaxFault, jax_netem.NetemShim) if pkg == "jax" else (Fault, NetemShim)
    shim = shim_cls(
        [fault_cls(**f) for f in faults], plan_seed=seed, process_id=1, worker_id=3,
        cluster_version=0, events_path=events_path, sleep=sleep, clock=lambda: clock[0],
    )
    outcomes, executed, armed = [], [], []
    for i, (method, timeout, advance) in enumerate(calls):
        clock[0] += advance
        try:
            if method.startswith("server:"):
                name = method.split(":", 1)[1]
                out = shim.server_call("svc", name, lambda req: executed.append(req) or req, i)
            else:
                out = shim.client_call("svc", method, lambda i=i: executed.append(i) or i, timeout)
            outcomes.append(("ok", out))
        except Exception as ex:  # noqa: BLE001 — the injected error is the outcome
            outcomes.append(("error", ex.code().name))
        armed.append(shim.armed_count)
    records = []
    if os.path.exists(events_path):
        with open(events_path) as f:
            records = [json.loads(line) for line in f if line.strip()]
    for r in records:
        r.pop("time"), r.pop("monotonic")
    return {"outcomes": outcomes, "sleeps": sleeps, "executed": executed, "armed": armed,
            "records": records}


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_both_shims_decide_delay_and_record_alike(tmp_path, case, seed):
    faults, calls = CASES[case]
    ref = _run_script("jax", faults, calls, seed, str(tmp_path / "jax.jsonl"))
    port = _run_script("port", faults, calls, seed, str(tmp_path / "port.jsonl"))
    assert port == ref
    assert ref["records"]  # every case fires


def test_jitter_is_seeded_by_plan_seed_process_and_fault(tmp_path):
    faults = [dict(kind=FaultKind.NET_DELAY, fault_id="d", delay_ms=100.0, duration_secs=30.0)]
    calls = [("m", None, 0.0)] * 3
    a = _run_script("port", faults, calls, 7, str(tmp_path / "a"))["sleeps"]
    b = _run_script("port", faults, calls, 7, str(tmp_path / "b"))["sleeps"]
    c = _run_script("port", faults, calls, 8, str(tmp_path / "c"))["sleeps"]
    assert a == b and a != c
    assert all(0.1 <= s <= 0.15 for s in a)  # base + uniform(0, base/2)


def test_the_injected_errors_are_the_ports_retryable_codes():
    shim = NetemShim(
        [Fault(kind=FaultKind.NET_BLACKHOLE, fault_id="b", duration_secs=30.0)],
        sleep=lambda s: None,
    )
    with pytest.raises(InjectedRpcError) as exc:
        shim.client_call("svc", "m", lambda: 1, 1.0)
    assert isinstance(exc.value, rpc_service.RpcError)
    assert exc.value.code() == StatusCode.DEADLINE_EXCEEDED
    assert rpc_service._retryable_error(exc.value)


# ---- arming from the environment --------------------------------------------


@pytest.mark.parametrize(
    "process_id, cluster_version, armed", [(0, 0, None), (1, 1, None), (1, 0, 1)]
)
def test_install_from_env_fences_process_and_generation(
    tmp_path, monkeypatch, process_id, cluster_version, armed
):
    path = str(tmp_path / "plan.json")
    named_plan("blackhole_master_link", 2).save(path)
    monkeypatch.setenv(chaos_hooks.PLAN_ENV, path)
    monkeypatch.setenv(jax_hooks.PLAN_ENV, path)
    kw = dict(process_id=process_id, cluster_version=cluster_version, worker_id=process_id)
    ref = jax_netem.install_from_env(**kw)
    shim = netem.install_from_env(**kw)
    assert (ref and ref.armed_count) == (shim and shim.armed_count) == armed
    assert rpc_service._client_fault_shim is shim
    netem.uninstall()
    assert rpc_service._client_fault_shim is None


def test_install_from_env_without_a_plan_installs_nothing(monkeypatch):
    monkeypatch.delenv(chaos_hooks.PLAN_ENV, raising=False)
    assert netem.install_from_env(process_id=0, cluster_version=0, worker_id=0) is None
    assert rpc_service._client_fault_shim is None


def test_an_unreadable_plan_fails_the_worker(tmp_path, monkeypatch):
    """The JAX worker logs an unreadable plan and runs without its faults;
    the port's raises (no fallback hides a broken plan)."""
    path = tmp_path / "plan.json"
    path.write_text("{not json")
    monkeypatch.setenv(chaos_hooks.PLAN_ENV, str(path))
    assert jax_netem.install_from_env(process_id=0, cluster_version=0, worker_id=0) is None
    with pytest.raises(ValueError):
        netem.install_from_env(process_id=0, cluster_version=0, worker_id=0)


def test_install_master_from_plan_arms_the_server_seam_alike(tmp_path):
    for name, armed in (("dup_report_storm", 2), ("blackhole_master_link", None)):
        ref = jax_netem.install_master_from_plan(jax_named_plan(name, 2))
        shim = netem.install_master_from_plan(named_plan(name, 2))
        assert (ref and ref.armed_count) == (shim and shim.armed_count) == armed
        assert rpc_service._server_fault_shim is shim
        netem.uninstall()
        jax_netem.uninstall()
        assert rpc_service._server_fault_shim is None


def test_master_shim_survives_sink_rebind_without_rearming():
    """A master-kill relaunch rebinds the sink on the SAME shim: an
    exhausted fault never fires again."""
    calls, mirrored = [], []
    shim = NetemShim(
        [Fault(kind=FaultKind.NET_DUPLICATE, fault_id="dup", method="report", count=1)]
    )
    shim.server_call("svc", "report", calls.append, "A")
    assert calls == ["A", "A"] and shim.armed_count == 0
    shim.set_telemetry_sink(lambda *a, **k: mirrored.append(a))
    shim.server_call("svc", "report", calls.append, "B")
    assert calls == ["A", "A", "B"] and mirrored == []


# ---- the dedup contract under duplicate delivery ----------------------------


def _servicer_pair(pkg: str, records: int):
    if pkg == "jax":
        from elasticdl_tpu.chaos.invariants import InvariantChecker as Checker
        from elasticdl_tpu.master.servicer import MasterServicer as Servicer
        from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as Dispatcher
        from elasticdl_tpu.rpc import messages as m

        return SimpleNamespace(
            checker=Checker(expected_records=records),
            d=Dispatcher({"s": (0, records)}, records_per_task=64, shuffle_seed=3),
            servicer_cls=Servicer, msg=m, shim=jax_netem.NetemShim, fault=JaxFault,
        )
    return SimpleNamespace(
        checker=InvariantChecker(expected_records=records),
        d=TaskDispatcher({"s": (0, records)}, records_per_task=64, shuffle_seed=3),
        servicer_cls=MasterServicer, msg=msg, shim=NetemShim, fault=Fault,
    )


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_duplicate_report_is_deduped_by_task_id(pkg):
    p = _servicer_pair(pkg, 128)
    p.d.add_observer(p.checker)
    servicer = p.servicer_cls(32, p.d)
    shim = p.shim([p.fault(kind=FaultKind.NET_DUPLICATE, fault_id="dup",
                           method="report_task_result", count=8)])
    while True:
        tid, task = p.d.get(worker_id=0)
        if task is None:
            break
        shim.server_call("svc", "report_task_result", servicer.report_task_result,
                         p.msg.ReportTaskResultRequest(task_id=tid))
    assert p.checker.check(p.d.counters(TaskType.TRAINING)) == []
    assert p.checker.dropped_reports == 2  # one drop per duplicated pair
    assert p.checker.double_counted_tasks() == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_duplicate_report_version_is_monotone_safe(pkg):
    p = _servicer_pair(pkg, 64)
    servicer = p.servicer_cls(32, p.d)
    servicer.add_version_observer(p.checker.on_version_report)
    shim = p.shim([p.fault(kind=FaultKind.NET_DUPLICATE, fault_id="dupv",
                           method="report_version", count=4)])
    for version in (2, 4, 6):
        shim.server_call("svc", "report_version", servicer.report_version,
                         p.msg.ReportVersionRequest(model_version=version, worker_id=0))
    assert servicer.get_model_version() == 6
    assert not any(v.invariant == "version_monotonic" for v in p.checker.check())


def test_duplicate_eval_metrics_are_counted_as_the_jax_servicer_counts_them():
    class _EvalService:
        reports = 0

        def set_master_servicer(self, s):
            pass

        def report_evaluation_metrics(self, outputs, labels, **kwargs):
            self.reports += 1

    counts = {}
    for pkg in ("jax", "port"):
        p = _servicer_pair(pkg, 64)
        service = _EvalService()
        servicer = p.servicer_cls(32, p.d, evaluation_service=service)
        tid, _task = p.d.get(worker_id=0)
        request = p.msg.ReportEvaluationMetricsRequest(task_id=tid)
        servicer.report_evaluation_metrics(request)
        servicer.report_evaluation_metrics(request)  # duplicate delivery
        counts[pkg] = (service.reports, servicer.duplicate_eval_drops)
    assert counts["port"] == counts["jax"] == (1, 1)


# ---- the port's socket seams ------------------------------------------------


class _CountingServicer:
    def __init__(self):
        self.calls = 0

    def heartbeat(self, request):
        self.calls += 1
        return msg.HeartbeatResponse()


@pytest.fixture()
def counting_server():
    servicer = _CountingServicer()
    server = rpc_service.create_server(servicer, 0, methods=("heartbeat",))
    server.start()
    yield servicer, server
    server.stop()


@pytest.mark.parametrize("direction, executed", [("response", 1), ("request", 0)])
def test_a_partition_on_the_socket(counting_server, direction, executed):
    """Response direction: the request lands and runs, the reply dies;
    request direction: it never reaches the server.  Both answer the
    caller DEADLINE_EXCEEDED after its deadline."""
    servicer, server = counting_server
    rpc_service.set_client_fault_shim(NetemShim(
        [Fault(kind=FaultKind.NET_PARTITION, fault_id="p", direction=direction,
               duration_secs=30.0)],
        sleep=lambda s: None,
    ))
    client = rpc_service.RpcClient(f"localhost:{server.port}", methods=("heartbeat",))
    with pytest.raises(InjectedRpcError) as exc:
        client._call("heartbeat", msg.HeartbeatRequest(worker_id=0), timeout=0.5)
    assert exc.value.code() == StatusCode.DEADLINE_EXCEEDED
    assert servicer.calls == executed


def test_the_client_seam_sees_every_attempt_with_its_service(counting_server):
    servicer, server = counting_server
    seen = []

    class _Shim:
        def client_call(self, service, method, invoke, timeout):
            seen.append((service, method, timeout))
            if len(seen) < 3:
                raise InjectedRpcError(StatusCode.UNAVAILABLE, "injected")
            return invoke()

    rpc_service.set_client_fault_shim(_Shim())
    client = rpc_service.RpcClient(
        f"localhost:{server.port}", methods=("heartbeat",),
        retry=RetryPolicy(max_attempts=5, base_delay_secs=0.0),
        retryable_methods={"heartbeat"}, deadlines=DeadlinePolicy.from_secs(2.0),
    )
    client._call("heartbeat", msg.HeartbeatRequest(worker_id=0))
    assert seen == [(rpc_service.SERVICE_NAME, "heartbeat", 2.0)] * 3
    assert servicer.calls == 1
    assert rpc_stats.snapshot() == {"unavailable": 2, "retries": 2}


def test_a_duplicated_report_over_the_socket_is_deduplicated_by_task_id():
    """The master's server with the shim at its seam: each
    ``report_task_result`` runs twice, the dispatcher counts it once and
    drops the re-delivery."""
    checker = InvariantChecker(expected_records=256)
    d = TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=3)
    d.add_observer(checker)
    servicer = MasterServicer(32, d)
    server = rpc_service.create_server(servicer, 0)
    server.start()
    try:
        rpc_service.set_server_fault_shim(NetemShim([Fault(
            kind=FaultKind.NET_DUPLICATE, fault_id="dup", method="report_task_result", count=2,
        )]))
        client = MasterClient(
            f"localhost:{server.port}", retry=RetryPolicy(max_attempts=3),
            retryable_methods=MASTER_RETRYABLE_METHODS,
        )
        while True:
            tid, task = d.get(worker_id=0)
            if task is None:
                break
            client.report_task_result(msg.ReportTaskResultRequest(task_id=tid))
    finally:
        server.stop()
    assert checker.check(d.counters(TaskType.TRAINING)) == []
    assert checker.dropped_reports == 2 and checker.double_counted_tasks() == []
    assert d.counters(TaskType.TRAINING).total_records == 256


def test_an_armed_worker_records_its_rpc_counters(tmp_path, monkeypatch):
    """A worker armed by the plan writes its RPC outcome counters to the
    event log after each failure, and the master merges them as a
    heartbeat would (per worker maxima, summed)."""
    plan_path, events = str(tmp_path / "plan.json"), str(tmp_path / "events.jsonl")
    named_plan("blackhole_master_link", 2).save(plan_path)
    monkeypatch.setenv(chaos_hooks.PLAN_ENV, plan_path)
    monkeypatch.setenv(chaos_hooks.EVENTS_ENV, events)
    netem.install_from_env(process_id=1, cluster_version=0, worker_id=5)
    rpc_stats.note_failure("deadline_exceeded")
    rpc_stats.note_retry()
    rpc_stats.note_failure("deadline_exceeded")
    with open(events) as f:
        recorded = [json.loads(line) for line in f]
    assert [r["rpc"] for r in recorded] == [
        {"deadline_exceeded": 1}, {"deadline_exceeded": 2, "retries": 1}]
    assert {r["observation"] for r in recorded} == {"rpc_stats"}
    assert {(r["worker_id"], r["process_id"]) for r in recorded} == {(5, 1)}
    servicer = MasterServicer(32, TaskDispatcher({"s": (0, 64)}, records_per_task=64))
    servicer.heartbeat(msg.HeartbeatRequest(worker_id=5, rpc={"retries": 3}))
    servicer.heartbeat(msg.HeartbeatRequest(worker_id=6, rpc={"unavailable": 1}))
    for r in recorded:
        servicer.merge_rpc_stats(r["worker_id"], r["rpc"])
    assert servicer.rpc_stats_totals() == {"retries": 3, "unavailable": 1, "deadline_exceeded": 2}
    netem.uninstall()
    rpc_stats.note_failure("unavailable")  # unarmed: nothing more recorded
    with open(events) as f:
        assert len(f.readlines()) == 2


# ---- the blackhole's race: a swallowed beat against the eviction -------------

# blackhole_master_link's posture: the chaos job's liveness timeout, the
# runner's RPC deadline, and the master's poll
RACE_TIMEOUT_SECS = 3.0
RACE_DEADLINE_SECS = 1.0
RACE_POLL_SECS = 0.5
# how late a loaded host may run the worker's count of an expired deadline
# and still have it logged before the eviction's SIGKILL (an H100 run was
# evicted 1.08 s after the fault, 0.08 s past a 1 s deadline)
RACE_HOST_LAG_SECS = 0.5


def _blackhole_race(interval: float, phase: float, poll_offset: float) -> tuple[float, float]:
    """One worker between task pulls, so its beats are its only liveness:
    its last beat lands at 0 s, the call at ``phase`` s (at the latest its
    next beat, ``interval`` s later) opens a blackhole window, and the
    master polls every ``RACE_POLL_SECS`` from ``poll_offset``.  Returns
    (when the worker counts its first expired deadline, when the master
    first finds it dead), through the real shim and servicer on one
    scripted clock."""
    now = [0.0]
    servicer = MasterServicer(
        32, TaskDispatcher({"s": (0, 64)}, records_per_task=64), clock=lambda: now[0]
    )
    servicer.heartbeat(msg.HeartbeatRequest(worker_id=1, step=3))
    counted: list[float] = []
    rpc_stats.set_observer(lambda _totals: counted.append(now[0]))

    def sleep(secs):
        now[0] += secs

    shim = NetemShim(
        [Fault(kind=FaultKind.NET_BLACKHOLE, fault_id="blackhole-p1", at_step=0,
               process_id=1, duration_secs=60.0)],
        process_id=1, worker_id=1, sleep=sleep, clock=lambda: now[0],
    )
    now[0] = phase
    with pytest.raises(InjectedRpcError) as info:
        shim.client_call("Master", "heartbeat", lambda: None, RACE_DEADLINE_SECS)
    rpc_service._note_rpc_failure(info.value)
    assert info.value.code() == StatusCode.DEADLINE_EXCEEDED
    evicted_at = poll_offset
    while True:
        now[0] = evicted_at
        if servicer.dead_workers(RACE_TIMEOUT_SECS) == [1]:
            return counted[0], evicted_at
        evicted_at += RACE_POLL_SECS


def _worst_race_margin(interval: float) -> float:
    margins = [
        evicted - counted
        for phase in (0.0, interval / 2, interval * 0.99, interval)
        for offset in (0.0, 0.01, 0.25, 0.49)
        for counted, evicted in [_blackhole_race(interval, phase, offset)]
    ]
    return min(margins)


def test_the_blackhole_race_at_the_fixed_two_second_beat():
    """At the lockstep worker's fixed 2 s beat, the beat the blackhole
    swallows expires its 1 s deadline at the instant the master's 3 s
    liveness timeout runs out: the eviction can come with no time for the
    worker to count it.  This is how phase 17's blackhole run lost its
    "deadline expired" gate on a loaded host."""
    assert _worst_race_margin(2.0) < 0.05


def _master_envs(*flags, timeout: float | None = RACE_TIMEOUT_SECS) -> dict:
    from elasticdl_tpu_torch.master.main import worker_envs
    from elasticdl_tpu_torch.utils.args import parse_master_args

    timeout_flags = () if timeout is None else ("--heartbeat_timeout_secs", str(timeout))
    return worker_envs(
        parse_master_args(["--model_def", "m.custom_model", *timeout_flags, *flags])
    )


def test_the_master_paces_the_beat_so_the_deadline_is_counted_first(monkeypatch):
    """The master's worker environment sets the beat's cadence from its
    liveness timeout and its RPC deadline, and at that cadence the
    swallowed beat's deadline is counted well before any eviction; with
    no deadline, or one as long as the timeout, the beat is a third of
    the timeout; under the default 30 s timeout it keeps its 2 s."""
    from elasticdl_tpu_torch.rpc.deadline import HEARTBEAT_INTERVAL_ENV
    from elasticdl_tpu_torch.worker import lockstep

    envs = _master_envs
    interval = float(envs("--rpc_deadline_secs", str(RACE_DEADLINE_SECS))[HEARTBEAT_INTERVAL_ENV])
    assert interval == 1.0
    assert _worst_race_margin(interval) >= RACE_HOST_LAG_SECS
    assert float(envs()[HEARTBEAT_INTERVAL_ENV]) == RACE_TIMEOUT_SECS / 3
    assert float(envs("--rpc_deadline_secs", "5.0")[HEARTBEAT_INTERVAL_ENV]) == RACE_TIMEOUT_SECS / 3
    assert HEARTBEAT_INTERVAL_ENV not in envs(timeout=None)
    # the worker's beat thread takes the cadence from its environment
    monkeypatch.setenv(HEARTBEAT_INTERVAL_ENV, str(interval))
    assert lockstep.heartbeat_interval_from_env() == interval
    monkeypatch.delenv(HEARTBEAT_INTERVAL_ENV)
    assert lockstep.heartbeat_interval_from_env() == lockstep.HEARTBEAT_INTERVAL_SECS == 2.0


# ---- a late beat against the eviction of a live worker ----------------------

def _evicts_a_live_worker(interval: float, late: float) -> bool:
    """A live worker between task pulls beats every ``interval`` s from
    0 s, and the beat due at ``interval`` comes ``late`` s after it (its
    process stalled: a host loaded by a job's start); the master polls
    every ``RACE_POLL_SECS`` from each of several offsets.  Whether any
    poll, through the real servicer on one scripted clock, finds the
    worker dead."""
    for poll_offset in (0.0, 0.1, 0.25, 0.4):
        now = [0.0]
        servicer = MasterServicer(
            32, TaskDispatcher({"s": (0, 64)}, records_per_task=64), clock=lambda: now[0]
        )
        beats = [0.0, interval + late] + [interval * (k + 1) + late for k in range(1, 8)]
        polls = [poll_offset + RACE_POLL_SECS * k for k in range(int(beats[-1] / RACE_POLL_SECS))]
        for at, kind in sorted([(b, "beat") for b in beats] + [(p, "poll") for p in polls]):
            now[0] = at
            if kind == "beat":
                servicer.heartbeat(msg.HeartbeatRequest(worker_id=1, step=3))
            elif servicer.dead_workers(RACE_TIMEOUT_SECS):
                return True
    return False


@pytest.mark.parametrize("late", [0.0, 0.5, 1.2, 1.8])
def test_a_beat_late_by_under_two_intervals_does_not_evict_a_live_worker(late):
    """At the lockstep worker's fixed 2 s beat and the chaos runner's 3 s
    timeout, one beat 1.2 s late (a process stalled at a job's start)
    evicts a live worker: phase 17's ``preempt_one_worker`` lost a worker
    so before its planned kill at step 6 (``faults_injected`` FAIL, the
    trace's re-formations empty).  At the cadence the master sends, a
    third of the timeout, a beat may run up to two intervals late."""
    from elasticdl_tpu_torch.rpc.deadline import HEARTBEAT_INTERVAL_ENV

    interval = float(_master_envs()[HEARTBEAT_INTERVAL_ENV])
    assert not _evicts_a_live_worker(interval, late)
    assert _evicts_a_live_worker(2.0, late) == (late > RACE_TIMEOUT_SECS - 2.0)
