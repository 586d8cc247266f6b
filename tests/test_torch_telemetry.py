"""The port's metrics registry, event log, ``/metrics`` endpoint and master
telemetry (``elasticdl_tpu_torch/telemetry/``) against the JAX package's,
on the CPU.

The registry's Prometheus text is byte-equal to the JAX registry's after
the same operations; the event log rotates and skips torn lines as the
JAX log does; ``MasterTelemetry`` registers the JAX family names for the
families slice 10a ports (the rest are listed, and wait for slice 10b),
driven by the same observer calls; a master on the CPU serves
``/metrics`` and ``/healthz`` over HTTP, with the JAX body's keys.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
from elasticdl_tpu.rpc import messages as jax_msg
from elasticdl_tpu.telemetry import events as jax_events
from elasticdl_tpu.telemetry import registry as jax_registry
from elasticdl_tpu.telemetry.master_hooks import MasterTelemetry as JaxTelemetry
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.telemetry import compile_tracker, events, registry
from elasticdl_tpu_torch.telemetry.httpd import TelemetryHTTPServer
from elasticdl_tpu_torch.telemetry.master_hooks import MasterTelemetry

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"


# ---- the registry ------------------------------------------------------------


def _ops_counters(r):
    r.counter("a_total", "A counter").inc()
    r.counter("a_total", labels={"type": "eval"}).inc(2.5)
    c = r.counter("mirror_total", "Mirrored")
    c.set_total(7)
    c.set_total(3)  # never lowers
    r.gauge("g", "A gauge", labels={"w": 'q"ote\\d'}).set(-1.25)
    g = r.gauge("g2")
    g.inc(4)
    g.dec(0.5)


def _ops_histograms(r):
    h = r.histogram("lat_seconds", "Latency", labels={"phase": "device_compute"})
    for v in (0.0005, 0.003, 0.003, 0.7, 99.0):
        h.observe(v)
    m = r.histogram("phase_seconds", labels={"phase": "host_fetch"})
    m.set_totals({"0.001": 2, "0.01": 5, "inf": 1, "junk": "x"}, 0.25, 8)
    m.set_totals({"0.001": 1}, 0.1, 3)  # monotone per slot
    r.histogram("serve_seconds", buckets=registry.SERVING_LATENCY_BUCKETS).observe(0.0002)


def _ops_prune_and_collect(r):
    for w in ("0", "1", "2"):
        r.gauge("age_secs", "Ages", labels={"worker": w}).set(float(w))
    r.prune_children("age_secs", [{"worker": "1"}])
    r.add_collect_callback(lambda reg: reg.gauge("scraped").inc())
    r.add_collect_callback(lambda reg: 1 / 0)  # a scrape never fails
    r.exposition()  # one scrape before the compared one


@pytest.mark.parametrize("ops", [_ops_counters, _ops_histograms, _ops_prune_and_collect])
def test_exposition_is_byte_equal_to_the_jax_registrys(ops):
    port, ref = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    ops(port)
    ops(ref)
    assert port.exposition() == ref.exposition()
    assert port.family_names() == ref.family_names()


def test_the_registrys_constants_and_refusals_are_the_jax_registrys():
    assert registry.STEP_LATENCY_BUCKETS == jax_registry.STEP_LATENCY_BUCKETS
    assert registry.SERVING_LATENCY_BUCKETS == jax_registry.SERVING_LATENCY_BUCKETS
    r = registry.MetricsRegistry()
    r.counter("x_total")
    with pytest.raises(ValueError, match="already registered"):
        r.gauge("x_total")
    with pytest.raises(ValueError, match="snake_case"):
        r.counter("Bad-Name")
    with pytest.raises(ValueError, match="only go up"):
        r.counter("x_total").inc(-1)


# ---- the event log -------------------------------------------------------------


def test_the_event_names_are_the_jax_packages():
    names = {k: v for k, v in vars(jax_events).items() if k.startswith("EVENT_")}
    assert {k: v for k, v in vars(events).items() if k.startswith("EVENT_")} == names
    assert events.EVENTS_FILENAME == jax_events.EVENTS_FILENAME


@pytest.mark.parametrize("async_writes", [False, True])
def test_rotation_and_torn_lines_read_as_the_jax_log_reads(tmp_path, monkeypatch, async_writes):
    monkeypatch.setenv(events.ROTATE_MAX_MB_ENV, str(300 / (1024 * 1024)))
    path = str(tmp_path / "events.jsonl")
    log = events.EventLog(path, async_writes=async_writes)
    for i in range(40):
        log.emit("step", step=i, worker_id=i % 2)
    log.flush()
    with open(path, "a") as f:
        f.write('{"event": "step", "step"')  # a writer killed mid-line
    shards = sorted(os.listdir(tmp_path))
    assert len(shards) > 1  # rotated, the oldest beyond the cap dropped
    got = events.read_jsonl(path)
    assert got == jax_events.read_jsonl(path) == events.read_events(path)
    steps = [e["step"] for e in got]
    assert steps == sorted(steps) and steps[-1] == 39
    assert all(e["event"] == "step" and "monotonic" in e and "time" in e for e in got)


def test_a_log_without_a_path_swallows_every_emit(tmp_path):
    log = events.EventLog("", async_writes=True)
    log.emit("step", step=1)
    log.flush()
    assert not log.enabled and os.listdir(tmp_path) == []


# ---- the master's telemetry ----------------------------------------------------

# the JAX families slice 10a leaves out: the memory ledger's and the
# heartbeat fan-in's and sweep's counters (the port's servicer applies
# each beat inline), slice 10b's
LEFT_FOR_10B = {
    "elasticdl_memory_bytes",
    "elasticdl_heartbeats_total",
    "elasticdl_heartbeat_batches_total",
    "elasticdl_heartbeat_batch_max",
    "elasticdl_dead_worker_sweeps_total",
    "elasticdl_dead_worker_sweep_ms_total",
    "elasticdl_dead_worker_sweep_max_ms",
}


def _drive_master(telemetry_cls, dispatcher_cls, servicer_cls, module, tmp):
    task_d = dispatcher_cls({"s": (0, 256)}, records_per_task=64)
    servicer = servicer_cls(32, task_d)
    telemetry = telemetry_cls(tmp)
    telemetry.attach(task_d, servicer)
    telemetry.job_start("training_only", 2)
    tid, task = task_d.get(0)
    task_d.report(tid, True, exec_counters={"time_batch_process_ms": 12, "compile_count": 2})
    tid, task = task_d.get(1)
    task_d.report(tid, False)
    task_d.report(tid, True)  # a stale report: dropped by the dedup
    servicer.report_version(module.ReportVersionRequest(model_version=4, worker_id=0))
    for worker_id in (0, 1):
        servicer.heartbeat(module.HeartbeatRequest(
            worker_id=worker_id, step=4,
            rpc={"retries": 1, "deadline_exceeded": worker_id},
            phases={"device_compute": {"ms": 12.5, "count": 2, "buckets": {"0.01": 2}},
                    "host_fetch": {"ms": 0.5, "count": 2, "buckets": {"0.001": 2}}},
            prefetch={"groups": 3, "stall_ms": 1, "stage_ms": 2, "boundary_stall_ms": 4},
        ))
    telemetry.observe_rpc("heartbeat", 0.002)
    telemetry.worker_dead([1], 0)
    telemetry.reform_start(1, [1], "worker_failure", 2)
    telemetry.reform_complete(1, 2, 2)
    telemetry.reform_latency(1, 1.5)
    telemetry.master_restart(1)
    telemetry.journal_replay(1, 0.01, 3, 1, 0)
    # each with its span's start, as the JAX master passes it
    telemetry.worker_rehome(0, 1, 1, 0, 0.0)
    telemetry.slice_loss(1, [1], [2, 3], 2, 1, False, 0.0)
    telemetry.mesh_resize(1, 4, 2, 2, 1, None, 0.0)
    telemetry.autoscale_decision(1, 0.0, "grow", 1, 2, "backlog 5 >= 4", None, 5)
    text = telemetry.registry.exposition()
    telemetry.job_end(0)
    return telemetry, text


def _samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_master_telemetry_registers_the_jax_families_10a_ports(tmp_path):
    port, port_text = _drive_master(
        MasterTelemetry, TaskDispatcher, MasterServicer, msg, str(tmp_path / "port")
    )
    ref, ref_text = _drive_master(
        JaxTelemetry, JaxDispatcher, JaxServicer, jax_msg, str(tmp_path / "jax")
    )
    port_families, ref_families = set(port.registry.family_names()), set(ref.registry.family_names())
    assert port_families == ref_families - LEFT_FOR_10B
    assert LEFT_FOR_10B <= ref_families
    # the same values under the same names, but for what depends on the
    # process (its own compiles) or the clock (ages, latencies)
    port_samples, ref_samples = _samples(port_text), _samples(ref_text)
    volatile = ("elasticdl_compile_total", "heartbeat_age", "rpc_latency", "workers_live")
    for name, value in port_samples.items():
        if not any(v in name for v in volatile):
            assert ref_samples[name] == value, name
    assert port_samples['elasticdl_step_phase_ms_total{phase="device_compute"}'] == 25.0
    assert port_samples["elasticdl_rpc_reports_deduped_total"] == 1
    # the event log's records, as the JAX master writes them (but for
    # the memory ledger's samples, slice 10b's, and the span ids)
    def records(tel_dir):
        return [
            {k: v for k, v in e.items() if k not in ("time", "monotonic", "trace_id")}
            for e in events.read_jsonl(os.path.join(tel_dir, "events.jsonl"))
            if e["event"] != "memory_sample"
        ]

    assert records(str(tmp_path / "port")) == records(str(tmp_path / "jax"))

    # and the span log's spans, by name and attributes (not ids or clocks)
    def spans(tel_dir):
        return sorted(
            json.dumps({k: v for k, v in s.items()
                        if k not in ("time", "start", "end", "trace_id", "span_id",
                                     "parent_span_id")}, sort_keys=True)
            for s in events.read_jsonl(os.path.join(tel_dir, "spans.jsonl"))
        )

    assert spans(str(tmp_path / "port")) == spans(str(tmp_path / "jax"))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()


def test_metrics_and_healthz_over_http_have_the_jax_bodys_keys():
    bodies = {}
    for name, telemetry_cls, dispatcher_cls, servicer_cls in (
        ("port", MasterTelemetry, TaskDispatcher, MasterServicer),
        ("jax", JaxTelemetry, JaxDispatcher, JaxServicer),
    ):
        task_d = dispatcher_cls({"s": (0, 128)}, records_per_task=64)
        servicer = servicer_cls(32, task_d)
        telemetry = telemetry_cls()
        telemetry.attach(task_d, servicer)
        server = (TelemetryHTTPServer if name == "port" else _jax_httpd())(
            telemetry.registry, health_fn=telemetry.build_health_fn("training_only"), port=0,
        )
        server.start()
        try:
            status, ctype, text = _get(server.port, "/metrics")
            assert status == 200 and "version=0.0.4" in ctype
            assert text == telemetry.registry.exposition()
            servicer.begin_quiesce()
            status, ctype, body = _get(server.port, "/healthz")
            assert status == 200 and ctype == "application/json"
            bodies[name] = json.loads(body)
            with pytest.raises(urllib.error.HTTPError):
                _get(server.port, "/nope")
        finally:
            server.stop()
    assert set(bodies["port"]) == set(bodies["jax"])
    assert set(bodies["port"]["memory"]) == {"host_rss_bytes", "host_available_bytes", "headroom_share"}
    for key in ("status", "job_type", "generation", "quiescing", "live_workers"):
        assert bodies["port"][key] == bodies["jax"][key], key
    assert bodies["port"]["status"] == "quiescing"


def _jax_httpd():
    from elasticdl_tpu.telemetry.httpd import TelemetryHTTPServer as JaxHTTPServer

    return JaxHTTPServer


def _master_args(tmp_path, *extra):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist
    from elasticdl_tpu_torch.utils.args import parse_master_args

    train = gen_mnist(str(tmp_path / "train"), num_records=64, num_shards=1, seed=1)
    return parse_master_args([
        "--model_def", MNIST_DEF, "--training_data", train, "--records_per_task", "32",
        "--minibatch_size", "32", "--num_workers", "0", "--port", "0", "--device", "cpu",
        *extra,
    ])


def test_a_cpu_master_serves_metrics_and_healthz_and_logs_its_job(tmp_path):
    from elasticdl_tpu_torch.master.main import build_master

    master = build_master(_master_args(tmp_path, "--telemetry_dir", str(tmp_path / "telemetry")))
    master.prepare()
    try:
        assert master.metrics_port is not None
        status, _ctype, text = _get(master.metrics_port, "/metrics")
        families = [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")]
        assert status == 200 and len(families) >= 8 and len(set(families)) == len(families)
        assert 'elasticdl_tasks_dispatched_total{type="training"} 0' in text
        status, _ctype, body = _get(master.metrics_port, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok" and health["job_type"] == "training_only"
    finally:
        master.request_stop()
        master.stop()
    assert master.metrics_port is None  # stopped with the master
    names = [e["event"] for e in events.read_jsonl(str(tmp_path / "telemetry" / "events.jsonl"))]
    assert names[0] == "job_start" and names[-1] == "job_end"


def test_a_negative_metrics_port_serves_nothing(tmp_path):
    from elasticdl_tpu_torch.master.main import build_master

    before = threading.active_count()
    master = build_master(_master_args(tmp_path, "--metrics_port", "-1"))
    master.prepare()
    try:
        assert master.metrics_port is None
    finally:
        master.request_stop()
        master.stop()
    assert threading.active_count() <= before + 1


# ---- the compile tracker ----------------------------------------------------------


def test_compile_deltas_ride_the_reports_once():
    compile_tracker._reset_for_tests()
    reporter = compile_tracker.ExecCounterReporter()
    assert compile_tracker.note_shape(("a", 1)) and not compile_tracker.note_shape(("a", 1))
    compile_tracker.note_compile(0.5)
    counters: dict = {}
    total = reporter.attach(counters)
    assert counters == {compile_tracker.COMPILE_COUNT_KEY: 2} and total == 2
    # a report that failed is not committed: its delta ships again
    again: dict = {}
    reporter.attach(again)
    assert again == counters
    reporter.commit(total)
    after: dict = {}
    reporter.attach(after)
    assert after == {} and compile_tracker.compile_secs_total() == 0.5
    from elasticdl_tpu.telemetry.compile_tracker import COMPILE_COUNT_KEY

    assert compile_tracker.COMPILE_COUNT_KEY == COMPILE_COUNT_KEY


# ---- chip_smoke.py's phase 18b, small ------------------------------------------


def _chip_smoke():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def phase18b(tmp_path_factory):
    from elasticdl_tpu_torch.telemetry import anatomy, worker_hooks

    chip_smoke = _chip_smoke()
    root = tmp_path_factory.mktemp("phase18b")
    mnist = dict(
        chip_smoke.ELASTIC_MNIST, train_records=1024, eval_records=0, batch=32,
        records_per_task=128, epochs=2,
    )
    data = chip_smoke._zoo_data(str(root / "data"), mnist)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        try:
            row = chip_smoke.anatomy_world_run(str(root / "run"), data, device="cpu", cfg=mnist)
        finally:
            anatomy.uninstall()
            worker_hooks.uninstall()
    return chip_smoke, row


def test_smoke_phase18b_rehearsal_on_the_cpu(phase18b):
    """18b's gates on a two-rank mnist world of 1 024 records x 2 epochs,
    32 rows a step: /metrics scraped twice over HTTP while it trains."""
    chip_smoke, row = phase18b
    assert chip_smoke.check_anatomy_world(row) == []
    assert set(row["first"]) == set(row["second"]) >= set(chip_smoke.TRACKED_PHASES) | {"untracked"}
    assert row["healthz"]["body"]["job_type"] == "training_only"
    assert list(row["goodput_generations"]) == [0]
    # every span kept, each task's trace across the master and a worker,
    # each rank's profiler window
    trace = row["trace"]
    assert chip_smoke.check_trace_dir(trace, world=True) == []
    assert trace["task_traces"] == 2 * 1024 // 128 and trace["task_traces_without_a_worker"] == 0
    assert trace["profile_events"] == {"profile_window_open": 2, "profile_window_close": 2}
    assert len(trace["profile_traces"]) == 2


def test_the_smokes_healthz_keys_are_the_jax_bodys():
    task_d = JaxDispatcher({"s": (0, 64)}, records_per_task=64)
    telemetry = JaxTelemetry()
    telemetry.attach(task_d, JaxServicer(32, task_d))
    assert _chip_smoke().HEALTHZ_KEYS == set(telemetry.build_health_fn("training_only")())


# each gate of 18b, and a change of the passing row that must trip it
PHASE18B_BREAKS = [
    lambda r: r.update(rc=1),
    lambda r: r.update(violations=["exactly_once"]),
    lambda r: r.update(second=None),
    lambda r: r["first"].pop("device_compute"),
    lambda r: r["second"].update(host_fetch=-1.0),
    lambda r: r["healthz"].update(status=500),
    lambda r: r["healthz"]["body"].pop("memory"),
    lambda r: r.update(goodput_generations={}),
    lambda r: r.update(step_generations=[0, 1]),
]


@pytest.mark.parametrize("case", range(len(PHASE18B_BREAKS)))
def test_each_phase18b_gate_trips(phase18b, case):
    import copy

    chip_smoke, row = phase18b
    row = copy.deepcopy(row)
    PHASE18B_BREAKS[case](row)
    assert chip_smoke.check_anatomy_world(row)
