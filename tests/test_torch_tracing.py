"""The port's span tracing (``elasticdl_tpu_torch/telemetry/tracing.py``)
held to ``tests/test_tracing.py``'s cases: the recorder, sampling, the
overhead contract (a disabled hook reads no clock), rotation, the trace
context on the wire, the master's task traces, the export and the
analyzer, the report's trace section, the profiler window's events and
span, the worker's task span and ``trace_fetches``, and a chaos run's
re-formation traced end to end.  Where the JAX package can run the same
case, both packages run it and their records are compared.
"""

from __future__ import annotations

import json
import os
import time

import pytest

from elasticdl_tpu.telemetry import tracing as jax_tracing
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.telemetry import trace as trace_cli
from elasticdl_tpu_torch.telemetry import tracing
from elasticdl_tpu_torch.telemetry.events import read_jsonl, rotate_if_needed
from elasticdl_tpu_torch.telemetry.master_hooks import MasterTelemetry
from elasticdl_tpu_torch.telemetry.tracing import (
    SPAN_CHECKPOINT_RESTORE,
    SPAN_REFORM,
    SPAN_REFORM_FENCE,
    SPAN_REFORM_RELAUNCH,
    SPAN_TASK_EXECUTE,
    SPAN_TASK_LIFECYCLE,
    SPAN_WORLD_JOIN,
    SpanRecorder,
    gen_span_id,
    gen_trace_id,
    read_spans,
)


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.uninstall()
    yield
    tracing.uninstall()


def _spans_path(tmp_path) -> str:
    return os.path.join(str(tmp_path), "spans.jsonl")


# ---- recorder mechanics -----------------------------------------------------


def test_trace_and_span_id_widths():
    assert len(gen_trace_id()) == 32
    assert len(gen_span_id()) == 16
    int(gen_trace_id(), 16)  # hex
    assert gen_trace_id() != gen_trace_id()


def test_the_span_vocabulary_is_the_jax_packages():
    names = {k: v for k, v in vars(tracing).items() if k.startswith("SPAN")}
    assert names == {k: v for k, v in vars(jax_tracing).items() if k.startswith("SPAN")}
    assert tracing.TRACE_SAMPLE_RATE_ENV == jax_tracing.TRACE_SAMPLE_RATE_ENV
    assert tracing.TRACE_PARENT_ENV == jax_tracing.TRACE_PARENT_ENV
    assert tracing.DEFAULT_SAMPLE_RATE == jax_tracing.DEFAULT_SAMPLE_RATE


def test_span_records_parenting_and_attrs(tmp_path):
    rec = SpanRecorder(_spans_path(tmp_path), worker_id=7, generation=2)
    with rec.span("outer_span", task_id=3) as outer:
        with rec.span("inner_span") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_span_id == outer.span_id
    rec.flush()
    by_name = {s["span"]: s for s in read_spans(_spans_path(tmp_path))}
    assert by_name["inner_span"]["parent_span_id"] == by_name["outer_span"]["span_id"]
    assert by_name["outer_span"]["task_id"] == 3
    assert by_name["outer_span"]["worker_id"] == 7
    assert by_name["outer_span"]["generation"] == 2
    assert by_name["outer_span"]["end"] >= by_name["outer_span"]["start"]


def test_a_span_record_has_the_jax_records_fields(tmp_path):
    """The same recorder calls in both packages write records with the
    same keys, so each package's ``trace`` CLI reads the other's log."""
    keys = []
    for mod, sub in ((tracing, "port"), (jax_tracing, "jax")):
        path = os.path.join(str(tmp_path), sub, "spans.jsonl")
        rec = mod.SpanRecorder(path, role="worker", worker_id=1, sample_rate=1.0)
        with rec.span("outer_span", task_id=3):
            rec.record_span("inner_span", 1.0, 2.0, sampled=True, step=4)
        rec.on_step(1)
        rec.on_step(2)
        rec.flush()
        keys.append(sorted((s["span"], tuple(sorted(s))) for s in mod.read_spans(path)))
    assert keys[0] == keys[1]


def test_explicit_trace_context_wins_over_stack(tmp_path):
    rec = SpanRecorder(_spans_path(tmp_path))
    ctx = {"trace_id": gen_trace_id(), "span_id": gen_span_id()}
    with rec.span("outer_span"):
        with rec.span("adopted_span", trace_ctx=ctx) as sp:
            assert sp.trace_id == ctx["trace_id"]
            assert sp.parent_span_id == ctx["span_id"]


def test_retroactive_record_span_and_sampling(tmp_path):
    rec = SpanRecorder(_spans_path(tmp_path), sample_rate=0.5)
    kept = sum(rec.record_span("sampled_span", 1.0, 2.0, sampled=True) for _ in range(10))
    assert kept == 5  # deterministic 1-in-2
    # lifecycle spans bypass the sampler
    for _ in range(3):
        assert rec.record_span("always_span", 1.0, 2.0)
    rec.flush()
    spans = read_spans(_spans_path(tmp_path))
    assert sum(1 for s in spans if s["span"] == "sampled_span") == 5
    assert sum(1 for s in spans if s["span"] == "always_span") == 3


def test_sample_rate_zero_drops_and_one_keeps(tmp_path):
    rec = SpanRecorder(_spans_path(tmp_path), sample_rate=0.0)
    assert not rec.record_span("x_span", 0.0, 1.0, sampled=True)
    rec = SpanRecorder(_spans_path(tmp_path), sample_rate=1.0)
    assert rec.record_span("x_span", 0.0, 1.0, sampled=True)


def test_on_step_records_interval_spans(tmp_path):
    rec = SpanRecorder(_spans_path(tmp_path), sample_rate=1.0)
    rec.on_step(10)  # no interval yet
    rec.on_step(11)
    rec.on_step(12)
    rec.flush()
    steps = [s for s in read_spans(_spans_path(tmp_path)) if s["span"] == "train_step"]
    assert [s["step"] for s in steps] == [10, 11]
    assert all(s["end"] >= s["start"] for s in steps)


def test_disabled_module_hooks_are_single_early_return(monkeypatch):
    """No tracer installed: the hot-path hooks must not even read the
    clock (the worker_hooks overhead contract, applied to spans)."""
    assert tracing.get_tracer() is None

    def boom(*_a, **_k):
        raise AssertionError("disabled path touched the clock")

    monkeypatch.setattr(tracing.time, "monotonic", boom)
    monkeypatch.setattr(tracing.time, "time", boom)
    tracing.record_step_span(5)
    tracing.flush()
    with tracing.trace_span("anything_span") as sp:
        assert sp is None
    assert list(tracing.trace_fetches(iter([1, 2]))) == [1, 2]


def test_disabled_recorder_is_usable_but_writes_nothing(tmp_path):
    rec = SpanRecorder("")  # a master without --telemetry_dir
    with rec.span("reform"):
        pass
    rec.record_span("x_span", 0.0, 1.0)
    rec.flush()  # no crash, nothing on disk
    assert not os.listdir(str(tmp_path))


def test_install_without_a_dir_leaves_no_tracer(tmp_path):
    """A run without telemetry after one with it in the same process
    writes nothing into the earlier run's directory (as
    ``worker_hooks.install("")``; the JAX install keeps the old one)."""
    assert tracing.install(str(tmp_path), sample_rate=1.0) is tracing.get_tracer()
    assert tracing.install("") is None and tracing.get_tracer() is None


# ---- rotation ---------------------------------------------------------------


def test_jsonl_rotation_caps_shards(tmp_path):
    path = os.path.join(str(tmp_path), "log.jsonl")
    line = json.dumps({"n": 0}) + "\n"
    for i in range(12):
        rotate_if_needed(path, max_bytes=len(line) * 2, keep_shards=3)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"n": i}) + "\n")
    shards = sorted(os.listdir(str(tmp_path)))
    assert "log.jsonl" in shards
    assert [p for p in shards if p.startswith("log.jsonl.")] == [
        "log.jsonl.1", "log.jsonl.2", "log.jsonl.3",
    ]
    # the reader walks shards oldest first; the newest record is last
    records = read_jsonl(path)
    assert records[-1]["n"] == 11
    assert [r["n"] for r in records] == sorted(r["n"] for r in records)


def test_event_log_rotation_end_to_end(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.telemetry import events as events_mod

    monkeypatch.setattr(events_mod, "ROTATE_MAX_BYTES", 200)
    log = events_mod.EventLog(os.path.join(str(tmp_path), "events.jsonl"))
    for i in range(50):
        log.emit("step", step=i)
    names = os.listdir(str(tmp_path))
    assert any(n.startswith("events.jsonl.") for n in names)
    assert len([n for n in names if n.startswith("events.jsonl")]) <= events_mod.ROTATE_KEEP_SHARDS + 1
    records = events_mod.read_events(os.path.join(str(tmp_path), "events.jsonl"))
    assert records[-1]["step"] == 49


def test_span_log_rotation(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.telemetry import events as events_mod

    monkeypatch.setattr(events_mod, "ROTATE_MAX_BYTES", 400)
    rec = SpanRecorder(_spans_path(tmp_path), buffer_spans=1)
    for i in range(30):
        rec.record_span("rotated_span", float(i), float(i) + 0.5)
    rec.flush()
    names = [n for n in os.listdir(str(tmp_path)) if "spans" in n]
    assert any(n.startswith("spans.jsonl.") for n in names)
    assert len(read_spans(_spans_path(tmp_path))) > 0


# ---- RPC wire format --------------------------------------------------------


def test_trace_context_round_trips_all_messages():
    ctx = {"trace_id": gen_trace_id(), "span_id": gen_span_id()}
    for message in (
        msg.GetTaskRequest(worker_id=1, trace=dict(ctx)),
        msg.TaskResponse(task_id=2, shard_name="s", trace=dict(ctx)),
        msg.ReportTaskResultRequest(task_id=2, trace=dict(ctx)),
        msg.WorldAssignmentResponse(has=True, worker_id=1, trace=dict(ctx)),
        msg.PredictRequest(request_id="r", trace=dict(ctx)),
        msg.SwapModelRequest(model_dir="d", trace=dict(ctx)),
    ):
        decoded = msg.decode(msg.encode(message))
        assert decoded.trace == ctx, type(message).__name__


def test_old_payloads_without_trace_fields_decode():
    """A peer from before the trace fields: its payload (no ``trace``
    key) decodes into the dataclasses with an empty context."""
    bodies = {
        "GetTaskRequest": {"worker_id": 3, "task_type": -1},
        "TaskResponse": {
            "task_id": 1, "shard_name": "s", "start": 0, "end": 64, "type": 0,
            "model_version": 5, "minibatch_size": 32, "extended": {},
        },
        "ReportTaskResultRequest": {"task_id": 1, "err_message": "", "exec_counters": {}},
        "WorldAssignmentResponse": {
            "has": True, "shutdown": False, "worker_id": 0,
            "coordinator_addr": "localhost:1", "num_processes": 2, "process_id": 1,
            "cluster_version": 3,
        },
    }
    for kind, body in bodies.items():
        header = json.dumps({"kind": kind, "body": body, "frames": []}).encode("utf-8")
        decoded = msg.decode(len(header).to_bytes(4, "little") + header)
        assert decoded.trace == {}, kind
    # the new encoding still reads as the old fields did
    assert msg.decode(msg.encode(msg.TaskResponse(task_id=9))).task_id == 9


# ---- master-side task traces ------------------------------------------------


def _master_fixture(tmp_path):
    telemetry = MasterTelemetry(str(tmp_path), trace_sample_rate=1.0)
    task_d = TaskDispatcher({"s": (0, 128)}, records_per_task=64, shuffle_seed=1)
    servicer = MasterServicer(32, task_d)
    telemetry.attach(task_d, servicer)
    return telemetry, task_d, servicer


def test_task_response_carries_dispatch_trace(tmp_path):
    telemetry, _task_d, servicer = _master_fixture(tmp_path)
    resp = servicer.get_task(msg.GetTaskRequest(worker_id=1))
    assert resp.trace.get("trace_id")
    assert resp.trace == telemetry.trace_for_task(resp.task_id)


def test_recovered_task_links_to_original_trace(tmp_path):
    """The preemption path: fail the first lease, lease again, and the
    new dispatch span shares the trace and parents to the original."""
    telemetry, task_d, servicer = _master_fixture(tmp_path)
    first = servicer.get_task(msg.GetTaskRequest(worker_id=0))
    task_d.report(first.task_id, success=False)  # the worker died or failed
    second = servicer.get_task(msg.GetTaskRequest(worker_id=1))
    assert second.trace["trace_id"] == first.trace["trace_id"]
    assert second.trace["span_id"] != first.trace["span_id"]
    task_d.report(second.task_id, success=True)
    # drain the rest so the spans close
    tid, _ = task_d.get(2)
    task_d.report(tid, success=True)
    telemetry.tracer.flush()
    spans = read_spans(os.path.join(str(tmp_path), "spans.jsonl"))
    roots = [
        s for s in spans
        if s["span"] == SPAN_TASK_LIFECYCLE and s["trace_id"] == first.trace["trace_id"]
    ]
    assert len(roots) == 2
    original = next(s for s in roots if not s["recovered"])
    recovered = next(s for s in roots if s["recovered"])
    assert recovered["parent_span_id"] == original["span_id"]
    assert original["success"] is False
    assert recovered["success"] is True


def test_lease_timeout_reclaim_closes_span(tmp_path):
    telemetry = MasterTelemetry(str(tmp_path))
    task_d = TaskDispatcher({"s": (0, 64)}, records_per_task=64, task_timeout_secs=0.001)
    servicer = MasterServicer(32, task_d)
    telemetry.attach(task_d, servicer)
    resp = servicer.get_task(msg.GetTaskRequest(worker_id=0))
    time.sleep(0.01)
    release = servicer.get_task(msg.GetTaskRequest(worker_id=1))
    assert release.trace["trace_id"] == resp.trace["trace_id"]
    task_d.report(release.task_id, success=True)
    telemetry.tracer.flush()
    spans = read_spans(os.path.join(str(tmp_path), "spans.jsonl"))
    assert len([s for s in spans if s.get("reclaimed")]) == 1


def test_the_lockstep_stream_response_carries_the_trace(tmp_path):
    telemetry, _task_d, servicer = _master_fixture(tmp_path)
    resp = servicer.get_step_task(msg.GetStepTaskRequest(seq=0, worker_id=0, cluster_version=0))
    assert resp.trace and resp.trace == telemetry.trace_for_task(resp.task_id)
    # the memo every other process of the world replays carries it too
    again = servicer.get_step_task(msg.GetStepTaskRequest(seq=0, worker_id=1, cluster_version=0))
    assert again.trace == resp.trace


# ---- export and analyze -----------------------------------------------------


def _write_jsonl(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")


def canned_reform_run(tmp_path) -> str:
    """Two generations with a 10 s downtime gap fully described by
    re-formation spans: detect 2 s, fence 1 s, relaunch 3 s, join 2 s,
    restore 1 s, warm-up 1 s."""
    run = str(tmp_path / "run")
    t0 = 1000.0
    events = []
    for i in range(5):
        events.append({
            "monotonic": t0 + i * 1.0, "time": 1.7e9 + i, "event": "step", "step": i,
            "generation": 0, "worker_id": i % 2, "records": 32,
            **({"duration_secs": 1.0} if i else {}),
        })
    gap_start = t0 + 4.0  # the last generation-0 step
    for i in range(4):
        events.append({
            "monotonic": gap_start + 10.0 + i * 1.0, "time": 1.7e9 + 20 + i, "event": "step",
            "step": 5 + i, "generation": 1, "worker_id": i % 2, "records": 32,
            **({"duration_secs": 1.0} if i else {}),
        })
    trace_id = gen_trace_id()
    reform_root = gen_span_id()
    spans = [
        {"span": SPAN_REFORM, "trace_id": trace_id, "span_id": reform_root,
         "parent_span_id": "", "role": "master", "worker_id": 0, "process_id": 0,
         "generation": 1, "start": gap_start + 2.0, "end": gap_start + 6.0,
         "reason": "worker_failure"},
        {"span": SPAN_REFORM_FENCE, "trace_id": trace_id, "span_id": gen_span_id(),
         "parent_span_id": reform_root, "role": "master", "generation": 1,
         "start": gap_start + 2.0, "end": gap_start + 3.0},
        {"span": SPAN_REFORM_RELAUNCH, "trace_id": trace_id, "span_id": gen_span_id(),
         "parent_span_id": reform_root, "role": "master", "generation": 1,
         "start": gap_start + 3.0, "end": gap_start + 6.0},
        {"span": SPAN_WORLD_JOIN, "trace_id": trace_id, "span_id": gen_span_id(),
         "parent_span_id": reform_root, "role": "worker", "worker_id": 2, "generation": 1,
         "start": gap_start + 6.0, "end": gap_start + 8.0},
        {"span": SPAN_CHECKPOINT_RESTORE, "trace_id": gen_trace_id(),
         "span_id": gen_span_id(), "parent_span_id": "", "role": "worker", "worker_id": 2,
         "generation": 1, "start": gap_start + 8.0, "end": gap_start + 9.0},
    ]
    _write_jsonl(os.path.join(run, "events.jsonl"), events)
    _write_jsonl(os.path.join(run, "spans.jsonl"), spans)
    return run


def test_export_emits_valid_chrome_trace(tmp_path):
    run = canned_reform_run(tmp_path)
    out = str(tmp_path / "trace.json")
    assert trace_cli.main(["export", run, "--output", out]) == 0
    with open(out, encoding="utf-8") as f:
        chrome = json.load(f)
    events = chrome["traceEvents"]
    assert isinstance(events, list) and events
    slices = [e for e in events if e["ph"] == "X"]
    assert slices, "no complete events"
    for e in slices:
        assert isinstance(e["ts"], (int, float))
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        assert e["name"]
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
    # one track per worker per generation, and a master track
    labels = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "process_name"}
    assert any("worker 0 gen 0" in label for label in labels)
    assert any("worker 0 gen 1" in label for label in labels)
    assert any("master" in label for label in labels)
    # span slices carry their causal ids for Perfetto queries
    reform = next(e for e in slices if e["name"] == SPAN_REFORM)
    assert reform["args"]["trace_id"]


def test_export_cli_on_empty_dir(tmp_path):
    assert trace_cli.main(["export", str(tmp_path)]) == 0  # an empty, valid trace
    assert trace_cli.main(["analyze", str(tmp_path / "missing")]) == 2


def test_analyze_attributes_reform_downtime_phases(tmp_path):
    run = canned_reform_run(tmp_path)
    report = trace_cli.analyze_run_dir(run)
    (_rel, analysis) = next(iter(report["runs"].items()))
    gaps = analysis["reform_downtime"]
    assert len(gaps) == 1
    gap = gaps[0]
    assert abs(gap["downtime_secs"] - 10.0) < 1e-6
    phases = gap["phases_secs"]
    # at least 90 % of the downtime in named phases
    assert gap["coverage"] >= 0.9, phases
    assert abs(phases["death_detection"] - 2.0) < 1e-6
    assert abs(phases["quiesce_recover"] - 1.0) < 1e-6
    assert abs(phases["world_relaunch"] - 3.0) < 1e-6
    assert abs(phases["world_join"] - 2.0) < 1e-6
    assert abs(phases["checkpoint_restore"] - 1.0) < 1e-6
    assert abs(phases["warmup_compile"] - 1.0) < 1e-6
    # the phases sum to the downtime (the sweep attributes every second)
    assert abs(sum(phases.values()) - gap["downtime_secs"]) < 1e-6


def test_analyze_without_spans_reports_unattributed(tmp_path):
    run = canned_reform_run(tmp_path)
    os.remove(os.path.join(run, "spans.jsonl"))
    report = trace_cli.analyze_run_dir(run)
    (_rel, analysis) = next(iter(report["runs"].items()))
    gap = analysis["reform_downtime"][0]
    assert gap["coverage"] == 0.0
    assert abs(gap["phases_secs"]["unattributed"] - gap["downtime_secs"]) < 1e-6


def test_straggler_report_wait_vs_work(tmp_path):
    """Worker 1 is 3x slower on every shared step: it is flagged, and
    worker 0 carries the barrier wait."""
    run = str(tmp_path / "run")
    events = []
    for step in range(1, 9):
        for worker, dur in ((0, 0.1), (1, 0.3)):
            events.append({
                "monotonic": 100.0 + step * 0.4 + worker * 0.001, "time": 1.7e9,
                "event": "step", "step": step, "generation": 0, "worker_id": worker,
                "records": 32, "duration_secs": dur,
            })
    _write_jsonl(os.path.join(run, "events.jsonl"), events)
    _write_jsonl(os.path.join(run, "spans.jsonl"), [])
    (_rel, analysis) = next(iter(trace_cli.analyze_run_dir(run)["runs"].items()))
    workers = analysis["stragglers"][0]["workers"]
    assert workers[1]["straggler"] is True
    assert workers[0]["straggler"] is False
    # the fast worker waits at the barrier, the straggler works
    assert workers[0]["barrier_wait_secs"] > workers[1]["barrier_wait_secs"]
    assert workers[0]["barrier_wait_pct"] > 50
    assert workers[1]["barrier_wait_pct"] == 0


# ---- the report's trace section and the profiler window ---------------------


def test_report_includes_trace_section(tmp_path):
    from elasticdl_tpu.telemetry import report as jax_report
    from elasticdl_tpu_torch.telemetry import report

    run = canned_reform_run(tmp_path)
    section = report.trace_section(run)
    assert section["reform_downtime"][0]["coverage"] >= 0.9
    assert section == jax_report.build_report(run)["runs"]["events.jsonl"]["trace"]
    assert report.trace_section(str(tmp_path / "none")) is None


def test_step_profiler_emits_window_events_and_span(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.telemetry import worker_hooks
    from elasticdl_tpu_torch.utils import profiling

    calls = []
    monkeypatch.setattr(profiling, "start_trace", lambda d, device=None: calls.append(("start", d)))
    monkeypatch.setattr(profiling, "stop_trace", lambda: calls.append(("stop", None)))
    worker_hooks.install(str(tmp_path), worker_id=1)
    tracing.install(str(tmp_path), worker_id=1, sample_rate=1.0)
    try:
        profiler = profiling.StepProfiler(str(tmp_path / "prof"), start_step=1, num_steps=2)
        for _ in range(6):
            profiler.on_step()
        profiler.stop()
        tracing.flush()
    finally:
        worker_hooks.uninstall()
    assert [c[0] for c in calls] == ["start", "stop"]
    names = [e["event"] for e in read_jsonl(os.path.join(str(tmp_path), "events.jsonl"))]
    assert "profile_window_open" in names
    assert "profile_window_close" in names
    window = [s for s in read_spans(_spans_path(tmp_path)) if s["span"] == "profile_window"]
    assert len(window) == 1
    assert window[0]["end"] > window[0]["start"]


def test_worker_task_span_adopts_dispatch_trace(tmp_path):
    """The worker's task_execute span lands in the master's dispatch
    trace (wired in process, no transport)."""
    tracing.install(str(tmp_path), worker_id=5, sample_rate=1.0)
    ctx = {"trace_id": gen_trace_id(), "span_id": gen_span_id()}
    with tracing.trace_span(SPAN_TASK_EXECUTE, trace_ctx=ctx, task_id=1):
        tracing.record_step_span(0)
        tracing.record_step_span(1)
    tracing.flush()
    spans = read_spans(_spans_path(tmp_path))
    task = next(s for s in spans if s["span"] == SPAN_TASK_EXECUTE)
    assert task["trace_id"] == ctx["trace_id"]
    assert task["parent_span_id"] == ctx["span_id"]
    steps = [s for s in spans if s["span"] == "train_step"]
    assert steps and all(s["trace_id"] == ctx["trace_id"] for s in steps)
    assert all(s["parent_span_id"] == task["span_id"] for s in steps)


def test_trace_fetches_records_first_fetch(tmp_path):
    tracing.install(str(tmp_path), sample_rate=1.0)
    ctx = {"trace_id": gen_trace_id(), "span_id": gen_span_id()}
    assert list(tracing.trace_fetches(iter([1, 2, 3]), trace_ctx=ctx)) == [1, 2, 3]
    tracing.flush()
    fetch = [s for s in read_spans(_spans_path(tmp_path)) if s["span"] == "data_fetch"]
    assert len(fetch) == 1
    assert fetch[0]["trace_id"] == ctx["trace_id"]


def test_the_reform_trace_reaches_a_relaunched_worker_by_env(monkeypatch):
    ctx = {"trace_id": gen_trace_id(), "span_id": gen_span_id()}
    monkeypatch.setenv(tracing.TRACE_PARENT_ENV, json.dumps(ctx))
    assert tracing.parent_from_env() == ctx
    monkeypatch.setenv(tracing.TRACE_PARENT_ENV, "not json")
    assert tracing.parent_from_env() is None
    monkeypatch.setenv(tracing.TRACE_SAMPLE_RATE_ENV, "0.25")
    assert tracing.sample_rate_from_env() == 0.25


# ---- a chaos run's re-formation, traced -------------------------------------


def _all_spans(run_dir: str) -> list[dict]:
    spans = []
    for root, _dirs, files in os.walk(run_dir):
        if "spans.jsonl" in files:
            spans.extend(read_spans(os.path.join(root, "spans.jsonl")))
    return spans


def test_chaos_preempt_trace_critical_path(tmp_path):
    """On a ``preempt_one_worker`` run ``trace analyze`` attributes at
    least 90 % of the re-formation's downtime to named phases, the
    master's reform trace holds the relaunched workers' world_join
    spans, and ``chaos_result.json`` carries the breakdown."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig, run_chaos_job
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.chaos.runner import write_result_json

    report = run_chaos_job(ChaosJobConfig(
        plan=builtin_plans(2)["preempt_one_worker"], workdir=str(tmp_path),
        device="cpu", num_records=512, num_epochs=2,
        extra_master_args=["--trace_sample_rate", "1.0"],
    ))
    assert report["invariants_ok"], report
    analysis = trace_cli.analyze_run_dir(str(tmp_path))
    gaps = [g for run in analysis["runs"].values() for g in run["reform_downtime"]]
    assert gaps, "no re-formation downtime captured"
    assert gaps[0]["coverage"] >= 0.9, gaps[0]
    spans = _all_spans(str(tmp_path))
    reform = next(s for s in spans if s["span"] == SPAN_REFORM)
    joined = [s for s in spans if s["span"] == SPAN_WORLD_JOIN and s["generation"] == 1]
    assert joined and all(s["trace_id"] == reform["trace_id"] for s in joined)
    with open(write_result_json(report, str(tmp_path)), encoding="utf-8") as f:
        result = json.load(f)
    traced = [g for run in result["trace"].values() for g in run["reform_downtime"]]
    assert traced and traced[0]["coverage"] >= 0.9


def test_chaos_coordinator_kill_links_recovered_task_trace(tmp_path):
    """Killing the chief (the task reporter) mid-task leaves a lease
    unreported: the recovered task's new dispatch span links back into
    its original trace, parented to the previous attempt's span."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig, run_chaos_job
    from elasticdl_tpu_torch.chaos.plan import builtin_plans

    report = run_chaos_job(ChaosJobConfig(
        plan=builtin_plans(2)["preempt_coordinator"], workdir=str(tmp_path),
        device="cpu", num_records=512, num_epochs=2,
        extra_master_args=["--trace_sample_rate", "1.0"],
    ))
    assert report["invariants_ok"], report
    spans = _all_spans(str(tmp_path))
    recovered = [s for s in spans if s.get("recovered")]
    assert recovered, "no recovered-task span"
    originals = {
        s["trace_id"] for s in spans if s["span"] == SPAN_TASK_LIFECYCLE and not s.get("recovered")
    }
    assert all(s["trace_id"] in originals for s in recovered)
    by_id = {s["span_id"]: s for s in spans}
    for span in recovered:
        parent = by_id.get(span["parent_span_id"])
        assert parent is not None and parent["span"] == SPAN_TASK_LIFECYCLE
