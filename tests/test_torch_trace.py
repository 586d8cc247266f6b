"""``python -m elasticdl_tpu_torch.telemetry.trace export|analyze`` held
to the JAX package's ``telemetry/trace.py``, on the CPU.

The same span and event files go through both packages'
``build_chrome_trace`` and ``analyze_telemetry_dir``, and the results
are equal: a canned run with a re-formation, a master outage, a served
request and the step anatomy, and the directories that real port jobs
write (a Local job with ``--step_anatomy``, a two-rank gloo world, and
``serving.main --telemetry_dir`` answering a traced request).  So the
JAX analyzer reads a port job's directory, and the port's reads the
JAX package's.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.telemetry import trace as jax_trace
from elasticdl_tpu_torch.telemetry import trace, tracing
from elasticdl_tpu_torch.telemetry.tracing import gen_span_id, gen_trace_id, read_spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.uninstall()
    yield
    tracing.uninstall()


def _write_jsonl(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")


def _span(name, start, end, trace_id=None, parent="", role="master", **attrs):
    return {"span": name, "trace_id": trace_id or gen_trace_id(), "span_id": gen_span_id(),
            "parent_span_id": parent, "role": role, "worker_id": attrs.pop("worker_id", 0),
            "process_id": 0, "generation": attrs.pop("generation", 0), "time": 1.7e9 + start,
            "start": start, "end": end, **attrs}


def _canned_run(root: str) -> str:
    """Three generations (a worker re-formation, then a master outage),
    the step anatomy, a served request with a reroute, a slow worker."""
    run = os.path.join(root, "run")
    events, spans = [], []
    for gen, start in ((0, 100.0), (1, 120.0), (2, 150.0)):
        for i in range(6):
            for worker in (0, 1):
                dur = 0.2 if worker == 0 else 0.5
                events.append({"monotonic": start + i + worker * 0.01, "time": 1.7e9 + start + i,
                               "event": "step", "step": gen * 10 + i, "generation": gen,
                               "worker_id": worker, "records": 32,
                               **({"duration_secs": dur} if i else {})})
        events.append({"monotonic": start + 2.5, "time": 1.7e9, "event": "step_anatomy",
                       "generation": gen, "steps": 1, "records": 32, "wall_ms": 10.0,
                       "host_fetch_ms": 1.0, "assemble_ms": 2.0, "h2d_transfer_ms": 1.5,
                       "device_compute_ms": 5.0, "step_bookkeeping_ms": 0.25,
                       "untracked_ms": 0.25})
    # generation 0 -> 1: a worker died at 105.5, the master re-formed
    reform = gen_trace_id()
    root_id = gen_span_id()
    spans.append({**_span("reform", 107.0, 111.0, reform, generation=1, reason="worker_failure"),
                  "span_id": root_id})
    spans.append(_span("reform_fence_recover", 107.0, 107.5, reform, root_id, generation=1))
    spans.append(_span("replica_harvest", 107.1, 107.4, reform, root_id, generation=1))
    spans.append(_span("reform_relaunch", 107.5, 111.0, reform, root_id, generation=1))
    spans.append(_span("world_join", 111.0, 114.0, reform, root_id, role="worker",
                       worker_id=2, generation=1))
    spans.append(_span("world_initialize", 112.0, 114.0, role="worker", worker_id=2,
                       generation=1))
    spans.append(_span("trainer_build", 114.0, 117.0, role="worker", worker_id=2,
                       generation=1))
    spans.append(_span("replica_restore", 115.0, 116.0, role="worker", worker_id=2,
                       generation=1))
    spans.append(_span("compile", 117.0, 118.5, role="worker", worker_id=2, generation=1))
    # generation 1 -> 2: the master died at 126.5 and came back
    events += [
        {"monotonic": 131.0, "time": 1.7e9, "event": "master_restart", "generation": 1},
        {"monotonic": 131.2, "time": 1.7e9, "event": "journal_replay", "generation": 1,
         "duration_secs": 0.2, "pending": 3, "active": 1, "epoch": 0, "stage_lost": False},
        {"monotonic": 133.0, "time": 1.7e9, "event": "worker_rehome", "worker_id": 2,
         "generation": 1, "kept": 1, "requeued": 0},
        {"monotonic": 0.0, "time": 1.7e9, "event": "job_start", "job_type": "training_only",
         "num_workers": 2},
    ]
    spans.append(_span("master_restart", 131.0, 131.5, generation=1))
    spans.append(_span("journal_replay", 131.0, 131.2, generation=1))
    spans.append(_span("worker_rehome", 132.0, 133.0, generation=1, worker_id=2, kept=1,
                       requeued=0))
    spans.append(_span("rpc_degraded", 140.0, 143.0, role="worker", worker_id=1,
                       kind="net_blackhole", fault_id="f1"))
    # one task's trace across master and worker, recovered once
    task = gen_trace_id()
    first = gen_span_id()
    spans.append({**_span("task_lifecycle", 104.0, 106.0, task, task_id=7, type="training",
                          shard="s", recovered=False, success=False), "span_id": first})
    spans.append(_span("task_lifecycle", 118.6, 119.0, task, first, task_id=7, type="training",
                       shard="s", recovered=True, success=True))
    spans.append(_span("task_execute", 104.1, 105.9, task, first, role="worker", task_id=7))
    # a served request: client root, a reroute, the replica's split
    req = gen_trace_id()
    req_root = gen_span_id()
    spans.append({**_span("predict_request", 160.0, 160.1, req, role="client",
                          request_id="r1"), "span_id": req_root})
    spans.append(_span("route", 160.005, 160.02, req, req_root, role="router", replica_id=0,
                       attempt=0, error="replica 0: shed"))
    spans.append(_span("reroute", 160.02, 160.095, req, req_root, role="router", replica_id=1,
                       attempt=1))
    spans.append(_span("queue", 160.025, 160.04, req, req_root, role="replica", worker_id=1))
    spans.append(_span("engine", 160.04, 160.09, req, req_root, role="replica", worker_id=1))
    spans.append(_span("serving_dispatch", 160.04, 160.09, role="replica", worker_id=1,
                       links=[{"trace_id": req, "span_id": req_root}]))
    _write_jsonl(os.path.join(run, "events.jsonl"), events)
    _write_jsonl(os.path.join(run, "spans.jsonl"), spans)
    return run


def _same(run: str):
    """Both packages' export and analysis of ``run``, compared."""
    port_chrome, ref_chrome = trace.build_chrome_trace(run), jax_trace.build_chrome_trace(run)
    assert port_chrome == ref_chrome
    port, ref = trace.analyze_telemetry_dir(run), jax_trace.analyze_telemetry_dir(run)
    assert port == ref
    assert trace._format_analysis(trace.analyze_run_dir(run)) == jax_trace._format_analysis(
        jax_trace.analyze_run_dir(run)
    )
    return port_chrome, port


def test_canned_run_exports_and_analyzes_as_the_jax_package(tmp_path):
    chrome, analysis = _same(_canned_run(str(tmp_path)))
    assert chrome["traceEvents"]
    gaps = analysis["reform_downtime"]
    assert len(gaps) == 2 and gaps[0]["coverage"] >= 0.9
    assert analysis["master_outage"]
    assert analysis["stragglers"][0]["workers"][1]["straggler"] is True
    assert set(analysis["steady_state"][0]["phases"]) >= {"device_compute", "untracked"}
    assert analysis["serving"]["requests"] == 1 and analysis["serving"]["reroutes"] == 1
    assert analysis["recovered_task_spans"] == 1


@pytest.mark.parametrize("command", ["export", "analyze", "analyze_json"])
def test_the_clis_write_what_the_jax_clis_write(tmp_path, command, capsys):
    run = _canned_run(str(tmp_path))
    argv = {"export": ["export", run, "--output"], "analyze": ["analyze", run],
            "analyze_json": ["analyze", run, "--json"]}[command]
    outs = []
    for mod, name in ((trace, "port"), (jax_trace, "jax")):
        full = argv + [str(tmp_path / f"{name}.json")] if command == "export" else argv
        assert mod.main(full) == 0
        outs.append(capsys.readouterr().out if command != "export"
                    else json.load(open(tmp_path / f"{name}.json")))
    if command == "analyze_json":
        outs = [json.loads(o) for o in outs]
    assert outs[0] == outs[1]


# ---- directories the port's jobs write ---------------------------------------


@pytest.fixture(scope="module")
def local_run(tmp_path_factory):
    """A port Local job with tracing (every span kept), the step anatomy,
    a checkpoint and an export."""
    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    d = tmp_path_factory.mktemp("local")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        train = gen_mnist(str(d / "t"), num_records=192, num_shards=1, seed=0)
        tel = str(d / "tel")
        rc = client.main([
            "train", "--model_def", MNIST_DEF, "--training_data", train,
            "--minibatch_size", "32", "--records_per_task", "96", "--device", "cpu",
            "--telemetry_dir", tel, "--trace_sample_rate", "1.0", "--step_anatomy", "true",
            "--checkpoint_dir", str(d / "ckpt"), "--checkpoint_steps", "3",
            "--output", str(d / "export"),
        ])
    finally:
        torch.set_num_threads(threads)
        tracing.uninstall()
    assert rc == 0
    return {"tel": tel, "export": str(d / "export")}


def test_a_local_jobs_directory_reads_in_both_analyzers(local_run):
    spans = read_spans(os.path.join(local_run["tel"], "spans.jsonl"))
    names = {s["span"] for s in spans}
    assert {"train_step", "trainer_build", "checkpoint_save_snapshot", "step_anatomy"} <= names
    _chrome, analysis = _same(local_run["tel"])
    assert analysis["steady_state"][0]["dispatches"] == 6
    assert analysis["steady_state"][0]["steps"] == 6


def test_a_gloo_worlds_directory_reads_in_both_analyzers(tmp_path):
    """A two-rank world with tracing on: every task is one trace that
    spans the master and the workers, and the JAX analyzer reads it."""
    from elasticdl_tpu_torch import client
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    train = gen_mnist(str(tmp_path / "t"), num_records=256, num_shards=1, seed=0)
    tel = str(tmp_path / "tel")
    rc = client.main([
        "train", "--model_def", MNIST_DEF, "--training_data", train, "--minibatch_size", "32",
        "--records_per_task", "64", "--device", "cpu",
        "--distribution_strategy", "AllreduceStrategy", "--num_workers", "2", "--port", "0",
        "--standby_workers", "0", "--telemetry_dir", tel, "--trace_sample_rate", "1.0",
        "--envs", "OMP_NUM_THREADS=1",
    ])
    assert rc == 0
    spans = read_spans(os.path.join(tel, "spans.jsonl"))
    lifecycle = [s for s in spans if s["span"] == "task_lifecycle"]
    assert len(lifecycle) == 4 and all(s["role"] == "master" for s in lifecycle)
    for root in lifecycle:
        members = [s for s in spans if s["trace_id"] == root["trace_id"] and s is not root]
        # both processes execute the task; process 0 alone reports it
        assert sorted(s["process_id"] for s in members if s["span"] == "task_execute") == [0, 1]
        assert [s["span"] for s in members if s["span"] == "report_task"] == ["report_task"]
        assert all(s["role"] == "worker" for s in members)
    joins = [s for s in spans if s["span"] == "world_join"]
    assert sorted(s["process_id"] for s in joins) == [0, 1]
    _chrome, analysis = _same(tel)
    # each process's first step has no interval
    assert analysis["stragglers"][0]["barrier_steps_compared"] == 7


def test_serving_main_writes_one_trace_per_request(local_run, tmp_path):
    """``serving.main --telemetry_dir`` (a frontend and one replica on
    the CPU): a request the client traces is one trace of the client's
    root, the router's route span and the replica's queue, engine and
    request spans, linked from its dispatch group; the analyzers' serving
    critical paths agree."""
    from elasticdl_tpu_torch.rpc import messages as msg
    from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
    from elasticdl_tpu_torch.serving.replica import ServingClient

    tel = str(tmp_path / "tel")
    addr_file = str(tmp_path / "addr")
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.main", "--model_dir",
         local_run["export"], "--num_replicas", "1", "--device", "cpu", "--addr_file",
         addr_file, "--minibatch_size", "4", "--telemetry_dir", tel],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(addr_file):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        client = ServingClient(open(addr_file).read().strip(),
                               deadlines=DeadlinePolicy.from_secs(60))
        tracer = tracing.install(str(tmp_path / "client"), role="client", sample_rate=1.0)
        images = {"image": np.random.RandomState(0).randint(0, 255, (3, 28, 28), np.uint8)}
        for i in range(2):
            with tracer.span("predict_request", request_id=f"r{i}") as root:
                response = client.predict(msg.PredictRequest(
                    request_id=f"r{i}", features=msg.pack_array_tree(images), trace=root.context))
            assert not response.error and response.rows == 3
        tracer.flush()
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.returncode is None:
            proc.kill()
            proc.wait()
    # the client's log and the serving processes' log, as one run
    spans = read_spans(os.path.join(tel, "spans.jsonl"))
    client_spans = read_spans(str(tmp_path / "client" / "spans.jsonl"))
    roots = [s for s in client_spans if s["span"] == "predict_request"]
    assert len(roots) == 2
    for root in roots:
        mine = {s["span"]: s for s in spans if s["trace_id"] == root["trace_id"]}
        assert set(mine) == {"route", "queue", "engine", "serving_request"}
        assert mine["route"]["role"] == "router" and mine["engine"]["role"] == "replica"
        assert all(s["parent_span_id"] == root["span_id"] for s in mine.values())
    dispatch = [s for s in spans if s["span"] == "serving_dispatch"]
    assert {link["trace_id"] for s in dispatch for link in s["links"]} == {
        r["trace_id"] for r in roots
    }
    _write_jsonl(os.path.join(tel, "spans.jsonl"), spans + client_spans)
    _chrome, analysis = _same(tel)
    assert analysis["serving"]["requests"] == 2 and analysis["serving"]["coverage"] > 0.5
