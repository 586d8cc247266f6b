"""Streaming in the port (``elasticdl_tpu_torch/streaming/``, the
dispatcher's watermark-lease mode, the journal's stream cursor, the
master's stream tick, live push and stream backlog, the chaos checks)
against the JAX package's (``elasticdl_tpu/streaming/``), on the CPU,
case for case with ``tests/test_streaming.py``.

The same inputs go through both packages: record bytes of both schemas
at several seeds and indices; origins; one scripted source sequence of
gets, reports and advances through both dispatchers (the same windows
and the same ``stream_status`` after every operation); snapshots
replayed across packages; event lists through both ``bounded_lag`` and
``freshness_monotone`` checks and both report sections; both live
pushers against the same fakes; both autoscalers on one lag sequence.
No tolerance but the served rows': those are held to the JAX engine's
within ``TOL`` (f32).
"""

from __future__ import annotations

import argparse
import os
import threading
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.chaos import harness as jax_harness
from elasticdl_tpu.chaos.invariants import InvariantChecker as JaxChecker
from elasticdl_tpu.chaos.plan import resolve_plan as jax_resolve_plan
from elasticdl_tpu.data import fast_pipeline as jax_fast
from elasticdl_tpu.master import autoscaler as jax_autoscaler
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
from elasticdl_tpu.serving import replica as jax_replica_mod
from elasticdl_tpu.serving.engine import ServingEngine as JaxEngine
from elasticdl_tpu.streaming import live_push as jax_live_push
from elasticdl_tpu.streaming import reader as jax_reader
from elasticdl_tpu.streaming import source as jax_source
from elasticdl_tpu.telemetry import report as jax_report
from elasticdl_tpu.telemetry.master_hooks import MasterTelemetry as JaxTelemetry
from elasticdl_tpu.trainer.state import Modes as JaxModes
from elasticdl_tpu.trainer.state import TrainState as JaxTrainState
from elasticdl_tpu.utils.export_utils import export_model as jax_export_model
from elasticdl_tpu.utils.model_utils import get_model_spec as jax_get_spec
from elasticdl_tpu_torch.chaos import harness
from elasticdl_tpu_torch.chaos.invariants import InvariantChecker
from elasticdl_tpu_torch.chaos.plan import resolve_plan
from elasticdl_tpu_torch.data import fast_pipeline
from elasticdl_tpu_torch.master import autoscaler
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.replication.blob import encode_snapshot
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.serving import replica as replica_mod
from elasticdl_tpu_torch.serving.replica import ServingReplica
from elasticdl_tpu_torch.streaming import live_push, reader, source
from elasticdl_tpu_torch.telemetry import report
from elasticdl_tpu_torch.telemetry.events import read_jsonl
from elasticdl_tpu_torch.telemetry.master_hooks import MasterTelemetry
from elasticdl_tpu_torch.trainer.state import Modes
from elasticdl_tpu_torch.utils import args as port_args
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.export_utils import build_with_weights, load_flats
from elasticdl_tpu_torch.utils.model_utils import get_model_spec

ORIGIN = "stream://mnist?seed=7&total=256&rate=0&initial=256"
WINDOW = 64
MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 command runs six test processes
    at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


# ---- records, origins and sources -------------------------------------------


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
@pytest.mark.parametrize("seed", [0, 7, 123457])
def test_stream_records_are_the_jax_bytes(dataset, seed):
    for index in (0, 1, 41, 4095, 1_000_002):
        got = reader.stream_record(dataset, seed, index)
        want = jax_reader.stream_record(dataset, seed, index)
        assert got["image"].dtype == want["image"].dtype == np.uint8
        assert np.array_equal(got["image"], want["image"])
        assert got["label"] == want["label"] and got["label"].dtype == np.int64

    class _Win:
        start, end = 40, 52

    origin = f"stream://{dataset}?seed={seed}"
    port_records = list(reader.StreamDataReader(data_origin=origin).read_records(_Win))
    # two readers, in two threads, read the same window alike
    other: list = []
    t = threading.Thread(target=lambda: other.extend(
        reader.StreamDataReader(data_origin=origin).read_records(_Win)))
    t.start()
    t.join()
    assert port_records == other
    assert port_records == list(jax_reader.StreamDataReader(data_origin=origin).read_records(_Win))
    assert reader.StreamDataReader(data_origin=origin).create_shards() == {}
    assert reader.StreamDataReader(data_origin=origin).metadata.extra == {
        "format": "stream", "dataset": dataset}


def test_an_unknown_schema_fails_at_the_reader():
    with pytest.raises(ValueError, match="unknown stream dataset"):
        reader.StreamDataReader(data_origin="stream://imagenet?seed=1")


@pytest.mark.parametrize("origin", [
    ORIGIN, "stream://mnist?seed=1", "stream://cifar10?total=10&rate=2.5&extra=x",
    "stream:///mnist?seed=3&seed=4", "stream://odps:project.table",
])
def test_origins_parse_as_in_jax(origin):
    assert source.is_stream_origin(origin) and jax_source.is_stream_origin(origin)
    got, want = source.parse_stream_origin(origin), jax_source.parse_stream_origin(origin)
    assert (got.dataset, got.seed, got.total, got.rate, got.params) == (
        want.dataset, want.seed, want.total, want.rate, want.params)


def test_a_non_stream_origin_is_refused_as_in_jax():
    for module in (source, jax_source):
        assert not module.is_stream_origin("/data/train")
        assert not module.is_stream_origin("")
        with pytest.raises(ValueError):
            module.parse_stream_origin("file:///nope")


def test_queue_sources_publish_the_same_watermarks():
    now = [0.0]
    sources = [
        module.QueueStreamSource(total=128, rate_per_sec=10.0, initial=32, clock=lambda: now[0])
        for module in (source, jax_source)
    ]
    steps = [("watermark",), ("advance", 64), ("advance_to", 50), ("tick", 11.0),
             ("watermark",), ("tick", -5.0), ("watermark",), ("advance", 1000),
             ("closed",), ("advance_to", 10)]
    trace = {0: [], 1: []}
    for step in steps:
        if step[0] == "tick":
            now[0] += step[1]
            continue
        for i, src in enumerate(sources):
            trace[i].append(getattr(src, step[0])(*step[1:]))
    assert trace[0] == trace[1] == [32, 96, 96, 110, 110, 128, True, 128]
    for module in (source, jax_source):
        built = module.build_stream_source(ORIGIN)
        assert built.watermark() == 256 and built.closed()


class _FakeOdps:
    def __init__(self):
        self.count = 0
        self.partitions = []

    def get_table(self, name):
        fake = self

        class _Reader:
            count = fake.count

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        class _Table:
            def open_reader(self, partition=None):
                fake.partitions.append((name, partition))
                return _Reader()

        return _Table()


def test_the_odps_tailer_reads_the_row_count_and_needs_the_sdk():
    client = _FakeOdps()
    tailer = source.OdpsTailingSource("t", partition="dt=1", client=client)
    assert tailer.watermark() == 0 and not tailer.closed()
    client.count = 4096
    assert tailer.watermark() == 4096
    tailer.close()
    assert tailer.closed() and client.partitions == [("t", "dt=1")] * 2
    # without the SDK the source fails where it is built, as the JAX one
    for module in (source, jax_source):
        with pytest.raises(ImportError, match="odps"):
            module.build_stream_source("stream://odps:project.table")


# ---- the watermark-lease dispatcher ------------------------------------------


def _pair(total=0, initial=0, records_per_task=WINDOW):
    """(JAX dispatcher, port dispatcher, sources), each over its
    package's source."""
    srcs = [source.QueueStreamSource(total=total, initial=initial),
            jax_source.QueueStreamSource(total=total, initial=initial)]
    port = TaskDispatcher({}, records_per_task=records_per_task, num_epochs=1,
                          stream_source=srcs[0], stream_origin=ORIGIN)
    ref = JaxDispatcher({}, records_per_task=records_per_task, num_epochs=1,
                        stream_source=srcs[1], stream_origin=ORIGIN)
    return ref, port, srcs


# each scenario of tests/test_streaming.py::TestWatermarkLease as one
# script: ("get", worker), ("report", nth lease, success), ("advance", n)
SCRIPTS = {
    "fifo_mint": (0, 160, [("get", 0), ("get", 1), ("get", 0)]),
    "partial_on_close": (96, 96, [("get", 0), ("get", 0), ("get", 1)]),
    "gap_free_prefix": (256, 256, [("get", 0)] * 4 + [
        ("report", 1, True), ("report", 0, True), ("report", 3, True), ("report", 2, True)]),
    "requeue": (256, 256, [("get", 0), ("report", 0, False), ("get", 1), ("report", 1, True)]),
    "duplicate_drop": (256, 256, [("get", 0), ("report", 0, True), ("report", 0, True)]),
    "finished_on_close": (128, 64, [("get", 0), ("report", 0, True), ("advance", 64),
                                    ("get", 0), ("report", 1, True), ("get", 1)]),
    "lag": (0, 192, [("get", 0), ("report", 0, True), ("advance", 32), ("get", 1)]),
}


def _observe(d) -> dict:
    status = d.stream_status()
    return {
        "status": status,
        "finished": d.finished(),
        "records": d.counters(TaskType.TRAINING).total_records,
    }


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_watermark_leases_are_the_jax_dispatchers(script):
    total, initial, ops = SCRIPTS[script]
    ref, port, srcs = _pair(total=total, initial=initial)
    leases: dict = {"jax": [], "port": []}
    for op in ops:
        out = {}
        for name, d in (("jax", ref), ("port", port)):
            if op[0] == "get":
                task_id, task = d.get(op[1])
                leases[name].append(task_id)
                out[name] = (task_id, None if task is None else (
                    task.shard_name, task.start, task.end, int(task.type)))
            elif op[0] == "report":
                d.report(leases[name][op[1]], op[2])
                out[name] = None
            else:
                out[name] = None
        if op[0] == "advance":
            for src in srcs:
                src.advance(op[1])
        assert out["port"] == out["jax"], op
        assert _observe(port) == _observe(ref), op
    assert port.streaming and ref.streaming
    final = _observe(port)
    want = {
        "fifo_mint": (0, 160, False),  # the open source holds [128, 160) back
        "partial_on_close": (0, 96, False),
        "gap_free_prefix": (256, 256, True),
        "requeue": (64, 256, False),
        "duplicate_drop": (64, 256, False),
        "finished_on_close": (128, 128, True),
        "lag": (64, 224, False),
    }[script]
    assert (final["status"]["trained_watermark"], final["status"]["source_watermark"],
            final["finished"]) == want


def test_windows_are_leased_in_offset_order_across_mints(tmp_path):
    """A divergence, pinned: a second mint's windows go under the windows
    still pending, so leases follow offset order and the trained
    watermark advances as a prefix.  The JAX dispatcher stacks the second
    mint on top and leases its windows first.  The port's journal replays
    the pending windows in the live dispatcher's order."""
    from elasticdl_tpu_torch.master import journal as journal_mod

    ref, port, srcs = _pair(total=0, initial=192)
    journal = journal_mod.MasterJournal(str(tmp_path))
    journal.set_snapshot_provider(lambda append: port.atomic_state_snapshot(
        lambda state: append({
            "dispatcher": state, "callbacks_invoked": 0, "world": None,
            "servicer": {"cluster_version": 0, "model_version": 0, "stream": {}},
        })))
    port.add_observer(journal)
    journal.start()
    leases = {"jax": [], "port": []}
    for name, d in (("jax", ref), ("port", port)):
        leases[name].append(d.get(0))
    for src in srcs:
        src.advance(128)
    for name, d in (("jax", ref), ("port", port)):
        leases[name] += [d.get(0) for _ in range(2)]
        for task_id, _task in leases[name]:
            d.report(task_id, True)
    spans = {name: [(t.start, t.end) for _tid, t in got] for name, got in leases.items()}
    assert spans["port"] == [(0, 64), (64, 128), (128, 192)]
    assert spans["jax"] == [(0, 64), (192, 256), (256, 320)]
    assert port.stream_status()["trained_watermark"] == 192
    assert ref.stream_status()["trained_watermark"] == 64
    journal.close()
    replayed = journal_mod.load_state(str(tmp_path))["dispatcher"]["pending"]
    assert [(t["start"], t["end"]) for t in replayed] == [
        (t.start, t.end) for t in port._pending] == [(256, 320), (192, 256)]


def test_an_epoch_dispatcher_has_no_stream_status():
    d = TaskDispatcher({"f": (0, 10)}, records_per_task=10, num_epochs=1)
    assert not d.streaming and d.stream_status() is None


# ---- the journal's stream cursor ---------------------------------------------


@pytest.mark.parametrize("replayer", ["jax", "port"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_stream_snapshot_replays_across_packages(writer, replayer):
    """A restarted master restores the exact stream cursor (the trained
    watermark, the out-of-order completions, the next offset) and
    re-floors its cold source at the journaled watermark, whichever
    package wrote the snapshot and whichever replays it."""
    ref, port, _ = _pair(total=256, initial=256)
    a = {"jax": ref, "port": port}[writer]
    leases = [a.get(0) for _ in range(3)]
    a.report(leases[1][0], True)  # [64, 128) done, [0, 64) not
    snap = a.state_snapshot()
    cold = (source if replayer == "port" else jax_source).QueueStreamSource(total=256, initial=0)
    b = (TaskDispatcher if replayer == "port" else JaxDispatcher)(
        {}, records_per_task=WINDOW, num_epochs=1, stream_source=cold, stream_origin=ORIGIN)
    b.restore_state(snap)
    assert b.stream_status() == a.stream_status()
    assert cold.watermark() == 256
    b.report(leases[0][0], True)
    assert b.stream_status()["trained_watermark"] == 128
    _, task = b.get(2)
    assert (task.start, task.end) == (192, 256)


def test_the_journal_replays_the_stream_cursor_as_the_live_dispatcher(tmp_path):
    """The port's journal replay (``master/journal.py``: the mint and the
    trained-prefix deltas) lands the cursor where the live dispatcher
    is, and so does the JAX package's replay of the port's journal."""
    from elasticdl_tpu_torch.master import journal as journal_mod

    src = source.QueueStreamSource(total=256, initial=256)
    d = TaskDispatcher({}, records_per_task=WINDOW, num_epochs=1, stream_source=src,
                       stream_origin=ORIGIN)
    journal = journal_mod.MasterJournal(str(tmp_path))
    journal.set_snapshot_provider(lambda append: d.atomic_state_snapshot(
        lambda state: append({
            "dispatcher": state, "callbacks_invoked": 0, "world": None,
            "servicer": {"cluster_version": 0, "model_version": 0, "stream": {}},
        })))
    d.add_observer(journal)
    journal.start()
    leases = [d.get(0) for _ in range(3)]
    d.report(leases[2][0], True)
    d.report(leases[0][0], True)
    journal.close()
    state = journal_mod.load_state(str(tmp_path))
    stream = state["dispatcher"]["stream"]
    live = d.state_snapshot()["stream"]
    assert (stream["next_offset"], stream["trained_watermark"]) == (
        live["next_offset"], live["trained_watermark"]) == (256, 64)
    assert {int(k): v for k, v in stream["completed"].items()} == {128: 192}
    # the JAX package's replay of the same journal lands alike
    from elasticdl_tpu.master import journal as jax_journal

    assert jax_journal.load_state(str(tmp_path))["dispatcher"]["stream"] == stream


# ---- bounded_lag and freshness_monotone ---------------------------------------


def _configs(tmp_path, **overrides):
    kw = dict(workdir=str(tmp_path), streaming=True, stream_total=256)
    kw.update(overrides)
    return (jax_harness.ChaosJobConfig(plan=jax_resolve_plan("none", 2), **kw),
            harness.ChaosJobConfig(plan=resolve_plan("none", 2), **kw))


LAG_CASES = {
    "within_bound": ({}, [{"event": "stream_lag", "lag_records": 300}], {"trained_watermark": 256}),
    "over_bound": (dict(stream_lag_limit=100), [{"event": "stream_lag", "lag_records": 101}],
                   {"trained_watermark": 256}),
    "incomplete_drain": ({}, [{"event": "stream_lag", "lag_records": 10}],
                         {"trained_watermark": 192}),
    "no_telemetry": ({}, [], {"trained_watermark": 256}),
    "epoch_run": (dict(streaming=False, stream_total=0), [], None),
}


@pytest.mark.parametrize("case", sorted(LAG_CASES))
def test_bounded_lag_gives_the_jax_verdict(tmp_path, case):
    overrides, events, final = LAG_CASES[case]
    ref_config, config = _configs(tmp_path, **overrides)
    got = harness._check_bounded_lag(config, events, final)
    assert got == jax_harness._check_bounded_lag(ref_config, events, final)
    status = {"within_bound": "PASS", "epoch_run": None}.get(case, "FAIL")
    assert (got or {}).get("status") == status


def _push(version, trained, mono, accepted=True):
    return {"event": "live_push", "model_version": version, "trained_watermark": trained,
            "monotonic": mono, "accepted": accepted}


FRESHNESS_CASES = {
    "monotone": [_push(2, 64, 1.0), _push(4, 128, 2.0)],
    "regressed": [_push(4, 128, 1.0), _push(6, 64, 2.0)],
    "refused_do_not_count": [_push(4, 128, 1.0), _push(6, 64, 2.0, accepted=False)],
    "out_of_order_log": [_push(4, 128, 2.0), _push(2, 64, 1.0)],
    "no_pushes": [],
}


@pytest.mark.parametrize("case", sorted(FRESHNESS_CASES))
def test_freshness_monotone_gives_the_jax_verdict(tmp_path, case):
    ref_config, config = _configs(tmp_path)
    events = FRESHNESS_CASES[case]
    got = harness._check_freshness_monotone(config, events)
    assert got == jax_harness._check_freshness_monotone(ref_config, events)
    assert got["status"] == ("FAIL" if case == "regressed" else "PASS")
    epoch_ref, epoch = _configs(tmp_path, streaming=False, stream_total=0)
    assert harness._check_freshness_monotone(epoch, events) is None


def test_a_dropped_stream_window_stalls_the_trained_watermark_as_in_jax():
    """``drop_stream_window`` on both dispatchers: the first lease
    vanishes, its report is dropped as a duplicate, the run still ends,
    and the trained watermark stays at the hole, so ``bounded_lag``'s
    drain fails alike."""
    ref, port, _ = _pair(total=256, initial=256)
    outcome = {}
    for name, d, module, checker in (
        ("jax", ref, jax_harness, JaxChecker(expected_records=256)),
        ("port", port, harness, InvariantChecker(expected_records=256)),
    ):
        d.add_observer(checker)
        module._install_corruption(SimpleNamespace(task_d=d, servicer=None), checker,
                                   "drop_stream_window")
        while True:
            task_id, task = d.get(0)
            if task is None:
                break
            d.report(task_id, True)
        outcome[name] = (d.stream_status(), d.finished(),
                         sorted(v.invariant for v in checker.check(d.counters(TaskType.TRAINING))))
    assert outcome["port"] == outcome["jax"]
    status, finished, _violations = outcome["port"]
    assert finished and status["trained_watermark"] == 0 and status["source_watermark"] == 256


# ---- telemetry and the report's streaming section ----------------------------

_STAMPS = ("time", "monotonic", "wall", "ts", "pid", "host", "process", "role")


def _stripped(events):
    return [{k: v for k, v in e.items() if k not in _STAMPS} for e in events]


def test_the_stream_tick_and_the_push_write_the_jax_events(tmp_path):
    statuses = [
        {"source_watermark": 64, "trained_watermark": 0, "lag": 64, "next_offset": 64,
         "closed": False},
        {"source_watermark": 64, "trained_watermark": 0, "lag": 64, "next_offset": 64,
         "closed": False},  # idle: nothing written
        {"source_watermark": 128, "trained_watermark": 64, "lag": 64, "next_offset": 128,
         "closed": True},
    ]
    logs = {}
    for name, cls in (("jax", JaxTelemetry), ("port", MasterTelemetry)):
        tel = cls(str(tmp_path / name))
        for status in statuses:
            tel.stream_tick(status)
        for accepted in (True, False):
            tel.live_push(model_version=4, trained_watermark=64, source_watermark=128,
                          accepted=accepted, replica="localhost:1", swap_ms=1.5,
                          started_at=0.0, reason="" if accepted else "stale swap")
        tel.events.flush()
        logs[name] = read_jsonl(str(tmp_path / name / "events.jsonl"))
        if name == "port":
            text = tel.registry.exposition()
            assert 'elasticdl_stream_live_push_total{accepted="true"} 1' in text
            assert 'elasticdl_stream_live_push_total{accepted="false"} 1' in text
    assert _stripped(logs["port"]) == _stripped(logs["jax"])
    assert [e["event"] for e in logs["port"]] == [
        "stream_watermark", "stream_lag", "stream_watermark", "stream_lag",
        "live_push", "live_push"]
    # the report's section over the same log is the JAX one's, and its
    # text the JAX report CLI's lines
    section = report.streaming_section(logs["port"])
    assert section == jax_report.streaming_section(logs["port"])
    assert report.streaming_section([]) is None
    assert report.streaming_lines(section) == [
        "streaming: trained watermark 64 / source 128 (source closed)",
        "  lag: max 64 p50 64.0 p95 64.0 last 64 record(s)",
        "  freshness: 2 push(es), 1 accepted, 1 refused, max staleness 64 record(s)",
        "    push v4: trained 64 / source 128 (staleness 64)",
        "    push v4: trained 64 / source 128 (staleness 64)  REFUSED",
    ]


def test_the_stream_gauges_are_scraped_only_in_watermark_lease_mode():
    _ref, port, srcs = _pair(total=0, initial=192)
    tel = MasterTelemetry("")
    tel.attach(port, SimpleNamespace(
        add_version_observer=lambda fn: None, set_trace_provider=lambda fn: None,
        live_workers=lambda: [], cluster_version=0,
        rpc_stats_totals=lambda: {}, duplicate_eval_drops=0, phase_stats_totals=lambda: {},
        heartbeat_ages=lambda: {}, prefetch_stats_totals=lambda: {}))
    task_id, _ = port.get(0)
    port.report(task_id, True)
    text = tel.registry.exposition()
    assert "elasticdl_stream_lag_records 128" in text
    assert 'elasticdl_stream_watermark{role="source"} 192' in text
    assert 'elasticdl_stream_watermark{role="trained"} 64' in text
    epoch = MasterTelemetry("")
    epoch._task_d = TaskDispatcher({"f": (0, 10)}, records_per_task=10)
    assert "elasticdl_stream" not in epoch.registry.exposition()


# ---- the live pusher ---------------------------------------------------------


class _FakeDirectory:
    def __init__(self):
        self.calls = 0
        self.stage = None

    def harvest(self, **kwargs):
        self.calls += 1
        return self.stage


class _FakeTelemetry:
    def __init__(self):
        self.rows = []

    def live_push(self, **kwargs):
        self.rows.append({k: v for k, v in kwargs.items() if k not in ("swap_ms", "started_at")})


def _fake_client(codec, responses, sent):
    class _Client:
        def __init__(self, addr, deadlines=None):
            pass

        def swap_model(self, request):
            sent.append((request.payload, request.version, request.source,
                         request.trained_watermark, request.source_watermark))
            return responses.pop(0)

        def close(self):
            pass

    return _Client


def _drive_pusher(pkg: str, monkeypatch) -> dict:
    """One scripted run of a pusher: before the first step, an empty
    harvest, the interval gate, an accepted push, the version gate, a
    stale refusal counted as converged, and a plain refusal."""
    from elasticdl_tpu.rpc import messages as jax_msg

    module, codec, rmod = (
        (jax_live_push, jax_msg, jax_replica_mod) if pkg == "jax"
        else (live_push, msg, replica_mod)
    )
    sent: list = []
    responses = [
        codec.SwapModelResponse(accepted=True, model_version=2),
        codec.SwapModelResponse(accepted=False, model_version=4, reason="stale swap: 4",
                                stale=True),
        codec.SwapModelResponse(accepted=False, model_version=4, reason="model_def mismatch"),
    ]
    monkeypatch.setattr(rmod, "ServingClient", _fake_client(codec, responses, sent))
    directory, telemetry, now = _FakeDirectory(), _FakeTelemetry(), [0.0]
    pusher = module.LivePusher("localhost:1", directory, telemetry=telemetry,
                               clock=lambda: now[0])
    status = {"source_watermark": 192, "trained_watermark": 128}
    tick = dict(generation=0, num_sources=2, live_worker_ids=[0, 1], stream_status=status)
    trace = []

    def step(version, advance=0.0, stage=None):
        now[0] += advance
        if stage is not None:
            directory.stage = stage
        trace.append((pusher.tick(model_version=version, **tick), directory.calls,
                      pusher.last_pushed_version, pusher.harvest_skips))

    step(0)  # nothing trained: no harvest
    step(2)  # harvest incomplete
    step(2, 0.5)  # inside the attempt interval
    stage = {"generation": 0, "version": 2, "checksum": "x", "payload": b"v2", "sources": 2}
    step(2, 1.0, stage)  # accepted
    step(2, 2.0)  # the same version never re-pushes
    step(4, 2.0, dict(stage, version=4, payload=b"v4"))  # stale: converged
    step(6, 2.0, dict(stage, version=6, payload=b"v6"))  # refused
    return {"trace": trace, "sent": sent, "rows": telemetry.rows,
            "counts": (pusher.pushes_accepted, pusher.pushes_refused)}


def test_the_live_pusher_is_the_jax_pushers(monkeypatch):
    port = _drive_pusher("port", monkeypatch)
    assert port == _drive_pusher("jax", monkeypatch)
    assert [t[0] for t in port["trace"]] == [False, False, False, True, False, True, False]
    assert port["trace"][0][1] == 0  # no harvest before the first step
    assert port["sent"][0] == (b"v2", 2, "live-push@128", 128, 192)
    assert [r["accepted"] for r in port["rows"]] == [True, False, False]
    assert port["counts"] == (2, 1)


# ---- the pushed payload against the flax weights -----------------------------


def _mnist_export(out: str, version: int, seed: int) -> str:
    """A JAX-written mnist export at ``version`` with weights from ``seed``."""
    spec = jax_get_spec("", MNIST_DEF)
    model = spec.build_model()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), {"image": np.zeros((1, 28, 28), np.float32)}, training=False))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (0.05 * rng.randn(*x.shape)).astype(np.float32), shapes["params"])
    stats = jax.tree_util.tree_map(
        lambda x: (1.0 + rng.rand(*x.shape)).astype(np.float32), shapes["batch_stats"])
    state = JaxTrainState.create(model.apply, params, optax.identity(), {"batch_stats": stats})
    state = state.replace(step=np.int32(version))
    args = argparse.Namespace(model_zoo="", model_def=MNIST_DEF, model_params_dict={})
    return jax_export_model(out, state, spec, args)


def test_a_pushed_mnist_snapshot_serves_the_flax_weights_forward(tmp_path):
    """The inline-payload swap of a replica-ring blob (``params/`` and
    ``batch_stats/`` names, as a push carries them) serves what the JAX
    engine serves from an export of the same flax state, and what the
    port's model with those weights carried by ``utils/flax_weights.py``
    computes directly; the compile count stays flat, the swap's record
    carries the watermark pair, and the replayed push is refused stale."""
    boot = _mnist_export(str(tmp_path / "v1"), 1, seed=1)
    pushed = _mnist_export(str(tmp_path / "v9"), 9, seed=2)
    flat_params, flat_state = load_flats(pushed)
    blob = encode_snapshot({**{f"params/{k}": v for k, v in flat_params.items()}, **flat_state},
                           {})
    rep = ServingReplica(boot, 4, device="cpu")
    feats = {"image": np.random.RandomState(3).rand(3, 28, 28).astype(np.float32)}
    before = rep.engine.predict_rows(feats)
    compiles = rep.servicer.serving_status(msg.ServingStatusRequest()).compile_count
    request = msg.SwapModelRequest(payload=blob, version=9, source="live-push@128",
                                   trained_watermark=128, source_watermark=192)
    resp = rep.servicer.swap_model(request)
    assert (resp.accepted, resp.model_version, resp.stale) == (True, 9, False), resp.reason
    assert rep.engine.last_swap_source == (
        "live-push@128 (trained watermark 128 / source 192)")
    served = rep.engine.predict_rows(feats)
    assert not np.allclose(before, served)
    assert rep.servicer.serving_status(msg.ServingStatusRequest()).compile_count == compiles
    np.testing.assert_allclose(served, JaxEngine(pushed, 8).predict_rows(feats),
                               atol=TOL, rtol=TOL)
    spec = get_model_spec("", MNIST_DEF)
    model = build_with_weights(spec, flat_params, flat_state, torch.device("cpu"))
    with torch.no_grad():
        direct = model(spec.device_parse({"image": torch.from_numpy(feats["image"])}))
    np.testing.assert_allclose(served, direct.numpy(), atol=1e-6, rtol=1e-6)
    replay = rep.servicer.swap_model(request)
    assert (replay.accepted, replay.stale) == (False, True)
    np.testing.assert_array_equal(rep.engine.predict_rows(feats), served)


# ---- the autoscaler and the flags ---------------------------------------------


def _scaler_args(**overrides):
    ns = argparse.Namespace(
        streaming=True, stream_lag_tasks=None, autoscale_p95_step_ms=None,
        autoscale_backlog_tasks=None, autoscale_cooldown_secs=0.0, autoscale_shrink=None,
        min_slices=None)
    for key, value in overrides.items():
        setattr(ns, key, value)
    return ns


@pytest.mark.parametrize("overrides", [
    dict(stream_lag_tasks=4), dict(), dict(streaming=False, stream_lag_tasks=4),
    dict(autoscale_backlog_tasks=3), dict(stream_lag_tasks=2, autoscale_backlog_tasks=9),
], ids=["lag_tasks", "none", "epoch_mode", "shared_knob", "lag_tasks_wins"])
def test_the_stream_lag_autoscaler_is_the_jax_ones(overrides):
    ref = jax_autoscaler.build_autoscaler(_scaler_args(**overrides), 2)
    got = autoscaler.build_autoscaler(_scaler_args(**overrides), 2)
    assert (got is None) == (ref is None)
    if got is None:
        return
    assert got.backlog_tasks == ref.backlog_tasks
    lags = [0, 1, 3, 4, 9, 2]
    decisions = [
        [scaler.evaluate(lag, current_slices=1, now=100.0 * i) for i, lag in enumerate(lags)]
        for scaler in (got, ref)
    ]
    assert decisions[0] == decisions[1]
    assert any(d is not None and d["action"] == "grow" for d in decisions[0])


def test_the_streaming_flags_stay_on_the_master():
    base = ["--model_def", "m.custom_model", "--training_data", ORIGIN]
    plain = port_args.parse_master_args(base)
    for flag in ("streaming", "stream_lag_tasks", "live_push_addr"):
        assert getattr(plain, flag) is None, flag
        assert flag not in port_args.UNPORTED_FLAGS
    streaming = port_args.parse_master_args(base + [
        "--streaming", "true", "--stream_lag_tasks", "4", "--live_push_addr", "localhost:9"])
    assert streaming.streaming is True and streaming.stream_lag_tasks == 4
    port_args.check_ported_flags(streaming)
    argv = port_args.build_worker_arguments(streaming, 0, "localhost:1")
    assert argv == port_args.build_worker_arguments(plain, 0, "localhost:1")
    assert not any("stream_lag" in a or "live_push" in a or a == "--streaming" for a in argv)
    assert ORIGIN in argv


# ---- the master -----------------------------------------------------------------


def _master(*flags, origin="stream://mnist?seed=7&total=256&rate=0&initial=192"):
    from elasticdl_tpu_torch.master.main import build_master

    return build_master(port_args.parse_master_args([
        "--model_def", MNIST_DEF, "--training_data", origin, "--records_per_task",
        str(WINDOW), "--minibatch_size", "32", "--num_workers", "0", "--device", "cpu",
        "--streaming", "true", *flags]))


def test_the_master_mints_windows_from_its_stream_source():
    master = _master()
    assert master.task_d.streaming and master.stream_source.watermark() == 192
    task_id, task = master.task_d.get(0)
    assert (task.shard_name, task.start, task.end) == (
        "stream://mnist?seed=7&total=256&rate=0&initial=192", 0, WINDOW)
    assert master.live_pusher is None
    # without --streaming the same origin has no shards at all
    from elasticdl_tpu_torch.master.main import build_master

    plain = build_master(port_args.parse_master_args([
        "--model_def", MNIST_DEF, "--training_data", ORIGIN, "--num_workers", "0",
        "--device", "cpu"]))
    assert not plain.task_d.streaming and plain.task_d.get(0) == (-1, None)


def test_the_master_pushes_on_a_thread_of_its_own_after_a_version_advance():
    master = _master("--replication", "true", "--live_push_addr", "localhost:1")
    calls = []
    release = threading.Event()

    class _SlowPusher(live_push.LivePusher):
        def tick(self, **kwargs):
            calls.append(kwargs)
            release.wait(10)

    master.live_pusher = _SlowPusher("localhost:1", directory=None)
    master.instance_manager = SimpleNamespace(worker_ids=lambda: [0, 1], world_size=2)
    master._live_push_tick()
    assert master._live_push_thread is None  # version 0: nothing to push
    master.servicer.report_version(msg.ReportVersionRequest(worker_id=0, model_version=2))
    master._live_push_tick()
    master._live_push_tick()  # the first push still runs: no second thread
    release.set()
    master._live_push_thread.join(10)
    assert len(calls) == 1 and calls[0]["model_version"] == 2
    assert calls[0]["num_sources"] == 2 and calls[0]["live_worker_ids"] == [0, 1]
    assert calls[0]["stream_status"]["source_watermark"] == 192


def test_live_push_without_replication_warns_and_pushes_nothing():
    master = _master("--live_push_addr", "localhost:1")
    assert master.replica_directory is None and master.live_pusher is None


def test_the_autoscaler_reads_the_stream_lag_in_windows():
    master = _master("--stream_lag_tasks", "2", "--autoscale_cooldown_secs", "0")
    resized = []
    master.instance_manager = SimpleNamespace(
        lockstep=True, world_num_slices=1, set_world_slices=resized.append)
    master.autoscaler.max_slices = 2
    # lag 192 records = 3 windows >= 2: grow
    master._autoscale_tick()
    assert resized == [2] and master._reform_requested == "autoscale:grow"


def test_a_reformation_that_would_lose_trained_windows_fails_the_job():
    """A streaming job keeps no checkpoint: re-forming with no complete
    replica set after windows were reported trained fails the job; before
    any report, or with a complete set, it goes on."""
    master = _master()
    assert not master._would_lose_trained_windows(None)  # nothing trained yet
    task_id, _ = master.task_d.get(0)
    master.task_d.report(task_id, True)
    assert not master._would_lose_trained_windows({"complete": True, "version": 2})
    assert not master._job_failed
    assert master._would_lose_trained_windows({"complete": False})
    assert master._job_failed and master._stop_requested


def test_a_window_reported_past_a_hole_also_fails_a_reformation_with_nothing_to_restore():
    """Window 1 reported before window 0 (still leased, or requeued):
    the trained watermark stays 0, but window 1 is marked trained and
    would never train again, so a re-formation that restores nothing
    fails the job all the same."""
    master = _master()
    first, _ = master.task_d.get(0)
    second, task = master.task_d.get(1)
    master.task_d.report(second, True)
    assert master.task_d.stream_status()["trained_watermark"] == 0
    assert master.task_d.stream_reported_records() == task.end - task.start == WINDOW
    assert master._would_lose_trained_windows({"complete": False})
    assert master._job_failed and master._stop_requested
    master.task_d.report(first, True)
    assert master.task_d.stream_reported_records() == 2 * WINDOW


def test_a_stream_window_batches_as_the_jax_pipeline_batches():
    """A stream window through both packages' minibatch choosers (the
    classic path, the mnist parse, the training shuffle): the same
    batches."""
    task = SimpleNamespace(shard_name=ORIGIN, start=64, end=164, type=TaskType.TRAINING)
    got = list(fast_pipeline.build_task_batches(
        reader.StreamDataReader(data_origin=ORIGIN), task, get_model_spec("", MNIST_DEF),
        Modes.TRAINING, None, 32, shuffle_records=True, dispatch_device="cpu"))
    want = list(jax_fast.build_task_batches(
        jax_reader.StreamDataReader(data_origin=ORIGIN), task, jax_get_spec("", MNIST_DEF),
        JaxModes.TRAINING, None, 32, shuffle_records=True))
    assert [len(labels) for _f, labels in got] == [32, 32, 32, 4]
    assert len(got) == len(want)
    for (gf, gl), (wf, wl) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gf["image"]), np.asarray(wf["image"]))
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
