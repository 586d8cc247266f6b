"""The port's step anatomy (``elasticdl_tpu_torch/telemetry/anatomy.py``,
``worker_hooks.py``, ``report.py::goodput_section``) against the JAX
package's, on the CPU.

The recorder's ``step_anatomy`` events and heartbeat totals equal the
JAX recorder's under one injected clock; the servicer's merge of the
shipped totals equals the JAX servicer's; the goodput section equals the
JAX report's on one event list.  With the feature off the hot paths read
no clock (a poisoned ``time.monotonic``), and ``--step_anatomy`` never
reaches a worker's argv.  Then the Local train CLI on a small mnist job
meets the goodput smoke's gates 1, 2, 3, 5 and 6
(``scripts/goodput_smoke.py``; gate 4, the spans, waits for slice 10b).
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import pytest

from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
from elasticdl_tpu.rpc import messages as jax_msg
from elasticdl_tpu.telemetry import anatomy as jax_anatomy
from elasticdl_tpu.telemetry import report as jax_report
from elasticdl_tpu.telemetry import worker_hooks as jax_hooks
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.telemetry import anatomy, report, worker_hooks
from elasticdl_tpu_torch.telemetry.events import read_jsonl
from elasticdl_tpu_torch.trainer import device_pipeline
from elasticdl_tpu_torch.trainer.stacking import PreStacked, run_stacked_steps

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
# the goodput smoke's gates (scripts/goodput_smoke.py)
UNTRACKED_GATE = 0.02
SUM_RESIDUAL_MS = 1e-3
NEGLIGIBLE_SHARE = 0.005


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(anatomy.STEP_ANATOMY_ENV, raising=False)
    monkeypatch.delenv(worker_hooks.TELEMETRY_DIR_ENV, raising=False)
    yield
    for mod in (anatomy, worker_hooks, jax_anatomy, jax_hooks):
        mod.uninstall()
    device_pipeline._reset_totals_for_tests()


def _fake_clock(monkeypatch, step: float = 0.00125):
    """``time.monotonic`` as a counter: both packages read the same
    sequence of times for the same sequence of calls."""
    ticks = itertools.count()
    monkeypatch.setattr("time.monotonic", lambda: 1000.0 + step * next(ticks))
    return ticks


def _drive(mod, rec):
    """One dispatch window of every phase, the JAX recorder's API."""
    list(rec.wrap_fetches([1, 2]))
    with rec.phase(mod.PHASE_ASSEMBLE):
        pass
    with rec.phase(mod.PHASE_H2D_TRANSFER):
        pass
    with rec.phase(mod.PHASE_DEVICE_COMPUTE, sub=mod.SUB_ENQUEUE):
        pass
    with rec.phase(mod.PHASE_DEVICE_COMPUTE, sub=mod.SUB_READY_WAIT):
        pass
    rec.wrapped_hook(lambda: None)()
    return rec.commit(steps=2, records=16, step=7)


# n_chips is the job's devices: the JAX tests' 8 virtual CPU devices
# against the port's one process on one device; time is the wall clock
_NOT_COMPARED = ("time", "n_chips")


def test_recorder_events_and_totals_equal_the_jax_recorders(tmp_path, monkeypatch):
    out = {}
    for name, mod, hooks in (("jax", jax_anatomy, jax_hooks), ("port", anatomy, worker_hooks)):
        _fake_clock(monkeypatch)
        hooks.install(str(tmp_path / name), worker_id=3, process_id=1, generation=2)
        rec = mod.AnatomyRecorder(flops_per_record=6.6e7)
        phases = [_drive(mod, rec) for _ in range(3)]
        events = [
            {k: v for k, v in e.items() if k not in _NOT_COMPARED}
            for e in read_jsonl(str(tmp_path / name / "events.jsonl"))
        ]
        out[name] = (phases, events, rec.heartbeat_snapshot(), rec.dispatches)
    assert out["port"] == out["jax"]
    phases, events, snap, dispatches = out["port"]
    assert dispatches == 3 and len(events) == 3
    assert set(snap) == set(anatomy.ALL_PHASES)
    for event in events:
        assert event["event"] == "step_anatomy" and event["worker_id"] == 3
        total = sum(event[f"{p}_ms"] for p in anatomy.ALL_PHASES)
        assert abs(event["wall_ms"] - total) < 1e-9
        assert abs(event["enqueue_ms"] + event["ready_wait_ms"] - event["device_compute_ms"]) < 1e-9


def test_the_vocabulary_is_the_jax_packages():
    for name in (
        "TRACKED_PHASES", "ALL_PHASES", "SERVING_REQUEST_PHASES", "PHASE_BOUNDARY_STALL",
        "STEP_ANATOMY_ENV", "PEAK_FLOPS_ENV", "MODEL_FLOPS_PER_RECORD", "SUB_ENQUEUE",
        "SUB_READY_WAIT",
    ):
        assert getattr(anatomy, name) == getattr(jax_anatomy, name), name
    assert worker_hooks.TELEMETRY_DIR_ENV == jax_hooks.TELEMETRY_DIR_ENV


def test_peak_flops_the_pin_wins_and_the_cpu_has_none(monkeypatch):
    import torch

    assert anatomy.peak_flops_per_chip(torch.device("cpu")) is None
    assert anatomy.peak_flops_per_chip() is None
    monkeypatch.setenv(anatomy.PEAK_FLOPS_ENV, "123e12")
    assert anatomy.peak_flops_per_chip(torch.device("cpu")) == 123e12
    assert anatomy._PEAK_FLOPS_BY_DEVICE_NAME == {"NVIDIA H100 80GB HBM3": 989.4e12}
    assert anatomy.model_flops_per_record(MNIST_DEF) == 6.6e7
    assert anatomy.model_flops_per_record("long_seq_transformer.x.custom_model") is None


def _beat(module, worker_id, phases, step=0):
    return module.HeartbeatRequest(worker_id=worker_id, step=step, phases=phases)


def test_the_servicers_phase_merge_equals_the_jax_servicers(monkeypatch):
    snaps = []
    for _ in range(3):
        rec = anatomy.AnatomyRecorder()
        _drive(anatomy, rec)
        first = rec.heartbeat_snapshot()
        _drive(anatomy, rec)
        snaps.append((first, rec.heartbeat_snapshot()))
    # each worker's newer beat, then its older one (reordered), a
    # duplicate, and a malformed phase entry
    beats = [(w, later) for w, (_first, later) in enumerate(snaps)]
    beats += [(w, first) for w, (first, _later) in enumerate(snaps)]
    beats += [(0, snaps[0][1]), (1, {"host_fetch": "garbage"})]
    totals = {}
    for name, module, servicer in (
        ("jax", jax_msg, JaxServicer(32, JaxDispatcher({"s": (0, 64)}, records_per_task=64))),
        ("port", msg, MasterServicer(32, TaskDispatcher({"s": (0, 64)}, records_per_task=64))),
    ):
        for worker_id, phases in beats:
            servicer.heartbeat(_beat(module, worker_id, phases, step=worker_id + 1))
        totals[name] = servicer.phase_stats_totals()
    assert totals["port"] == totals["jax"]
    assert totals["port"]["device_compute"]["count"] == 6  # 3 workers x 2 windows
    ms = sum(s[1]["assemble"]["ms"] for s in snaps)
    assert totals["port"]["assemble"]["ms"] == pytest.approx(ms, rel=1e-12)


def _anatomy_events(n: int, workers=(0,), generations=(0,)) -> list:
    rng = np.random.RandomState(0)
    events = []
    for gen, worker, i in itertools.product(generations, workers, range(n)):
        phases = {p: float(rng.uniform(0.1, 5.0)) for p in anatomy.TRACKED_PHASES}
        if worker == 1:  # a straggler whose device lags
            phases["device_compute"] *= 20
        phases["untracked"] = float(rng.uniform(0.0, 0.05))
        event = {
            "event": "step_anatomy", "generation": gen, "worker_id": worker,
            "steps": 2, "records": 64, "wall_ms": sum(phases.values()),
            "enqueue_ms": phases["device_compute"] / 3,
            "ready_wait_ms": phases["device_compute"] * 2 / 3,
            "flops_per_record": 6.6e7, "n_chips": 1,
            **{f"{p}_ms": v for p, v in phases.items()},
        }
        if i % 2:
            event["peak_flops_per_chip"] = 989.4e12
        events.append(event)
    return events


@pytest.mark.parametrize("case", ["one_worker", "stragglers", "two_generations", "no_peak", "none"])
def test_goodput_section_is_the_jax_reports(case):
    events = {
        "one_worker": _anatomy_events(9),
        "stragglers": _anatomy_events(7, workers=(0, 1, 2)),
        "two_generations": _anatomy_events(5, workers=(0, 1), generations=(0, 1)),
        "no_peak": [
            {k: v for k, v in e.items() if k != "peak_flops_per_chip"}
            for e in _anatomy_events(4)
        ],
        "none": [{"event": "step", "monotonic": 1.0}],
    }[case]
    got = report.goodput_section(events)
    assert got == jax_report.goodput_section(events)
    if case == "none":
        assert got is None
        return
    overall = got["overall"]
    assert overall["max_sum_residual_ms"] < SUM_RESIDUAL_MS
    assert 0 < overall["e2e_vs_roofline"] <= 1
    if case == "stragglers":
        assert overall["workers"][1]["straggler"]
        assert overall["workers"][1]["lagging_phase"] == "device_compute"
    if case == "no_peak":
        assert overall["mfu"] is None and "peak" in overall["mfu_reason"]


# ---- off: one branch, no clock ------------------------------------------------


def test_disabled_hooks_read_no_clock(monkeypatch):
    def boom():
        raise AssertionError("clock read on the disabled path")

    monkeypatch.setattr("time.monotonic", boom)
    assert anatomy.get_recorder() is None
    assert anatomy.heartbeat_snapshot() == {}
    worker_hooks.record_step(3, 8)
    worker_hooks.emit_event("rpc_fault_injected", fault_id="x")


class _Trainer:
    """A stand-in trainer with the port's placement surface."""

    step = 7

    @property
    def device(self):
        import torch

        return torch.device("cpu")

    def __init__(self):
        self.calls = []

    def pad_to(self, tree, rows):
        x = np.asarray(tree)
        return np.concatenate([x, np.repeat(x[-1:], rows - x.shape[0], 0)]) if len(x) < rows else x

    def row_mask(self, n, rows):
        mask = np.zeros(rows, np.float32)
        mask[:n] = 1.0
        return mask

    def place_group(self, features, labels, weights):
        return features, labels, weights

    def place_step(self, features, labels, weights):
        return features, labels, weights

    def train_step(self, features, labels, weights=None):
        self.calls.append(("single", len(labels)))

    def train_steps_stacked(self, features, labels, weights):
        self.calls.append(("stacked", len(labels)))


def _batches(sizes):
    return [(np.ones((n, 2), np.float32), np.arange(n, dtype=np.int32)) for n in sizes]


def _stream(sizes, prestacked=False):
    items = list(_batches(sizes))
    if prestacked:
        feats = np.ones((2, 4, 2), np.float32)
        items.append(PreStacked(feats, np.zeros((2, 4), np.int32), 8, feats[0]))
    return items


@pytest.mark.parametrize("prefetch", [False, True])
def test_off_the_loops_read_no_clock(monkeypatch, prefetch):
    trainer = _Trainer()
    on = run_stacked_steps(
        lambda: trainer, iter(_stream([4, 4, 3], prestacked=True)), 2,
        canonical_rows=4, device_prefetch=prefetch,
    )
    calls = list(trainer.calls)
    trainer.calls.clear()
    device_pipeline._reset_totals_for_tests()
    if not prefetch:
        # the serial loop reads no clock at all; the staging thread of the
        # prefetch loop keeps its own (the stall totals), anatomy or not
        def boom():
            raise AssertionError("clock read with the anatomy off")

        monkeypatch.setattr("time.monotonic", boom)
    off = run_stacked_steps(
        lambda: trainer, iter(_stream([4, 4, 3], prestacked=True)), 2,
        canonical_rows=4, device_prefetch=prefetch, anatomy=None,
    )
    assert off == on == 19
    assert trainer.calls == calls


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_each_group_commits_one_sum_exact_event(tmp_path, prefetch, k):
    worker_hooks.install(str(tmp_path), worker_id=3, generation=2)
    rec = anatomy.AnatomyRecorder()
    trainer = _Trainer()
    processed = run_stacked_steps(
        lambda: trainer, iter(_stream([4, 4, 3], prestacked=True)), k,
        canonical_rows=4, device_prefetch=prefetch, anatomy=rec,
    )
    assert processed == 19
    events = [e for e in read_jsonl(str(tmp_path / "events.jsonl")) if e["event"] == "step_anatomy"]
    # k 1: three singles and the ready-made group; k 2: a stacked pair, the
    # trailing single, the ready-made group
    assert len(events) == rec.dispatches == len(trainer.calls) == (4 if k == 1 else 3)
    assert sum(e["records"] for e in events) == 19
    assert sum(e["steps"] for e in events) == 5
    for event in events:
        assert event["worker_id"] == 3 and event["generation"] == 2 and event["step"] == 7
        total = sum(event.get(f"{p}_ms", 0.0) for p in anatomy.ALL_PHASES)
        assert abs(event["wall_ms"] - total) < SUM_RESIDUAL_MS
        assert abs(event["enqueue_ms"] + event["ready_wait_ms"] - event["device_compute_ms"]) < 1e-9
    snap = rec.heartbeat_snapshot()
    assert {"host_fetch" if not prefetch else "h2d_transfer", "device_compute"} <= set(snap)


def test_step_anatomy_never_reaches_worker_argv_and_travels_by_env(tmp_path):
    from elasticdl_tpu_torch.master.main import worker_envs
    from elasticdl_tpu_torch.utils.args import build_worker_arguments, parse_master_args

    base = ["--model_def", MNIST_DEF, "--training_data", "/tmp/x"]
    off = parse_master_args(base)
    on = parse_master_args(
        base + ["--step_anatomy", "true", "--telemetry_dir", str(tmp_path), "--metrics_port", "7"]
    )
    argv_on = build_worker_arguments(on, 0, "localhost:1")
    assert argv_on == build_worker_arguments(off, 0, "localhost:1")
    assert not any(a.startswith(("--step_anatomy", "--telemetry_dir", "--metrics")) for a in argv_on)
    assert worker_envs(on)[anatomy.STEP_ANATOMY_ENV] == "1"
    assert worker_envs(on)[worker_hooks.TELEMETRY_DIR_ENV] == str(tmp_path)
    assert anatomy.STEP_ANATOMY_ENV not in worker_envs(off)


def test_install_follows_the_flag_and_the_environment(monkeypatch):
    assert anatomy.install_if_enabled(None) is None and anatomy.get_recorder() is None
    assert anatomy.install_if_enabled(True) is anatomy.get_recorder() is not None
    assert anatomy.install_if_enabled(False) is None and anatomy.get_recorder() is None
    monkeypatch.setenv(anatomy.STEP_ANATOMY_ENV, "1")
    assert anatomy.install_from_env(model_def=MNIST_DEF) is not None


# ---- the Local train CLI on the CPU: the goodput smoke's gates ---------------


def _window(data_dir, tel_dir, *flags) -> tuple:
    from elasticdl_tpu_torch import client

    argv = [
        "train", "--model_def", MNIST_DEF, "--training_data", data_dir,
        "--minibatch_size", "32", "--records_per_task", "64", "--num_epochs", "1",
        "--device", "cpu", "--step_anatomy", "true", "--telemetry_dir", tel_dir, *flags,
    ]
    device_pipeline._reset_totals_for_tests()
    assert client.main(argv) == 0
    totals = device_pipeline.heartbeat_snapshot()
    events = read_jsonl(os.path.join(tel_dir, "events.jsonl"))
    return events, totals


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    root = tmp_path_factory.mktemp("goodput")
    data = gen_mnist(str(root / "train"), num_records=384, num_shards=2, seed=1)
    out = {}
    try:
        for name, flags in (
            ("off", ("--device_prefetch", "false")),
            ("prefetch", ("--device_prefetch", "true")),
            ("fused", ("--device_prefetch", "true", "--boundary_fusion", "true")),
        ):
            out[name] = _window(data, str(root / name), *flags)
    finally:
        anatomy.uninstall()
        worker_hooks.uninstall()
    return out


@pytest.mark.parametrize("name", ["off", "prefetch", "fused"])
def test_local_windows_meet_gates_1_2_3(windows, name):
    events, _totals = windows[name]
    anat = [e for e in events if e["event"] == "step_anatomy"]
    steps = [e for e in events if e["event"] == "step"]
    # gate 1: every dispatch has a step_anatomy event, sum-exact
    assert len(anat) == 12 and sum(e["steps"] for e in anat) == len(steps) == 12
    for event in anat:
        total = sum(event.get(f"{p}_ms", 0.0) for p in anatomy.ALL_PHASES)
        assert abs(event["wall_ms"] - total) < SUM_RESIDUAL_MS
    overall = report.goodput_section(events)["overall"]
    assert overall == jax_report.goodput_section(events)["overall"]
    # gate 2: the untracked residual under 2 % of the wall
    assert overall["untracked_share"] < UNTRACKED_GATE
    # gate 3: a measured e2e_vs_roofline and the percentiles
    assert 0 < overall["e2e_vs_roofline"] <= 1
    for phase in ("device_compute", "host_fetch"):
        assert {"p50_ms", "p95_ms", "p99_ms"} <= set(overall["phases"][phase])
    assert overall["mfu"] is None and overall["mfu_reason"]


def test_local_prefetch_lowers_the_h2d_share_gate_5(windows):
    off = report.goodput_section(windows["off"][0])["overall"]["phases"]
    on = report.goodput_section(windows["prefetch"][0])["overall"]["phases"]
    share_on = on.get("h2d_transfer", {}).get("share") or 0.0
    assert share_on < off["h2d_transfer"]["share"] or share_on < NEGLIGIBLE_SHARE


def test_local_boundary_fusion_lowers_the_boundary_stall_gate_6(windows):
    def stall_share(name):
        events, totals = windows[name]
        wall = report.goodput_section(events)["overall"]["wall_ms_total"]
        return totals.get("boundary_stall_ms", 0) / wall

    fused = stall_share("fused")
    assert fused < stall_share("prefetch") or fused < NEGLIGIBLE_SHARE
    # the counter is no phase: the fused window stays sum-exact (gate 1)
    assert "boundary_stall_ms" not in windows["fused"][0][-1]


# ---- chip_smoke.py's phase 18a, small ------------------------------------------


@pytest.fixture(scope="module")
def phase18a(tmp_path_factory):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    lm = dict(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2, dtype="float32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "GPT2S", lm)
        mp.setattr(chip_smoke, "SEQ", 32)
        try:
            row = chip_smoke.anatomy_lm_run(str(tmp_path_factory.mktemp("phase18a")), device="cpu")
        finally:
            anatomy.uninstall()
            worker_hooks.uninstall()
    return chip_smoke, row


def test_smoke_phase18a_rehearsal_on_the_cpu(phase18a):
    """Every gate of 18a on a small LM (2 layers, width 32): the CPU takes
    the kernels' plain path, so no stream is timed and no launch counted."""
    chip_smoke, row = phase18a
    assert chip_smoke.check_anatomy_lm(row, per_step=0) == []
    for name, _prefetch in chip_smoke.ANATOMY_WINDOWS:
        window = row[name]
        assert window["dispatches"] == window["step_samples"] == chip_smoke.LOCAL_STEPS
        assert window["launches"] == {k: 0 for k in chip_smoke.FLASH_NAMES}
        assert set(window["goodput"]["phases"]) == set(anatomy.ALL_PHASES)
    assert chip_smoke.TRACKED_PHASES == anatomy.TRACKED_PHASES


# each gate of 18a, and a change of the passing row that must trip it
PHASE18A_BREAKS = [
    lambda r: r["prefetch_off"].update(rc=1),
    lambda r: r["prefetch_on"].update(dispatches=7),
    lambda r: r["prefetch_off"].update(max_sum_residual_ms=0.01),
    lambda r: r["prefetch_on"]["goodput"].update(untracked_share=0.03),
    lambda r: r["prefetch_off"]["goodput"].update(e2e_vs_roofline=1.2),
    lambda r: r["prefetch_on"]["goodput"]["phases"].pop("host_fetch"),
    lambda r: r["prefetch_off"]["goodput"]["phases"]["device_compute"].pop("p99_ms"),
    lambda r: (
        r["prefetch_on"]["goodput"]["phases"]["h2d_transfer"].update(share=0.5),
        r["prefetch_off"]["goodput"]["phases"]["h2d_transfer"].update(share=0.1),
    ),
    lambda r: r["prefetch_off"].update(gpu_ms=[1e9] * len(r["prefetch_off"]["device_compute_ms"])),
]


@pytest.mark.parametrize("case", range(len(PHASE18A_BREAKS)))
def test_each_phase18a_gate_trips(phase18a, case):
    import copy

    chip_smoke, row = phase18a
    row = copy.deepcopy(row)
    PHASE18A_BREAKS[case](row)
    assert chip_smoke.check_anatomy_lm(row, per_step=0)


def test_smoke_phase18a_traces_and_profiles_on_the_cpu(phase18a):
    """18a's traced window: sampled spans, the profiler window's events,
    span and torch.profiler trace, ``trace export`` and ``analyze`` on
    its directory, and its step walls beside prefetch_off's."""
    chip_smoke, row = phase18a
    trace = row["trace"]
    assert chip_smoke.check_trace_dir(trace) == []
    assert trace["spans"]["trainer_build"] == 1 and trace["spans"]["train_step"] >= 1
    assert trace["profile_events"] == {"profile_window_open": 1, "profile_window_close": 1}
    assert len(trace["profile_traces"]) == 1 and trace["profile_traces"][0]["events"] > 0
    assert set(row["trace_overhead"]) == {"prefetch_off", chip_smoke.TRACED_WINDOW}
    assert row[chip_smoke.TRACED_WINDOW]["dispatches"] == chip_smoke.LOCAL_STEPS
    # the tracing-off side of the comparison ran with no tracer at all
    assert row["prefetch_off"]["spans_written"] == row["prefetch_on"]["spans_written"] == 0
    assert row[chip_smoke.TRACED_WINDOW]["spans_written"] > 0


# each trace gate of phase 18, and a change of the passing row that must trip it
PHASE18_TRACE_BREAKS = [
    lambda t: t.update(spans={}),
    lambda t: t.update(malformed=[("train_step", ["start/end"])]),
    lambda t: t.update(export_rc=1),
    lambda t: t.update(chrome_problems=["no traceEvents"]),
    lambda t: t.update(steady_state={}),
    lambda t: t["profile_events"].pop("profile_window_close"),
    lambda t: t["spans"].pop("profile_window"),
    lambda t: t.update(profile_traces=[]),
]


@pytest.mark.parametrize("case", range(len(PHASE18_TRACE_BREAKS)))
def test_each_phase18_trace_gate_trips(phase18a, case):
    import copy

    chip_smoke, row = phase18a
    trace = copy.deepcopy(row["trace"])
    assert chip_smoke.check_trace_dir(trace) == []
    PHASE18_TRACE_BREAKS[case](trace)
    assert chip_smoke.check_trace_dir(trace)


def test_the_trace_gate_reads_kernel_names_and_span_records():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    trace = {
        "spans": {"profile_window": 1}, "malformed": [], "export_rc": 0, "chrome_problems": [],
        "steady_state": {0: {"phases": {"device_compute": {}}}},
        "profile_events": {"profile_window_open": 1, "profile_window_close": 1},
        "profile_traces": [{"events": 9, "kernel_names": [
            "void flash_fwd_sm90_kernel<64, 2>(FwdParams)", "void flash_bwd_dq_sm90_kernel<64>()",
        ]}],
        "task_traces": 2, "task_traces_without_a_worker": 0,
    }
    hopper = chip_smoke.HOPPER_KERNELS[:2]
    assert chip_smoke.check_trace_dir(trace, kernels=hopper) == []
    assert chip_smoke.check_trace_dir(trace, kernels=chip_smoke.HOPPER_KERNELS)
    assert chip_smoke.check_trace_dir(trace, kernels=hopper, world=True) == []
    trace["task_traces_without_a_worker"] = 1
    assert chip_smoke.check_trace_dir(trace, world=True)
    good = {"span": "train_step", "trace_id": "a" * 32, "span_id": "b" * 16,
            "parent_span_id": "", "role": "worker", "worker_id": 0, "process_id": 0,
            "generation": 0, "start": 1.0, "end": 1.5}
    assert chip_smoke._span_problems(good) == []
    for broken in (dict(good, trace_id="x"), dict(good, parent_span_id="c" * 15),
                   dict(good, end=0.5), dict(good, role=""), {k: v for k, v in good.items()
                                                            if k != "generation"}):
        assert chip_smoke._span_problems(broken)
    assert chip_smoke._chrome_problems({"traceEvents": [
        {"ph": "X", "ts": 1.0, "dur": 2.0, "name": "n", "pid": 1, "tid": 0}]}) == []
    assert chip_smoke._chrome_problems({"traceEvents": [
        {"ph": "X", "ts": 1.0, "dur": -2.0, "name": "n", "pid": 1, "tid": 0}]})
    assert chip_smoke._chrome_problems({}) == ["no traceEvents"]


def test_phase18a_counts_each_kernels_launches():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    good = {k: 24 for k in chip_smoke.FLASH_NAMES}
    window = {
        "rc": 0, "dispatches": 2, "steps": 2, "max_sum_residual_ms": 0.0, "gpu_ms": [],
        "device_compute_ms": [1.0, 1.0], "launches": good,
        "goodput": {"untracked_share": 0.0, "e2e_vs_roofline": 0.5, "phases": {
            p: {"p50_ms": 1.0, "p99_ms": 1.0, "share": 0.0} for p in anatomy.ALL_PHASES
        }},
    }
    row = {"prefetch_off": window, "prefetch_on": dict(window)}
    assert chip_smoke.check_anatomy_lm(row, steps=2, per_step=12) == []
    row["prefetch_on"] = dict(window, launches=dict(good, flash_bwd_dq=23))
    assert chip_smoke.check_anatomy_lm(row, steps=2, per_step=12)
