"""The port's chaos runner CLI (``python -m elasticdl_tpu_torch.chaos.runner``)
against the JAX package's (``elasticdl_tpu/chaos/runner.py``), on the CPU.

For every builtin plan the port's runner must configure its faulted job
and its fault-free baseline as the JAX ``_run`` does (replication,
master HA, slices, the RPC deadlines and retry budget, records, epochs),
and ``--list`` must print the JAX runner's Plans block and its
Invariants block (the fleet simulator's invariants and plans wait for
slice 11).  The runner's own default, ``--device cuda``, refuses a
machine without a card.  Then the CLI runs end to end with ``--device
cpu`` as ``chip_smoke.py``'s phase 17 runs it, six subprocesses, three
at a time on the CPU (``chip_smoke.CHAOS_CPU_WIDTH``), each with its own
work directory: ``preempt_one_worker`` with its
baseline (exit 0, every invariant PASS, ``trajectory_parity`` within the
default 0.15, ``chaos_result.json`` written), ``--corrupt double_report``
(exit 1, ``exactly_once`` FAIL), ``dup_report_storm`` (exit 0,
reports deduplicated), ``slow_network_mid_epoch`` (exit 0, no
re-formation), and the phase's gates on all six, each shown to trip on
a row that breaks it.  The runs are gated test by test: a run that
misses a gate fails the tests of that run, not every test of the file.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import pytest

from elasticdl_tpu.chaos import harness as jax_harness
from elasticdl_tpu.chaos import runner as jax_runner
from elasticdl_tpu_torch.chaos import harness
from elasticdl_tpu_torch.chaos import runner
from elasticdl_tpu_torch.chaos.plan import builtin_plans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

def statuses(report: dict) -> dict:
    return {i["name"]: i["status"] for i in report["invariants"]}


# ---- the configuration of each plan's jobs ----------------------------------


def _configs_of(module, harness_module, argv: list, workdir: str) -> list:
    """The configurations ``module._run`` gives the harness, the baseline's
    included (the harness replaced by a recorder)."""
    configs = []

    def record(config):
        configs.append(config)
        return {"invariants": [], "invariants_ok": True, "accuracy": 0.5}

    args = module.build_arg_parser().parse_args(argv)
    original = harness_module.run_chaos_job
    harness_module.run_chaos_job = record
    try:
        module._run(args, workdir)
    finally:
        harness_module.run_chaos_job = original
    return configs


VARIANTS = {
    "defaults": [],
    "no_baseline": ["--no-baseline"],
    "replication_on": ["--replication", "on", "--num-records", "256"],
    "four_workers": ["--num-workers", "4", "--num-slices", "2", "--num-epochs", "1"],
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize(
    "plan", sorted(set(builtin_plans(2)) - set(runner.STREAMING_PLANS)) + ["random:1234"]
)
def test_every_plan_configures_its_jobs_as_the_jax_runner(tmp_path, plan, variant):
    argv = ["--plan", plan, *VARIANTS[variant]]
    ref = _configs_of(jax_runner, jax_harness, argv, str(tmp_path))
    port = _configs_of(runner, harness, argv, str(tmp_path))
    assert len(port) == len(ref) == (1 if "--no-baseline" in argv else 2)
    for got, want in zip(port, ref):
        assert got.plan.to_json() == want.plan.to_json()
        for f in dataclasses.fields(want):
            if f.name != "plan":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.device == "cuda"
        assert got.journal_dir == os.path.join(want.workdir, "journal")


def test_the_network_plans_posture_is_the_jax_runners():
    for name in ("NETWORK_PLANS", "REPLICATION_PLANS", "MULTISLICE_PLANS", "MASTER_HA_PLANS",
                 "INVARIANT_DESCRIPTIONS", "TRAJECTORY_TOLERANCE"):
        assert getattr(runner, name) == getattr(jax_runner, name), name
    # the eviction plans' budget is outlasted by their window, with a lease
    # timeout to reclaim the unreachable worker's tasks
    for name in ("blackhole_master_link", "oneway_partition_worker"):
        posture = runner.NETWORK_PLANS[name]
        assert posture["rpc_retry_secs"] < builtin_plans(2)[name].faults[0].duration_secs
        assert posture["task_timeout_secs"]


def test_the_streaming_plan_is_refused_naming_slice_9(tmp_path):
    args = runner.build_arg_parser().parse_args(["--plan", "streaming_preempt_under_load"])
    with pytest.raises(NotImplementedError, match="slice 9"):
        runner.job_config(args, str(tmp_path))


def _blocks(text: str) -> dict:
    blocks, current = {}, None
    for line in text.splitlines():
        if not line.startswith(" "):
            current = blocks.setdefault(line, [])
        else:
            current.append(line)
    return blocks


@pytest.mark.parametrize("flag", ["--list", "--list-plans"])
def test_list_prints_the_jax_runners_plans_and_invariants(capsys, flag):
    from elasticdl_tpu.fleetsim.plans import FLEET_INVARIANT_DESCRIPTIONS

    assert jax_runner.main([flag]) == 0
    ref = _blocks(capsys.readouterr().out)
    assert runner.main([flag]) == 0
    port = _blocks(capsys.readouterr().out)
    assert port["Plans:"] == ref["Plans:"]
    assert len(port["Plans:"]) == len(builtin_plans(2))
    if flag == "--list":
        assert port["Invariants:"] == [
            line for line in ref["Invariants:"]
            if line.split()[0] not in FLEET_INVARIANT_DESCRIPTIONS
        ]
        assert "no_false_dead" in "\n".join(port["Invariants:"])
    assert set(port) == ({"Plans:", "Invariants:"} if flag == "--list" else {"Plans:"})


def test_the_default_device_refuses_a_machine_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.main(["--plan", "none", "--no-baseline", "--workdir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "chaos_result.json")


# ---- end to end on the CPU: the smoke's phase 17 ----------------------------

WANT_RC = {name: rc for name, _argv, rc in chip_smoke.CHAOS_RUNS}


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    """``chip_smoke.py``'s phase 17 on the CPU: the six runner CLI runs,
    three at a time; each test gates the runs it reads
    (``chip_smoke.check_chaos_case``)."""
    root = tmp_path_factory.mktemp("chaos_runner")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        runs = chip_smoke.chaos_runs(str(root), device="cpu")
    return {"runs": runs, "root": str(root)}


def _run(phase, name: str) -> SimpleNamespace:
    """A run's exit code, its report and its ``chaos_result.json``."""
    def load(file):
        with open(os.path.join(phase["root"], name, file)) as f:
            return json.load(f)

    return SimpleNamespace(
        rc=phase["runs"][name]["rc"], report=load("report.json"),
        result=load("chaos_result.json"),
    )


def test_smoke_phase17_chaos_rehearsal_on_the_cpu(phase):
    rows = phase["runs"]
    assert set(rows) == set(WANT_RC)
    for name, row in rows.items():
        assert chip_smoke.check_chaos_case(name, row, WANT_RC[name]) == [], (name, row)
    assert rows["blackhole_master_link"]["rpc"]["deadline_exceeded"] > 0
    assert rows["preempt_one_worker"]["standby_activated"] == 2


def test_preempt_one_worker_passes_every_invariant_beside_its_baseline(phase):
    run = _run(phase, "preempt_one_worker")
    assert run.rc == 0
    report = run.report
    assert report["invariants_ok"] and report["records_ok"] and report["device"] == "cpu"
    assert set(statuses(report).values()) == {"PASS"}
    assert set(statuses(report)) == {
        "exactly_once", "records_accounted", "version_monotonic", "reform_progress",
        "faults_injected", "trajectory_parity",
    }
    assert abs(report["accuracy_delta"]) <= runner.TRAJECTORY_TOLERANCE
    assert report["baseline_ok"] and report["accuracy"] >= 0.9
    assert [e["kind"] for e in report["faults_injected"]] == ["preempt_worker"]
    assert len(report["reforms"]) == 1 and report["reform_latency_secs"] > 0
    assert report["detect_secs"] is not None and report["kill_to_step_secs"] is not None
    assert report["tasks_tracked"] == 2 * 1024 // 64
    # the verdict beside the artifacts, as the JAX runner writes it
    assert run.result["invariants_ok"] and run.result["plan"] == "preempt_one_worker"
    assert statuses(run.result) == statuses(report)
    assert "trace" not in run.result


def test_a_double_report_corruption_exits_1_with_exactly_once_failed(phase):
    run = _run(phase, "double_report")
    assert run.rc == 1
    report = run.report
    assert not report["invariants_ok"] and report["corrupt"] == "double_report"
    assert statuses(report)["exactly_once"] == "FAIL"
    assert "trajectory_parity" not in statuses(report)  # no baseline for a corrupted run
    assert statuses(run.result)["exactly_once"] == "FAIL" and not run.result["invariants_ok"]


def test_dup_report_storm_is_deduplicated_exactly_once(phase):
    run = _run(phase, "dup_report_storm")
    assert run.rc == 0
    report = run.report
    assert report["invariants_ok"], report["invariants"]
    assert statuses(report)["duplicate_delivery_exactly_once"] == "PASS"
    assert report["rpc"]["reports_deduped"] > 0
    fired = {e["fault_id"] for e in report["faults_injected"]}
    assert fired == {"dup-report-task", "dup-report-version"}
    assert not report["reforms"]


def test_a_slow_network_is_not_a_dead_worker(phase):
    run = _run(phase, "slow_network_mid_epoch")
    assert run.rc == 0
    report = run.report
    assert report["invariants_ok"], report["invariants"]
    assert statuses(report)["no_false_dead"] == "PASS"
    assert report["reforms"] == []
    assert {e["kind"] for e in report["faults_injected"]} == {"net_delay"}


# each gate of phase 17, and a change of a passing row that must trip it
BREAKS = [
    ("preempt_one_worker", lambda r: r.update(rc=1)),
    ("preempt_one_worker", lambda r: r.update(accuracy_delta=0.2)),
    ("preempt_one_worker", lambda r: r.update(reforms=2)),
    ("preempt_one_worker", lambda r: r["invariants"].update(exactly_once="FAIL")),
    ("preempt_one_worker", lambda r: r.update(result_json=False)),
    ("double_report", lambda r: r["invariants"].update(exactly_once="PASS")),
    ("dup_report_storm", lambda r: r["rpc"].update(reports_deduped=0)),
    ("dup_report_storm", lambda r: r["invariants"].update(duplicate_delivery_exactly_once="FAIL")),
    ("drop_dedup", lambda r: r["invariants"].update(duplicate_delivery_exactly_once="PASS")),
    ("blackhole_master_link", lambda r: r["rpc"].pop("deadline_exceeded")),
    ("blackhole_master_link", lambda r: r.update(dead_workers=[[0]])),
    ("slow_network_mid_epoch", lambda r: r.update(reforms=1)),
    ("slow_network_mid_epoch", lambda r: r["rpc"].update(deadline_exceeded=1)),
]


@pytest.mark.parametrize("case", range(len(BREAKS)))
def test_each_phase17_gate_trips(phase, case):
    name, breaks = BREAKS[case]
    row = copy.deepcopy(phase["runs"][name])
    # the run passes its gates, and the break trips one of them
    assert chip_smoke.check_chaos_case(name, row, WANT_RC[name]) == [], row.get("log_tail", row)
    breaks(row)
    assert chip_smoke.check_chaos_case(name, row, WANT_RC[name])
