"""The port's chaos harness (``elasticdl_tpu_torch/chaos/harness.py``) and
the report sections it embeds (``telemetry/report.py``) against the JAX
package's, on the CPU.

The same synthetic events go through both packages' checks
(``_check_no_false_dead``, ``_check_duplicate_delivery``,
``_check_no_lost_steps``) and report sections (``multislice_section``,
``master_ha_section``, ``replication_section``), which must give equal
dicts, as ``tests/test_netchaos.py:807-884`` holds the JAX ones; the
sections also read the port's chaos event log, whose records say
``observation`` where the JAX log says ``event``.  Every corruption must
trip what it trips in the JAX package, on a dispatcher driven alike in
both; the master's argv of each configuration, streaming runs and the
live push included, must parse to the JAX harness's settings.  No
tolerance: every compared value is equal exactly.  The streaming checks
and the ``drop_stream_window`` corruption are held to the JAX package's
in ``tests/test_torch_streaming.py``.
"""

from __future__ import annotations

import json
import os

import pytest

from elasticdl_tpu.chaos import harness as jax_harness
from elasticdl_tpu.chaos.invariants import InvariantChecker as JaxChecker
from elasticdl_tpu.chaos.plan import named_plan as jax_named_plan
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
from elasticdl_tpu.telemetry import report as jax_report
from elasticdl_tpu_torch.chaos import harness
from elasticdl_tpu_torch.chaos.invariants import InvariantChecker
from elasticdl_tpu_torch.chaos.plan import FaultKind, builtin_plans, named_plan
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.telemetry import report
from elasticdl_tpu_torch.utils.constants import TaskType


def _configs(tmp_path, plan: str, num_workers: int = 2, **kw):
    return (
        jax_harness.ChaosJobConfig(
            plan=jax_named_plan(plan, num_workers), workdir=str(tmp_path / "w"), **kw
        ),
        harness.ChaosJobConfig(
            plan=named_plan(plan, num_workers), workdir=str(tmp_path / "w"), **kw
        ),
    )


# ---- the network checks -----------------------------------------------------


REFORMS = ([], [{"reason": "worker_failure", "detected_at": 0.0}])


@pytest.mark.parametrize("reforms", REFORMS, ids=["none", "one"])
@pytest.mark.parametrize("plan", sorted(builtin_plans(2)))
def test_no_false_dead_is_the_jax_harnesses(tmp_path, plan, reforms):
    ref_config, config = _configs(tmp_path, plan)
    ref = jax_harness._check_no_false_dead(ref_config, reforms)
    assert harness._check_no_false_dead(config, reforms) == ref
    assert (ref is None) == (plan != "slow_network_mid_epoch")


def _drive_checker(pkg: str, script: list):
    """A checker fed ``script``'s reports alike in both packages:
    ``("report", counted)`` is a report of a leased training task
    (``counted=False``: a dedup drop), ``("double", None)`` a report the
    dedup should have dropped counted again."""
    checker_cls, dispatcher_cls = (
        (JaxChecker, JaxDispatcher) if pkg == "jax" else (InvariantChecker, TaskDispatcher)
    )
    checker = checker_cls(expected_records=128)
    d = dispatcher_cls({"s": (0, 128)}, records_per_task=64, shuffle_seed=3)
    d.add_observer(checker)
    for what, counted in script:
        if what == "report":
            if counted:
                tid, task = d.get(0)
                d.report(tid, success=True)
            else:
                checker.on_task_reported(10**6, None, True, False)
        else:
            tid, task = d.get(0)
            d.report(tid, success=True)
            checker.on_task_reported(tid, task, True, True)
    return checker


DUP_FIRED = (
    [],
    [{"kind": FaultKind.NET_DUPLICATE, "method": "report_task_result"},
     {"kind": FaultKind.NET_DUPLICATE, "method": "report_version"}],
    [{"kind": FaultKind.NET_DUPLICATE, "method": "report_version"}],
)
DUP_SCRIPTS = (
    [("report", True)],
    [("report", True), ("report", False)],
    [("double", None), ("report", False)],
)


@pytest.mark.parametrize("corrupt", ["", "drop_dedup"])
@pytest.mark.parametrize("script", range(len(DUP_SCRIPTS)))
@pytest.mark.parametrize("fired", range(len(DUP_FIRED)))
@pytest.mark.parametrize("plan", ["dup_report_storm", "preempt_one_worker"])
def test_duplicate_delivery_is_the_jax_harnesses(tmp_path, plan, fired, script, corrupt):
    ref_config, config = _configs(tmp_path, plan, corrupt=corrupt)
    events = DUP_FIRED[fired]
    ref = jax_harness._check_duplicate_delivery(
        ref_config, _drive_checker("jax", DUP_SCRIPTS[script]), events
    )
    port = harness._check_duplicate_delivery(
        config, _drive_checker("port", DUP_SCRIPTS[script]), events
    )
    assert port == ref
    assert (ref is None) == (plan == "preempt_one_worker" and not corrupt)


# (kind, step, monotonic): a push, a kill, a restore
NO_LOST = [
    [("push", 6, 99.0), ("kill", 0, 100.0), ("restore", 6, 105.0)],
    [("push", 6, 99.0), ("kill", 0, 100.0), ("restore", 4, 105.0)],
    [("push", 6, 99.0), ("push", 8, 101.0), ("kill", 0, 100.0), ("restore", 6, 105.0)],
    [("kill", 0, 100.0)],
    [("push", 6, 99.0)],
]


@pytest.mark.parametrize("replication", [True, False])
@pytest.mark.parametrize("case", range(len(NO_LOST)))
def test_no_lost_steps_is_the_jax_harnesses_on_both_logs(tmp_path, case, replication):
    ref_config, config = _configs(tmp_path, "preempt_one_worker", replication=replication)
    kills = [
        {"kind": FaultKind.PREEMPT, "monotonic": at} for w, _s, at in NO_LOST[case] if w == "kill"
    ]
    jax_events = [
        {"event": f"replica_{w}", "step": s, "monotonic": at}
        for w, s, at in NO_LOST[case] if w != "kill"
    ]
    ref = jax_harness._check_no_lost_steps(ref_config, jax_events, kills)
    assert harness._check_no_lost_steps(config, jax_events, kills) == ref
    port_events = [
        {("observation" if k == "event" else k): v for k, v in e.items()} for e in jax_events
    ]
    assert harness._check_no_lost_steps(config, port_events + kills, kills) == ref


# ---- the report sections ----------------------------------------------------


def _events(kind: str) -> list[dict]:
    """A synthetic log for one section, in the JAX shape (``event`` and
    ``generation``)."""
    if kind == "multislice":
        return [
            {"event": "slice_loss", "generation": 1, "lost_slices": [1], "dead_workers": [2, 3],
             "old_slices": 2, "new_slices": 1, "parked": False, "monotonic": 10.0},
            {"event": "mesh_resize", "generation": 1, "old_world_size": 4, "new_world_size": 2,
             "old_slices": 2, "new_slices": 1, "monotonic": 10.5},
            {"event": "autoscale_decision", "generation": 2, "action": "grow", "from_slices": 1,
             "to_slices": 2, "reason": "backlog", "monotonic": 20.0},
            {"event": "replica_push", "num_slices": 2, "source_slice": 0, "step": 4},
            {"event": "replica_push", "num_slices": 2, "source_slice": 1, "step": 4},
            {"event": "replica_push", "num_slices": 1, "source_slice": 0, "step": 8},
        ]
    if kind == "master_ha":
        return [
            {"event": "step", "monotonic": 9.0}, {"event": "step", "monotonic": 10.0},
            {"event": "master_restart", "generation": 0, "monotonic": 12.0},
            {"event": "journal_replay", "duration_secs": 0.002, "pending": 5, "active": 1,
             "monotonic": 12.1},
            {"event": "worker_rehome", "worker_id": 1, "kept": 1, "requeued": 0,
             "monotonic": 14.0},
            {"event": "worker_rehome", "worker_id": 0, "kept": 0, "requeued": 2,
             "monotonic": 14.5},
            {"event": "step", "monotonic": 15.0},
            {"event": "master_restart", "generation": 1, "monotonic": 30.0},
            {"event": "journal_replay", "duration_secs": 0.003, "pending": 2, "active": 0,
             "monotonic": 30.1},
            {"event": "step", "monotonic": 33.0},
        ]
    return [
        {"event": "replica_push", "generation": 0, "source": 0, "step": 2},
        {"event": "replica_push", "generation": 0, "source": 1, "step": 4},
        {"event": "replica_push", "generation": 1, "source": 0, "step": 6},
        {"event": "replica_harvest", "generation": 1, "complete": True, "version": 4},
        {"event": "replica_restore", "generation": 1, "step": 4},
    ]


SECTIONS = ("multislice", "master_ha", "replication")


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("section", SECTIONS)
def test_report_sections_are_the_jax_packages(section, empty):
    events = [] if empty else _events(section)
    name = f"{section}_section"
    ref = getattr(jax_report, name)(events)
    assert getattr(report, name)(events) == ref
    assert (ref is None) == empty


@pytest.mark.parametrize("section", SECTIONS)
def test_report_sections_read_the_ports_event_log(section):
    """The same events as the port's chaos log writes them: ``observation``
    for ``event``, and a worker's ``cluster_version`` for ``generation``
    (the master's records keep ``generation``)."""
    ref = getattr(jax_report, f"{section}_section")(_events(section))
    port_events = []
    for e in _events(section):
        e = {("observation" if k == "event" else k): v for k, v in e.items()}
        if e["observation"].startswith("replica_") and "generation" in e:
            e["cluster_version"] = e.pop("generation")
        port_events.append(e)
    if section == "master_ha":
        # the port's restart carries its replay; its re-homes list their
        # leases, and it also records the refused ones
        port_events = [e for e in port_events if e["observation"] != "journal_replay"]
        for e in port_events:
            if e["observation"] == "master_restart":
                e.update({0: dict(replay_secs=0.002, pending=5, active=1),
                          1: dict(replay_secs=0.003, pending=2, active=0)}[e["generation"]])
            if e["observation"] == "worker_rehome":
                e["kept"], e["requeued"] = [7] * e["kept"], [8] * e["requeued"]
        port_events.append({"observation": "worker_rehome", "worker_id": 3, "accepted": False,
                            "monotonic": 14.2})
        # the step samples give each outage's downtime, as in the JAX report
        got = report.master_ha_section(port_events)
        assert got == ref
        assert got["restarts"][0]["downtime_secs"] == 5.0
        # the port's master writes the restarts and re-homes to both logs
        # under --telemetry_dir: each is counted once
        assert report.master_ha_section(port_events + _events(section)) == ref
        return
    assert getattr(report, f"{section}_section")(port_events) == ref


# ---- the corruptions --------------------------------------------------------


class _FakeMaster:
    def __init__(self, d, servicer=None):
        self.task_d = d
        self.servicer = servicer


class _FakeServicer:
    def __init__(self):
        self.observers = []

    def add_version_observer(self, fn):
        self.observers.append(fn)


def _corrupted_violations(pkg: str, mode: str) -> list[tuple]:
    """Violations of a run of 256 records in tasks of 64 (each reported
    twice under ``drop_dedup``), with versions 2, 4, 6 reported."""
    checker_cls, dispatcher_cls, module = (
        (JaxChecker, JaxDispatcher, jax_harness) if pkg == "jax"
        else (InvariantChecker, TaskDispatcher, harness)
    )
    checker = checker_cls(expected_records=256)
    d = dispatcher_cls({"s": (0, 256)}, records_per_task=64, shuffle_seed=3)
    d.add_observer(checker)
    servicer = _FakeServicer()
    module._install_corruption(_FakeMaster(d, servicer), checker, mode)
    for version in (2, 4, 6):
        checker.on_version_report(0, version)
        for fn in servicer.observers:
            fn(0, version)
    while True:
        tid, task = d.get(0)
        if task is None:
            break
        d.report(tid, success=True)
        if mode == "drop_dedup":
            d.report(tid, success=True)  # the duplicate delivery
    return sorted(
        (v.invariant, v.detail) for v in checker.check(d.counters(TaskType.TRAINING))
    )


@pytest.mark.parametrize(
    "mode, trips",
    [("", set()), ("double_report", {"exactly_once"}),
     ("lose_task", {"exactly_once", "records_accounted"}),
     ("version_rollback", {"version_monotonic"}), ("drop_dedup", {"exactly_once"})],
)
def test_every_corruption_trips_what_the_jax_one_trips(mode, trips):
    ref = _corrupted_violations("jax", mode)
    port = _corrupted_violations("port", mode)
    assert port == ref
    assert {name for name, _ in ref} == trips


def test_an_unknown_corruption_is_refused():
    d = TaskDispatcher({"s": (0, 64)}, records_per_task=64)
    with pytest.raises(ValueError):
        harness._install_corruption(_FakeMaster(d), InvariantChecker(), "cosmic_rays")
    assert harness.CORRUPTIONS == jax_harness.CORRUPTIONS
    assert harness.DATASETS == jax_harness.DATASETS


@pytest.mark.parametrize(
    "plan, kw, match",
    [
        ("preempt_one_worker", dict(corrupt="drop_dedup"), "drop_dedup"),
        ("preempt_one_worker", dict(corrupt="journal_rollback"), "journal_rollback"),
        ("preempt_after_replication", dict(corrupt="same_slice_ring", replication=True),
         "same_slice_ring"),
        ("preempt_one_worker", dict(corrupt="drop_shard_parts"), "drop_shard_parts"),
        ("slice_loss_mid_epoch", dict(), "SLICE_LOSS"),
        ("master_kill_mid_epoch", dict(), "MASTER_KILL"),
        ("preempt_one_worker", dict(dataset="cifar"), "dataset"),
        ("none", dict(streaming=True, stream_total=0), "bounded prefix"),
        ("preempt_one_worker", dict(corrupt="drop_stream_window"), "drop_stream_window"),
    ],
)
def test_a_run_that_would_pass_green_is_refused_as_in_jax(tmp_path, plan, kw, match):
    ref_config, config = _configs(tmp_path, plan, num_records=64, **kw)
    with pytest.raises(ValueError, match=match):
        jax_harness.run_chaos_job(ref_config)
    with pytest.raises(ValueError, match=match):
        harness.run_chaos_job(config)


# ---- the master's argv ------------------------------------------------------

# the settings the JAX harness's argv sets, and the port's must equal
SETTINGS = (
    "model_def", "minibatch_size", "records_per_task", "num_epochs", "compute_dtype",
    "shuffle_seed", "port", "distribution_strategy", "num_workers", "checkpoint_steps",
    "heartbeat_timeout_secs", "replication", "replication_steps", "master_journal_dir",
    "rehome_grace_secs", "standby_workers", "num_slices", "rpc_deadline_secs",
    "rpc_retry_secs", "task_timeout_secs", "streaming", "live_push_addr",
)

ARGV_CASES = {
    "plain": ("preempt_one_worker", {}),
    "replication": ("preempt_after_replication", dict(replication=True, replication_steps=4)),
    "master_ha": ("master_kill_mid_epoch", dict(master_ha=True, rehome_grace_secs=7.0)),
    "slices": ("slice_loss_mid_epoch", dict(num_slices=2, replication=True)),
    "network": ("blackhole_master_link", dict(rpc_deadline_secs=1.0, rpc_retry_secs=4.0,
                                               task_timeout_secs=30.0)),
    "same_slice_ring": ("slice_loss_mid_epoch", dict(num_slices=2, replication=True,
                                                     corrupt="same_slice_ring")),
    "extra": ("none", dict(extra_master_args=["--evaluation_steps", "8"])),
    "streaming": ("streaming_preempt_under_load",
                  dict(streaming=True, stream_total=256, replication=True)),
    "live_push": ("none", dict(streaming=True, stream_total=256, replication=True,
                               live_push_addr="localhost:1")),
}


@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_the_masters_argv_carries_the_jax_harnesses_settings(tmp_path, case):
    from elasticdl_tpu_torch.utils.args import parse_master_args

    plan, kw = ARGV_CASES[case]
    ref_config, config = _configs(tmp_path, plan, **kw)
    ref = jax_harness._master_args(ref_config, "/data", "/ckpt")
    argv = harness._master_args(config, "/data", "/ckpt")
    args = parse_master_args(argv)
    for key in SETTINGS + ("evaluation_steps",) * (case == "extra"):
        assert getattr(args, key) == getattr(ref, key), key
    # a streaming run keeps no checkpoint
    assert (args.training_data, args.device) == ("/data", "cuda")
    assert args.checkpoint_dir == (ref.checkpoint_dir if config.streaming else "/ckpt")
    # the telemetry event log beside the chaos artifacts, as the JAX
    # harness places it
    assert args.telemetry_dir == ref.telemetry_dir == os.path.join(config.workdir, "telemetry")
    assert "--jax_platform" not in argv
    # the workers' environment: the plan, the event log and the ring
    # corruption, as the JAX harness exports them (its platform pins aside)
    ref_envs = {k: v for k, v in ref.envs_dict.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    assert args.envs_dict == ref_envs


# ---- the event log ----------------------------------------------------------


def test_events_log_splits_faults_from_observations_and_skips_torn_lines(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"fault_id": "a", "kind": "preempt_worker"}) + "\n")
        f.write(json.dumps({"observation": "checkpoint_restore", "version": 4}) + "\n")
        f.write('{"fault_id": "torn", "ki\n\n')
    assert harness._read_events(path) == jax_harness._read_events(path)
    faults, observations = harness._read_events(path)
    assert [e["fault_id"] for e in faults] == ["a"] and len(observations) == 1
    assert harness._read_events(str(tmp_path / "missing")) == ([], [])


def test_the_runner_result_json_keeps_the_jax_keys_but_the_trace(tmp_path):
    from elasticdl_tpu.chaos import runner as jax_runner
    from elasticdl_tpu_torch.chaos import runner

    rep = {
        "plan": "p", "seed": 3, "corrupt": "", "invariants": [
            {"name": "exactly_once", "status": "PASS", "violations": []}],
        "invariants_ok": True, "rc": 0, "accuracy": 0.9, "accuracy_delta": 0.01,
        "reform_latency_secs": 1.0, "detect_secs": 0.5, "kill_to_step_secs": 2.0,
        "replication": {"pushes_by_generation": {}}, "rpc": {"retries": 1},
        "master_ha": {"restarts": []}, "master_lives": 2, "multislice": {"slice_losses": []},
    }
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    with open(jax_runner.write_result_json(rep, str(tmp_path / "jax"))) as f:
        ref = json.load(f)
    with open(runner.write_result_json(rep, str(tmp_path / "port"))) as f:
        port = json.load(f)
    # the trace section too since slice 10b-1 (empty: no spans here)
    assert port == ref and port["trace"] == {}


@pytest.mark.parametrize("corrupt, want", [(False, [2, 2, 0, 0]), (True, [1, 2, 3, 0])])
def test_same_slice_ring_forces_the_slice_blind_neighbor(monkeypatch, corrupt, want):
    """``--corrupt same_slice_ring`` reaches the workers by env: four
    processes in two slices push to the next process of another slice,
    or, corrupted, to ``(i + 1) % n`` (two of them on their own slice)."""
    from elasticdl_tpu_torch.replication.replicator import SAME_SLICE_RING_ENV, PeerReplicator
    from elasticdl_tpu_torch.replication.store import ReplicaStore

    if corrupt:
        monkeypatch.setenv(SAME_SLICE_RING_ENV, "1")
    else:
        monkeypatch.delenv(SAME_SLICE_RING_ENV, raising=False)
    neighbors = [
        PeerReplicator(ReplicaStore(), p, 4, 0, "", num_slices=2).neighbor for p in range(4)
    ]
    assert neighbors == want
