"""Slice-granular elasticity, parking and the autoscaler in the port
(slice 6b-2c) against the JAX package's, on the CPU.

- **The shared rules.** ``slice_assignments`` over a grid of process and
  slice counts; the slice-aware replica ring's neighbor; the autoscaler's
  and the step-time tracker's decision streams for each case of
  ``tests/test_multislice.py::TestAutoscaler``, on one injected clock;
  the cross-slice coverage invariant on the same events.
- **The instance manager's slice surface** (``TestInstanceManagerSlices``):
  divisibility, resizes in slices, the fleet's size, the journaled map.
- **Both masters through one fake slice instance manager**
  (``_FakeSliceIM``, ``TestSliceReform``): a whole slice's death, a
  partial death, every slice dead, park -> stray request -> grant, the
  autoscale tick, no autoscaler without its flags, the slice-loss and
  resize records; and a parked master's journal replayed by the other
  package's master, each way, staying parked.
- **End to end** (gloo, tiny mnist through the train CLI):
  ``chip_smoke.py``'s phase 15b and 15c-d at a small size: a two-slice
  world with replication that loses slice 1 and resumes from peer RAM,
  a park below ``--min_slices`` and its grant, and an autoscale grow.
"""

from __future__ import annotations

import importlib
import json
import os
from types import SimpleNamespace

import pytest

PKGS = ("jax", "torch")


def _pkg(pkg: str) -> SimpleNamespace:
    base = "elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch"

    def imp(name):
        return importlib.import_module(f"{base}.{name}")

    return SimpleNamespace(
        base=base,
        mesh=imp("parallel.mesh"),
        autoscaler=imp("master.autoscaler"),
        slo=imp("telemetry.slo"),
        master=imp("master.master"),
        args=imp("utils.args"),
        journal=imp("master.journal"),
        replicator=imp("replication.replicator"),
        store=imp("replication.store"),
        harness=imp("chaos.harness"),
    )


# ---- the shared rules ------------------------------------------------------


@pytest.mark.parametrize("slices", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("processes", [0, 1, 2, 3, 4, 5, 8, 9])
def test_slice_assignments_match_jax(processes, slices):
    got = _pkg("torch").mesh.slice_assignments(processes, slices)
    assert got == _pkg("jax").mesh.slice_assignments(processes, slices)
    assert len(got) == processes and got == sorted(got)


@pytest.mark.parametrize("processes, slices", [(2, 1), (2, 2), (4, 2), (6, 3), (8, 2), (5, 2)])
def test_the_slice_aware_ring_matches_jax(processes, slices):
    """Each process's push target, and that it lives on another slice in
    a multi-slice world."""
    got, want = [], []
    for pid in range(processes):
        for pkg, out in (("torch", got), ("jax", want)):
            m = _pkg(pkg)
            rep = m.replicator.PeerReplicator(
                m.store.ReplicaStore(generation=0), process_id=pid,
                num_processes=processes, generation=0, addr="x:1", num_slices=slices,
            )
            out.append((rep.neighbor, rep.advertisement()["slice_id"]))
    assert got == want
    assign = _pkg("torch").mesh.slice_assignments(processes, slices)
    if slices > 1:
        assert all(assign[n] != assign[p] for p, (n, _s) in enumerate(got))


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# each case of tests/test_multislice.py::TestAutoscaler as a script of
# (operation, arguments) run on both packages' autoscalers
AUTOSCALER_CASES = {
    "grow_on_backlog": (dict(backlog_tasks=10), [("eval", 12, 2, 100.0)]),
    "no_grow_under_backlog_slo": (dict(backlog_tasks=10), [("eval", 3, 2, 100.0)]),
    "grow_clamped_at_max_slices": (dict(backlog_tasks=10, max_slices=2), [("eval", 50, 2, 100.0)]),
    "grow_on_p95": (dict(p95_step_ms=100.0), [("samples", [500.0] * 20), ("eval", 0, 1, 100.0)]),
    "cooldown_blocks_consecutive_decisions": (
        dict(backlog_tasks=10, cooldown_secs=30.0),
        [("eval", 10, 1, 100.0), ("eval", 10, 2, 110.0), ("eval", 10, 2, 140.0)],
    ),
    "reform_restarts_cooldown_and_baseline": (
        dict(backlog_tasks=10, cooldown_secs=1e6),
        [("samples", [100.0] * 8), ("reform",), ("p95",), ("eval", 50, 1, None)],
    ),
    "shrink_gated_and_bounded": (
        dict(p95_step_ms=100.0, shrink=True, min_slices=1, max_slices=4),
        [("samples", [10.0] * 8), ("eval", 0, 2, 100.0), ("eval", 0, 1, 200.0)],
    ),
    "no_shrink_on_empty_backlog_alone": (
        dict(backlog_tasks=10, shrink=True, min_slices=1, max_slices=4), [("eval", 0, 2, 100.0)]
    ),
    "no_shrink_without_flag": (
        dict(p95_step_ms=100.0), [("samples", [10.0] * 8), ("eval", 0, 2, 100.0)]
    ),
    # the tracker fed by version reports on the injected clock: 10 steps
    # a second, then a regime of 2 steps a second past the p95 SLO
    "version_reports_on_one_clock": (
        dict(p95_step_ms=300.0, backlog_tasks=40),
        [("versions", 0.1, 10, 12), ("p95",), ("eval", 5, 1, None),
         ("versions", 0.5, 130, 12), ("p95",), ("eval", 5, 1, None), ("eval", 41, 2, None)],
    ),
}


def _run_autoscaler(pkg: str, kw: dict, script: list) -> list:
    m = _pkg(pkg)
    clock = _Clock()
    kw = dict(kw)
    kw.setdefault("cooldown_secs", 0.0)
    kw.setdefault("max_slices", 4)
    scaler = m.autoscaler.Autoscaler(
        tracker=m.slo.StepTimePercentileTracker(clock=clock), **kw
    )
    out = []
    for op, *a in script:
        if op == "eval":
            backlog, current, now = a
            out.append(scaler.evaluate(backlog, current, now=now if now is not None else clock()))
        elif op == "samples":
            scaler.tracker._samples_ms.extend(a[0])
        elif op == "reform":
            scaler.note_reform()
        elif op == "p95":
            out.append(scaler.tracker.p95_ms())
        elif op == "versions":
            step_secs, first, count = a
            for i in range(count):
                clock.t += step_secs * 4
                scaler.note_version(0, first + 4 * i)
    out.append(scaler.decisions)
    return out


@pytest.mark.parametrize("case", sorted(AUTOSCALER_CASES))
def test_autoscaler_decision_stream_matches_jax(case):
    kw, script = AUTOSCALER_CASES[case]
    got = _run_autoscaler("torch", kw, script)
    assert got == _run_autoscaler("jax", kw, script)
    if case == "cooldown_blocks_consecutive_decisions":
        assert [d and d["action"] for d in got[:3]] == ["grow", None, "grow"]
    if case == "version_reports_on_one_clock":
        # 100 ms a step, then 500 ms: the grow waits for the slow regime
        assert got[0] == pytest.approx(100.0) and got[1] is None
        assert got[2] == pytest.approx(500.0) and got[3]["reason"].startswith("p95")
        assert got[4]["reason"].startswith("backlog") and got[4]["to_slices"] == 3


def test_build_autoscaler_reads_the_same_flags():
    for argv in ([], ["--autoscale_backlog_tasks", "4", "--autoscale_cooldown_secs", "5"],
                 ["--autoscale_p95_step_ms", "9", "--autoscale_shrink", "true",
                  "--min_slices", "2"]):
        built = []
        for pkg in PKGS:
            m = _pkg(pkg)
            args = m.args.parse_master_args(["--model_def", "m.custom_model", *argv])
            scaler = m.autoscaler.build_autoscaler(args, 3)
            built.append(None if scaler is None else (
                scaler.p95_step_ms, scaler.backlog_tasks, scaler.cooldown_secs,
                scaler.shrink_enabled, scaler.min_slices, scaler.max_slices,
            ))
        assert built[0] == built[1]
        assert (built[0] is None) == (not argv)


def test_step_time_tracker_matches_jax_on_one_clock():
    trackers = []
    for pkg in PKGS:
        clock = _Clock()
        tracker = _pkg(pkg).slo.StepTimePercentileTracker(window=16, clock=clock)
        seen = []
        for version, dt in [(0, 0), (4, 0.4), (8, 0.2), (8, 0.1), (6, 0.1), (12, 1.2),
                            (20, 0.8), (24, 0.3), (40, 3.2)] + [(44 + 4 * i, 0.1 * i) for i in range(20)]:
            clock.t += dt
            tracker.note_version(1, version)
            seen.append((tracker.sample_count, tracker.p95_ms(), tracker.percentile_ms(50)))
        tracker.reset()
        seen.append((tracker.sample_count, tracker.p95_ms()))
        trackers.append(seen)
    assert trackers[0] == trackers[1]


COVERAGE_EVENTS = [
    [],
    [{"event": "replica_push", "step": 4, "source": 0, "target": 2, "source_slice": 0,
      "target_slice": 1, "num_slices": 2}],
    [{"event": "replica_push", "step": 4, "source": 0, "target": 1, "source_slice": 0,
      "target_slice": 0, "num_slices": 2}],
    [{"event": "replica_push", "step": 4, "source": 0, "target": 1, "num_slices": 2}],
    [{"event": "replica_push", "step": 8, "source": 0, "target": 1, "source_slice": 0,
      "target_slice": 0, "num_slices": 1}],
    [{"event": "replica_push", "step": 4, "source": 1, "target": 0, "source_slice": 1,
      "target_slice": 0, "num_slices": 2, "has_sharded": True, "sharded_tables": 1,
      "sharded_rows": 0}],
]


@pytest.mark.parametrize("num_slices", [1, 2])
@pytest.mark.parametrize("case", range(len(COVERAGE_EVENTS)))
def test_cross_slice_coverage_matches_jax(case, num_slices):
    """The invariant on the JAX telemetry log's events, and on the same
    events as the port's chaos log writes them (``observation``)."""
    from elasticdl_tpu.chaos.harness import check_cross_slice_coverage as jax_check
    from elasticdl_tpu_torch.chaos.harness import check_cross_slice_coverage

    events = COVERAGE_EVENTS[case]
    want = jax_check(events, num_slices)
    assert check_cross_slice_coverage(events, num_slices) == want
    observed = [
        {("observation" if k == "event" else k): v for k, v in e.items()} for e in events
    ]
    assert check_cross_slice_coverage(observed, num_slices) == want
    assert bool(want) == (case in (2, 3, 5) or (num_slices > 1 and case in (0, 4)))


def test_capacity_realized_and_the_master_flags():
    from elasticdl_tpu_torch.chaos.harness import (
        ChaosJobConfig,
        check_capacity_realized,
        master_flags,
    )
    from elasticdl_tpu_torch.chaos.plan import FaultKind, builtin_plans

    fault = {"fault_id": "capacity-grant", "kind": FaultKind.RESTORE_CAPACITY, "monotonic": 10.0}
    assert check_capacity_realized([fault], [{"reason": "chaos:capacity-grant", "detected_at": 1.0}]) == []
    assert check_capacity_realized([fault], [{"reason": "worker_failure", "detected_at": 9.0}]) == []
    assert check_capacity_realized([fault], [{"reason": "x", "detected_at": 5.0}])
    assert check_capacity_realized([dict(fault, kind="preempt_worker")], []) == []
    plan = builtin_plans(2)["grow_under_load"]
    # the JAX harness runs master-HA and multi-slice jobs without standbys
    assert master_flags(ChaosJobConfig(plan, "/w")) == []
    assert master_flags(ChaosJobConfig(plan, "/w", num_slices=2)) == [
        "--num_slices", "2", "--standby_workers", "0"]
    assert master_flags(ChaosJobConfig(plan, "/w", master_ha=True)) == [
        "--master_journal_dir", os.path.join("/w", "journal"), "--standby_workers", "0"]


# ---- the instance manager's slice surface ----------------------------------


def _im(pkg, num_workers=4, num_slices=2):
    return _pkg(pkg).master.LocalInstanceManager(
        master=None, num_workers=num_workers, build_argv=lambda *a, **k: [],
        lockstep=True, num_slices=num_slices,
    )


def _surface(im):
    return (im.world_size, im.world_num_slices, im.max_world_size, im.fleet_slices)


SURFACE_SCRIPTS = {
    "set_world_slices": (4, 2, [("slices", 1), ("slices", 99), ("slices", 0)]),
    "set_world_size_snaps_to_slice_units": (4, 2, [("size", 3), ("size", 4), ("size", 1), ("size", 9)]),
    "max_world_size_is_fleet": (4, 2, [("slices", 1)]),
    "single_slice_ignores_slice_snap": (4, 1, [("size", 3), ("size", 0)]),
    "three_slices": (6, 3, [("size", 5), ("slices", 2), ("size", 6)]),
}


@pytest.mark.parametrize("case", sorted(SURFACE_SCRIPTS))
def test_instance_manager_slice_surface_matches_jax(case):
    workers, slices, script = SURFACE_SCRIPTS[case]
    seen = []
    for pkg in PKGS:
        im = _im(pkg, workers, slices)
        out = [_surface(im)]
        for op, n in script:
            (im.set_world_slices if op == "slices" else im.set_world_size)(n)
            out.append(_surface(im))
        seen.append(out)
    assert seen[0] == seen[1]


def test_instance_manager_refuses_an_uneven_fleet_and_restores_a_map():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="not divisible"):
            _im(pkg, 3, 2)
        im = _im(pkg, 4, 2)
        im.restore_worker_slices({"7": 0, "8": 1})
        assert im.worker_slices() == {7: 0, 8: 1}
        # --num_slices on a task-stream job is ignored, as in JAX
        single = _pkg(pkg).master.LocalInstanceManager(
            None, 1, lambda *a, **k: [], lockstep=False, num_slices=2
        )
        assert single.fleet_slices == 1


# ---- both masters through one fake slice instance manager ------------------


class _FakeSliceIM:
    """``LocalInstanceManager``'s slice surface without processes (the
    JAX ``tests/test_multislice.py::_FakeSliceIM``)."""

    lockstep = True

    def __init__(self, slice_assignments, num_workers=4, num_slices=2):
        self._assign = slice_assignments
        self._num_workers = num_workers
        self.fleet_slices = num_slices
        self._pps = num_workers // num_slices
        self.world_num_slices = num_slices
        self.world_size = num_workers
        assign = slice_assignments(num_workers, num_slices)
        self._workers = {wid: assign[wid] for wid in range(num_workers)}
        self.reformed_with: list[int] = []
        self.torn_down = 0
        self.started = False
        self.pending_world_trace = None

    @property
    def max_world_size(self):
        return self._num_workers

    def worker_ids(self):
        return list(self._workers)

    def worker_slices(self):
        return dict(self._workers)

    def set_world_slices(self, n):
        n = max(1, min(self.fleet_slices, int(n)))
        self.world_num_slices = n
        self.world_size = n * self._pps

    def set_world_size(self, n):
        self.set_world_slices(max(1, int(n) // self._pps))

    def restore_worker_slices(self, mapping):
        self._workers = {int(k): int(v) for k, v in mapping.items()}

    def reform_world(self, cluster_version, count_against_budget=True):
        self.reformed_with.append(self.world_size)
        assign = self._assign(self.world_size, self.world_num_slices)
        self._workers = {
            100 * (len(self.reformed_with) + 1) + i: assign[i] for i in range(self.world_size)
        }

    def teardown_world(self, budget=False):
        self.torn_down += 1
        self._workers = {}

    def start_workers(self):
        self.started = True

    def poll_failed_workers(self):
        return []

    def reserve_worker_ids(self, next_id):
        pass

    def adopt_worker(self, worker_id, pid):
        return True

    def stop_workers(self, grace_secs=0.0):
        pass


@pytest.fixture(scope="module")
def mnist_shards(tmp_path_factory):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    return gen_mnist(
        str(tmp_path_factory.mktemp("slices") / "train"), num_records=64, num_shards=1, seed=3
    )


def _make_master(pkg, train, tmp_path, extra=(), fake_im=None):
    m = _pkg(pkg)
    argv = [
        "--model_def", "mnist_functional_api.mnist_functional_api.custom_model",
        "--training_data", train, "--minibatch_size", "16", "--records_per_task", "32",
        "--num_workers", "4", "--distribution_strategy", "AllreduceStrategy",
        "--envs", f"ELASTICDL_TPU_CHAOS_EVENTS={tmp_path / f'events_{pkg}.jsonl'}", *extra,
    ]
    if pkg == "jax":
        argv += ["--metrics_port", "-1"]
    args = m.args.parse_master_args(argv)
    return m.master.Master(args, instance_manager_factory=(lambda _m: fake_im) if fake_im else None)


def _decisions(master, im) -> dict:
    return {
        "reformed_with": list(im.reformed_with), "torn_down": im.torn_down,
        "world_num_slices": im.world_num_slices, "world_size": im.world_size,
        "parked": master._parked, "quiescing": master.servicer.is_quiescing,
        "generation": master.servicer.cluster_version,
        "reforms": [(e["reason"], e["dead_workers"]) for e in master.reform_events],
        "requested": master._reform_requested,
    }


# (dead workers, reason, set_world_slices before the step or None) steps
REFORM_SCRIPTS = {
    "whole_slice_death_shrinks_next_world": ((), [([2, 3], "worker_failure", None)]),
    "partial_slice_death_keeps_size": ((), [([3], "worker_failure", None)]),
    "all_slices_dead_is_whole_world_crash": ((), [([0, 1, 2, 3], "worker_failure", None)]),
    "park_then_stray_then_grant": (
        ("--min_slices", "2"),
        [([2, 3], "worker_failure", None), ([], "stray", 1), ([], "capacity_grant", 2)],
    ),
    "shrink_then_grow_back": (
        (), [([2, 3], "worker_failure", None), ([], "capacity_grant", 2)],
    ),
}


def _run_reform_script(pkg, train, tmp_path, extra, steps):
    im = _FakeSliceIM(_pkg(pkg).mesh.slice_assignments)
    master = _make_master(pkg, train, tmp_path, extra, fake_im=im)
    out = []
    for dead, reason, slices in steps:
        if slices is not None:
            im.set_world_slices(slices)
        master._reform_lockstep(list(dead), reason=reason)
        out.append(_decisions(master, im))
    return out


@pytest.mark.parametrize("case", sorted(REFORM_SCRIPTS))
def test_slice_reform_decisions_match_jax(case, mnist_shards, tmp_path):
    extra, steps = REFORM_SCRIPTS[case]
    got = _run_reform_script("torch", mnist_shards, tmp_path, extra, steps)
    assert got == _run_reform_script("jax", mnist_shards, tmp_path, extra, steps)
    expected_first = {
        "whole_slice_death_shrinks_next_world": [2],
        "partial_slice_death_keeps_size": [4],
        "all_slices_dead_is_whole_world_crash": [4],
        "park_then_stray_then_grant": [],
        "shrink_then_grow_back": [2],
    }[case]
    assert got[0]["reformed_with"] == expected_first
    if case == "park_then_stray_then_grant":
        assert [(s["parked"], s["quiescing"], s["torn_down"]) for s in got] == [
            (True, True, 1), (True, True, 1), (False, False, 1)]
        assert got[-1]["reformed_with"] == [4]


def test_slice_loss_and_mesh_resize_are_recorded_as_jax_emits_them(mnist_shards, tmp_path):
    """The port writes the JAX package's ``slice_loss`` and ``mesh_resize``
    telemetry events to its chaos event log, with the same fields."""
    from elasticdl_tpu_torch.chaos.invariants import read_event_log

    im = _FakeSliceIM(_pkg("jax").mesh.slice_assignments)
    jax_master = _make_master("jax", mnist_shards, tmp_path, fake_im=im)
    emitted = []
    jax_master.telemetry.events.emit = lambda name, **kw: emitted.append((name, kw))
    jax_master._reform_lockstep([2, 3], reason="worker_failure")
    want = {name: kw for name, kw in emitted if name in ("slice_loss", "mesh_resize")}
    port_im = _FakeSliceIM(_pkg("torch").mesh.slice_assignments)
    port = _make_master("torch", mnist_shards, tmp_path, fake_im=port_im)
    port._reform_lockstep([2, 3], reason="worker_failure")
    got = {e["observation"]: e for e in read_event_log(str(tmp_path / "events_torch.jsonl"))}
    assert set(got) == {"slice_loss", "mesh_resize"}
    for name in ("slice_loss", "mesh_resize"):
        keys = set(want[name]) - {"started_at", "trace_ctx", "dcn"}
        assert {k: got[name][k] for k in keys} == {k: want[name][k] for k in keys}
    assert got["slice_loss"]["lost_slices"] == [1] and not got["slice_loss"]["parked"]
    assert (got["mesh_resize"]["old_slices"], got["mesh_resize"]["new_slices"]) == (2, 1)


def test_the_autoscale_tick_requests_a_grow_as_jax_does(mnist_shards, tmp_path):
    from elasticdl_tpu_torch.chaos.invariants import read_event_log

    flags = ("--autoscale_backlog_tasks", "1", "--autoscale_cooldown_secs", "0")
    seen = []
    for pkg in PKGS:
        im = _FakeSliceIM(_pkg(pkg).mesh.slice_assignments)
        im.set_world_slices(1)
        master = _make_master(pkg, mnist_shards, tmp_path, flags, fake_im=im)
        assert master.autoscaler is not None
        master._autoscale_tick()
        seen.append((im.world_num_slices, master._reform_requested, master.autoscaler.decisions))
    assert seen[0] == seen[1]
    assert seen[0][:2] == (2, "autoscale:grow")
    (decision,) = [e for e in read_event_log(str(tmp_path / "events_torch.jsonl"))
                   if e["observation"] == "autoscale_decision"]
    assert decision["to_slices"] == 2


@pytest.mark.parametrize("late, want", [
    ({3: 0.2}, [2, 3]),  # the rest of slice 1 dies 0.2 s later: one slice loss
    ({}, [2]),  # worker 2 alone: the settle runs out, a crash of one process
    ({0: 0.1, 1: 0.1}, [0, 1, 2]),  # slice 0 then dies in full; slice 1 stays partial
])
def test_a_slice_deaths_settle_before_the_plan(late, want, mnist_shards, tmp_path, monkeypatch):
    """A slice's processes die moments apart: the master waits (up to
    ``SLICE_DEATH_SETTLE_SECS``) while a slice is dead in part, so that a
    poll between two deaths does not take a slice loss for one crash."""
    import time

    from elasticdl_tpu_torch.master import master as port_master

    monkeypatch.setattr(port_master, "SLICE_DEATH_SETTLE_SECS", 0.6)
    im = _FakeSliceIM(_pkg("torch").mesh.slice_assignments)
    start = time.monotonic()
    im.poll_failed_workers = lambda: [w for w, at in late.items() if time.monotonic() - start >= at]
    master = _make_master("torch", mnist_shards, tmp_path, fake_im=im)
    master._handle_dead_workers([2])
    assert master.reform_events[0]["dead_workers"] == want
    assert im.world_num_slices == (2 if want == [2] else 1)
    assert time.monotonic() - start < (0.5 if late == {3: 0.2} else 2.0)


def test_no_autoscaler_without_its_flags(mnist_shards, tmp_path):
    for pkg in PKGS:
        master = _make_master(
            pkg, mnist_shards, tmp_path, fake_im=_FakeSliceIM(_pkg(pkg).mesh.slice_assignments)
        )
        assert master.autoscaler is None


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_a_parked_journal_is_replayed_parked_by_the_other_package(
    writer, reader, mnist_shards, tmp_path
):
    """A master parked below --min_slices dies; the other package's master
    relaunched from its journal comes back parked and quiesced, with the
    journaled slice count, and starts no world."""
    journal = str(tmp_path / "journal")
    extra = ("--min_slices", "2", "--master_journal_dir", journal)
    im = _FakeSliceIM(_pkg(writer).mesh.slice_assignments)
    first = _make_master(writer, mnist_shards, tmp_path, extra, fake_im=im)
    first._reform_lockstep([2, 3], reason="worker_failure")
    assert first._parked
    first.journal.flush()
    world = _pkg(reader).journal.load_state(journal)["world"]
    assert (world["parked"], world["num_slices"], world["worker_ids"]) == (True, 1, [])
    first.journal.close()
    im2 = _FakeSliceIM(_pkg(reader).mesh.slice_assignments)
    second = _make_master(reader, mnist_shards, tmp_path, extra, fake_im=im2)
    assert second._parked
    second.prepare(port=0)
    try:
        assert not im2.started
        assert second.servicer.is_quiescing
        assert im2.world_num_slices == 1
        # a grant un-parks it
        im2.set_world_slices(2)
        second._reform_lockstep([], reason="capacity_grant")
        assert not second._parked and im2.reformed_with == [4]
        assert not second.servicer.is_quiescing
    finally:
        second.stop()


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_a_restored_multi_slice_world_keeps_its_slice_map(writer, reader, mnist_shards, tmp_path):
    """A two-slice world journaled by one package comes back to the other
    package's restored master with its slice map and slice count, so a
    slice loss after the restart still shrinks the world."""
    journal = str(tmp_path / "journal")
    extra = ("--master_journal_dir", journal, "--rehome_grace_secs", "30")
    im = _FakeSliceIM(_pkg(writer).mesh.slice_assignments)
    first = _make_master(writer, mnist_shards, tmp_path, extra, fake_im=im)
    first._record_world()
    first.journal.flush()
    first.journal.close()
    im2 = _FakeSliceIM(_pkg(reader).mesh.slice_assignments)
    im2.restore_worker_slices({})
    im2.set_world_slices(1)
    second = _make_master(reader, mnist_shards, tmp_path, extra, fake_im=im2)
    second.prepare(port=0)
    try:
        assert (im2.worker_slices(), im2.world_num_slices, im2.world_size) == (
            {0: 0, 1: 0, 2: 1, 3: 1}, 2, 4)
        assert not second._parked and not im2.started
        second._reform_lockstep([2, 3], reason="worker_failure")
        assert im2.reformed_with == [2] and im2.world_num_slices == 1
    finally:
        second.stop()


# ---- end to end: chip_smoke.py's phase 15b-d at a small size -----------------


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    """Worker processes inherit the environment: one intra-op thread
    each, so that they do not oversubscribe the CPU."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


def _smoke():
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    return chip_smoke


def test_smoke_phase15_slices_rehearsal_on_the_cpu(tmp_path):
    """15b (four ranks in two slices with replication lose slice 1 and
    resume from peer RAM in two), 15c (a park below --min_slices and a
    grant 2 s later) and 15d (an autoscale grow from one slice to two,
    beside 15c), gated by the smoke's own gates."""
    smoke = _smoke()
    cfg = dict(smoke.SLICE_MNIST, train_records=512, eval_records=256, shards=2,
               records_per_task=64, batch=16, epochs=2, min_accuracy=0.0)
    data = smoke._zoo_data(str(tmp_path / "data"), cfg)
    report = smoke.slices_phase(str(tmp_path), cfg, device="cpu", data=data, with_standby=False)
    print(json.dumps(report, default=str))
    smoke.check_slices(report, cfg)


def test_a_two_slice_world_of_two_resumes_alone_from_peer_ram(tmp_path):
    """Two ranks in two slices with replication lose slice 1: the next
    world is process 0 alone, which asks the master for the replica
    stage (a world of one still restores from peer RAM) and finishes the
    job with every record once."""
    from elasticdl_tpu_torch.chaos.invariants import check_replication_no_lost_steps
    from elasticdl_tpu_torch.chaos.plan import builtin_plans

    smoke = _smoke()
    cfg = dict(smoke.SLICE_MNIST, train_records=512, eval_records=256, shards=2,
               records_per_task=64, batch=16, epochs=2, min_accuracy=0.0)
    data = smoke._zoo_data(str(tmp_path / "data"), cfg)
    run = smoke._distributed_run(
        cfg, data, "cpu", str(tmp_path / "job"), "two", plan=builtin_plans(2)["slice_loss_mid_epoch"],
        extra=("--num_slices", "2", "--min_slices", "1", "--replication", "true",
               "--standby_workers", "0"),
    )
    row, events = run["row"], run["events"]
    assert row["rc"] == 0 and row["total_records"] == 1024 and not row["violations"]
    (event,) = row["reform_events"]
    assert event["dead_workers"] == [1] and event["harvest"]["complete"]
    assert run["built"]["worlds"] == [{2: run["built"]["worlds"][0][2]}]
    assert smoke._restored_from(events) == f"replica@{event['harvest']['version']}"
    assert check_replication_no_lost_steps(events)["status"] == "PASS"
    (loss,) = smoke._observed(events, "slice_loss")
    assert (loss["lost_slices"], loss["new_slices"], loss["parked"]) == ([1], 1, False)
    assert row["dumps"] == 1
