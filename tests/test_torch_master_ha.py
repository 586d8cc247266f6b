"""Master high availability in the port (slice 6b-2b) against the JAX
package's, on the CPU.

- **The journal, the servicer and the dispatcher, case by case.** The
  cases of ``tests/test_master_ha.py`` whose code this slice brings run
  on both packages (``pkg``): string keys only, replay equivalent to a
  snapshot (and the same replayed state in both packages), the restored
  dispatcher finishing the job, a kill at an epoch's last task, the
  generation fence and the stream stamps in replay, the abort's lost
  tail and the success reports that survive it, the address file, the
  re-homing handshake's fence and sink, the checker across a restart,
  the deferred callbacks, the re-home deadline and the stage release.
- **The port's own pins.** A lease is durable before its response leaves
  the master (the JAX package loses it with the batch tail); the worker
  sides of re-homing (the lockstep worker, whose fence rejection is
  terminal, its HA linger, and the task-stream worker's lease ledger);
  re-resolution of the master's address on the socket transport; the
  adopted process; the master-recovery invariant read from the chaos
  event log; and nothing of the journal without ``--master_journal_dir``.
- **One scripted control plane through both packages.** A JAX ``Master``
  and a port ``Master`` in process, with a fake instance manager, go
  through the same leases, reports, fence, crash at a tick, replay and
  re-homes: the journals are equal once each record's ``time`` and
  ``monotonic`` stamps and the JAX dispatch trace (``response.trace``,
  slice 10) are dropped, the counters are equal, and each package's
  ``replay`` reads the other's journal to the same state.
- **End to end.** Two gloo ranks of a tiny mnist through the train CLI
  under ``master_kill_mid_epoch`` and ``master_kill_during_reform``, one
  checker spanning the master's lives (``chip_smoke.py``'s phase 14 at a
  small size).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import random
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from elasticdl_tpu_torch.master import journal as port_journal
from elasticdl_tpu_torch.rpc import messages as port_msg

PKGS = ("jax", "torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mods(pkg: str) -> SimpleNamespace:
    base = "elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch"

    def imp(name):
        return importlib.import_module(f"{base}.{name}")

    return SimpleNamespace(
        journal=imp("master.journal"),
        disp=imp("master.task_dispatcher"),
        servicer=imp("master.servicer"),
        msg=imp("rpc.messages"),
        inv=imp("chaos.invariants"),
        events=imp("telemetry.events"),
        TaskType=imp("utils.constants").TaskType,
        master=lambda: imp("master.master"),
    )


@pytest.fixture(params=PKGS)
def m(request):
    return _mods(request.param)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    """The worker processes this file starts inherit the environment: one
    intra-op thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


# ---- the journal, replayed ------------------------------------------------


def _journal_for(m, d, path, cv=0, **kw):
    journal = m.journal.MasterJournal(str(path), **kw)
    d.add_observer(journal)
    journal.set_snapshot_provider(
        lambda append: d.atomic_state_snapshot(
            lambda dispatcher_state: append(
                {
                    "dispatcher": dispatcher_state,
                    "servicer": {"cluster_version": cv, "model_version": 0, "stream": {}},
                    "callbacks_invoked": journal.callbacks_invoked,
                    "world": None,
                }
            )
        )
    )
    journal.start()
    return journal


def _drive_random(d, journal, rng, ops=60):
    """A random but valid transition stream: lease, succeed, fail,
    recover a worker, re-snapshot now and then."""
    active: list[int] = []
    for _ in range(ops):
        op = rng.random()
        if op < 0.45:
            tid, task = d.get(worker_id=rng.randrange(3))
            if task is not None:
                active.append(tid)
        elif op < 0.75 and active:
            tid = active.pop(rng.randrange(len(active)))
            d.report(
                tid,
                success=rng.random() < 0.8,
                exec_counters={"fail_count": rng.randrange(2), "batch_count": rng.randrange(5)},
            )
        elif op < 0.85 and active:
            d.recover_tasks(rng.randrange(3))
            still_active = set(d.state_snapshot()["active"])
            active = [t for t in active if str(t) in still_active]
        elif op < 0.9:
            journal.write_snapshot()


def test_journal_records_and_snapshots_use_string_keys_only(m):
    d = m.disp.TaskDispatcher({"s": (0, 128)}, records_per_task=64, shuffle_seed=1)
    d.get(worker_id=0)
    snap = d.state_snapshot()

    def assert_str_keys(obj, path="$"):
        if isinstance(obj, dict):
            for key, value in obj.items():
                assert isinstance(key, str), f"non-str key at {path}: {key!r}"
                assert_str_keys(value, f"{path}.{key}")
        elif isinstance(obj, list):
            for i, item in enumerate(obj):
                assert_str_keys(item, f"{path}[{i}]")

    assert_str_keys(snap)
    assert json.loads(json.dumps(snap)) == snap


def _replayed(m, path, seed):
    rng = random.Random(seed)
    d = m.disp.TaskDispatcher(
        {"a": (0, 256), "b": (256, 192)}, records_per_task=64, num_epochs=3, shuffle_seed=seed
    )
    journal = _journal_for(m, d, path, snapshot_every=10_000)
    _drive_random(d, journal, rng)
    journal.flush()
    return d, m.journal.load_state(str(path))


@pytest.mark.parametrize("seed", [1, 7, 23, 57])
def test_journal_replay_reconstructs_snapshot_equivalent_state(m, tmp_path, seed):
    d, restored = _replayed(m, tmp_path, seed)
    assert restored is not None and not restored["clean_shutdown"]
    assert restored["dispatcher"] == d.state_snapshot()


@pytest.mark.parametrize("seed", [1, 7, 23, 57])
def test_both_packages_replay_the_same_transitions_to_the_same_state(tmp_path, seed):
    jax_d, jax_state = _replayed(_mods("jax"), tmp_path / "jax", seed)
    port_d, port_state = _replayed(_mods("torch"), tmp_path / "torch", seed)
    assert port_state["dispatcher"] == jax_state["dispatcher"]
    assert port_d.state_snapshot() == jax_d.state_snapshot()


def test_restored_dispatcher_continues_equivalently(m, tmp_path):
    rng = random.Random(11)
    d = m.disp.TaskDispatcher({"a": (0, 256)}, records_per_task=64, num_epochs=2, shuffle_seed=11)
    journal = _journal_for(m, d, tmp_path, snapshot_every=10_000)
    _drive_random(d, journal, rng, ops=25)
    journal.flush()
    restored = m.journal.load_state(str(tmp_path))
    d2 = m.disp.TaskDispatcher({"a": (0, 256)}, records_per_task=64, num_epochs=2, shuffle_seed=99)
    d2.restore_state(restored["dispatcher"])
    assert d2.state_snapshot() == d.state_snapshot()
    # leases held at the kill are presented by nobody: requeued
    for tid in list(restored["dispatcher"]["active"]):
        d2.reconcile_leases(restored["dispatcher"]["active"][tid]["worker_id"], set())
    seen = set()
    while True:
        tid, task = d2.get(worker_id=0)
        if task is None:
            break
        assert task.uid not in seen
        seen.add(task.uid)
        d2.report(tid, success=True)
    assert d2.finished()


def test_replay_kill_at_epochs_last_task_runs_remaining_epochs(m, tmp_path):
    d = m.disp.TaskDispatcher({"s": (0, 128)}, records_per_task=64, num_epochs=2, shuffle_seed=5)
    journal = _journal_for(m, d, tmp_path, snapshot_every=10_000)
    leases = []
    while d.state_snapshot()["pending"]:
        tid, _task = d.get(worker_id=0)
        leases.append(tid)
    for tid in leases:
        d.report(tid, success=True)
    journal.flush()
    restored = m.journal.load_state(str(tmp_path))
    d2 = m.disp.TaskDispatcher({"s": (0, 128)}, records_per_task=64, num_epochs=2, shuffle_seed=5)
    d2.restore_state(restored["dispatcher"])
    assert not d2.finished()
    remaining = 0
    while True:
        tid, task = d2.get(worker_id=1)
        if task is None:
            break
        d2.report(tid, success=True)
        remaining += 1
    assert remaining == len(leases) and d2.finished()
    assert d2.counters(m.TaskType.TRAINING).total_records == 2 * 128


def _snapshot_record(stream=None):
    return {
        "kind": "snapshot",
        "state": {
            "dispatcher": {
                "epoch": 0, "next_task_id": 0, "next_task_uid": 0, "pending": [],
                "pending_eval": [], "active": {}, "counters": {},
            },
            "servicer": {"cluster_version": 0, "model_version": 0, "stream": stream or {}},
        },
    }


def test_replay_generation_bump_resets_stream_and_is_monotone(m):
    state = m.journal.replay([
        _snapshot_record(),
        {"kind": "stream", "stream_seq": 4, "response": {"task_id": 9}},
        {"kind": "generation", "cluster_version": 2},
        {"kind": "stream", "stream_seq": 0, "response": {"task_id": 11}},
        {"kind": "generation", "cluster_version": 1},
    ])
    assert state["servicer"]["cluster_version"] == 2
    assert state["servicer"]["stream"] == {"0": {"task_id": 11}}


def test_replay_drops_stream_records_stamped_for_another_world(m):
    state = m.journal.replay([
        _snapshot_record(),
        {"kind": "stream", "stream_seq": 4, "response": {"task_id": 9}, "cluster_version": 0},
        {"kind": "generation", "cluster_version": 1},
        {"kind": "stream", "stream_seq": 5, "response": {"task_id": 10}, "cluster_version": 0},
        {"kind": "stream", "stream_seq": 6, "response": {"task_id": 12}},
        {"kind": "stream", "stream_seq": 0, "response": {"task_id": 11}, "cluster_version": 1},
    ])
    assert state["servicer"]["stream"] == {"0": {"task_id": 11}, "6": {"task_id": 12}}


def test_replay_stream_snapshot_supersedes_earlier_memos(m):
    state = m.journal.replay([
        _snapshot_record({"0": {"task_id": 7}}),
        {"kind": "stream_snapshot", "stream": {"0": {"task_id": 7}, "1": {"task_id": 8}}},
        {"kind": "stream", "stream_seq": 2, "response": {"task_id": 9}},
    ])
    assert state["servicer"]["stream"] == {
        "0": {"task_id": 7}, "1": {"task_id": 8}, "2": {"task_id": 9},
    }


def test_step_task_memo_journals_with_its_generation_stamp(m):
    d = m.disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=4)
    servicer = m.servicer.MasterServicer(32, d)
    recorded: list = []

    class _Journal:
        def record_stream(self, seq, response, cluster_version=-1):
            recorded.append((seq, cluster_version))

        def flush(self):
            pass

    servicer.set_journal(_Journal())
    resp = servicer.get_step_task(m.msg.GetStepTaskRequest(worker_id=0, seq=0, cluster_version=0))
    assert resp.task_id != -1 and recorded == [(0, 0)]
    stale = servicer.get_step_task(m.msg.GetStepTaskRequest(worker_id=1, seq=0, cluster_version=7))
    assert stale.task_id == -1 and recorded == [(0, 0)]


def test_journal_abort_drops_the_unflushed_tail(m, tmp_path):
    d = m.disp.TaskDispatcher({"s": (0, 128)}, records_per_task=64, shuffle_seed=2)
    journal = _journal_for(m, d, tmp_path, fsync_batch=10_000, fsync_interval_secs=3600.0)
    d.get(worker_id=0)  # a lease leased straight off the dispatcher rides the batch
    journal.abort()
    restored = m.journal.load_state(str(tmp_path))
    assert restored["dispatcher"]["active"] == {}
    assert len(restored["dispatcher"]["pending"]) == 2
    journal.on_epoch_opened(1)
    journal.flush()
    assert m.journal.load_state(str(tmp_path))["dispatcher"] == restored["dispatcher"]


def test_journal_success_reports_survive_the_abort_tail(m, tmp_path):
    d = m.disp.TaskDispatcher({"s": (0, 128)}, records_per_task=64, shuffle_seed=2)
    journal = _journal_for(m, d, tmp_path, fsync_batch=10_000, fsync_interval_secs=3600.0)
    tid, _task = d.get(worker_id=0)
    d.report(tid, success=True)
    journal.abort()
    restored = m.journal.load_state(str(tmp_path))
    assert restored["dispatcher"]["active"] == {}
    assert len(restored["dispatcher"]["pending"]) == 1
    assert restored["dispatcher"]["counters"]["TRAINING"]["total_records"] == 128


# a lease served through the servicer survives a kill in the port (it is
# flushed before its response leaves) and rides the lost tail in the JAX
# package: (task-stream leases, step-stream leases) active after the abort
DURABLE_LEASES = {"jax": (0, 0), "torch": (1, 1)}


@pytest.mark.parametrize("pkg", PKGS)
def test_a_served_lease_is_durable_before_its_response_leaves(pkg, tmp_path):
    m = _mods(pkg)
    got = []
    for kind in ("get_task", "get_step_task"):
        path = tmp_path / kind
        d = m.disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=2)
        journal = _journal_for(m, d, path, fsync_batch=10_000, fsync_interval_secs=3600.0)
        servicer = m.servicer.MasterServicer(32, d)
        servicer.set_journal(journal)
        if kind == "get_task":
            resp = servicer.get_task(m.msg.GetTaskRequest(worker_id=0))
        else:
            resp = servicer.get_step_task(
                m.msg.GetStepTaskRequest(worker_id=0, seq=0, cluster_version=0)
            )
        assert resp.task_id > 0
        journal.abort()
        restored = m.journal.load_state(str(path))
        got.append(len(restored["dispatcher"]["active"]))
        if kind == "get_step_task" and got[-1]:
            # and the stream memo with it: a restarted master answers seq
            # 0 as the first life did
            assert restored["servicer"]["stream"]["0"]["task_id"] == resp.task_id
    assert tuple(got) == DURABLE_LEASES[pkg]


def test_master_addr_file_round_trip(m, tmp_path):
    m.journal.write_master_addr(str(tmp_path), "localhost:4711")
    assert m.journal.read_master_addr(m.journal.addr_file_path(str(tmp_path))) == "localhost:4711"
    assert m.journal.read_master_addr(str(tmp_path / "missing")) is None


def test_both_packages_write_the_same_address_file(tmp_path):
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        _mods(pkg).journal.write_master_addr(str(tmp_path / pkg), "localhost:4711")
    files = [(tmp_path / pkg / "master_addr").read_bytes() for pkg in PKGS]
    assert files[0] == files[1] == b"localhost:4711\n"
    assert port_journal.MASTER_ADDR_FILE_ENV == _mods("jax").journal.MASTER_ADDR_FILE_ENV


# ---- the re-homing handshake --------------------------------------------------


def _leased_dispatcher(m):
    d = m.disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=4)
    leases = {}
    for worker in (1, 1, 2):
        tid, _task = d.get(worker_id=worker)
        leases.setdefault(worker, []).append(tid)
    return d, leases


def test_reconcile_leases_keeps_presented_and_requeues_the_rest(m):
    d, leases = _leased_dispatcher(m)
    kept, requeued = d.reconcile_leases(1, {leases[1][0]})
    assert kept == [leases[1][0]] and requeued == [leases[1][1]]
    assert d.is_active(leases[2][0]) and not d.is_active(leases[1][1])
    kept, requeued = d.reconcile_leases(2, {9999, *leases[2]})
    assert kept == leases[2] and requeued == []


def test_servicer_rehome_fences_stale_generations(m):
    d, leases = _leased_dispatcher(m)
    servicer = m.servicer.MasterServicer(32, d)
    servicer.set_boot_id("boot-2")
    servicer.bump_cluster_version()
    stale = servicer.rehome_worker(
        m.msg.RehomeRequest(worker_id=1, cluster_version=0, lease_ids=leases[1])
    )
    assert not stale.accepted and stale.cluster_version == 1
    assert all(d.is_active(t) for t in leases[1])
    # a fenced worker records no liveness
    assert servicer.live_workers() == []
    current = servicer.rehome_worker(
        m.msg.RehomeRequest(worker_id=1, cluster_version=1, lease_ids=leases[1])
    )
    assert current.accepted and current.boot_id == "boot-2"
    assert sorted(current.accepted_leases) == sorted(leases[1])
    assert servicer.live_workers() == [1]


def test_servicer_rehome_sink_receives_reconciliation_outcome(m):
    d, leases = _leased_dispatcher(m)
    servicer = m.servicer.MasterServicer(32, d)
    servicer.set_boot_id("b")
    sunk = []
    servicer.set_rehome_sink(
        lambda worker_id, pid, kept, requeued, started_at: sunk.append(
            (worker_id, pid, sorted(kept), sorted(requeued), started_at)
        )
    )
    before = time.monotonic()
    servicer.rehome_worker(
        m.msg.RehomeRequest(worker_id=1, cluster_version=0, pid=77, lease_ids=[leases[1][0]])
    )
    assert [s[:4] for s in sunk] == [(1, 77, [leases[1][0]], [leases[1][1]])]
    assert before <= sunk[0][4] <= time.monotonic()


def test_heartbeats_carry_the_boot_id(m):
    d, _ = _leased_dispatcher(m)
    servicer = m.servicer.MasterServicer(32, d)
    assert servicer.heartbeat(m.msg.HeartbeatRequest(worker_id=1)).boot_id == ""
    servicer.set_boot_id("b7")
    assert servicer.heartbeat(m.msg.HeartbeatRequest(worker_id=1)).boot_id == "b7"


def test_rehome_messages_round_trip():
    req = port_msg.decode(port_msg.encode(
        port_msg.RehomeRequest(worker_id=3, cluster_version=2, pid=4242, lease_ids=[7, 9])
    ))
    assert (req.worker_id, req.cluster_version, req.pid, req.lease_ids) == (3, 2, 4242, [7, 9])
    resp = port_msg.decode(port_msg.encode(
        port_msg.RehomeResponse(accepted=True, cluster_version=2, boot_id="abc", accepted_leases=[7])
    ))
    assert resp.accepted and resp.accepted_leases == [7] and resp.boot_id == "abc"
    jax_msg = _mods("jax").msg
    for name in ("RehomeRequest", "RehomeResponse"):
        ours = {f.name: f.default for f in dataclasses.fields(getattr(port_msg, name))}
        theirs = {f.name: f.default for f in dataclasses.fields(getattr(jax_msg, name))}
        assert ours == theirs, name


# ---- the invariant checker across a restart ---------------------------------


def test_checker_identity_spans_master_restart(m):
    checker = m.inv.InvariantChecker(expected_records=256)
    d = m.disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=3)
    d.add_observer(checker)
    tid, _ = d.get(worker_id=0)
    d.report(tid, success=True)
    d2 = m.disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=8)
    d2.restore_state(d.state_snapshot())
    d2.add_observer(checker)
    while True:
        tid, task = d2.get(worker_id=1)
        if task is None:
            break
        d2.report(tid, success=True)
    assert checker.check(d2.counters(m.TaskType.TRAINING)) == []
    summary = checker.summary()
    assert summary["ok"] and summary["tasks_tracked"] == 4


def test_checker_detects_double_training_across_restart(m):
    checker = m.inv.InvariantChecker(expected_records=256)
    d = m.disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=3)
    d.add_observer(checker)
    tid, task = d.get(worker_id=0)
    d.report(tid, success=True)
    snap = d.state_snapshot()
    snap["pending"].append(
        m.disp.Task(
            shard_name=task.shard_name, start=task.start, end=task.end, type=task.type,
            uid=task.uid,
        ).to_dict()
    )
    d2 = m.disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=8)
    d2.restore_state(snap)
    d2.add_observer(checker)
    while True:
        tid, t = d2.get(worker_id=1)
        if t is None:
            break
        d2.report(tid, success=True)
    assert any(v.invariant == "exactly_once" and "double" in v.detail for v in checker.check())


# ---- the master-recovery invariant, from the chaos event log ----------------


def _ha_config(tmp_path, plan="master_kill_mid_epoch", master_ha=True):
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig
    from elasticdl_tpu_torch.chaos.plan import named_plan

    return ChaosJobConfig(plan=named_plan(plan, 2), workdir=str(tmp_path), master_ha=master_ha)


def _write_jsonl(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")


RECOVERY_CASES = {
    # (chaos events, journal records after the snapshot, lives, forge a
    # rollback) -> the verdict and a word of the violation
    "clean": (
        [{"observation": "master_restart", "generation": 0}],
        [{"kind": "generation", "cluster_version": 1}, {"kind": "generation", "cluster_version": 2}],
        2, False, "PASS", "",
    ),
    "rollback": (
        [{"observation": "master_restart", "generation": 0}], [], 2, True, "FAIL", "rolled back",
    ),
    "no_restart_evidence": ([], [], 2, False, "FAIL", "master_restart"),
    "kill_never_fired": ([], [], 1, False, "FAIL", "never realized"),
}


@pytest.mark.parametrize("case", sorted(RECOVERY_CASES))
def test_master_recovery_invariant(tmp_path, case):
    from elasticdl_tpu_torch.chaos.harness import _check_master_recovery, _corrupt_journal_rollback

    events, records, lives, forge, status, word = RECOVERY_CASES[case]
    config = _ha_config(tmp_path)
    events_path = str(tmp_path / "events.jsonl")
    _write_jsonl(events_path, events)
    _write_jsonl(port_journal.journal_path(config.journal_dir), [{"kind": "snapshot", "state": {}}, *records])
    if forge:
        _corrupt_journal_rollback(config.journal_dir)
    verdict = _check_master_recovery(config, events_path, master_lives=lives)
    assert verdict["status"] == status, verdict
    assert any(word in v for v in verdict["violations"]) if word else not verdict["violations"]


def test_master_recovery_invariant_absent_without_master_kill(tmp_path):
    from elasticdl_tpu_torch.chaos.harness import _check_master_recovery

    assert _check_master_recovery(_ha_config(tmp_path, "preempt_one_worker"), "/nonexistent", 1) is None


def test_harness_rejects_master_kill_plan_without_ha(tmp_path):
    from elasticdl_tpu_torch.chaos.harness import run_master_lives

    with pytest.raises(ValueError, match="master_ha"):
        run_master_lives(lambda: 0, _ha_config(tmp_path, master_ha=False), str(tmp_path / "e"))


# ---- the lockstep worker's side -------------------------------------------------


class _RehomeRecorder:
    def __init__(self, accept=True, fail_first=False, cluster_version=0):
        self.requests, self.accept, self.fail_first = [], accept, fail_first
        self.cluster_version = cluster_version

    def rehome_worker(self, request):
        self.requests.append(request)
        if self.fail_first and len(self.requests) == 1:
            raise ConnectionError("master gone again")
        return port_msg.RehomeResponse(
            accepted=self.accept, cluster_version=self.cluster_version, boot_id="b2",
            accepted_leases=list(request.lease_ids) if self.accept else [],
        )


def _lockstep(master, recent=(17,)):
    from elasticdl_tpu_torch.worker.lockstep import LockstepWorker

    worker = LockstepWorker.__new__(LockstepWorker)
    worker._worker_id, worker._process_id, worker._cluster_version = 3, 0, 0
    worker._recent_task_ids = list(recent)
    worker._master_boot_id, worker._fenced, worker._addr_stamp = None, False, None
    worker._replica_server = None
    worker._master = master
    return worker


def test_worker_rehomes_on_boot_id_change():
    master = _RehomeRecorder()
    worker = _lockstep(master, recent=(16, 17))
    worker._note_master_boot("")  # HA off: no-op
    worker._note_master_boot("b1")  # first sighting: remembered
    worker._note_master_boot("b1")
    assert master.requests == []
    worker._note_master_boot("b2")  # the restart
    assert [(r.worker_id, r.lease_ids, r.pid) for r in master.requests] == [(3, [16, 17], os.getpid())]
    worker._note_master_boot("b2")  # settled
    assert len(master.requests) == 1 and not worker._fenced


def test_lockstep_rehome_failure_retries_on_next_beat():
    master = _RehomeRecorder(fail_first=True)
    worker = _lockstep(master)
    worker._master_boot_id = "b1"
    worker._note_master_boot("b2")
    assert worker._master_boot_id == "b1"
    worker._note_master_boot("b2")
    assert len(master.requests) == 2 and worker._master_boot_id == "b2"


def test_lockstep_fence_rejection_is_terminal():
    master = _RehomeRecorder(accept=False, cluster_version=1)
    worker = _lockstep(master)
    worker._master_boot_id = "b1"
    worker._note_master_boot("b2")
    # the boot id advances even so, and the process knows it is fenced
    assert worker._fenced and worker._master_boot_id == "b2"


def test_lockstep_lingers_under_master_ha_and_leaves_once_fenced(monkeypatch, tmp_path):
    """A process whose world broke lingers under master HA without a
    replica server, watches the address file, re-homes when a relaunched
    master rewrites it (presenting no lease), and leaves once fenced."""
    from elasticdl_tpu_torch.worker import lockstep

    addr = tmp_path / "master_addr"
    addr.write_text("localhost:1\n")
    monkeypatch.delenv(port_journal.MASTER_ADDR_FILE_ENV, raising=False)
    master = _RehomeRecorder(accept=False, cluster_version=1)
    worker = _lockstep(master)
    assert not worker._ha_mode()
    slept = []
    monkeypatch.setattr(lockstep.time, "sleep", slept.append)
    monkeypatch.setenv(lockstep.REPLICA_LINGER_ENV, "7")
    worker._linger_for_harvest()  # HA off, no replica server: the plain wait
    assert slept == [7.0]
    monkeypatch.setenv(port_journal.MASTER_ADDR_FILE_ENV, str(addr))
    assert worker._ha_mode()
    worker._addr_stamp = lockstep._addr_file_stamp()

    def relaunch(_secs):
        slept.append(_secs)
        if len(slept) == 3:  # a relaunched master rewrites the file
            os.utime(addr, ns=(1, worker._addr_stamp + 1_000_000))

    monkeypatch.setattr(lockstep.time, "sleep", relaunch)
    worker._linger_for_harvest()
    assert worker._fenced and [r.lease_ids for r in master.requests] == [[]]
    assert all(s == lockstep.LINGER_POLL_SECS for s in slept[1:])
    monkeypatch.setenv(lockstep.REPLICA_LINGER_ENV, "0")
    worker._fenced = False
    worker._linger_for_harvest()  # disabled: returns at once
    assert not worker._fenced


# ---- the task-stream worker's side ---------------------------------------------


def _task_stream(master, leases=(), generation=0):
    from elasticdl_tpu_torch.worker.worker import Worker

    from elasticdl_tpu_torch.telemetry.compile_tracker import ExecCounterReporter

    worker = Worker.__new__(Worker)
    worker._worker_id, worker._master = 7, master
    worker._compile_deltas = ExecCounterReporter()
    worker._inflight_leases = set(leases)
    worker._task_traces = {}
    worker._master_boot_id, worker._master_cluster_version = "b1", generation
    worker._trainer, worker._stopped = None, False
    worker._rehome_lock = threading.Lock()
    return worker


def test_task_stream_rehome_presents_its_lease_ledger():
    leased = [
        port_msg.TaskResponse(task_id=21, shard_name="s", start=0, end=8),
        port_msg.TaskResponse(task_id=22, shard_name="s", start=8, end=16),
        port_msg.TaskResponse(task_id=-1, type=3),  # WAIT: not a lease
    ]
    master = _RehomeRecorder()
    master.get_task = lambda request: leased.pop(0)
    master.report_task_result = lambda request: None
    worker = _task_stream(master)
    worker._timing = SimpleNamespace(exec_counters=lambda: {})
    for _ in range(3):
        worker.get_task()
    assert worker._inflight_leases == {21, 22}
    worker.report_task_result(21)
    assert worker._inflight_leases == {22}
    assert worker._note_master_boot("b2")
    assert [r.lease_ids for r in master.requests] == [[22]]


def test_task_stream_worker_rehomes_before_its_retried_report(monkeypatch, tmp_path):
    """A report that died with the master reaches the relaunched master
    (found through the address file) only after the handshake, which
    still presents its lease."""
    import socket

    from elasticdl_tpu_torch.rpc.retry import RetryPolicy
    from elasticdl_tpu_torch.rpc.service import MASTER_RETRYABLE_METHODS, MasterClient, create_server

    calls = []

    class Relaunched:
        def heartbeat(self, request):
            calls.append("heartbeat")
            return port_msg.HeartbeatResponse(cluster_version=0, boot_id="b2")

        def rehome_worker(self, request):
            calls.append(("rehome_worker", sorted(request.lease_ids)))
            return port_msg.RehomeResponse(
                accepted=True, cluster_version=0, boot_id="b2",
                accepted_leases=list(request.lease_ids),
            )

        def report_task_result(self, request):
            calls.append(("report_task_result", request.task_id))

    with socket.socket() as sock:  # the dead master's address
        sock.bind(("localhost", 0))
        dead = sock.getsockname()[1]
    server = create_server(Relaunched(), 0)
    server.start()
    try:
        monkeypatch.setenv(port_journal.MASTER_ADDR_FILE_ENV, str(tmp_path / "master_addr"))
        client = MasterClient(
            f"localhost:{dead}", retry=RetryPolicy(max_attempts=20, base_delay_secs=0.0),
            retryable_methods=MASTER_RETRYABLE_METHODS,
            resolve_addr=lambda: f"localhost:{server.port}",
        )
        worker = _task_stream(client, leases={21, 22})
        worker._timing = SimpleNamespace(exec_counters=lambda: {})
        worker._install_reconnect_hook()
        worker.report_task_result(21)
    finally:
        server.stop()
    assert calls == ["heartbeat", ("rehome_worker", [21, 22]), ("report_task_result", 21)]
    assert worker._master_boot_id == "b2" and worker._inflight_leases == {22}


def test_heartbeat_presents_pre_outage_generation_to_rehome():
    rehomes = []

    class Restarted:
        def heartbeat(self, request):
            worker._stopped = True  # one beat is enough
            return port_msg.HeartbeatResponse(cluster_version=7, boot_id="b2")

        def rehome_worker(self, request):
            rehomes.append(request)
            return port_msg.RehomeResponse(
                accepted=True, cluster_version=7, boot_id="b2",
                accepted_leases=list(request.lease_ids),
            )

    worker = _task_stream(Restarted(), leases={31}, generation=3)
    worker._start_heartbeats(interval_secs=0.01)
    deadline = time.monotonic() + 10.0
    while worker._master_cluster_version != 7 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [r.cluster_version for r in rehomes] == [3]
    assert worker._master_cluster_version == 7


def test_rehome_failure_keeps_pre_outage_generation():
    class Down:
        def rehome_worker(self, request):
            raise ConnectionError("master gone again")

    worker = _task_stream(Down(), generation=3)
    assert worker._note_master_boot("b2") is False
    assert (worker._master_boot_id, worker._master_cluster_version) == ("b1", 3)


def test_rehome_survives_concurrent_lease_mutation():
    class RacingSet(set):
        def __iter__(self):
            raise RuntimeError("Set changed size during iteration")

    worker = _task_stream(object(), generation=3)
    worker._inflight_leases = RacingSet()
    assert worker._note_master_boot("b2") is False and worker._master_boot_id == "b1"
    worker._inflight_leases = set()
    worker._master = _RehomeRecorder(cluster_version=3)
    assert worker._note_master_boot("b2") is True and worker._master_boot_id == "b2"


def test_rehome_drops_leases_the_master_did_not_reaccept():
    class Partial:
        def rehome_worker(self, request):
            worker._inflight_leases.add(33)  # a lease taken mid-handshake
            return port_msg.RehomeResponse(accepted=True, boot_id="b2", accepted_leases=[21])

    worker = _task_stream(Partial(), leases={21, 22})
    assert worker._note_master_boot("b2") is True
    assert worker._inflight_leases == {21, 33}


def test_task_stream_fence_rejection_takes_the_masters_generation():
    worker = _task_stream(_RehomeRecorder(accept=False, cluster_version=5), generation=3)
    assert worker._note_master_boot("b2") is False
    assert (worker._master_boot_id, worker._master_cluster_version) == ("b1", 5)


# ---- deferred callbacks, the re-home deadline, the stage release ------------


def _drain(d, worker_id=0):
    while True:
        tid, task = d.get(worker_id=worker_id)
        if task is None:
            return
        d.report(tid, success=True)


def _save_model_journal(m, path):
    d = m.disp.TaskDispatcher({"s": (0, 128)}, records_per_task=64, shuffle_seed=3)
    journal = _journal_for(m, d, path, snapshot_every=10_000)
    d.add_deferred_callback_create_save_model_task("/tmp/export")
    _drain(d)
    assert d.invoke_deferred_callback()
    journal.flush()
    return journal


def test_save_model_task_is_journaled_like_any_other(m, tmp_path):
    _save_model_journal(m, tmp_path)
    restored = m.journal.load_state(str(tmp_path))
    save_tasks = [
        t for t in restored["dispatcher"]["pending"]
        if int(t["type"]) == int(m.TaskType.SAVE_MODEL)
    ]
    assert len(save_tasks) == 1 and int(save_tasks[0]["uid"]) > 0
    assert save_tasks[0]["extended"] == {"saved_model_path": "/tmp/export"}
    assert restored["callbacks_invoked"] == 1


def test_callback_consumption_journals_after_execution(m, tmp_path):
    _save_model_journal(m, tmp_path)
    records = m.events.read_jsonl(m.journal.journal_path(str(tmp_path)))
    created_at = [
        i for i, r in enumerate(records)
        if r["kind"] == "tasks_created"
        and any(int(t["type"]) == int(m.TaskType.SAVE_MODEL) for t in r.get("tasks", []))
    ]
    callback_at = [i for i, r in enumerate(records) if r["kind"] == "callback"]
    assert created_at and callback_at and created_at[0] < callback_at[0]
    truncated = m.journal.replay(records[: callback_at[0]])
    assert truncated["callbacks_invoked"] == 0
    assert any(
        int(t["type"]) == int(m.TaskType.SAVE_MODEL) for t in truncated["dispatcher"]["pending"]
    )


def _rehome_deadline_master(live, pending=(1, 2)):
    dead_calls: list = []
    fake = SimpleNamespace(
        _rehome_deadline=time.monotonic() - 1.0,
        _rehome_lock=threading.Lock(),
        _rehome_pending=set(pending),
        servicer=SimpleNamespace(live_workers=lambda: list(live), cluster_version=3),
        telemetry=SimpleNamespace(worker_dead=lambda missing, cv: None),
        _handle_dead_workers=dead_calls.append,
    )
    return fake, dead_calls


@pytest.mark.parametrize("live, dead", [([1], [[2]]), ([1, 2], [])], ids=["one_silent", "all_alive"])
def test_rehome_deadline_settles_alive_workers(m, live, dead):
    fake, dead_calls = _rehome_deadline_master(live)
    m.master().Master._check_rehome_deadline(fake)
    assert dead_calls == dead
    assert fake._rehome_deadline is None and fake._rehome_pending == set()


def test_stage_release_clears_the_lost_stage_marker(m, tmp_path):
    d = m.disp.TaskDispatcher({"s": (0, 128)}, records_per_task=64, shuffle_seed=3)
    journal = _journal_for(m, d, tmp_path)
    journal.record_stage(generation=2, version=7, complete=True)
    journal.flush()
    assert m.journal.load_state(str(tmp_path))["stage"] == {
        "generation": 2, "version": 7, "complete": True,
    }
    journal.record_stage_released(2)
    journal.flush()
    assert m.journal.load_state(str(tmp_path))["stage"] is None


def test_restore_stage_release_fires_the_sink_when_the_chief_fetches():
    """The port releases the stage once process 0 has it (a pinned
    divergence: the JAX package waits for every process); the journal's
    sink fires then, once."""
    from elasticdl_tpu_torch.master.servicer import MasterServicer

    d, _ = _leased_dispatcher(_mods("torch"))
    servicer = MasterServicer(32, d)
    released: list = []
    servicer.set_stage_released_sink(released.append)
    servicer.set_restore_stage(
        {"generation": 0, "version": 5, "checksum": "c", "payload": b"x", "world_size": 2}
    )
    req = port_msg.GetRestoreStateRequest
    assert servicer.get_restore_state(req(cluster_version=0, process_id=1)).has
    assert released == []
    assert servicer.get_restore_state(req(cluster_version=0, process_id=0)).has
    assert released == [0]
    assert not servicer.get_restore_state(req(cluster_version=0, process_id=1)).has


# ---- the transport and the adopted process -----------------------------------


def test_rpc_client_reresolves_the_master_address(tmp_path):
    """A retrying client whose master moved follows the address file to
    the new one; without the hook it keeps retrying the old address."""
    from elasticdl_tpu_torch.rpc.retry import RetryPolicy
    from elasticdl_tpu_torch.rpc.service import (
        MASTER_RETRYABLE_METHODS,
        MasterClient,
        RpcError,
        create_server,
    )

    class Servicer:
        def heartbeat(self, request):
            return port_msg.HeartbeatResponse(boot_id="new")

    dead = create_server(Servicer(), 0)
    old_port = dead.port
    dead.stop()
    live = create_server(Servicer(), 0)
    live.start()
    try:
        port_journal.write_master_addr(str(tmp_path), f"localhost:{live.port}")
        addr_file = port_journal.addr_file_path(str(tmp_path))
        policy = RetryPolicy(max_attempts=6, base_delay_secs=0.0, max_delay_secs=0.0)
        client = MasterClient(
            f"localhost:{old_port}", retry=policy, retryable_methods=MASTER_RETRYABLE_METHODS,
            resolve_addr=lambda: port_journal.read_master_addr(addr_file),
        )
        assert client.heartbeat(port_msg.HeartbeatRequest(worker_id=0)).boot_id == "new"
        assert client.addr == f"localhost:{live.port}"
        stuck = MasterClient(
            f"localhost:{old_port}", retry=policy, retryable_methods=MASTER_RETRYABLE_METHODS
        )
        with pytest.raises(RpcError):
            stuck.heartbeat(port_msg.HeartbeatRequest(worker_id=0))
    finally:
        live.stop()


def test_adopted_process_polls_signals_and_reaps():
    from elasticdl_tpu_torch.master.master import LocalInstanceManager, _AdoptedProcess

    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    im = LocalInstanceManager(None, 2, lambda *a, **k: [])
    assert im.adopt_worker(4, proc.pid) and not im.adopt_worker(4, proc.pid)
    assert im.worker_ids() == [4] and im.worker_pid(4) == proc.pid
    assert im.poll_failed_workers() == []
    im.reserve_worker_ids(9)
    assert im._claim_worker_id() == 9
    adopted = im._procs[4]
    adopted.kill()
    assert adopted.wait(timeout=10) == -9  # a child of this process: its real code
    assert im.poll_failed_workers() == [4]
    gone = _AdoptedProcess(proc.pid)
    assert gone.poll() == -1  # reaped: the pid is gone


@pytest.mark.parametrize("finished", [False, True], ids=["mid_job", "stream_ended"])
def test_adopted_worker_that_vanished_fails_only_before_the_stream_end(finished):
    """A non-child's exit code is unknown: it vanished (polls -1) as a
    failure mid-job, as the stream's end once the dispatcher finished;
    a reaped child's non-zero code is a failure either way."""
    from elasticdl_tpu_torch.master.master import LocalInstanceManager

    # an orphan: its parent exits at once, so this process cannot reap it
    out = subprocess.run(
        [sys.executable, "-c", "import subprocess, sys; print(subprocess.Popen("
         "[sys.executable, '-c', 'import time; time.sleep(0.5)']).pid)"],
        capture_output=True, text=True, check=True,
    )
    orphan = int(out.stdout)
    child = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    master = SimpleNamespace(task_d=SimpleNamespace(finished=lambda: finished))
    im = LocalInstanceManager(master, 2, lambda *a, **k: [])
    assert im.adopt_worker(0, orphan) and im.adopt_worker(1, child.pid)
    deadline = time.monotonic() + 30
    while None in (im._procs[0].poll(), im._procs[1].poll()) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert im._procs[1].poll() == 3  # reaped here: its real code
    assert im._procs[0].exit_unknown and not im._procs[1].exit_unknown
    assert im.poll_failed_workers() == ([1] if finished else [0, 1])


def test_a_child_that_exits_after_the_first_reap_keeps_its_exit_code(monkeypatch):
    """The race behind the unsteady ``mid_job`` case above: a child of
    this process exits after ``poll``'s first ``waitpid`` found it running
    and before the zombie check.  It is reaped there, with its code, and
    not taken for a vanished non-child (-1)."""
    from elasticdl_tpu_torch.master import master as master_mod
    from elasticdl_tpu_torch.utils.proc import HeldProcess

    child = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    # unreaped, so its pid is still this child's: exited means a zombie
    held = HeldProcess(child.pid)
    deadline = time.monotonic() + 30
    while not held.exited() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert held.exited()
    real_waitpid = os.waitpid
    looks = []

    def first_look_finds_it_running(pid, flags):
        looks.append(pid)
        return (0, 0) if len(looks) == 1 else real_waitpid(pid, flags)

    monkeypatch.setattr(os, "waitpid", first_look_finds_it_running)
    adopted = master_mod._AdoptedProcess(child.pid)
    assert adopted.poll() == 3 and not adopted.exit_unknown
    assert looks == [child.pid, child.pid]


# ---- without --master_journal_dir nothing of the journal runs ---------------


def _mnist_args(tmp_path, *extra):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist
    from elasticdl_tpu_torch.utils.args import parse_master_args

    train = gen_mnist(str(tmp_path / "t"), num_records=32, num_shards=1, seed=0)
    return parse_master_args([
        "--model_def", "mnist_functional_api.mnist_functional_api.custom_model",
        "--training_data", train, "--minibatch_size", "8", "--records_per_task", "16",
        "--device", "cpu", "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "2", "--port", "0", *extra,
    ])


def test_ha_flags_default_none_and_never_reach_worker_argv(tmp_path, monkeypatch):
    """Without --master_journal_dir: no journal object, no boot id, the
    plain fail-fast client, no address file; and the HA flags never reach
    the worker argv (the environment carries them)."""
    from elasticdl_tpu_torch.master.main import build_master, worker_envs
    from elasticdl_tpu_torch.rpc.retry import RETRY_SECS_ENV
    from elasticdl_tpu_torch.utils.args import build_worker_arguments
    from elasticdl_tpu_torch.worker.main import build_master_client

    monkeypatch.chdir(tmp_path)
    args = _mnist_args(tmp_path)
    assert (args.master_journal_dir, args.rpc_retry_secs, args.rehome_grace_secs) == (None,) * 3
    plain = build_worker_arguments(args, 0, "localhost:1")
    master = build_master(_mnist_args(tmp_path, "--num_workers", "0"))
    master.prepare(port=0)
    master.stop()
    assert master.journal is None and master.servicer.boot_id == ""
    assert master.servicer.heartbeat(port_msg.HeartbeatRequest(worker_id=0)).boot_id == ""
    assert not [f for _, _, files in os.walk(tmp_path) for f in files if "master_addr" in f]
    assert port_journal.MASTER_ADDR_FILE_ENV not in worker_envs(args)
    for env in (port_journal.MASTER_ADDR_FILE_ENV, RETRY_SECS_ENV):
        monkeypatch.delenv(env, raising=False)
    client = build_master_client("localhost:1")
    assert client._retry is None and client._resolve_addr is None
    journal_dir = tmp_path / "j"
    ha_args = _mnist_args(
        tmp_path, "--master_journal_dir", str(journal_dir), "--rpc_retry_secs", "30",
        "--rehome_grace_secs", "9",
    )
    assert build_worker_arguments(ha_args, 0, "localhost:1") == plain
    assert not any("journal" in a or "retry" in a or "rehome" in a for a in plain)
    for key, value in worker_envs(ha_args).items():
        monkeypatch.setenv(key, value)
    client = build_master_client("localhost:1")
    assert client._retry is not None and client._resolve_addr is not None
    ha_master = build_master(_mnist_args(
        tmp_path, "--master_journal_dir", str(journal_dir), "--num_workers", "0"
    ))
    assert ha_master.journal is not None and ha_master.servicer.boot_id
    ha_master.prepare(port=0)
    ha_master.stop()
    assert port_journal.read_master_addr(port_journal.addr_file_path(str(journal_dir))) == (
        f"localhost:{ha_master.port}"
    )


def test_a_restored_master_waits_for_its_world_and_journals_relaunches(tmp_path):
    """A restored master starts no world over the journaled one and gives
    new workers ids past it; a task-stream relaunch journals the new
    world, so that a later restart waits for the relaunched worker."""
    from elasticdl_tpu_torch.master.master import Master

    class TaskStream(_FakeInstanceManager):
        lockstep, world_size = False, 1

        def start_workers(self):
            self._ids = [self._next]
            self._next += 1

        def restart_worker(self, worker_id):
            self._ids.remove(worker_id)
            self.start_workers()
            self._ids = [worker_id + 1]
            return worker_id + 1

    journal_dir = tmp_path / "j"
    args = _mnist_args(tmp_path, "--master_journal_dir", str(journal_dir), "--num_workers", "1")
    master = Master(args, instance_manager_factory=TaskStream)
    master.prepare(port=0)
    master._handle_dead_workers([0])
    master.journal.flush()
    assert port_journal.load_state(str(journal_dir))["world"]["worker_ids"] == [1]
    master._server.stop()  # a kill: no job_end record
    restored = Master(args, instance_manager_factory=TaskStream)
    restored.prepare(port=0)
    try:
        assert restored.instance_manager.worker_ids() == []  # none started
        assert restored._rehome_pending == {1} and restored._rehome_deadline is not None
        assert restored.instance_manager._next == 2
    finally:
        restored.stop()


# ---- one scripted control plane through both packages ----------------------

# the fields the journal comparison drops, and why: each record's wall and
# monotonic stamps, and the JAX dispatch span's trace context in a
# step-stream response (the port's tracing comes with slice 10; its
# responses carry an empty trace)
DROPPED_FIELDS = ("time", "monotonic", "response.trace")


class _FakeInstanceManager:
    """A lockstep world of two without processes: the master's re-form,
    record and adoption paths run, nothing is spawned."""

    lockstep = True
    world_size = 2

    def __init__(self, _master):
        self._ids, self._next, self.adopted = [], 0, {}

    def worker_ids(self):
        return list(self._ids)

    def start_workers(self):
        self._ids = [self._next, self._next + 1]
        self._next += 2

    def reform_world(self, _version, count_against_budget=True):
        self.start_workers()

    def poll_failed_workers(self):
        return []

    def adopt_worker(self, worker_id, pid):
        self.adopted[worker_id] = pid
        self._ids.append(worker_id)
        return True

    def reserve_worker_ids(self, next_id):
        self._next = max(self._next, next_id)

    def stop_workers(self, grace_secs=15.0):
        self._ids = []


def _scripted_run(pkg, train, journal_dir):
    """Two master lives of one package driven by fake workers over its
    servicer; returns the journal's records, what the workers saw, and
    the final training counters."""
    m = _mods(pkg)
    master_mod = m.master()
    args_mod = importlib.import_module(
        ("elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch") + ".utils.args"
    )
    argv = [
        "--model_def", "mnist_functional_api.mnist_functional_api.custom_model",
        "--training_data", train, "--minibatch_size", "32", "--records_per_task", "64",
        "--num_epochs", "2", "--shuffle_seed", "5", "--master_journal_dir", journal_dir,
        "--port", "0", "--rehome_grace_secs", "30",
    ]
    if pkg == "jax":
        argv += ["--metrics_port", "-1"]
    args = args_mod.parse_master_args(argv)
    seen = []

    def life():
        master = master_mod.Master(args, instance_manager_factory=_FakeInstanceManager)
        master.prepare()
        return master, master.servicer

    def pull(servicer, seq, cv, *wids):
        resps = [
            servicer.get_step_task(m.msg.GetStepTaskRequest(seq=seq, worker_id=w, cluster_version=cv))
            for w in wids
        ]
        seen.append([(r.task_id, r.shard_name, r.start) for r in resps])
        return resps[0]

    def report(servicer, tid, err=""):
        servicer.report_task_result(m.msg.ReportTaskResultRequest(
            task_id=tid, err_message=err, exec_counters={"batch_count": 2}
        ))

    master, s = life()
    for seq in range(3):  # generation 0: three tasks, the second fails
        r = pull(s, seq, 0, 0, 1)
        s.report_version(m.msg.ReportVersionRequest(model_version=2 * (seq + 1), worker_id=0))
        report(s, r.task_id, "boom" if seq == 1 else "")
    master._reform_lockstep([1], reason="worker_failure")  # the fence
    for seq in range(2):
        r = pull(s, seq, 1, 2, 3)
        s.report_version(m.msg.ReportVersionRequest(model_version=6 + 2 * seq, worker_id=2))
        report(s, r.task_id)
    inflight = pull(s, 2, 1, 2, 3).task_id
    done = pull(s, 3, 1, 3, 2).task_id
    report(s, done)  # a success report flushes everything before it
    master.request_crash("tick")
    with pytest.raises(master_mod.SimulatedMasterCrash):
        master.run(poll_secs=0.01)
    master, s = life()  # the relaunch replays the journal
    rehomes = [
        (r.accepted, sorted(r.accepted_leases), r.cluster_version) for r in (
            s.rehome_worker(m.msg.RehomeRequest(worker_id=0, cluster_version=0, pid=11)),
            s.rehome_worker(m.msg.RehomeRequest(
                worker_id=2, cluster_version=1, pid=12, lease_ids=[inflight]
            )),
            s.rehome_worker(m.msg.RehomeRequest(worker_id=3, cluster_version=1, pid=13)),
        )
    ]
    outcome = {
        "inflight": inflight, "rehomes": rehomes,
        "adopted": sorted(master.instance_manager.adopted.items()),
    }
    report(s, inflight)
    seq = 4
    while pull(s, seq, 1, 2, 3).shard_name:
        report(s, seen[-1][0][0])
        seq += 1
    master.journal.write_snapshot()
    master.stop()
    records = m.events.read_jsonl(m.journal.journal_path(journal_dir))
    c = master.task_d.counters(m.TaskType.TRAINING)
    outcome["counters"] = (c.total_records, c.failed_records, dict(c.exec_metrics))
    return records, seen, outcome


def _comparable(records):
    """A journal's records without ``DROPPED_FIELDS``."""
    out = []
    for record in json.loads(json.dumps(records)):
        for key in ("time", "monotonic"):
            record.pop(key, None)
        kind = record.get("kind")
        if kind == "stream":
            record["response"].pop("trace", None)
        elif kind in ("stream_snapshot", "snapshot"):
            memos = record["stream"] if kind == "stream_snapshot" else record["state"]["servicer"]["stream"]
            for memo in memos.values():
                memo.pop("trace", None)
        out.append(record)
    return out


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    d = tmp_path_factory.mktemp("scripted")
    train = gen_mnist(str(d / "t"), num_records=256, num_shards=2, seed=0)
    return {pkg: _scripted_run(pkg, train, str(d / f"journal_{pkg}")) for pkg in PKGS}


def test_scripted_control_plane_run_gives_equal_journals_in_both_packages(scripted):
    (jax_records, jax_seen, jax_outcome) = scripted["jax"]
    (port_records, port_seen, port_outcome) = scripted["torch"]
    assert port_seen == jax_seen
    assert port_outcome == jax_outcome
    assert port_outcome["counters"] == (512, 0, {"batch_count": 18})
    # the fenced world's worker refused; the in-flight lease re-accepted;
    # both re-homed workers adopted with their pids
    assert port_outcome["rehomes"] == [
        (False, [], 1), (True, [port_outcome["inflight"]], 1), (True, [], 1),
    ]
    assert port_outcome["adopted"] == [(2, 12), (3, 13)]
    # the run covered the journal's kinds, both lives and the fence
    kinds = {r["kind"] for r in port_records}
    assert {"snapshot", "lease", "report", "generation", "stream", "world",
            "version", "tasks_created", "epoch", "stream_snapshot", "job_end"} <= kinds
    assert sum(r["kind"] == "snapshot" for r in port_records) == 3
    # no field of a record but the dropped ones differs, and no record
    # carries a boot id or a pid
    assert _comparable(port_records) == _comparable(jax_records)
    assert not any("boot_id" in json.dumps(r) or '"pid"' in json.dumps(r) for r in port_records)


def test_each_package_replays_the_others_journal(scripted):
    jax_journal, port_journal_mod = _mods("jax").journal, _mods("torch").journal
    for pkg in PKGS:
        records = scripted[pkg][0]
        for cut in (len(records) // 2, len(records)):
            head = json.loads(json.dumps(records[:cut]))
            assert jax_journal.replay(head) == port_journal_mod.replay(head), (pkg, cut)
    final = port_journal_mod.replay(scripted["jax"][0])
    assert final["clean_shutdown"] and final["servicer"]["cluster_version"] == 1
    assert final["dispatcher"]["counters"]["TRAINING"]["total_records"] == 512


# ---- end to end: the train CLI through a master kill, on the CPU -----------


@pytest.mark.parametrize("case", ["mid_epoch", "during_reform"])
def test_master_kill_plans_end_to_end_on_the_cpu(tmp_path, case):
    """``chip_smoke.py``'s phase 14a and 14b at a small size: two gloo
    ranks of mnist through the train CLI, the master killed (at a tick at
    version >= 6, or inside the re-formation a preemption causes) and
    relaunched from its journal; one checker spans both lives."""
    sys.path.insert(0, REPO)
    import chip_smoke

    # 64 steps: the kill at version >= 6 lands with most of the job still
    # to run, also when a loaded CPU delays the master's next tick
    cfg = dict(
        chip_smoke.HA_MNIST, train_records=1024, eval_records=128, batch=32,
        records_per_task=64, shards=2, min_accuracy=0.0,
    )
    data = chip_smoke._zoo_data(str(tmp_path / "data"), cfg)
    row = chip_smoke.master_ha_run(str(tmp_path), cfg, data, case, device="cpu")
    assert chip_smoke.check_master_ha_case(case, row, cfg) == []
    assert row["violations"] == [] and row["total_records"] == 2048
    if case == "mid_epoch":
        assert set(row["rehomed"]) == {"0", "1"} and row["generations"]["final"] == 0
    else:
        assert row["fenced"] == [0] and row["generations"] == {"at_kill": 1, "final": 2}


def test_rehome_settles_only_the_leases_held_at_the_outage():
    """A restored master's handshake requeues an outage lease the worker
    does not present, and keeps a lease it granted since (the worker's
    stream holds it, though its request was built before it saw it):
    requeued, that task would train twice."""
    from elasticdl_tpu_torch.master import servicer as port_servicer
    from elasticdl_tpu_torch.master import task_dispatcher as port_disp

    d = port_disp.TaskDispatcher({"s": (0, 256)}, records_per_task=64, shuffle_seed=3)
    held = [d.get(1)[0], d.get(1)[0]]
    servicer = port_servicer.MasterServicer(32, d)
    servicer.restore_control_state(0, 0, outage_leases=d.snapshot()["active"])
    since = d.get(1)[0]
    resp = servicer.rehome_worker(
        port_msg.RehomeRequest(worker_id=1, cluster_version=0, pid=77, lease_ids=[held[0]])
    )
    assert resp.accepted and sorted(resp.accepted_leases) == sorted([held[0], since])
    assert sorted(d.snapshot()["active"]) == sorted([held[0], since])
    assert d.snapshot()["pending"] == 2  # the fourth task and the outage lease nobody presented
