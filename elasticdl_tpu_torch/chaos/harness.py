"""The chaos harness's master lives and its capacity faults: run a job
under a fault plan whose faults include master kills or capacity
changes, with one invariant checker spanning every life of the master;
the first parts of ``elasticdl_tpu/chaos/harness.py``.

- :class:`_MasterKillWatcher` arms a step-triggered ``MASTER_KILL``: when
  the master-observed model version reaches the fault's ``at_step``, the
  run loop dies at its next tick (``Master.request_crash("tick")``); a
  ``trigger="reform"`` kill is armed up front and dies inside the next
  re-formation, after the fence;
- :func:`run_master_lives` is the JAX ``run_chaos_job``'s master-lives
  loop: build a master, arm the kill, run it, catch
  ``SimulatedMasterCrash``, sleep the fault's ``duration_secs`` (the
  outage the workers ride out on their retry budget), and build the
  next master from the same arguments, hence from the same journal;
- :func:`_check_master_recovery` is the ``master_recovery`` invariant:
  every planned kill fired, a ``master_restart`` per extra life, and
  journal generation fences that never go backwards;
  :func:`_corrupt_journal_rollback` forges the rollback it must flag;
- :class:`_CapacityDriver` executes the plan's ``REDUCE_CAPACITY`` and
  ``RESTORE_CAPACITY`` faults on the master-observed model version, one
  fault per re-formation, and :func:`check_capacity_realized` holds each
  to a re-formation that realized it;
- :func:`check_cross_slice_coverage` is the ``cross_slice_replica_coverage``
  invariant: in a multi-slice world every replica push lands on another
  slice than its source;
- :func:`master_flags` gives the master the flags the configuration
  implies (the journal, the slices, no standbys where JAX runs none).

The port's master writes ``master_restart`` and ``worker_rehome`` to the
chaos event log (``chaos/hooks.py::append_event``), so the invariant
reads that log where the JAX harness reads its telemetry event log.  The
rest of the harness (the report, the capacity faults, the other
corruptions, the runner and netem) comes with slice 6b-2d.  The
invariants read the port's chaos event log, whose observations carry
``"observation"`` where the JAX telemetry log's carry ``"event"``; both
are read.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.chaos.invariants import read_event_log
from elasticdl_tpu_torch.chaos.plan import FaultKind, FaultPlan
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

@dataclass
class ChaosJobConfig:
    """What the master-lives part of the harness reads of the JAX
    harness's job configuration: the plan, the work directory (the
    journal defaults to ``<workdir>/journal``, as there), master HA, and
    the wall budget of the whole run."""

    plan: FaultPlan
    workdir: str
    master_ha: bool = False
    journal_dir: str = ""
    run_timeout_secs: float = 600.0
    # peer state replication (the cross-slice coverage invariant's
    # precondition)
    replication: bool = False
    # the fleet split into this many slices; 1 = one-slice re-formation
    num_slices: int = 1
    # start the job on fewer slices than the fleet (a capacity grant or
    # an autoscale grow then grows the world mid-training)
    initial_slices: int | None = None

    def __post_init__(self):
        if not self.journal_dir:
            self.journal_dir = os.path.join(self.workdir, "journal")


def master_flags(config: ChaosJobConfig) -> list[str]:
    """The master flags ``config`` implies, as the JAX harness adds them:
    the journal for master HA, the slices for a multi-slice fleet, and no
    standbys in either (a killed master's warm pool would outlive it as
    orphans the relaunched master cannot drain; a standby is sliceless
    until activated, and slice plans re-form into resized worlds the pool
    was not sized for)."""
    flags: list[str] = []
    if config.master_ha:
        flags += ["--master_journal_dir", config.journal_dir]
    if config.num_slices > 1:
        flags += ["--num_slices", str(config.num_slices)]
    if config.master_ha or config.num_slices > 1:
        flags += ["--standby_workers", "0"]
    return flags


class _CapacityDriver(threading.Thread):
    """Master-side fault execution: capacity faults trigger on the
    master-observed model version and re-form the world at the new
    size, one fault per re-formation."""

    def __init__(self, master, plan: FaultPlan, events_path: str, fired: set | None = None):
        super().__init__(name="chaos-capacity-driver", daemon=True)
        self._master = master
        # shared across master lives: a journal-restored model version is
        # past an executed fault's at_step already
        self._fired = fired if fired is not None else set()
        self._pending = [f for f in plan.master_faults() if f.fault_id not in self._fired]
        self._events_path = events_path
        self._stop = threading.Event()

    def stop(self):
        self._stop.set()

    def run(self):
        im = self._master.instance_manager
        if im is None or not getattr(im, "lockstep", False):
            return
        # a RESTORE_CAPACITY grows back to the configured fleet, not to
        # the current world (grow_under_load starts smaller on purpose)
        full_size = getattr(im, "max_world_size", im.world_size)
        while self._pending and not self._stop.is_set():
            version = self._master.servicer.get_model_version()
            due = sorted(
                (f for f in self._pending if version >= f.at_step), key=lambda f: f.at_step
            )
            if not due:
                self._stop.wait(0.2)
                continue
            # one fault per re-formation: a shrink and a restore fired in
            # one poll would coalesce into one full-size re-formation
            fault = due[0]
            self._pending.remove(fault)
            self._fired.add(fault.fault_id)
            if fault.kind == FaultKind.REDUCE_CAPACITY:
                im.set_world_size(im.world_size - fault.count)
            else:
                im.set_world_size(full_size)
            self._record(fault, version, im.world_size)
            reforms_before = len(self._master.reform_events)
            self._master.request_reform(f"chaos:{fault.fault_id}")
            deadline = time.monotonic() + 30.0
            while (
                not self._stop.is_set()
                and len(self._master.reform_events) == reforms_before
                and time.monotonic() < deadline
            ):
                self._stop.wait(0.2)

    def _record(self, fault, version: int, world_size: int):
        logger.warning(
            "CHAOS capacity fault %s at version %d -> world size %d",
            fault.fault_id, version, world_size,
        )
        chaos_hooks.append_event(
            self._events_path,
            {
                "fault_id": fault.fault_id,
                "kind": fault.kind,
                "process_id": None,
                "step": version,
                "world_size": world_size,
                "time": time.time(),
                "monotonic": time.monotonic(),
            },
        )


def check_capacity_realized(fault_events: list[dict], reform_events: list[dict]) -> list[str]:
    """A capacity fault is executed only once a re-formation realizes the
    new size: the driver records the request, but the job can end first.
    The matching ``chaos:`` re-formation, or any re-formation at or after
    the firing (a failure's re-formation takes the resize with it),
    realizes it.  Returns the violations."""
    violations = []
    reasons = {e.get("reason") for e in reform_events}
    for event in fault_events:
        if event.get("kind") not in (FaultKind.REDUCE_CAPACITY, FaultKind.RESTORE_CAPACITY):
            continue
        realized = f"chaos:{event['fault_id']}" in reasons or any(
            e["detected_at"] >= event["monotonic"] - 2.0 for e in reform_events
        )
        if not realized:
            violations.append(
                f"capacity fault {event['fault_id']} was requested but no "
                "re-formation realized it"
            )
    return violations


def _is(event: dict, name: str) -> bool:
    """Whether ``event`` is the observation ``name`` of the port's chaos
    event log or the event ``name`` of the JAX package's telemetry log."""
    return event.get("observation") == name or event.get("event") == name


def check_cross_slice_coverage(events: list[dict], num_slices: int) -> list[str]:
    """The slice-aware replica ring's contract, from the event log: in a
    multi-slice world every replica push lands on ANOTHER slice than its
    source, or a whole-slice loss takes a shard and its only replica
    together.  Also, over every push, a state with row-sharded tables
    must push its rows.  Returns the violations (none: PASS)."""
    violations: list[str] = []
    pushes = [
        e for e in events
        if _is(e, "replica_push")
        # only pushes from a multi-slice world are in the contract (a
        # world shrunk to one slice has no other slice to push to)
        and int(e.get("num_slices", 1) or 1) > 1
    ]
    if num_slices > 1 and not pushes:
        violations.append(
            "no replica_push events from a multi-slice world — ring coverage unproven"
        )
    for e in pushes:
        src, dst = e.get("source_slice"), e.get("target_slice")
        if src is None or dst is None:
            violations.append(
                f"replica_push at step {e.get('step')} carries no slice placement "
                "(source_slice/target_slice missing)"
            )
        elif src == dst:
            violations.append(
                f"replica_push at step {e.get('step')}: process {e.get('source')} "
                f"pushed to process {e.get('target')} on its OWN slice {src} — a "
                "slice loss takes shard and replica together"
            )
    for e in events:
        if not _is(e, "replica_push") or not e.get("has_sharded"):
            continue
        if not int(e.get("sharded_rows", 0) or 0):
            violations.append(
                f"replica_push at step {e.get('step')} from process {e.get('source')}: "
                f"state has {e.get('sharded_tables')} row-sharded table(s) but the "
                "push carried zero rows — the shard's only replica holds no table "
                "coverage"
            )
    return violations


def slice_invariants(
    config: ChaosJobConfig, events: list[dict], reform_events: list[dict]
) -> list[dict]:
    """The slice and capacity invariants ``config`` is in contract for:
    ``cross_slice_replica_coverage`` (replication over two or more
    slices) and ``capacity_realized`` (a plan with capacity faults)."""
    out = []
    if config.replication and config.num_slices > 1:
        violations = check_cross_slice_coverage(events, config.num_slices)
        out.append({
            "name": "cross_slice_replica_coverage",
            "status": "FAIL" if violations else "PASS",
            "violations": violations,
        })
    if config.plan.master_faults():
        violations = check_capacity_realized(
            [e for e in events if e.get("kind") in FaultKind.MASTER_SIDE], reform_events
        )
        out.append({
            "name": "capacity_realized",
            "status": "FAIL" if violations else "PASS",
            "violations": violations,
        })
    return out


class _MasterKillWatcher(threading.Thread):
    """Arms a step-triggered MASTER_KILL: when the master-observed model
    version reaches the fault's ``at_step``, ask the run loop to die at
    its next tick."""

    def __init__(self, master, fault):
        super().__init__(name="chaos-master-kill-watcher", daemon=True)
        self._master = master
        self._fault = fault
        self._stop = threading.Event()
        self.armed_at_version: int | None = None

    def stop(self):
        self._stop.set()

    def run(self):
        while not self._stop.is_set():
            version = self._master.servicer.get_model_version()
            if version >= self._fault.at_step:
                logger.warning(
                    "CHAOS arming master kill %s at version %d",
                    self._fault.fault_id, version,
                )
                self.armed_at_version = version
                self._master.request_crash("tick")
                return
            self._stop.wait(0.1)


def _record_master_kill(events_path: str, fault, crashed_at: float, **fields):
    """MASTER_KILL firings are recorded by the harness (the victim IS the
    process that would record them), stamped with the master's own crash
    time so that outage metrics are exact."""
    chaos_hooks.append_event(
        events_path,
        {
            "fault_id": fault.fault_id,
            "kind": fault.kind,
            "process_id": None,
            "trigger": fault.trigger,
            "time": time.time(),
            "monotonic": crashed_at,
            **fields,
        },
        fsync=True,
    )


def _corrupt_journal_rollback(journal_dir: str):
    """``journal_rollback``: forge a decreasing generation pair into the
    journal between master lives.  Replay's monotone guard absorbs it;
    the ``master_recovery`` invariant must still flag it."""
    from elasticdl_tpu_torch.master.journal import journal_path

    with open(journal_path(journal_dir), "a", encoding="utf-8") as f:
        for version in (1, 0):
            f.write(
                json.dumps(
                    {
                        "seq": 10**9,
                        "kind": "generation",
                        "cluster_version": version,
                        "time": time.time(),
                        "monotonic": time.monotonic(),
                        "forged": True,
                    }
                )
                + "\n"
            )


def _check_master_recovery(
    config: ChaosJobConfig,
    events_path: str,
    master_lives: int,
    events: list | None = None,
) -> dict | None:
    """The master-HA contract under a MASTER_KILL: every planned kill
    fired, each relaunched master restored from the journal (a
    ``master_restart`` per extra life), and the journal's generation
    fences are monotone (a rolled-back fence would let a restored master
    resurrect a fenced generation).  None when the plan kills no master."""
    kills = config.plan.master_kill_faults()
    if not kills or not config.master_ha:
        return None
    from elasticdl_tpu_torch.master.journal import journal_path
    from elasticdl_tpu_torch.telemetry.events import read_jsonl

    violations = []
    if events is None:
        events = read_event_log(events_path) if os.path.exists(events_path) else []
    restarts = [e for e in events if e.get("observation") == "master_restart"]
    # realization first: deriving the expectation from the observed
    # lives alone would pass a kill that never fired
    if master_lives - 1 < len(kills):
        violations.append(
            f"plan demands {len(kills)} master kill(s) but only "
            f"{master_lives - 1} fired — the MASTER_KILL fault was never "
            "realized"
        )
    expected_restarts = master_lives - 1
    if len(restarts) < expected_restarts:
        violations.append(
            f"{expected_restarts} master relaunch(es) but only {len(restarts)} "
            "master_restart event(s) — a relaunched master did not restore "
            "from the journal"
        )
    records = read_jsonl(journal_path(config.journal_dir))
    if not records:
        violations.append("control-plane journal is empty or unreadable")
    fences = [int(r["cluster_version"]) for r in records if r.get("kind") == "generation"]
    for prev, nxt in zip(fences, fences[1:]):
        if nxt < prev:
            violations.append(
                f"journal generation fence rolled back: {nxt} recorded after "
                f"{prev} — a restored master could resurrect a fenced generation"
            )
    return {
        "name": "master_recovery",
        "status": "FAIL" if violations else "PASS",
        "violations": violations,
    }


def run_master_lives(
    launch,
    config: ChaosJobConfig,
    events_path: str,
    checker=None,
    on_build=None,
) -> dict:
    """Run a job through as many master lives as the plan's kills make.
    ``launch()`` runs one life through an entry point that builds its
    master with ``master/main.py::build_master`` (the train CLI,
    ``client.main(["train", ...])``, or ``master/main.py::main``) with
    ``--master_journal_dir`` when the plan kills the master, and returns
    its exit code; every life gets the same arguments, hence the same
    journal.  Each life's master gets ``checker`` (one
    ``InvariantChecker`` spanning every life), ``on_build(master)``, its
    kill, armed, the plan's capacity faults (a :class:`_CapacityDriver`
    whose fired set spans the lives) and, with
    ``config.initial_slices``, a first world of that many slices; a life
    that dies is relaunched after the fault's ``duration_secs``.  Returns the last life's exit code, every life's
    master, each kill's firing (``{"fault_id", "crashed_at",
    "armed_at_version", "step", "pids"}``: the model version at the kill and
    the worker processes the dead master left) and whether ``run_timeout_secs`` ran
    out.  Processes of earlier lives still running at the end (a
    lingering survivor) are killed and reaped."""
    from unittest import mock

    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.master import SimulatedMasterCrash

    kills = config.plan.master_kill_faults()
    if kills and not config.master_ha:
        # refuse rather than silently drop the kills
        raise ValueError(
            f"plan {config.plan.name!r} contains MASTER_KILL faults but "
            "master_ha is off — enable ChaosJobConfig.master_ha"
        )
    original = master_main.build_master
    masters: list = []
    watchers: list = []
    drivers: list = []
    fired: list[dict] = []
    fired_capacity: set = set()

    def build(args):
        master = original(args)
        masters.append(master)
        im = master.instance_manager
        if config.initial_slices is not None and hasattr(im, "set_world_slices"):
            # the job starts on fewer slices than the fleet
            im.set_world_slices(config.initial_slices)
        if checker is not None:
            # task identity is the journaled uid, so the restored
            # dispatcher's backlog replay dedups onto the earlier records
            master.task_d.add_observer(checker)
            master.servicer.add_version_observer(checker.on_version_report)
            master.reform_callbacks.append(checker.on_reform)
        if on_build is not None:
            on_build(master)
        kill = kills[len(masters) - 1] if len(masters) <= len(kills) else None
        watchers.append(None)
        if kill is not None:
            if kill.trigger == "reform":
                master.request_crash("reform")
            else:
                watchers[-1] = _MasterKillWatcher(master, kill)
                watchers[-1].start()
        if config.plan.master_faults():
            drivers.append(_CapacityDriver(master, config.plan, events_path, fired_capacity))
            drivers[-1].start()
        return master

    deadline = time.monotonic() + config.run_timeout_secs
    rc = None
    timed_out = False
    while True:
        outcome: dict = {}

        def life():
            try:
                outcome["rc"] = launch()
            except SimulatedMasterCrash:
                outcome["crashed"] = True
            except BaseException as ex:  # noqa: BLE001 — re-raised below
                outcome["error"] = ex

        runner = threading.Thread(target=life, name=f"chaos-master-life-{len(masters)}")
        with mock.patch.object(master_main, "build_master", build):
            runner.start()
            runner.join(timeout=max(1.0, deadline - time.monotonic()))
            timed_out = runner.is_alive()
            if timed_out and masters:
                masters[-1].request_stop()
                runner.join(timeout=30)
        for watcher in watchers + drivers:
            if watcher is not None:
                watcher.stop()
        if "error" in outcome:
            raise outcome["error"]
        if outcome.get("crashed") and not timed_out:
            master, watcher = masters[-1], watchers[-1]
            kill = kills[len(masters) - 1]
            step = master.servicer.get_model_version()
            im = master.instance_manager
            fired.append({
                "fault_id": kill.fault_id,
                "crashed_at": master.crashed_at,
                "armed_at_version": watcher.armed_at_version if watcher else None,
                "step": step,
                # the processes the dead master left behind
                "pids": {w: im.worker_pid(w) for w in im.worker_ids()} if im else {},
            })
            _record_master_kill(events_path, kill, master.crashed_at, step=step)
            # the master-down window: the workers retry and back off here
            time.sleep(kill.duration_secs or 2.0)
            continue
        rc = outcome.get("rc")
        break
    for dead in masters[:-1]:
        if dead.instance_manager is not None:
            dead.instance_manager._kill_all()
    return {"rc": rc, "masters": masters, "kills": fired, "timed_out": timed_out}
