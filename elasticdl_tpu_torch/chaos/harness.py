"""The chaos harness's master lives: run a job under a fault plan whose
faults include master kills, with one invariant checker spanning every
life of the master; the first part of ``elasticdl_tpu/chaos/harness.py``.

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
  :func:`_corrupt_journal_rollback` forges the rollback it must flag.

The port's master writes ``master_restart`` and ``worker_rehome`` to the
chaos event log (``chaos/hooks.py::append_event``), so the invariant
reads that log where the JAX harness reads its telemetry event log.  The
rest of the harness (the report, the capacity faults, the other
corruptions, the runner and netem) comes with slice 6b-2d.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.chaos.invariants import read_event_log
from elasticdl_tpu_torch.chaos.plan import FaultPlan
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

    def __post_init__(self):
        if not self.journal_dir:
            self.journal_dir = os.path.join(self.workdir, "journal")


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
    ``InvariantChecker`` spanning every life), ``on_build(master)`` and
    its kill, armed; a life that dies is relaunched after the fault's
    ``duration_secs``.  Returns the last life's exit code, every life's
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
    fired: list[dict] = []

    def build(args):
        master = original(args)
        masters.append(master)
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
        for watcher in watchers:
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
