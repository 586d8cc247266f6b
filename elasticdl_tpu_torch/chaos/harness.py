"""The chaos harness: run a real model-zoo job under a fault plan with
the invariant checker attached, and return a JSON-able report; the
counterpart of ``elasticdl_tpu/chaos/harness.py``.

:func:`run_chaos_job` trains a lockstep job (mnist by default, or
DeepFM on ``gen_frappe``) through ``master/main.py`` in this process,
with the workers as subprocesses on the requested device, faults
injected from the plan (worker-side from the plan file the master
exports by env, master-side by :class:`_CapacityDriver`, the master
kills and, for duplicate delivery, netem's server seam), and checks the
elastic contract end to end:

- the checker's ``exactly_once``, ``records_accounted``,
  ``version_monotonic`` and ``reform_progress``;
- ``faults_injected``: the plan executed (a fault-free run must not pass
  a fault-injection gate), every capacity fault realized;
- ``no_false_dead`` (a latency-only plan re-forms nothing) and
  ``duplicate_delivery_exactly_once`` (duplicated reports visibly
  deduplicated);
- ``replication_no_lost_steps``, ``cross_slice_replica_coverage`` and
  ``master_recovery`` where the configuration is in their contract;
- for a streaming run (``streaming=True``: a ``stream://`` origin of
  ``stream_total`` records, no epochs, no checkpoints), ``bounded_lag``
  (the lag stayed under its bound and the stream drained whole) and
  ``freshness_monotone`` (the served model's trained watermark never
  went back across the live pushes to ``live_push_addr``).

:func:`run_master_lives` runs the master's lives: build a master, arm its
kill (:class:`_MasterKillWatcher` at a step, or inside a re-formation),
run it, catch ``SimulatedMasterCrash``, wait the fault's outage, and
build the next from the same arguments, hence the same journal.
:data:`CORRUPTIONS` break a run on purpose, so that each invariant is
shown to fail when it should (:func:`_install_corruption`).

The port's master and workers write ``master_restart``, ``worker_rehome``,
``slice_loss``, ``replica_push`` and the rest to the chaos event log
(``chaos/hooks.py::append_event``), whose observations carry
``"observation"`` where the JAX telemetry log's carry ``"event"``; the
checks and the report's sections (``telemetry/report.py``) read both.
The job runs with ``--telemetry_dir <workdir>/telemetry``, as the JAX
harness's does: the master writes its lifecycle there too, the workers
their ``step`` samples and their mirrored netem firings, and the
report's ``master_ha`` section reads the step gap of each outage from
it, and a streaming run's report its ``streaming`` section (the final
watermarks, the lag and the freshness ledger).  The master writes its
spans there too (``spans.jsonl``), and the runner's ``trace`` section
reads them.

Clock note: workers stamp their events with ``time.monotonic()``, which
is machine-wide on Linux, so the master-side latencies subtract worker
times from the master's own readings; chaos jobs run on one host.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.chaos.invariants import (
    InvariantChecker,
    check_replication_no_lost_steps,
    is_record,
    read_event_log,
)
from elasticdl_tpu_torch.chaos.plan import FaultKind, FaultPlan
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# fault kinds whose firing is "the preemption" for the latency metrics,
# the network kinds that end in an eviction included (a blackholed or
# one-way-partitioned worker exhausts its retry budget, dies, and the
# re-formation it causes is the fault's downtime); delay and duplicate
# kinds must cost no re-formation
_KILL_KINDS = frozenset(
    {
        FaultKind.PREEMPT,
        FaultKind.KILL_COORDINATOR,
        FaultKind.KILL_IN_CHECKPOINT,
        FaultKind.KILL_DURING_REPLICATION,
        FaultKind.DROP_HEARTBEAT,
        FaultKind.SLICE_LOSS,
        FaultKind.NET_BLACKHOLE,
        FaultKind.NET_PARTITION,
    }
)

# deliberate corruptions: each proves that the checker catches what it
# claims to (a checker that cannot fail is not a checker).
# ``double_report``, ``lose_task`` and ``version_rollback`` corrupt what
# the master's observers see; ``journal_rollback`` forges a decreasing
# generation pair into the journal between master lives
# (``master_recovery`` must flag it); ``same_slice_ring`` forces the
# slice-blind replica ring on a multi-slice world through the workers'
# environment (``cross_slice_replica_coverage`` must flag it);
# ``drop_dedup`` counts a duplicated report twice (``exactly_once`` and
# ``duplicate_delivery_exactly_once`` must trip; it needs a plan with
# net_duplicate faults); ``drop_shard_parts`` strips the sharded table
# rows from every replica push through the workers' environment while
# the push still reports a state with sharded rows, the shape of "a
# shard's only replica died" (``replication_no_lost_steps`` and the
# sharded extension of ``cross_slice_replica_coverage`` must trip; it
# needs replication and a model whose tables are row-sharded, such as
# ``deepfm_sharded_embedding`` on ``frappe``).  ``drop_stream_window``
# (streaming runs only) takes the first leased stream window out of the
# dispatcher's active set and marks it reported, so that neither the
# lease timeout nor a worker's death requeues it: the trained watermark
# stalls at the hole, and ``bounded_lag``'s final drain must trip (the
# run still ends: ``finished()`` waits for the minted windows, not for
# the trained watermark).
CORRUPTIONS = (
    "",
    "double_report",
    "lose_task",
    "version_rollback",
    "journal_rollback",
    "same_slice_ring",
    "drop_dedup",
    "drop_shard_parts",
    "drop_stream_window",
)

# model-zoo presets: the model_def's synthetic dataset
DATASETS = ("mnist", "frappe")


@dataclass
class ChaosJobConfig:
    """One chaos job: the JAX harness's configuration, plus the device
    the workers and the final evaluation run on (``cuda`` unless the
    caller asks for the CPU) and the journal's directory (default
    ``<workdir>/journal``, as there)."""

    plan: FaultPlan
    workdir: str
    master_ha: bool = False
    journal_dir: str = ""
    run_timeout_secs: float = 600.0
    # peer state replication: ring-push state into the surviving
    # processes' RAM so the re-formed world restores without a disk read
    replication: bool = False
    # the fleet split into this many slices; 1 = one-slice re-formation
    num_slices: int = 1
    # start the job on fewer slices than the fleet (a capacity grant or
    # an autoscale grow then grows the world mid-training)
    initial_slices: int | None = None
    # the model-zoo job the faults hit, and the dataset that feeds it
    model_def: str = "mnist_functional_api.mnist_functional_api.custom_model"
    dataset: str = "mnist"  # one of DATASETS
    num_records: int = 512
    num_epochs: int = 2
    num_workers: int = 2
    minibatch_size: int = 32
    records_per_task: int = 64
    checkpoint_steps: int = 2
    heartbeat_timeout_secs: float = 3.0
    data_seed: int = 3
    shuffle_seed: int = 5
    # restore the final checkpoint and score a held-out split
    evaluate: bool = False
    eval_records: int = 512
    eval_seed: int = 9
    corrupt: str = ""  # one of CORRUPTIONS
    extra_master_args: list = field(default_factory=list)
    replication_steps: int = 0  # 0 = every task boundary
    # how long a relaunched master waits for its journaled world to re-home
    rehome_grace_secs: float = 5.0
    # the network plans' RPC posture: per-method deadlines (a blackhole
    # becomes DEADLINE_EXCEEDED), a retry budget (transient windows are
    # ridden out, permanent ones evict), a lease timeout (an unreachable
    # worker's lease is reclaimed); None = the flag is absent
    rpc_deadline_secs: float | None = None
    rpc_retry_secs: float | None = None
    task_timeout_secs: float | None = None
    # streaming (watermark-lease) runs: a stream:// origin instead of
    # generated shards, no epochs and no checkpoints (the replica ring is
    # the only durability, so a streaming run wants replication); the
    # records are accounted against the stream's total, and bounded_lag
    # takes the place of epoch parity
    streaming: bool = False
    stream_total: int = 0  # records the bounded prefix publishes
    stream_rate: float = 0.0  # the watermark's advance, records a second
    stream_initial: int = 0  # records published at the start
    # bounded_lag's bound in records; 0: six windows, floored at 256
    stream_lag_limit: int = 0
    # the live train-to-serve push's target ("host:port" of a serving
    # frontend or replica); "" pushes nothing
    live_push_addr: str = ""
    device: str = "cuda"

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


def check_cross_slice_coverage(events: list[dict], num_slices: int) -> list[str]:
    """The slice-aware replica ring's contract, from the event log: in a
    multi-slice world every replica push lands on ANOTHER slice than its
    source, or a whole-slice loss takes a shard and its only replica
    together.  Also, over every push, a state with row-sharded tables
    must push its rows.  Returns the violations (none: PASS)."""
    violations: list[str] = []
    pushes = [
        e for e in events
        if is_record(e, "replica_push")
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
        if not is_record(e, "replica_push") or not e.get("has_sharded"):
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
    coverage = _check_cross_slice_coverage(config, events)
    if coverage is not None:
        out.append(coverage)
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
    on_crash=None,
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
    that dies is relaunched after the fault's ``duration_secs``, and
    ``on_crash()`` runs between its death and that wait.  Returns the last life's exit code, every life's
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
            if on_crash is not None:
                on_crash()
            # the master-down window: the workers retry and back off here
            time.sleep(kill.duration_secs or 2.0)
            continue
        rc = outcome.get("rc")
        break
    for dead in masters[:-1]:
        if dead.instance_manager is not None:
            dead.instance_manager._kill_all()
    return {"rc": rc, "masters": masters, "kills": fired, "timed_out": timed_out}


# ---- the job ----------------------------------------------------------------


def _master_args(config: ChaosJobConfig, train_dir: str, ckpt_dir: str) -> list[str]:
    """The master's argv for ``config``'s job: the JAX harness's flags,
    with ``--device`` where it passes ``--jax_platform``."""
    envs = [
        f"{chaos_hooks.PLAN_ENV}={os.path.join(config.workdir, 'chaos_plan.json')}",
        f"{chaos_hooks.EVENTS_ENV}={os.path.join(config.workdir, 'chaos_events.jsonl')}",
    ]
    if config.corrupt == "same_slice_ring":
        from elasticdl_tpu_torch.replication.replicator import SAME_SLICE_RING_ENV

        envs.append(f"{SAME_SLICE_RING_ENV}=1")
    if config.corrupt == "drop_shard_parts":
        from elasticdl_tpu_torch.replication.replicator import DROP_SHARD_PARTS_ENV

        envs.append(f"{DROP_SHARD_PARTS_ENV}=1")

    def optional(flag: str, value) -> list[str]:
        return [flag, str(value)] if value is not None else []

    return [
        "--model_def", config.model_def,
        "--training_data", train_dir,
        "--minibatch_size", str(config.minibatch_size),
        "--records_per_task", str(config.records_per_task),
        "--num_epochs", str(config.num_epochs),
        "--compute_dtype", "float32",
        "--shuffle_seed", str(config.shuffle_seed),
        "--device", config.device,
        "--envs", ",".join(envs),
        "--port", "0",
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", str(config.num_workers),
        # a streaming run persists through the replica ring alone
        *(
            [] if config.streaming
            else ["--checkpoint_dir", ckpt_dir, "--checkpoint_steps", str(config.checkpoint_steps)]
        ),
        *(["--streaming", "true"] if config.streaming else []),
        *(["--live_push_addr", config.live_push_addr] if config.live_push_addr else []),
        "--heartbeat_timeout_secs", str(config.heartbeat_timeout_secs),
        # the telemetry event log beside the chaos artifacts
        "--telemetry_dir", os.path.join(config.workdir, "telemetry"),
        *(
            ["--replication", "true", "--replication_steps", str(config.replication_steps)]
            if config.replication else []
        ),
        *master_flags(config),
        *optional("--rehome_grace_secs", config.rehome_grace_secs if config.master_ha else None),
        *optional("--rpc_deadline_secs", config.rpc_deadline_secs),
        *optional("--rpc_retry_secs", config.rpc_retry_secs),
        *optional("--task_timeout_secs", config.task_timeout_secs),
        *config.extra_master_args,
    ]


def _install_corruption(master, checker: InvariantChecker, mode: str):
    """Corrupt the run on purpose so that the checker must flag it:

    - ``double_report``: the first successful training completion reaches
      the observers twice (a double-counting dispatcher);
    - ``lose_task``: the first successful training completion is hidden
      from the observers (a silently lost completion);
    - ``version_rollback``: once training passes version 4, a lower
      version is reported (state regression);
    - ``drop_dedup``: the dispatcher's task-id dedup is off: a report for
      a lease no longer active (a duplicated delivery) counts again;
    - ``drop_stream_window``: the first training lease vanishes from the
      active set, pre-marked reported, so nothing ever requeues it (its
      worker still trains it, and its report is dropped as a duplicate).

    ``journal_rollback``, ``same_slice_ring`` and ``drop_shard_parts``
    act elsewhere (between master lives, in the workers' environment)."""
    from elasticdl_tpu_torch.utils.constants import TaskType

    if not mode:
        return
    if mode not in CORRUPTIONS:
        raise ValueError(f"unknown corruption {mode!r}; valid: {CORRUPTIONS}")
    fired: list = []
    if mode in ("double_report", "lose_task"):
        task_d = master.task_d
        orig_report = task_d.report

        def corrupt_report(task_id, success=True, exec_counters=None):
            assignment = task_d._active.get(task_id)
            task = assignment.task if assignment else None
            is_victim = (
                success and not fired and task is not None and task.type == TaskType.TRAINING
            )
            if is_victim and mode == "lose_task":
                fired.append(task_id)
                # the dispatcher counts it with the observers detached:
                # they never learn of it
                observers, task_d._observers = task_d._observers, []
                try:
                    orig_report(task_id, success=success, exec_counters=exec_counters)
                finally:
                    task_d._observers = observers
                return
            orig_report(task_id, success=success, exec_counters=exec_counters)
            if is_victim and mode == "double_report":
                fired.append(task_id)
                task_d._notify("on_task_reported", task_id, task, True, True)

        task_d.report = corrupt_report
    elif mode == "version_rollback":

        def rollback(worker_id, version):
            if version >= 4 and not fired:
                fired.append(version)
                checker.on_version_report(worker_id, version - 3)

        master.servicer.add_version_observer(rollback)
    elif mode == "drop_dedup":
        task_d = master.task_d
        orig_report = task_d.report
        leased: dict[int, object] = {}

        class _LeaseMemo:
            """Every lease's task, so that the duplicate path below can
            find a task the dispatcher has already popped."""

            def on_task_leased(self, task_id, worker_id, task):
                leased[task_id] = task

        task_d.add_observer(_LeaseMemo())

        def no_dedup_report(task_id, success=True, exec_counters=None):
            active_before = task_d.is_active(task_id)
            orig_report(task_id, success=success, exec_counters=exec_counters)
            task = leased.get(task_id)
            if (
                success and not active_before and task is not None
                and task.type == TaskType.TRAINING
            ):
                # the duplicate the dispatcher rightly dropped counts anyway
                task_d._notify("on_task_reported", task_id, task, True, True)

        task_d.report = no_dedup_report
    elif mode == "drop_stream_window":
        task_d = master.task_d
        orig_get = task_d.get

        def dropping_get(worker_id):
            task_id, task = orig_get(worker_id)
            if not fired and task is not None and task.type == TaskType.TRAINING:
                fired.append(task_id)
                # a lost lease: gone from the active set and pre-marked
                # reported, so neither the timeout reclaim nor a death's
                # recovery requeues it
                with task_d._lock:
                    task_d._active.pop(task_id, None)
                    task_d._reported_task_ids.add(task_id)
            return task_id, task

        task_d.get = dropping_get


def _read_events(path: str) -> tuple[list[dict], list[dict]]:
    """(fault firings, observations) from the chaos event log; a torn
    line (a writer killed mid-write) is skipped."""
    faults: list[dict] = []
    observations: list[dict] = []
    if not os.path.exists(path):
        return faults, observations
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except ValueError:
                continue
            (observations if "observation" in event else faults).append(event)
    return faults, observations


def _check_no_lost_steps(
    config: ChaosJobConfig, events: list[dict], fault_events: list[dict]
) -> dict | None:
    """``replication_no_lost_steps``: under a plain preemption with
    replication on, the resumed generation restores from peer RAM at the
    last step replicated before the kill."""
    return check_replication_no_lost_steps(events, config.replication, fault_events)


def _check_no_false_dead(config: ChaosJobConfig, reform_events: list[dict]) -> dict | None:
    """Gray is not dead: a plan whose only faults are network latency
    (within the heartbeat tolerance) must end with no re-formation."""
    kinds = {f.kind for f in config.plan.faults}
    if not kinds or kinds != {FaultKind.NET_DELAY}:
        return None
    violations = []
    if reform_events:
        violations.append(
            f"{len(reform_events)} re-formation(s) during a latency-only network "
            "plan — a slow-but-alive worker was declared dead "
            f"(reasons: {[e.get('reason') for e in reform_events]})"
        )
    return {
        "name": "no_false_dead",
        "status": "FAIL" if violations else "PASS",
        "violations": violations,
    }


def _check_duplicate_delivery(
    config: ChaosJobConfig, checker: InvariantChecker, fault_events: list[dict]
) -> dict | None:
    """The dedup contract under real duplicate delivery: netem ran report
    RPCs twice in the master, and task accounting stays exactly once,
    with proof that the dedup engaged (the dispatcher dropped the
    re-deliveries), not that no duplicate happened."""
    dup_faults = [f for f in config.plan.faults if f.kind == FaultKind.NET_DUPLICATE]
    if not dup_faults and config.corrupt != "drop_dedup":
        return None
    violations = []
    dup_fired = [e for e in fault_events if e.get("kind") == FaultKind.NET_DUPLICATE]
    if dup_faults and not dup_fired:
        # an unfired duplicate fault must not pass this vacuously
        violations.append(
            f"plan injects {len(dup_faults)} duplicate-delivery fault(s) but none "
            "fired — netem server-seam plumbing broken?"
        )
    dup_task_reports = [e for e in dup_fired if e.get("method") == "report_task_result"]
    if dup_task_reports and checker.dropped_reports == 0:
        violations.append(
            f"{len(dup_task_reports)} duplicated report_task_result deliveries but "
            "the dispatcher never dropped one — the task-id dedup did not engage"
        )
    for detail in checker.double_counted_tasks():
        violations.append(f"task {detail} — duplicate delivery double-counted a shard")
    return {
        "name": "duplicate_delivery_exactly_once",
        "status": "FAIL" if violations else "PASS",
        "violations": violations,
    }


def _check_cross_slice_coverage(config: ChaosJobConfig, events: list[dict]) -> dict | None:
    """``cross_slice_replica_coverage``, for replication over two or more
    slices."""
    if not config.replication or config.num_slices <= 1:
        return None
    violations = check_cross_slice_coverage(events, config.num_slices)
    return {
        "name": "cross_slice_replica_coverage",
        "status": "FAIL" if violations else "PASS",
        "violations": violations,
    }


def _refuse_misconfigured(config: ChaosJobConfig):
    """A corruption or a fault that this configuration cannot realize
    would let the run pass green; refuse it."""
    kills = config.plan.master_kill_faults()
    if config.dataset not in DATASETS:
        raise ValueError(f"unknown dataset {config.dataset!r}; valid: {DATASETS}")
    if kills and not config.master_ha:
        raise ValueError(
            f"plan {config.plan.name!r} contains MASTER_KILL faults but master_ha "
            "is off — enable ChaosJobConfig.master_ha (the runner does this for "
            "the master_kill_* plans)"
        )
    if config.corrupt == "journal_rollback" and not kills:
        raise ValueError(
            "--corrupt journal_rollback requires a master_kill plan with master HA "
            "enabled (the forgery lands between master lives)"
        )
    if config.corrupt == "drop_dedup" and not any(
        f.kind == FaultKind.NET_DUPLICATE for f in config.plan.faults
    ):
        raise ValueError(
            "--corrupt drop_dedup requires a plan with net_duplicate faults "
            "(dup_report_storm) — without duplicate delivery the disabled dedup "
            "corrupts nothing"
        )
    if config.corrupt == "same_slice_ring" and not (
        config.replication and config.num_slices > 1
    ):
        raise ValueError(
            "--corrupt same_slice_ring requires replication on and num_slices > 1 "
            "(it forces the slice-blind replica ring)"
        )
    if config.corrupt == "drop_shard_parts" and not config.replication:
        # without replication no push happens, and the corrupted run
        # would pass green (a model without row-sharded tables shows at
        # run time: its pushes carry has_sharded False)
        raise ValueError(
            "--corrupt drop_shard_parts requires replication on and a model "
            "whose tables are row-sharded (it strips sharded rows from the "
            "replica push payloads)"
        )
    if config.streaming and config.stream_total <= 0:
        # an unbounded source never closes: finished() never fires and
        # the run could only time out
        raise ValueError(
            "streaming chaos runs need a bounded prefix: set "
            "ChaosJobConfig.stream_total > 0"
        )
    if config.corrupt == "drop_stream_window" and not config.streaming:
        raise ValueError(
            "--corrupt drop_stream_window requires a streaming run "
            "(ChaosJobConfig.streaming=True) — epoch-mode runs have no "
            "watermark accounting to falsify"
        )
    if any(f.kind == FaultKind.SLICE_LOSS for f in config.plan.faults) and config.num_slices <= 1:
        raise ValueError(
            f"plan {config.plan.name!r} contains SLICE_LOSS faults but num_slices "
            "is 1 — configure ChaosJobConfig.num_slices (the runner does this for "
            "the slice plans)"
        )


def _fault_violations(config: ChaosJobConfig, fault_events, reform_events) -> list[str]:
    """``faults_injected``: the plan executed.  A generation-0 kill may
    pre-empt the later faults of its generation, so a single unfired
    fault is reported, not failed; but a plan of which nothing fired, a
    generation-0 eviction without a re-formation, or a capacity fault no
    re-formation realized fails."""
    from elasticdl_tpu_torch.rpc.retry import DEFAULT_RETRY_SECS

    violations = []
    if config.plan.faults and not fault_events:
        violations.append(
            "plan has %d fault(s) but none fired — injection plumbing broken?"
            % len(config.plan.faults)
        )

    def evicting(f) -> bool:
        # kills always cost their worker; a network window only when it
        # outlasts the worker's retry budget (a survivable blackhole is
        # ridden out on retries, with no re-formation)
        if f.kind not in _KILL_KINDS:
            return False
        if f.kind in (FaultKind.NET_BLACKHOLE, FaultKind.NET_PARTITION):
            budget = (
                config.rpc_retry_secs if config.rpc_retry_secs is not None
                else DEFAULT_RETRY_SECS
            )
            return (f.duration_secs or 0.0) > budget
        return True

    if any(f.cluster_version == 0 and evicting(f) for f in config.plan.faults) and not reform_events:
        violations.append("plan kills a generation-0 worker but no re-formation occurred")
    violations += check_capacity_realized(fault_events, reform_events)
    return violations


def _check_bounded_lag(
    config: ChaosJobConfig, events: list[dict], final_status: dict | None
) -> dict | None:
    """A streaming run's counterpart of epoch parity: under fault the lag
    behind the source stays within its bound, and the final drain is
    whole (the trained watermark reaches the stream's total: a window
    whose lease was lost for good leaves a hole the trained watermark
    never crosses).  None for an epoch run."""
    if not config.streaming:
        return None
    limit = config.stream_lag_limit or max(256, 6 * config.records_per_task)
    lags = [int(e.get("lag_records", 0)) for e in events if e.get("event") == "stream_lag"]
    violations = []
    if not lags:
        violations.append(
            "streaming run produced no stream_lag events — watermark telemetry missing"
        )
    elif max(lags) > limit:
        violations.append(
            f"lag peaked at {max(lags)} records > bound {limit} — backlog not "
            "bounded under fault"
        )
    trained = (final_status or {}).get("trained_watermark")
    if config.stream_total and trained != config.stream_total:
        violations.append(
            f"final drain incomplete: trained watermark {trained} != stream total "
            f"{config.stream_total} (a leased window was lost and never requeued)"
        )
    return {
        "name": "bounded_lag",
        "status": "FAIL" if violations else "PASS",
        "violations": violations,
        "max_lag_records": max(lags) if lags else None,
        "lag_limit_records": limit,
    }


def _check_freshness_monotone(config: ChaosJobConfig, events: list[dict]) -> dict | None:
    """The served model's trained watermark never goes back across the
    live pushes: an accepted push older than an earlier accepted one
    means serving regressed to staler state.  PASS with ``pushes: 0`` on
    a streaming run with no push target; None for an epoch run."""
    if not config.streaming:
        return None
    pushes = sorted(
        (e for e in events if e.get("event") == "live_push" and e.get("accepted")),
        key=lambda e: e.get("monotonic", 0.0),
    )
    violations = []
    high = None
    for push in pushes:
        trained = int(push.get("trained_watermark", -1))
        if high is not None and trained < high:
            violations.append(
                f"served trained-watermark regressed: {trained} after {high} "
                f"(model version {push.get('model_version')})"
            )
        high = trained if high is None else max(high, trained)
    return {
        "name": "freshness_monotone",
        "status": "FAIL" if violations else "PASS",
        "violations": violations,
        "pushes": len(pushes),
    }


def run_chaos_job(config: ChaosJobConfig) -> dict:
    """Run one chaos job end to end; returns the report.  Its
    ``invariants_ok`` is the verdict; ``records_ok`` is the record
    accounting alone."""
    from elasticdl_tpu_torch.chaos import netem
    from elasticdl_tpu_torch.data.recordio_gen import synthetic
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.telemetry.report import (
        master_ha_section,
        multislice_section,
        replication_section,
        streaming_section,
    )
    from elasticdl_tpu_torch.utils.constants import TaskType

    _refuse_misconfigured(config)
    if config.num_workers > 1:
        # a lockstep world needs the native codec in every worker: fail
        # here, once, rather than in each worker through the re-formation
        # budget
        from elasticdl_tpu_torch.data.recordio import ensure_native_codec

        ensure_native_codec()
    os.makedirs(config.workdir, exist_ok=True)
    plan_path = os.path.join(config.workdir, "chaos_plan.json")
    events_path = os.path.join(config.workdir, "chaos_events.jsonl")
    config.plan.save(plan_path)
    if os.path.exists(events_path):
        os.remove(events_path)
    # a reused work directory starts afresh: a leftover checkpoint would
    # resume at the last run's version, and a stale journal would restore
    # the last run's dispatch state into the first master
    for stale in (
        os.path.join(config.workdir, "ckpt"), config.journal_dir,
        os.path.join(config.workdir, "telemetry"),
    ):
        shutil.rmtree(stale, ignore_errors=True)
    if config.streaming:
        # no shards: a record is a pure function of (seed, index), so the
        # origin is the dataset
        train = (
            f"stream://{config.dataset}?seed={config.data_seed}"
            f"&total={config.stream_total}&rate={config.stream_rate}"
            f"&initial={config.stream_initial}"
        )
    else:
        gen = synthetic.gen_frappe if config.dataset == "frappe" else synthetic.gen_mnist
        train = gen(
            os.path.join(config.workdir, "train"),
            num_records=config.num_records, num_shards=2, seed=config.data_seed,
        )
    ckpt = os.path.join(config.workdir, "ckpt")
    argv = _master_args(config, train, ckpt)
    expected_records = (
        config.stream_total if config.streaming else config.num_epochs * config.num_records
    )
    checker = InvariantChecker(expected_records=expected_records)

    # start clean: an earlier run in this process may have left a seam
    # installed if it unwound on an error
    netem.uninstall()
    built: list = []

    shims: list = []

    def on_build(master):
        if not built:
            # duplicate delivery fires in this process's handlers: the
            # shim is installed once per run and kept across master lives
            # (a new one would reset its counters and fire exhausted
            # faults again); only its telemetry sink follows the master
            shims.append(netem.install_master_from_plan(
                config.plan, events_path, telemetry_sink=master.telemetry.events.emit,
            ))
            _install_corruption(master, checker, config.corrupt)
        elif shims[0] is not None:
            shims[0].set_telemetry_sink(master.telemetry.events.emit)
        built.append(master)

    def on_crash():
        if config.corrupt == "journal_rollback":
            _corrupt_journal_rollback(config.journal_dir)

    started_at = time.monotonic()
    try:
        out = run_master_lives(
            lambda: master_main.main(argv), config, events_path,
            checker=checker, on_build=on_build, on_crash=on_crash,
        )
    finally:
        # the seams must not leak into the baseline run that usually
        # follows in this process
        netem.uninstall()
    masters = out["masters"]
    master = masters[-1]
    reform_events = [e for m in masters for e in m.reform_events]
    counters = master.task_d.counters(TaskType.TRAINING)
    fault_events, observations = _read_events(events_path)
    events = fault_events + observations
    # the telemetry log: the masters' lifecycle (written by a thread of
    # each, flushed here: a killed life never reached its job_end) and
    # the workers' step samples
    from elasticdl_tpu_torch.telemetry.events import EVENTS_FILENAME, read_jsonl

    for life in masters:
        life.telemetry.events.flush()
    telemetry_events = read_jsonl(os.path.join(config.workdir, "telemetry", EVENTS_FILENAME))

    # latencies: the first kill-type firing, its detection, the first step
    kill_at = next(
        (e["monotonic"] for e in fault_events if e.get("kind") in _KILL_KINDS), None
    )
    # the re-formation the fault caused (a loaded host can re-form
    # spuriously before the fault fires)
    reform = next(
        (e for e in reform_events if kill_at is None or e["detected_at"] >= kill_at),
        reform_events[0] if reform_events else {},
    )
    # the RPC counters armed workers recorded in the event log, merged as
    # their heartbeats would have (an evicted worker never shipped them)
    for e in observations:
        if e.get("observation") == "rpc_stats":
            master.servicer.merge_rpc_stats(e["worker_id"], e.get("rpc") or {})
    pull_at = master.servicer.first_stream_pull_at()
    detect_secs = (
        round(reform["detected_at"] - kill_at, 3) if reform and kill_at is not None else None
    )
    kill_to_step_secs = (
        round(pull_at - kill_at, 3) if pull_at is not None and kill_at is not None else None
    )
    records_ok = (
        out["rc"] == 0 and master.task_d.finished()
        and counters.total_records == expected_records
    )
    invariants = checker.summary(counters)
    fired_ids = {e.get("fault_id") for e in fault_events}
    unfired = [f.fault_id for f in config.plan.faults if f.fault_id not in fired_ids]
    fault_violations = _fault_violations(config, fault_events, reform_events)
    checks = [
        {
            "name": "faults_injected",
            "status": "FAIL" if fault_violations else "PASS",
            "violations": fault_violations,
        },
        _check_no_false_dead(config, reform_events),
        _check_duplicate_delivery(config, checker, fault_events),
        _check_no_lost_steps(config, events, fault_events),
        _check_cross_slice_coverage(config, events),
        _check_master_recovery(config, events_path, len(masters), events),
        _check_bounded_lag(
            config, telemetry_events,
            master.task_d.stream_status() if config.streaming else None,
        ),
        _check_freshness_monotone(config, telemetry_events),
    ]
    for check in checks:
        if check is not None:
            invariants["invariants"].append(check)
            invariants["ok"] = invariants["ok"] and check["status"] == "PASS"

    report = {
        "plan": config.plan.name,
        "seed": config.plan.seed,
        "corrupt": config.corrupt,
        "device": config.device,
        "num_workers": config.num_workers,
        "num_records": config.num_records,
        "num_epochs": config.num_epochs,
        "rc": out["rc"],
        "timed_out": out["timed_out"],
        "wall_secs": round(time.monotonic() - started_at, 3),
        "records_ok": records_ok,
        "faults_injected": fault_events,
        "observations": observations,
        "invariants": invariants["invariants"],
        "invariants_ok": bool(invariants["ok"] and records_ok and not out["timed_out"]),
        "faults_unfired": unfired,
        "tasks_tracked": invariants["tasks_tracked"],
        "max_model_version": invariants["max_model_version"],
        "reforms": [
            {
                k: round(v, 3) if isinstance(v, float) else v
                for k, v in e.items()
                if k != "detected_at"
            }
            for e in reform_events
        ],
        "reform_latency_secs": round(reform.get("latency_secs", -1.0), 3),
        "detect_secs": detect_secs,
        "kill_to_step_secs": kill_to_step_secs,
        "heartbeat_timeout_secs": config.heartbeat_timeout_secs,
        "standby_activated": getattr(master.instance_manager, "standby_activations", 0),
        # the fleet's RPC outcome totals (heartbeat-shipped, and recorded
        # by armed workers) and the master's dedup drops
        "rpc": {
            **master.servicer.rpc_stats_totals(),
            "reports_deduped": checker.dropped_reports,
            "eval_reports_deduped": master.servicer.duplicate_eval_drops,
        },
    }
    if config.replication:
        report["replication"] = replication_section(events) or {}
    multislice = multislice_section(events) if config.num_slices > 1 else None
    if multislice is not None:
        report["multislice"] = multislice
    master_ha = master_ha_section(events + telemetry_events) if config.master_ha else None
    if master_ha is not None:
        report["master_ha"] = master_ha
    if config.streaming:
        report["streaming"] = {
            "final": master.task_d.stream_status(),
            **(streaming_section(telemetry_events) or {}),
        }
    if config.master_ha:
        report["master_lives"] = len(masters)
    if not records_ok:
        report["total_records"] = counters.total_records
    if config.evaluate and records_ok:
        report["accuracy"] = round(_evaluate_checkpoint(config, ckpt), 4)
    return report


def _evaluate_checkpoint(config: ChaosJobConfig, ckpt: str) -> float:
    """The job's final checkpoint, restored into a Local evaluator on
    ``config.device`` and scored on a held-out split."""
    from elasticdl_tpu_torch.data.recordio_gen import synthetic
    from elasticdl_tpu_torch.trainer.local_executor import LocalExecutor
    from elasticdl_tpu_torch.utils.args import parse_master_args

    gen = synthetic.gen_frappe if config.dataset == "frappe" else synthetic.gen_mnist
    eval_dir = gen(
        os.path.join(config.workdir, "eval"),
        num_records=config.eval_records, num_shards=1, seed=config.eval_seed,
    )
    args = parse_master_args([
        "--model_def", config.model_def,
        "--validation_data", eval_dir,
        "--minibatch_size", str(config.minibatch_size),
        "--records_per_task", str(config.eval_records),
        "--checkpoint_dir", ckpt,
        "--compute_dtype", "float32",
        "--device", config.device,
    ])
    results = LocalExecutor(args).run()
    return float(results.get("accuracy", 0.0))
