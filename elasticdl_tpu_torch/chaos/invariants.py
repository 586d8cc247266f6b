"""The elastic-contract invariant checker.

A copy of ``elasticdl_tpu/chaos/invariants.py``.

Fed by observer callbacks from the master's task dispatcher (task
lifecycle) and servicer (version reports, re-formations), it asserts
after the job what elasticity promises during it:

- **exactly_once** — every created TRAINING task completes successfully
  exactly once: a count of 0 is a LOST shard (records silently dropped
  from the gradient stream), >1 is a DOUBLE-TRAINED shard (records
  double-counted).  Task identity is the dispatcher-assigned ``uid`` —
  stable across lease/requeue cycles AND across a journaled master
  restart (a restored master rebuilds equivalent Task objects, so the
  object id cannot span the outage) — with ``id(task)`` as the
  fallback for uid-less tasks; each epoch's re-slicing creates fresh
  uids.
- **records_accounted** — successful task record sums match the
  expected total (``num_epochs × dataset size``) when the caller knows
  it, and always match the dispatcher's own counters.
- **version_monotonic** — within one world generation no worker's
  reported model version ever decreases (a rollback means an update was
  lost or state regressed); re-formation resets the per-worker floor
  (restoring from a checkpoint legitimately rewinds the step), but
- **reform_progress** — training must then advance PAST the highest
  version seen before each re-formation (the job cannot "complete" by
  looping over restored state).

One more check reads the chaos event log instead
(:func:`check_replication_no_lost_steps`, the JAX harness's
``replication_no_lost_steps``): under a plain preemption with
``--replication``, the re-formed world restores from peer RAM at the
last replicated step before the kill, not at an older disk checkpoint.

The checker never raises mid-run: it records, then :meth:`check`
returns the violations.  It must detect corruption, so its unit tests
(tests/test_chaos.py) feed it a lost task, a double report, and a
version rollback and assert each is flagged.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field

from elasticdl_tpu_torch.chaos.plan import FaultKind
from elasticdl_tpu_torch.utils.constants import TaskType

# faults after which a complete replica set survives by construction (one
# process, or one slice, dies): the no-lost-steps check applies
_REPLICA_RECOVERABLE_KINDS = frozenset(
    {FaultKind.PREEMPT, FaultKind.KILL_COORDINATOR, FaultKind.SLICE_LOSS}
)


@dataclass
class Violation:
    invariant: str
    detail: str

    def as_dict(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail}


@dataclass
class _TaskRecord:
    task: object
    num_records: int
    successes: int = 0
    failures: int = 0
    reclaims: int = 0
    workers: list = field(default_factory=list)


class InvariantChecker:
    """Attach with::

        master.task_d.add_observer(checker)
        master.servicer.add_version_observer(checker.on_version_report)
        master.reform_callbacks.append(checker.on_reform)
    """

    def __init__(self, expected_records: int | None = None):
        self._lock = threading.Lock()
        self._expected_records = expected_records
        # task key -> record; the task object is held here, so a
        # fallback id(task) key cannot be recycled while the checker
        # lives
        self._tasks: dict[int, _TaskRecord] = {}
        self._version_floor: dict[int, int] = {}  # worker -> last version
        self._max_version = 0
        self._reforms: list[dict] = []
        self._violations: list[Violation] = []
        # reports the dispatcher DROPPED (unknown/reclaimed lease):
        # correct behavior — and under duplicate delivery the proof that
        # the task-id dedup actually engaged (duplicate_delivery_
        # exactly_once reads it)
        self._dropped_reports = 0

    @staticmethod
    def _key(task) -> int:
        """uid when the dispatcher assigned one (stable across a master
        restart), negated so the uid key space can never collide with
        the id(task) fallback (CPython ids are positive)."""
        uid = getattr(task, "uid", -1)
        return -uid if uid > 0 else id(task)

    # ---- dispatcher observer ----------------------------------------------

    def on_tasks_created(self, tasks):
        with self._lock:
            for task in tasks:
                if task.type != TaskType.TRAINING:
                    continue
                key = self._key(task)
                if key in self._tasks:
                    # a journal-restored dispatcher replays its pending
                    # backlog on observer re-attach: same uid = same
                    # shard — keep the pre-outage history
                    continue
                self._tasks[key] = _TaskRecord(task, task.num_records)

    def on_task_leased(self, task_id: int, worker_id: int, task):
        with self._lock:
            rec = self._tasks.get(self._key(task))
            if rec is not None:
                rec.workers.append(worker_id)

    def on_task_reported(self, task_id: int, task, success: bool, counted: bool):
        """``counted=False``: the dispatcher dropped the report (unknown
        or reclaimed lease) — correct behavior, not a completion."""
        with self._lock:
            if task is None or not counted:
                self._dropped_reports += 1
                return
            rec = self._tasks.get(self._key(task))
            if rec is None:
                return
            if success:
                rec.successes += 1
            else:
                rec.failures += 1

    def on_task_reclaimed(self, task_id: int, task):
        with self._lock:
            rec = self._tasks.get(self._key(task))
            if rec is not None:
                rec.reclaims += 1

    # ---- servicer / master observers --------------------------------------

    def on_version_report(self, worker_id: int, version: int):
        with self._lock:
            floor = self._version_floor.get(worker_id)
            if floor is not None and version < floor:
                self._violations.append(
                    Violation(
                        "version_monotonic",
                        f"worker {worker_id} reported version {version} "
                        f"after {floor} within one generation",
                    )
                )
            self._version_floor[worker_id] = version
            self._max_version = max(self._max_version, version)

    def on_reform(self, cluster_version: int, dead_workers=(), reason=""):
        with self._lock:
            self._reforms.append(
                {
                    "cluster_version": cluster_version,
                    "dead_workers": list(dead_workers),
                    "reason": reason,
                    "max_version_before": self._max_version,
                }
            )
            # a re-formed world restores from a checkpoint: rewinding the
            # per-worker floor is legitimate exactly here
            self._version_floor.clear()

    # ---- verdict -----------------------------------------------------------

    def check(self, dispatcher_counters=None) -> list[Violation]:
        """Run the post-job invariants; returns ALL violations (recorded
        during the run + found now)."""
        with self._lock:
            violations = list(self._violations)
            lost = [r for r in self._tasks.values() if r.successes == 0]
            doubled = [r for r in self._tasks.values() if r.successes > 1]
            for rec in lost:
                t = rec.task
                violations.append(
                    Violation(
                        "exactly_once",
                        f"task {t.shard_name}[{t.start}:{t.end}] was "
                        f"never successfully trained (lost shard; "
                        f"{rec.failures} failure(s), {rec.reclaims} "
                        f"reclaim(s))",
                    )
                )
            for rec in doubled:
                t = rec.task
                violations.append(
                    Violation(
                        "exactly_once",
                        f"task {t.shard_name}[{t.start}:{t.end}] trained "
                        f"{rec.successes} times (double-counted shard)",
                    )
                )
            trained = sum(
                r.num_records for r in self._tasks.values() if r.successes
            )
            if (
                self._expected_records is not None
                and trained != self._expected_records
            ):
                violations.append(
                    Violation(
                        "records_accounted",
                        f"trained {trained} records, expected "
                        f"{self._expected_records}",
                    )
                )
            if dispatcher_counters is not None and self._expected_records \
                    is not None:
                if dispatcher_counters.total_records != self._expected_records:
                    violations.append(
                        Violation(
                            "records_accounted",
                            "dispatcher counters disagree: "
                            f"{dispatcher_counters.total_records} != "
                            f"{self._expected_records}",
                        )
                    )
            for reform in self._reforms:
                if self._max_version <= reform["max_version_before"] and (
                    reform["max_version_before"] > 0
                ):
                    violations.append(
                        Violation(
                            "reform_progress",
                            "training never advanced past version "
                            f"{reform['max_version_before']} reached "
                            "before re-formation to generation "
                            f"{reform['cluster_version']}",
                        )
                    )
        return violations

    # ---- report helpers ----------------------------------------------------

    @property
    def reforms(self) -> list[dict]:
        with self._lock:
            return list(self._reforms)

    @property
    def max_version(self) -> int:
        return self._max_version

    @property
    def dropped_reports(self) -> int:
        """Reports the dispatcher refused to count (task-id dedup)."""
        with self._lock:
            return self._dropped_reports

    def double_counted_tasks(self) -> list[str]:
        """Descriptions of tasks counted successful more than once —
        what duplicate delivery MUST NOT produce."""
        with self._lock:
            return [
                f"{r.task.shard_name}[{r.task.start}:{r.task.end}] "
                f"counted {r.successes} times"
                for r in self._tasks.values()
                if r.successes > 1
            ]

    def summary(self, dispatcher_counters=None) -> dict:
        violations = self.check(dispatcher_counters)
        names = (
            "exactly_once",
            "records_accounted",
            "version_monotonic",
            "reform_progress",
        )
        failed = {v.invariant for v in violations}
        return {
            "invariants": [
                {
                    "name": name,
                    "status": "FAIL" if name in failed else "PASS",
                    "violations": [
                        v.detail for v in violations if v.invariant == name
                    ],
                }
                for name in names
            ],
            "ok": not violations,
            "tasks_tracked": len(self._tasks),
            "reforms": self.reforms,
            "max_model_version": self._max_version,
        }


# ---- the replication contract, from the event log ---------------------------


def read_event_log(path: str) -> list[dict]:
    """The chaos event log's records (``chaos/hooks.py::append_event``)."""
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def check_replication_no_lost_steps(
    events: list[dict], replication: bool = True
) -> dict | None:
    """The replication contract under a plain preemption, as a function
    of the event log (the JAX harness's ``_check_no_lost_steps``,
    ``elasticdl_tpu/chaos/harness.py:697``): the resumed generation
    restores FROM PEER RAM at exactly the last replicated step before
    the kill, not the (older) last disk checkpoint.  None when it does
    not apply (replication off, or no recoverable fault fired).

    The log's records are the port's: a fault firing carries its
    ``kind``; pushes and restores are the ``replica_push`` and
    ``replica_restore`` observations, each with its ``step``."""
    if not replication:
        return None
    recoverable = [e for e in events if e.get("kind") in _REPLICA_RECOVERABLE_KINDS]
    if not recoverable:
        return None
    kill_at = min(e["monotonic"] for e in recoverable)
    push_events = [
        e
        for e in events
        if e.get("observation") == "replica_push" and e.get("monotonic", 0.0) <= kill_at
    ]
    restore_events = [e for e in events if e.get("observation") == "replica_restore"]
    pushed = [int(e.get("step", -1)) for e in push_events]
    restored = [int(e.get("step", -1)) for e in restore_events]
    violations = []
    if not pushed:
        violations.append("no replica_push before the kill")
    if not restored:
        violations.append(
            "no replica_restore event — the re-formed world did not "
            "restore from peer RAM"
        )
    elif pushed and max(restored) < max(pushed):
        violations.append(
            f"restored at step {max(restored)} but step {max(pushed)} "
            "was replicated before the kill — steps lost despite a "
            "complete replica set"
        )
    # sharded tables (slice 9; no port state has them yet): "no lost
    # steps" includes their ROWS — the pushes before the kill must have
    # carried them and the restore must have applied them
    if any(e.get("has_sharded") for e in push_events):
        rows_pushed = sum(int(e.get("sharded_rows", 0) or 0) for e in push_events)
        rows_restored = sum(int(e.get("sharded_rows", 0) or 0) for e in restore_events)
        if not rows_pushed:
            violations.append(
                "pushes report row-sharded state but carried zero "
                "sharded table rows before the kill — the tables had "
                "no replica to survive it"
            )
        if restored and not rows_restored:
            violations.append(
                "replica restore applied zero sharded table rows "
                "though the replicated state is row-sharded — the "
                "tables were lost across the reform"
            )
    return {
        "name": "replication_no_lost_steps",
        "status": "FAIL" if violations else "PASS",
        "violations": violations,
    }
