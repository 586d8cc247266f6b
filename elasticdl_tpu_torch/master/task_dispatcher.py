"""Dynamic data sharding — the elasticity primitive; a copy of
``elasticdl_tpu/master/task_dispatcher.py``, whole, so that the Local
executor and, later, the port's master share it.

Reference: ``elasticdl/python/master/task_dispatcher.py``:
the master partitions the dataset into tasks of ``records_per_task``
records, workers pull tasks and report results, failed/abandoned tasks are
re-queued, so the job tolerates any worker-set change without losing data.
This logic is device-agnostic and survives the TPU redesign unchanged in
spirit; it is what lets a mesh re-formation resume mid-epoch.

Deviations from the reference (improvements, not translations):

- task *lease timeouts*: a task held longer than ``task_timeout_secs`` is
  reclaimed (the reference left this as a TODO, task_dispatcher.py:255);
- training tasks shuffled with a seeded RNG for reproducible runs;
- assignments carry wall-clock lease info for observability.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

# Key under which workers report per-task failed-record counts
# (reference common/constants.py TaskExecCounterKey.FAIL_COUNT).
FAIL_COUNT = "fail_count"
# Key under which workers report their process's compile count (the JAX
# package's telemetry/compile_tracker.py names it)
COMPILE_COUNT_KEY = "compile_count"


@dataclass
class Task:
    """A unit of elastic work: a record range [start, end) of one shard."""

    shard_name: str
    start: int
    end: int
    type: TaskType
    model_version: int = -1
    extended: dict = field(default_factory=dict)
    # stable identity across lease/requeue cycles AND across a journaled
    # master restart (id(task) is process-local; the control-plane
    # journal needs an identity that survives serialization)
    uid: int = -1

    @property
    def num_records(self) -> int:
        return self.end - self.start

    def to_dict(self) -> dict:
        """JSON-safe form for the control-plane journal (str keys only —
        the journal is JSONL and reconnect payloads ride msgpack with
        strict_map_key)."""
        return {
            "shard_name": self.shard_name,
            "start": self.start,
            "end": self.end,
            "type": int(self.type),
            "model_version": self.model_version,
            "extended": dict(self.extended),
            "uid": self.uid,
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "Task":
        return cls(
            shard_name=raw["shard_name"],
            start=int(raw["start"]),
            end=int(raw["end"]),
            type=TaskType(raw["type"]),
            model_version=int(raw.get("model_version", -1)),
            extended=dict(raw.get("extended", {})),
            uid=int(raw.get("uid", -1)),
        )


@dataclass
class JobCounters:
    total_records: int = 0
    failed_records: int = 0
    # any other worker-reported per-task counters, summed (e.g. the
    # time_<bucket>_ms wall-clock buckets from utils.timing_utils)
    exec_metrics: dict = field(default_factory=dict)


@dataclass
class _Assignment:
    worker_id: int
    task: Task
    leased_at: float


class TaskDispatcher:
    """Creates and dispatches :class:`Task`s; tracks their lifecycle."""

    def __init__(
        self,
        training_shards: dict[str, tuple[int, int]] | None,
        evaluation_shards: dict[str, tuple[int, int]] | None = None,
        prediction_shards: dict[str, tuple[int, int]] | None = None,
        records_per_task: int = 4096,
        num_epochs: int = 1,
        task_timeout_secs: float = 0.0,
        shuffle_seed: int | None = None,
        clock=time.monotonic,
        stream_source=None,
        stream_origin: str = "",
    ):
        """Shard dicts map ``shard_name -> (start_index, num_records)``
        (the output of a data reader's ``create_shards()``).  ``clock``
        is the lease clock — injectable so the fleet simulator
        (the JAX package's fleetsim) can drive lease timeouts on a virtual
        clock; production always passes the default.

        ``stream_source`` switches the dispatcher into **watermark-lease
        mode** (streaming subsystem): instead of slicing finite shards
        into epochs, training tasks are minted lazily as
        ``[offset, offset + records_per_task)`` windows of an unbounded
        stream, up to the source's published watermark.  Lease/report/
        reclaim/requeue and exactly-once accounting are byte-identical
        to the epoch path — a window IS a task — and ``finished()``
        never fires while the source is open.  ``stream_origin`` is the
        ``stream://`` origin stamped as every window's shard_name (the
        worker-side reader regenerates records from it)."""
        self._lock = threading.Lock()
        self._callback_lock = threading.Lock()
        self._rng = random.Random(shuffle_seed)
        self._clock = clock

        self._shards = {
            TaskType.TRAINING: dict(training_shards or {}),
            TaskType.EVALUATION: dict(evaluation_shards or {}),
            TaskType.PREDICTION: dict(prediction_shards or {}),
        }
        self._records_per_task = records_per_task
        self._num_epochs = num_epochs
        # GIL-atomic int: the epoch property reads unlocked (telemetry/
        # report consumers); every write happens under the lock
        self._epoch = 0  # guarded-by: _lock (writes)
        self._task_timeout_secs = task_timeout_secs

        self._pending: list[Task] = []  # guarded-by: _lock
        self._pending_eval: list[Task] = []  # guarded-by: _lock
        self._active: dict[int, _Assignment] = {}  # guarded-by: _lock
        self._next_task_id = 0  # guarded-by: _lock
        self._next_task_uid = 0  # guarded-by: _lock
        # lease ids whose report was PROCESSED (assignment consumed):
        # distinguishes a duplicate delivery of an already-processed
        # report (its exec counters were already summed — bank nothing)
        # from a stale reclaimed-lease report (nothing was summed — the
        # compile delta must still be banked).  One int per lease, same
        # footprint as the servicer's eval-metrics dedup set.
        self._reported_task_ids: set[int] = set()  # guarded-by: _lock

        # ---- watermark-lease (streaming) state ----
        self._stream = stream_source
        self._stream_origin = stream_origin
        self._stream_next_offset = 0  # guarded-by: _lock
        # completed windows not yet contiguous with the trained
        # watermark: start -> end.  Windows complete out of order (many
        # workers, requeues); the trained watermark only advances over a
        # gap-free prefix, which is what makes it safe to restore from
        # (every record below it trained exactly once).
        self._stream_completed: dict[int, int] = {}  # guarded-by: _lock
        self._trained_watermark = 0  # guarded-by: _lock

        self._counters: dict[TaskType, JobCounters] = {}  # guarded-by: _lock
        self._done_callbacks: list[Callable[[], None]] = []
        self._evaluation_service: Any = None
        # lifecycle observers (chaos invariant checking, metrics).  May
        # be notified while the dispatcher lock is held: observers must
        # record and return, never call back into the dispatcher.
        self._observers: list[Any] = []

        if self._shards[TaskType.TRAINING]:
            logger.info("Starting epoch 0")
            self.create_tasks(TaskType.TRAINING)
        elif self._shards[TaskType.EVALUATION]:
            self.create_tasks(TaskType.EVALUATION)
        elif self._shards[TaskType.PREDICTION]:
            self.create_tasks(TaskType.PREDICTION)

    # ---- lifecycle observers ----------------------------------------------

    def add_observer(self, observer: Any):
        """Register a task-lifecycle observer.  Optional methods:
        ``on_tasks_created(tasks)``, ``on_task_leased(task_id,
        worker_id, task)``, ``on_task_reported(task_id, task, success,
        counted)``, ``on_task_done(task_id, task, worker_id, success,
        exec_counters)`` (counted reports only — carries the reporter
        and its exec counters for telemetry), ``on_task_reclaimed(
        task_id, task)``, ``on_epoch_opened(epoch)`` (lazy epoch
        advance), ``on_callback_invoked()`` (a deferred all-tasks-done
        callback was consumed).  Callbacks may
        run under the dispatcher lock — observers must not re-enter.

        Tasks created before attach (the constructor slices epoch 0) are
        replayed immediately, so an observer attached between
        construction and the first lease sees the complete lifecycle."""
        with self._lock:
            self._observers.append(observer)
            backlog = self._pending + self._pending_eval
        if backlog:
            callback = getattr(observer, "on_tasks_created", None)
            if callback is not None:
                callback(backlog)

    def _notify(self, method: str, *args):
        for observer in self._observers:
            callback = getattr(observer, method, None)
            if callback is None:
                continue
            try:
                callback(*args)
            except Exception:  # noqa: BLE001 — observers never break dispatch
                logger.exception(
                    "Task observer %r.%s failed", observer, method
                )

    # ---- task creation ----------------------------------------------------

    # lock-holding: _lock — called only from create_tasks
    def _slice_shards(
        self,
        task_type: TaskType,
        model_version: int,
        extended: dict | None = None,
    ) -> list[Task]:
        tasks = []
        # accumulates across epochs (reference task_dispatcher.py:128-137)
        counters = self._counters.setdefault(task_type, JobCounters())
        for shard_name, (first, count) in self._shards[task_type].items():
            counters.total_records += count
            limit = first + count
            for lo in range(first, limit, self._records_per_task):
                self._next_task_uid += 1
                tasks.append(
                    Task(
                        shard_name=shard_name,
                        start=lo,
                        end=min(lo + self._records_per_task, limit),
                        type=task_type,
                        model_version=model_version,
                        extended=dict(extended or {}),
                        uid=self._next_task_uid,
                    )
                )
        return tasks

    # lock-holding: _lock — callers: __init__ (single-threaded
    # construction), get() and create_evaluation_tasks (both locked);
    # there are deliberately no other call sites
    def create_tasks(
        self,
        task_type: TaskType,
        model_version: int = -1,
        extended: dict | None = None,
    ):
        tasks = self._slice_shards(task_type, model_version, extended)
        if task_type == TaskType.TRAINING:
            self._rng.shuffle(tasks)
            self._pending.extend(tasks)
        elif task_type == TaskType.EVALUATION:
            self._pending_eval.extend(tasks)
        else:
            self._pending.extend(tasks)
        logger.info(
            "Created %d %s tasks covering %d records (model version %d)",
            len(tasks),
            task_type.name.lower(),
            self._counters[task_type].total_records,
            model_version,
        )
        self._notify("on_tasks_created", tasks)

    # lock-holding: _lock
    def _mint_stream_tasks_locked(self):
        """Mint window tasks up to the source watermark (streaming mode).

        Full ``records_per_task`` windows only while the source is open
        — the ragged tail is minted once the source closes, so window
        boundaries are stable across masters (journal replay mints
        nothing; minted windows ride ``tasks_created`` records like any
        epoch slice).  Minted windows keep offset order across mints:
        the pending stack pops oldest-first so the trained watermark
        advances as a prefix instead of stranding behind a hole."""
        watermark = self._stream.watermark()
        closed = self._stream.closed()
        tasks: list[Task] = []
        counters = self._counters.setdefault(TaskType.TRAINING, JobCounters())
        while True:
            end = min(self._stream_next_offset + self._records_per_task,
                      watermark)
            if end <= self._stream_next_offset:
                break
            if end - self._stream_next_offset < self._records_per_task \
                    and not closed:
                break  # partial window: wait for the watermark (or close)
            self._next_task_uid += 1
            tasks.append(
                Task(
                    shard_name=self._stream_origin,
                    start=self._stream_next_offset,
                    end=end,
                    type=TaskType.TRAINING,
                    uid=self._next_task_uid,
                )
            )
            counters.total_records += end - self._stream_next_offset
            self._stream_next_offset = end
        if not tasks:
            return
        # pending is a stack (pop from the end): the new windows go under
        # every window still pending, in reverse, so leases follow offset
        # order across mints too; a requeued window (appended) still goes
        # first.  The JAX dispatcher stacks each mint on top, so a later
        # mint's windows are leased before older ones and the trained
        # watermark stalls behind the older windows until the newer drain
        self._pending[:0] = reversed(tasks)
        logger.info(
            "Minted %d stream window(s) up to watermark %d (lag %d)",
            len(tasks),
            watermark,
            watermark - self._trained_watermark,
        )
        self._notify("on_tasks_created", tasks)

    # ---- task leasing -----------------------------------------------------

    # lock-holding: _lock
    def _lease(self, worker_id: int, task: Task) -> int:
        self._next_task_id += 1
        self._active[self._next_task_id] = _Assignment(
            worker_id, task, self._clock()
        )
        self._notify("on_task_leased", self._next_task_id, worker_id, task)
        return self._next_task_id

    def get(self, worker_id: int) -> tuple[int, Task | None]:
        """Lease the next task; lazily opens the next epoch
        (reference task_dispatcher.py:237-258)."""
        with self._lock:
            self._reclaim_expired_locked()
            if self._stream is not None:
                self._mint_stream_tasks_locked()
            elif not self._pending and self._epoch < self._num_epochs - 1:
                self._epoch += 1
                # journal observers need the epoch-cursor advance BEFORE
                # the created tasks so replay applies them in order
                self._notify("on_epoch_opened", self._epoch)
                self.create_tasks(TaskType.TRAINING)
                logger.info("Starting epoch %d", self._epoch)
            if not self._pending:
                return -1, None
            task = self._pending.pop()
            return self._lease(worker_id, task), task

    def is_active(self, task_id: int) -> bool:
        """Whether the lease is still held (metric reports are only
        accepted for active leases)."""
        with self._lock:
            return task_id in self._active

    def create_evaluation_tasks(
        self, model_version: int, eval_job_id: int | None = None
    ) -> int:
        """Locked eval-task creation for the evaluation service; returns
        how many tasks were created (reference evaluation_service.py:223-244
        calls into the dispatcher the same way).  ``eval_job_id`` stamps the
        tasks so their completions can be tied to the issuing job."""
        with self._lock:
            before = len(self._pending_eval)
            extended = (
                {"eval_job_id": eval_job_id}
                if eval_job_id is not None
                else None
            )
            self.create_tasks(TaskType.EVALUATION, model_version, extended)
            return len(self._pending_eval) - before

    def get_eval_task(self, worker_id: int) -> tuple[int, Task | None]:
        with self._lock:
            # reclaim here too, not only in get(): an EVALUATION_ONLY job
            # has no training pulls, so this is the only place an expired
            # eval lease can ever be re-queued
            self._reclaim_expired_locked()
            if not self._pending_eval:
                return -1, None
            task = self._pending_eval.pop()
            return self._lease(worker_id, task), task

    # ---- task completion / failure ---------------------------------------

    def report(
        self,
        task_id: int,
        success: bool,
        exec_counters: dict[str, int] | None = None,
    ):
        """Report task completion; failures re-queue the task
        (reference task_dispatcher.py:260-293).

        Completing a task also REFRESHES the lease clock of the
        reporter's other active leases: prefetching workers lease a
        bounded window of tasks ahead of consumption
        (``worker/task_data_service.py``), so an ahead-leased task's
        clock would otherwise run during the whole decode-ahead window
        and ``task_timeout_secs`` sized for lease-then-train would
        silently re-queue it (duplicate training).  A report is proof
        of progress; a worker that stops completing tasks stops
        refreshing, and its leases still expire.
        """
        eval_completed = False
        with self._lock:
            assignment = self._active.pop(task_id, None)
            if assignment is None:
                logger.warning("Unknown or already-reclaimed task id: %d", task_id)
                if (
                    exec_counters
                    and COMPILE_COUNT_KEY in exec_counters
                    and task_id not in self._reported_task_ids
                ):
                    # the compile counter is PROCESS-level, not
                    # task-scoped: a stale (reclaimed-lease) report's
                    # delta is still a real recompile, and the worker's
                    # watermark advances on RPC success — dropping it
                    # here would hide the recompile from the
                    # elasticdl_compile_total mirror forever.  But a
                    # DUPLICATE DELIVERY of an already-processed report
                    # (network chaos: lost reply + re-execution) already
                    # summed this exact delta on its first execution —
                    # banking it again would double-count, so the
                    # reported-ids memory gates the bank
                    stale = self._counters.setdefault(
                        TaskType.TRAINING, JobCounters()
                    )
                    stale.exec_metrics[COMPILE_COUNT_KEY] = (
                        stale.exec_metrics.get(COMPILE_COUNT_KEY, 0)
                        + exec_counters[COMPILE_COUNT_KEY]
                    )
                # counted=False: a stale report was (correctly) dropped
                self._notify(
                    "on_task_reported", task_id, None, success, False
                )
                return
            self._reported_task_ids.add(task_id)
            now = self._clock()
            for a in self._active.values():
                if a.worker_id == assignment.worker_id:
                    a.leased_at = now
            task = assignment.task
            counters = self._counters.setdefault(task.type, JobCounters())
            if exec_counters:
                counters.failed_records += exec_counters.get(FAIL_COUNT, 0)
                for key, value in exec_counters.items():
                    if key != FAIL_COUNT:
                        counters.exec_metrics[key] = (
                            counters.exec_metrics.get(key, 0) + value
                        )
            if not success:
                if task.type == TaskType.EVALUATION:
                    self._pending_eval.append(task)
                else:
                    self._pending.append(task)
                logger.info(
                    "Task %d failed on worker %d; re-queued",
                    task_id,
                    assignment.worker_id,
                )
            elif (
                task.type == TaskType.EVALUATION
                and self._evaluation_service is not None
            ):
                eval_completed = True
            else:
                if self._stream is not None and task.type == TaskType.TRAINING:
                    self._stream_complete_locked(task)
                logger.info(
                    "Task %d completed; %d remaining",
                    task_id,
                    len(self._pending) + len(self._active),
                )
            self._notify("on_task_reported", task_id, task, success, True)
            self._notify(
                "on_task_done",
                task_id,
                task,
                assignment.worker_id,
                success,
                dict(exec_counters or {}),
            )
        if eval_completed:
            self._evaluation_service.complete_task(
                eval_job_id=task.extended.get("eval_job_id")
            )

    # lock-holding: _lock
    def _stream_complete_locked(self, task: Task):
        """Record a trained window; advance the trained watermark over
        the gap-free prefix.  Exactly-once is upstream (a window reaches
        here once per the report dedup), so the pops never double."""
        self._stream_completed[task.start] = task.end
        while self._trained_watermark in self._stream_completed:
            self._trained_watermark = self._stream_completed.pop(
                self._trained_watermark
            )

    def recover_tasks(self, worker_id: int):
        """Re-queue everything a dead worker held
        (reference task_dispatcher.py:299-309)."""
        with self._lock:
            ids = [
                tid
                for tid, a in self._active.items()
                if a.worker_id == worker_id
            ]
        for tid in ids:
            self.report(tid, success=False)
        if ids:
            logger.info(
                "Recovered %d tasks from dead worker %d", len(ids), worker_id
            )

    # lock-holding: _lock
    def _reclaim_expired_locked(self):
        """Lease-timeout reclaim (the reference's TODO at :255)."""
        if self._task_timeout_secs <= 0:
            return
        now = self._clock()
        expired = [
            tid
            for tid, a in self._active.items()
            if now - a.leased_at > self._task_timeout_secs
        ]
        for tid in expired:
            a = self._active.pop(tid)
            if a.task.type == TaskType.EVALUATION:
                self._pending_eval.append(a.task)
            else:
                self._pending.append(a.task)
            self._notify("on_task_reclaimed", tid, a.task)
            logger.warning(
                "Task %d leased by worker %d timed out after %.1fs; re-queued",
                tid,
                a.worker_id,
                now - a.leased_at,
            )

    # ---- lifecycle --------------------------------------------------------

    def finished(self) -> bool:
        with self._lock:
            if self._stream is not None:
                # streaming: never finished while the source is open (a
                # WAIT response keeps the workers polling), and once it
                # closes, finished means the backlog fully drained —
                # every published record minted, every window reported.
                stream_pending = (
                    not self._stream.closed()
                    or self._stream_next_offset < self._stream.watermark()
                )
                return not (
                    stream_pending
                    or self._pending
                    or self._pending_eval
                    or self._active
                )
            # epochs are opened LAZILY by get() — an un-started epoch is
            # still pending work.  Without this term, a worker death at
            # the last task of an epoch lets the master's poll loop see
            # empty queues (the survivor reported the task, then blocked
            # in a dead collective and never pulled again) and declare a
            # multi-epoch job complete one epoch early, skipping the
            # re-formation entirely.
            epochs_pending = bool(
                self._shards[TaskType.TRAINING]
                and self._epoch < self._num_epochs - 1
            )
            return not (
                self._pending
                or self._pending_eval
                or self._active
                or epochs_pending
            )

    def invoke_deferred_callback(self) -> bool:
        """Pop and run one all-tasks-done callback in registration order
        (e.g. final evaluation, then SAVE_MODEL creation; reference
        task_dispatcher.py:221-235).

        Serialized by a dedicated lock so concurrent callers (master poll
        loop + every worker's get_task) can't run callbacks out of order,
        and re-checked against task state so a callback that created new
        work postpones the rest until that work drains.  The callback
        itself runs outside the main lock — callbacks re-enter dispatcher
        methods (create_evaluation_tasks)."""
        with self._callback_lock:
            with self._lock:
                if not self._done_callbacks:
                    return False
                if self._pending or self._pending_eval or self._active:
                    # an earlier callback created work that hasn't drained;
                    # report "still busy" without consuming the next one
                    return True
                callback = self._done_callbacks.pop(0)
            callback()
            # journaled AFTER the callback runs: consumption recorded
            # before execution would make deferred work (final
            # evaluation, SAVE_MODEL creation) at-MOST-once across a
            # master crash — replay would drop the callback with its
            # tasks never created.  The reverse crash window re-runs
            # the callback, which report dedup and path-overwrite
            # tolerate.
            self._notify("on_callback_invoked")
        return True

    def drop_deferred_callbacks(self, count: int):
        """Journal-replay hook: discard the first ``count`` registered
        callbacks — the ones a previous master life already consumed."""
        for _ in range(max(0, min(count, len(self._done_callbacks)))):
            self._done_callbacks.pop(0)

    def add_deferred_callback(self, callback: Callable[[], None]):
        """Run ``callback`` once all current tasks drain (FIFO order)."""
        self._done_callbacks.append(callback)

    def add_deferred_callback_create_save_model_task(self, saved_model_path):
        self.add_deferred_callback(
            lambda: self._create_save_model_task(saved_model_path)
        )

    def _create_save_model_task(self, saved_model_path: str):
        """One SAVE_MODEL task carrying a small data shard (the worker needs
        example records to trace the export signature; reference
        task_dispatcher.py:186-214)."""
        shards = self._shards[TaskType.TRAINING]
        if not shards:
            raise RuntimeError("SAVE_MODEL requires training shards")
        shard_name, (first, count) = next(iter(shards.items()))
        with self._lock:
            self._counters[TaskType.SAVE_MODEL] = JobCounters()
            self._next_task_uid += 1
            task = Task(
                shard_name=shard_name,
                start=first,
                end=first + min(self._records_per_task, count),
                type=TaskType.SAVE_MODEL,
                extended={"saved_model_path": saved_model_path},
                uid=self._next_task_uid,
            )
            self._pending.append(task)
        # observers (journal, invariant checker) must see this creation
        # like any other: without it a master killed between the
        # SAVE_MODEL creation and the next snapshot replays a dispatcher
        # that silently never exports the final model
        self._notify("on_tasks_created", [task])

    def set_evaluation_service(self, evaluation_service):
        with self._lock:
            self._evaluation_service = evaluation_service
            if (
                self._shards[TaskType.EVALUATION]
                and not self._shards[TaskType.TRAINING]
            ):
                evaluation_service.init_eval_only_job(len(self._pending_eval))

    # ---- observability ----------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def streaming(self) -> bool:
        return self._stream is not None

    def stream_status(self) -> dict | None:
        """The streaming backlog signal: ``lag = source_watermark -
        trained_watermark`` is what the autoscaler rides and what the
        bounded-lag chaos invariant bounds.  ``None`` in epoch mode."""
        if self._stream is None:
            return None
        with self._lock:
            watermark = self._stream.watermark()
            return {
                "source_watermark": watermark,
                "trained_watermark": self._trained_watermark,
                "lag": max(0, watermark - self._trained_watermark),
                "next_offset": self._stream_next_offset,
                "closed": self._stream.closed(),
            }

    def stream_reported_records(self) -> int:
        """The records of every window reported trained: the gap-free
        prefix below the trained watermark and the windows reported past
        a hole (out of order, or past a requeued window), which the
        watermark has not crossed yet.  0 in epoch mode."""
        with self._lock:
            return self._trained_watermark + sum(
                end - start for start, end in self._stream_completed.items()
            )

    # lock-holding: _lock
    def _counters_for(self, task_type: TaskType) -> JobCounters:
        return self._counters.setdefault(task_type, JobCounters())

    def counters(self, task_type: TaskType) -> JobCounters:
        """The live counters object (run-loop summaries, post-run
        harness reads).  The lookup/create takes the dispatcher lock;
        the returned object is shared — cross-thread readers of its
        exec metrics use :meth:`exec_metrics_snapshot` instead."""
        with self._lock:
            return self._counters_for(task_type)

    def exec_metrics_snapshot(self, task_type: TaskType) -> dict:
        """Copy of the summed exec counters taken under the dispatcher
        lock — scrape-time readers (telemetry collect callbacks) must
        not iterate the live dict while a report mutates it."""
        with self._lock:
            return dict(self._counters_for(task_type).exec_metrics)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "pending": len(self._pending),
                "pending_eval": len(self._pending_eval),
                "active": {
                    tid: (a.worker_id, a.task.shard_name, a.task.start)
                    for tid, a in self._active.items()
                },
            }

    # ---- durable control-plane state (master/journal.py) -------------------

    def state_snapshot(self) -> dict:
        """FULL dispatcher state, JSON-safe (dict keys str-typed):
        everything :meth:`restore_state` needs to reconstruct an
        equivalent dispatcher after a master restart.  Lease wall-clocks
        are deliberately absent — a restored lease gets a fresh clock,
        and the re-homing handshake requeues leases nobody claims."""
        with self._lock:
            return self._state_snapshot_locked()

    def atomic_state_snapshot(self, sink):
        """Capture state and hand it to ``sink`` WITHOUT releasing the
        transition lock in between.  Observers journal every transition
        from inside this same lock, so whatever journal position ``sink``
        appends at is atomic w.r.t. dispatcher deltas — no lease/report
        can land between the capture and its record (a delta journaled
        there would be ordered before the snapshot and dropped by
        replay).  ``sink`` must not re-enter dispatcher methods."""
        with self._lock:
            sink(self._state_snapshot_locked())

    # lock-holding: _lock
    def _state_snapshot_locked(self) -> dict:
        stream = None
        if self._stream is not None:
            stream = {
                "next_offset": self._stream_next_offset,
                "trained_watermark": self._trained_watermark,
                "completed": {
                    str(s): e for s, e in self._stream_completed.items()
                },
                # journaled so a restarted master re-floors its source:
                # the watermark must never regress across a master life
                "source_watermark": self._stream.watermark(),
            }
        return {
            "epoch": self._epoch,
            "stream": stream,
            "next_task_id": self._next_task_id,
            "next_task_uid": self._next_task_uid,
            "pending": [t.to_dict() for t in self._pending],
            "pending_eval": [t.to_dict() for t in self._pending_eval],
            "active": {
                str(tid): {
                    "worker_id": a.worker_id,
                    "task": a.task.to_dict(),
                }
                for tid, a in self._active.items()
            },
            "counters": {
                task_type.name: {
                    "total_records": c.total_records,
                    "failed_records": c.failed_records,
                    "exec_metrics": dict(c.exec_metrics),
                }
                for task_type, c in self._counters.items()
            },
        }

    def restore_state(self, state: dict):
        """Install a replayed :meth:`state_snapshot` — REPLACES the
        constructor-sliced epoch 0 wholesale (counters included), so a
        journal-restored master never double-counts the initial slice.
        Restored leases get a fresh clock: a lease that survived the
        outage must not be reclaimed the instant the master is back."""
        now = self._clock()
        with self._lock:
            self._epoch = int(state["epoch"])
            self._next_task_id = int(state["next_task_id"])
            self._next_task_uid = int(state.get("next_task_uid", 0))
            self._pending = [Task.from_dict(t) for t in state["pending"]]
            self._pending_eval = [
                Task.from_dict(t) for t in state["pending_eval"]
            ]
            self._active = {
                int(tid): _Assignment(
                    int(entry["worker_id"]),
                    Task.from_dict(entry["task"]),
                    now,
                )
                for tid, entry in state["active"].items()
            }
            self._counters = {
                TaskType[name]: JobCounters(
                    total_records=int(c.get("total_records", 0)),
                    failed_records=int(c.get("failed_records", 0)),
                    exec_metrics=dict(c.get("exec_metrics", {})),
                )
                for name, c in state.get("counters", {}).items()
            }
            stream = state.get("stream")
            if stream is not None and self._stream is not None:
                self._stream_next_offset = int(stream["next_offset"])
                self._trained_watermark = int(stream["trained_watermark"])
                self._stream_completed = {
                    int(s): int(e)
                    for s, e in stream.get("completed", {}).items()
                }
                advance_to = getattr(self._stream, "advance_to", None)
                if advance_to is not None:
                    advance_to(int(stream.get("source_watermark", 0)))

    def reconcile_leases(
        self, worker_id: int, presented: set[int]
    ) -> tuple[list[int], list[int]]:
        """Re-homing handshake (worker reconnecting after a master
        outage): the worker presents its in-flight lease ids; leases
        this dispatcher holds for the worker that are presented are
        re-accepted (fresh clock), the rest are requeued — the worker
        dropped them, died holding them, or the journal recorded a lease
        the worker never learned of.  Presented ids the dispatcher does
        not know stay unaccepted: their eventual report is dropped and
        the task (still pending here) trains exactly once."""
        kept: list[int] = []
        requeued: list[tuple[int, Task]] = []
        now = self._clock()
        with self._lock:
            for tid, a in list(self._active.items()):
                if a.worker_id != worker_id:
                    continue
                if tid in presented:
                    a.leased_at = now
                    kept.append(tid)
                    continue
                del self._active[tid]
                if a.task.type == TaskType.EVALUATION:
                    self._pending_eval.append(a.task)
                else:
                    self._pending.append(a.task)
                requeued.append((tid, a.task))
                self._notify("on_task_reclaimed", tid, a.task)
        if kept or requeued:
            logger.info(
                "Re-homed worker %d: %d lease(s) re-accepted, %d requeued",
                worker_id,
                len(kept),
                len(requeued),
            )
        return kept, [tid for tid, _t in requeued]
