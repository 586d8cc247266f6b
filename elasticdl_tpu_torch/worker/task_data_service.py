"""Task-lease stream with exactly-once task accounting; a copy of
``elasticdl_tpu/worker/task_data_service.py``, the task-stream worker's.

``report_record_done`` keeps the cumulative count of processed records
and reports every pending task the count has covered, so each task is
reported exactly once however the batch size divides the task size, also
when one count covers several tasks or straddles two.  Tasks are leased
one at a time (``start_task_stream``/``lease_task``) and batched per
task; the accounting takes counts, not records.  A count is the batch's
actual number of records (the reference adds a fixed minibatch size even
for a short last batch).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

FAIL_COUNT = "fail_count"


class TaskDataService:
    def __init__(
        self,
        worker,
        training_with_evaluation: bool = False,
        data_reader_params: dict | None = None,
        data_origin: str | None = None,
        custom_data_reader=None,
        wait_sleep_secs: float = 2.0,
    ):
        self._worker = worker
        self._training_with_evaluation = training_with_evaluation
        self._wait_sleep_secs = wait_sleep_secs
        create = custom_data_reader or create_data_reader
        params = dict(data_reader_params or {})
        self.data_reader = create(data_origin=data_origin, **params)
        self._lock = threading.Lock()
        self._pending_save_model_task = None
        self._has_warmed_up = False
        self._failed_record_count = 0
        self._reported_record_count = 0
        self._current_task = None
        self._pending_tasks: deque = deque()
        self._last_poll_was_wait = False

    def get_current_task(self):
        return self._current_task

    # ---- exactly-once task reporting --------------------------------------

    def report_record_done(self, count: int, err_msg: str = "") -> bool:
        """Add ``count`` processed records; report every task that is now
        fully covered.  Returns True if at least one task completed."""
        self._reported_record_count += count
        if err_msg:
            self._failed_record_count += count

        if not self._pending_tasks:
            return False
        task = self._pending_tasks[0]
        if self._reported_record_count < task.end - task.start:
            return False
        if err_msg:
            logger.warning(
                "records (%d/%d) failed in task %d: %s",
                self._failed_record_count,
                task.end - task.start,
                task.task_id,
                err_msg,
            )
        # batches may cover several whole tasks: keep popping while the
        # cumulative count spans the head task (reference :93-104)
        with self._lock:
            while self._pending_tasks and self._reported_record_count >= (
                self._pending_tasks[0].end - self._pending_tasks[0].start
            ):
                task = self._pending_tasks.popleft()
                self._reported_record_count -= task.end - task.start
                self._do_report_task(task, err_msg)
                self._failed_record_count = 0
            if self._pending_tasks:
                self._current_task = self._pending_tasks[0]
        return True

    def _do_report_task(self, task, err_msg: str = ""):
        counters = (
            {FAIL_COUNT: self._failed_record_count}
            if self._failed_record_count
            else {}
        )
        self._worker.report_task_result(
            task.task_id, err_msg, exec_counters=counters, include_timing=True
        )

    # ---- per-task fast-path stream (training / prediction) -----------------

    def start_task_stream(self):
        """Main-thread entry for the worker's vectorized per-task loops
        (training and prediction): poll the master until a data task
        arrives, handling WAIT by invoking ``worker.on_wait`` (eval
        drain — main-thread-only work) and sleeping (reference
        ``:156-172``'s warm-up loop).  Returns the first task —
        leased AND registered for exactly-once accounting — or ``None``
        when the job is complete or a SAVE_MODEL task arrived (stashed;
        caller processes it).

        The first time through, one record of the first task is read so
        ``data_reader.metadata`` is populated before any pipeline runs
        (reference :156-172's warm-up).
        """
        while True:
            _tid, task = self.lease_task()
            if task is not None:
                if not self._has_warmed_up:
                    for _ in self.data_reader.read_records(task):
                        break
                    self._has_warmed_up = True
                return task
            if self._pending_save_model_task is not None:
                return None
            if not self._last_poll_was_wait:
                logger.info("No more tasks, stopping")
                return None
            on_wait = getattr(self._worker, "on_wait", None)
            if on_wait is not None:
                on_wait()
            time.sleep(self._wait_sleep_secs)

    def lease_task(self):
        """Lease the next data task (training or prediction, whichever
        queue this job runs) and register it for exactly-once
        accounting; safe to call from a prefetcher's producer thread
        (never sleeps, never calls back into the worker).  Returns
        ``(task_id, task)``, or ``(None, None)`` when the stream pauses —
        job complete, WAIT (``_last_poll_was_wait`` distinguishes; only
        :meth:`start_task_stream` reads it, on the main thread after the
        stream drains), or a SAVE_MODEL task (stashed for the main
        thread).

        Tasks are registered in lease order, which with a single
        producer is also batch-stream order, so :meth:`report_record_done`
        pops them exactly as the classic straddling stream did.
        Ahead-leasing is safe under dispatcher lease timeouts
        (``task_timeout_secs``): every task report refreshes the
        reporter's other leases (``TaskDispatcher.report``), so an
        ahead-leased task only expires if this worker stops completing
        tasks altogether.
        """
        task = self._worker.get_task()
        if not task.shard_name:
            self._last_poll_was_wait = task.is_wait
            return None, None
        if task.type == int(TaskType.SAVE_MODEL):
            with self._lock:
                self._pending_save_model_task = task
            self._last_poll_was_wait = True  # stream pauses, job not done
            return None, None
        with self._lock:
            self._pending_tasks.append(task)
            if len(self._pending_tasks) == 1:
                self._current_task = task
        return task.task_id, task

    def get_save_model_task_and_dataset(self):
        if not self._pending_save_model_task:
            return None, None
        task = self._pending_save_model_task
        self._pending_save_model_task = None
        ds = Dataset.from_generator(
            lambda: iter(self.data_reader.read_records(task))
        )
        return task, ds
