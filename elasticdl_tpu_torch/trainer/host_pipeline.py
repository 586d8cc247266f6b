"""Cross-task host-pipeline prefetch: decode ahead while the device runs;
the counterpart of ``elasticdl_tpu/trainer/host_pipeline.py``.

One producer thread walks the task stream (dispatcher -> task ->
minibatch pipeline) and fills a bounded queue with host numpy batches,
so while the device executes the current step the next task's records
are already read, decoded and batched.  The producer never touches the
device: placing a batch on it stays on the consuming (training) thread.

Ordering and accounting are those of the serial loop: batches arrive in
task order, a task's batches are contiguous, and the caller reports each
task only after consuming all its batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from elasticdl_tpu_torch.utils.tree_utils import tree_leaves

_TASK = "task"
_BATCH = "batch"
_END_TASK = "end"
_ERROR = "error"
_DONE = "done"


class TaskPrefetcher:
    """Iterate ``(task_id, task, batches)`` triples with the host
    pipeline running ahead on a background thread.

    ``next_task()`` -> ``(task_id, task)`` or ``(_, None)`` at end of
    stream (the dispatcher contract).  ``make_batches(task)`` -> iterable
    of minibatches.  Decode-ahead memory is bounded by both
    ``max_buffered_batches`` and ``max_buffered_bytes``.

    Each yielded ``batches`` iterator must be consumed before advancing
    the outer iteration.
    """

    def __init__(
        self,
        next_task: Callable,
        make_batches: Callable,
        max_buffered_batches: int = 32,
        max_buffered_bytes: int = 64 << 20,
    ):
        self._next_task = next_task
        self._make_batches = make_batches
        # the queue itself is unbounded; _put blocks on whichever budget
        # (batch count or bytes) is exhausted first
        self._q: queue.Queue = queue.Queue()
        self._max_batches = max(1, max_buffered_batches)
        self._max_bytes = max_buffered_bytes
        self._credit = threading.Condition()
        self._buffered_batches = 0
        self._buffered_bytes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, name="task-prefetch", daemon=True
        )
        self._started = False

    # ---- producer ---------------------------------------------------------

    @staticmethod
    def _batch_bytes(batch) -> int:
        return sum(np.asarray(leaf).nbytes for leaf in tree_leaves(batch))

    def _put(self, item, count: int = 0, nbytes: int = 0) -> bool:
        """Blocking put that aborts when the consumer closed us; batch
        items charge both buffering budgets, and marker items (count=0)
        are throttled by total queue depth so a stream of empty tasks
        cannot drain the whole dispatcher into the queue."""
        marker_cap = 2 * self._max_batches + 8
        with self._credit:
            while not self._stop.is_set():
                if count == 0:
                    if self._q.qsize() < marker_cap:
                        self._q.put(item)
                        return True
                elif (
                    self._buffered_batches < self._max_batches
                    and self._buffered_bytes < self._max_bytes
                ):
                    self._buffered_batches += count
                    self._buffered_bytes += nbytes
                    self._q.put(item)
                    return True
                self._credit.wait(timeout=0.1)
        return False

    def _release(self, count: int, nbytes: int):
        with self._credit:
            self._buffered_batches -= count
            self._buffered_bytes -= nbytes
            self._credit.notify()

    def _produce(self):
        try:
            while not self._stop.is_set():
                tid, task = self._next_task()
                if task is None:
                    break
                if not self._put((_TASK, (tid, task))):
                    return
                for batch in self._make_batches(task):
                    nbytes = max(1, self._batch_bytes(batch))
                    if not self._put((_BATCH, (batch, 1, nbytes)), 1, nbytes):
                        return
                if not self._put((_END_TASK, tid)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            self._put((_ERROR, e))
            return
        self._put((_DONE, None))

    # ---- consumer ---------------------------------------------------------

    def __iter__(self) -> Iterator:
        if not self._started:
            self._started = True
            self._thread.start()
        while True:
            kind, payload = self._q.get()
            if kind == _DONE:
                return
            if kind == _ERROR:
                raise payload
            if kind != _TASK:
                raise RuntimeError(f"protocol error: {kind} outside a task")
            tid, task = payload
            batches = self._task_batches(tid)
            yield tid, task, batches
            # the runtimes drain `batches` inside the loop body; drain
            # what a partial consumer left so the stream stays aligned
            for _ in batches:
                pass

    def _task_batches(self, expect_tid) -> Iterator:
        while True:
            kind, payload = self._q.get()
            if kind == _BATCH:
                batch, count, nbytes = payload
                self._release(count, nbytes)
                yield batch
            elif kind == _END_TASK:
                if payload != expect_tid:
                    raise RuntimeError(
                        f"task {payload} ended inside task {expect_tid}"
                    )
                return
            elif kind == _ERROR:
                raise payload
            else:
                raise RuntimeError(f"unexpected {kind} inside task")

    def close(self):
        """Stop the producer and release it if blocked on a full queue."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=5)
