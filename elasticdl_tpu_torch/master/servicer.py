"""The master's service logic, transport-agnostic; the counterpart of
``elasticdl_tpu/master/servicer.py`` for the lockstep path.

It wraps the task dispatcher (``master/task_dispatcher.py``) and serves
``get_task``, the memoized lockstep step stream (``get_step_task``, with
its two cluster-version fences), task and version reports and
heartbeats; the master's run loop reads liveness from it
(``dead_workers``) and fences a world with ``bump_cluster_version`` and
``reset_step_stream``.  Requests and responses are the dataclasses of
``rpc/messages.py``; ``rpc/service.py`` only moves them.

Left out until the slices that need them: the journal (master high
availability), the replica directory and restore stage, re-homing, the
profiler command, the quiesce flag, and the telemetry fan-in of step
phases, prefetch and memory.  Heartbeats are applied under one lock
(the JAX package coalesces them for fleets of thousands).
"""

from __future__ import annotations

import threading
import time

from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.merge import max_merge_counters


class MasterServicer:
    # keep this many newest memoized seqs: lockstep processes cannot
    # diverge by more than one dispatch group, so hundreds of seqs of
    # slack is unreachable
    STREAM_MEMO_KEEP = 512

    def __init__(self, minibatch_size: int, task_dispatcher, clock=time.monotonic):
        self._task_d = task_dispatcher
        self._minibatch_size = minibatch_size
        self._clock = clock
        self._lock = threading.Lock()
        # GIL-atomic ints: unlocked reads are the documented pattern;
        # every WRITE takes the lock
        self._version = 0  # guarded-by: _lock (writes)
        self._cluster_version = 0  # guarded-by: _lock (writes)
        # worker_id -> last liveness signal (heartbeat or step pull)
        self._heartbeats: dict[int, float] = {}  # guarded-by: _lock
        # externally reported failures (process exits); cleared only by
        # forget_worker so a racing in-flight heartbeat cannot erase them
        self._marked_dead: set[int] = set()  # guarded-by: _lock
        # worker-shipped RPC outcome totals, max-merged per worker and
        # summed across workers (rpc/stats.py)
        self._worker_rpc_stats: dict[int, dict[str, int]] = {}  # guarded-by: _lock
        self._rpc_totals: dict[str, int] = {}  # guarded-by: _lock
        # lockstep step stream: seq -> memoized TaskResponse.  Every
        # process of a world pulls the same seq and must see the same
        # answer; WAIT is the only non-final answer and is never memoized
        self._step_stream: dict[int, msg.TaskResponse] = {}  # guarded-by: _stream_lock
        self._stream_lock = threading.Lock()
        self._first_stream_pull_at: float | None = None  # guarded-by: _stream_lock
        # (worker_id, model_version) observers — chaos invariant checking
        self._version_observers: list = []

    def add_version_observer(self, callback):
        """``callback(worker_id, model_version)`` on every version
        report; must not call back into the servicer."""
        self._version_observers.append(callback)

    def get_model_version(self) -> int:
        return self._version

    # ---- RPC handlers -----------------------------------------------------

    def get_task(self, request: msg.GetTaskRequest) -> msg.TaskResponse:
        """Lease the next task for ``worker_id``.  A WAIT response means
        new work may appear later (a re-queued lease, a deferred
        SAVE_MODEL): poll again after a short sleep."""
        with self._lock:
            self._heartbeats[request.worker_id] = self._clock()
        if request.task_type == int(TaskType.EVALUATION):
            task_id, task = self._task_d.get_eval_task(request.worker_id)
        else:
            task_id, task = self._task_d.get(request.worker_id)
        if task is not None:
            return msg.task_to_response(
                task_id, task, self._version, self._minibatch_size
            )
        if (not self._task_d.finished()) or (
            self._task_d.invoke_deferred_callback()
        ):
            return self._wait()
        return self._end()

    def get_step_task(self, request: msg.GetStepTaskRequest) -> msg.TaskResponse:
        """Resolve one lockstep stream position.  The first request for
        an unresolved ``seq`` leases the next task (evaluation tasks
        ahead of training) and memoizes the response; every other
        process replays it.  End-of-job is memoized too, so every
        process ends at the same seq.  A request from another world
        generation gets end-of-job, and records no liveness."""
        with self._lock:
            if request.cluster_version != self._cluster_version:
                return self._end()
            self._heartbeats[request.worker_id] = self._clock()
        with self._stream_lock:
            if request.cluster_version != self._cluster_version:
                # re-checked under this lock: a reform landing between the
                # two would let a stale request lease from the recovered
                # queue into the new world's stream
                return self._end()
            if self._first_stream_pull_at is None:
                self._first_stream_pull_at = self._clock()
            memo = self._step_stream.get(request.seq)
            if memo is not None:
                return memo
            task_id, task = self._task_d.get_eval_task(request.worker_id)
            if task is None:
                task_id, task = self._task_d.get(request.worker_id)
            if task is not None:
                resp = msg.task_to_response(
                    task_id, task, self._version, self._minibatch_size
                )
                self._memoize_stream(request.seq, resp)
                return resp
            if (not self._task_d.finished()) or (
                self._task_d.invoke_deferred_callback()
            ):
                return self._wait()
            resp = self._end()
            self._memoize_stream(request.seq, resp)
            return resp

    def _wait(self) -> msg.TaskResponse:
        return msg.TaskResponse(
            type=int(TaskType.WAIT),
            model_version=self._version,
            minibatch_size=self._minibatch_size,
        )

    def _end(self) -> msg.TaskResponse:
        return msg.TaskResponse(
            model_version=self._version, minibatch_size=self._minibatch_size
        )

    # lock-holding: _stream_lock
    def _memoize_stream(self, seq: int, resp: msg.TaskResponse):
        self._step_stream[seq] = resp
        if len(self._step_stream) > self.STREAM_MEMO_KEEP + 64:
            for old in sorted(self._step_stream)[
                : len(self._step_stream) - self.STREAM_MEMO_KEEP
            ]:
                del self._step_stream[old]

    def reset_step_stream(self):
        """Drop all memoized stream state (re-formation: the new world
        restarts at seq 0 and pulls from the recovered queue)."""
        with self._stream_lock:
            self._step_stream.clear()
            self._first_stream_pull_at = None

    def bump_cluster_version(self) -> int:
        """Advance the world generation; stale workers are fenced out of
        the step stream from this point on."""
        with self._lock:
            self._cluster_version += 1
            return self._cluster_version

    def first_stream_pull_at(self) -> float | None:
        """Monotonic time of the first step-task pull since the last
        stream reset: the 'new world is training again' signal that
        re-formation latency is measured to."""
        with self._stream_lock:
            return self._first_stream_pull_at

    def report_task_result(self, request: msg.ReportTaskResultRequest):
        if request.err_message:
            logger.warning("Worker reported error: %s", request.err_message)
        self._task_d.report(
            request.task_id,
            success=not request.err_message,
            exec_counters=request.exec_counters,
        )

    def report_version(self, request: msg.ReportVersionRequest):
        """Workers report their step count (the model version)."""
        with self._lock:
            self._version = max(self._version, request.model_version)
        for callback in self._version_observers:
            try:
                callback(request.worker_id, request.model_version)
            except Exception:  # noqa: BLE001 — observers never break RPCs
                logger.exception("Version observer failed")

    def heartbeat(self, request: msg.HeartbeatRequest) -> msg.HeartbeatResponse:
        with self._lock:
            self._heartbeats[request.worker_id] = self._clock()
            if request.rpc:
                max_merge_counters(
                    self._worker_rpc_stats.setdefault(request.worker_id, {}),
                    request.rpc,
                    totals=self._rpc_totals,
                )
        return msg.HeartbeatResponse(cluster_version=self._cluster_version)

    # ---- failure detection and re-formation hooks -------------------------

    def mark_worker_dead(self, worker_id: int):
        """External failure signal (a worker process exited abnormally):
        reported by the next ``dead_workers`` whatever the heartbeats
        say, until ``forget_worker``."""
        with self._lock:
            self._marked_dead.add(worker_id)

    def dead_workers(self, timeout_secs: float) -> list[int]:
        """Workers marked dead, plus (when ``timeout_secs > 0``) workers
        whose last liveness signal is older than the timeout."""
        now = self._clock()
        with self._lock:
            dead = set(self._marked_dead)
            if timeout_secs > 0:
                dead.update(
                    wid for wid, at in self._heartbeats.items()
                    if now - at > timeout_secs
                )
            return sorted(dead)

    def forget_worker(self, worker_id: int):
        with self._lock:
            self._heartbeats.pop(worker_id, None)
            self._marked_dead.discard(worker_id)

    def live_workers(self) -> list[int]:
        with self._lock:
            return sorted(set(self._heartbeats) - self._marked_dead)

    def rpc_stats_totals(self) -> dict[str, int]:
        """Fleet-wide RPC outcome totals: per-worker maxima summed."""
        with self._lock:
            return dict(self._rpc_totals)

    @property
    def cluster_version(self) -> int:
        return self._cluster_version
