"""The master's service logic, transport-agnostic; the counterpart of
``elasticdl_tpu/master/servicer.py``.

It wraps the task dispatcher (``master/task_dispatcher.py``) and serves
``get_task`` (the task-stream worker's leases of training, evaluation
and prediction tasks), the memoized lockstep step stream
(``get_step_task``, with its two cluster-version fences), task and
version reports (a version report may queue a step-based evaluation),
evaluation metrics (lease-guarded and deduplicated by task id, then
accumulated by the evaluation service), heartbeats (with ``--replication``
they feed the replica directory and carry the ring's peer map back) and
the harvested replica stage of a re-formed world (``get_restore_state``,
fenced by generation); the master's run loop reads liveness from it
(``dead_workers``) and fences a world with ``bump_cluster_version`` and
``reset_step_stream``.  Requests and responses are the dataclasses of
``rpc/messages.py``; ``rpc/service.py`` only moves them.

With ``--master_journal_dir`` (master high availability) the servicer
journals the two transitions only it sees, generation bumps and the
memoized step-stream resolutions (``master/journal.py``), stamps every
heartbeat with the master process's boot id, and serves the re-homing
handshake (``rehome_worker``): a worker that outlived a master outage
presents its generation, pid and in-flight leases, and is fenced or
reconciled and handed to the master for adoption.  Unlike the JAX
package, a lease is durable before its response leaves the master: the
servicer flushes the journal after each new lease (under the stream
lock for the step stream), so a restarted master never re-issues a
task id, nor a stream position, that a worker already holds.

The quiesce flag rides every heartbeat (``should_quiesce``): a parked
job (``Master._park``) waits quiesced until a capacity grant re-forms
its world; as in the JAX package, no worker reads it yet.  The standby
mailbox (``post_world_assignment``, ``get_world_assignment``,
``drain_standbys``) is the RPC form of the world assignment a local
standby reads on its stdin.

Left out until the slices that need them: the profiler command and the
telemetry fan-in of step phases and memory (the device pipeline's
staging totals are kept, per worker).  Heartbeats are applied under one
lock (the JAX package coalesces them for fleets of thousands).
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict

from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.merge import max_merge_counters


class MasterServicer:
    # keep this many newest memoized seqs: lockstep processes cannot
    # diverge by more than one dispatch group, so hundreds of seqs of
    # slack is unreachable
    STREAM_MEMO_KEEP = 512

    def __init__(
        self,
        minibatch_size: int,
        task_dispatcher,
        evaluation_service=None,
        clock=time.monotonic,
    ):
        self._task_d = task_dispatcher
        self._minibatch_size = minibatch_size
        self._evaluation_service = evaluation_service
        self._clock = clock
        self._lock = threading.Lock()
        # GIL-atomic ints: unlocked reads are the documented pattern;
        # every WRITE takes the lock
        self._version = 0  # guarded-by: _lock (writes)
        self._cluster_version = 0  # guarded-by: _lock (writes)
        self._quiesce = False  # guarded-by: _lock (writes)
        # hot-standby world assignments addressed by standby id (the RPC
        # form of the local standby's stdin line)
        self._world_assignments: dict[str, dict] = {}  # guarded-by: _lock
        self._standby_drain = False  # guarded-by: _lock
        # worker_id -> last liveness signal (heartbeat or step pull)
        self._heartbeats: dict[int, float] = {}  # guarded-by: _lock
        # externally reported failures (process exits); cleared only by
        # forget_worker so a racing in-flight heartbeat cannot erase them
        self._marked_dead: set[int] = set()  # guarded-by: _lock
        # worker-shipped RPC outcome totals, max-merged per worker and
        # summed across workers (rpc/stats.py)
        self._worker_rpc_stats: dict[int, dict[str, int]] = {}  # guarded-by: _lock
        self._rpc_totals: dict[str, int] = {}  # guarded-by: _lock
        # the device pipeline's staging totals, max-merged per worker
        self._worker_prefetch_stats: dict[int, dict[str, int]] = {}  # guarded-by: _lock
        # task ids whose evaluation metrics were accumulated: a second
        # report for a lease still active (a lost reply, a client retry)
        # is dropped
        self._eval_metrics_seen: set[int] = set()  # guarded-by: _lock
        # worker_id -> monotonic time of its first get_task lease (a
        # relaunched worker's is the end of the relaunch latency)
        self._first_lease_at: dict[int, float] = {}  # guarded-by: _lock
        # lockstep step stream: seq -> memoized TaskResponse.  Every
        # process of a world pulls the same seq and must see the same
        # answer; WAIT is the only non-final answer and is never memoized
        self._step_stream: dict[int, msg.TaskResponse] = {}  # guarded-by: _stream_lock
        self._stream_lock = threading.Lock()
        self._first_stream_pull_at: float | None = None  # guarded-by: _stream_lock
        # (worker_id, model_version) observers — chaos invariant checking
        self._version_observers: list = []
        # peer replication (replication/): the master-side directory the
        # heartbeats feed, and the harvested stage a re-formed world
        # restores from
        self._replica_directory = None
        self._restore_stage: dict | None = None  # guarded-by: _lock
        # master high availability (master/journal.py): the journal sink
        # records generation bumps and step-stream resolutions; the boot
        # id names THIS master process, so a re-homing worker can tell a
        # restart from a blip; the rehome sink lets the Master adopt
        # re-homed orphans; the event sink (``fn(event, **fields)``)
        # records a fenced re-home; the served sink (a restored master's)
        # marks the end of its outage
        self._journal = None
        self._boot_id = ""
        self._rehome_sink = None
        self._stage_released_sink = None
        self._event_sink = None
        self._served_sink = None
        # the leases a restored master's journal held at the outage: the
        # ones a re-homing handshake settles (None: not restored, all)
        self._outage_leases: set[int] | None = None
        if evaluation_service is not None:
            evaluation_service.set_master_servicer(self)

    def add_version_observer(self, callback):
        """``callback(worker_id, model_version)`` on every version
        report; must not call back into the servicer."""
        self._version_observers.append(callback)

    def get_model_version(self) -> int:
        return self._version

    def set_replica_directory(self, directory):
        """Attach the replication subsystem's master-side directory;
        heartbeats then carry advertisements up and peer maps down."""
        self._replica_directory = directory

    def set_journal(self, journal):
        """Attach the control-plane journal (``master/journal.py``):
        generation bumps and lockstep stream resolutions are recorded
        from here, the two transitions only the servicer sees."""
        self._journal = journal

    def set_boot_id(self, boot_id: str):
        self._boot_id = boot_id

    @property
    def boot_id(self) -> str:
        return self._boot_id

    def set_stage_released_sink(self, sink):
        """``sink(generation)`` fires once, when the staged replica set
        has been fetched (journal hook)."""
        self._stage_released_sink = sink

    def set_rehome_sink(self, sink):
        """``sink(worker_id, pid, kept, requeued, started_at)`` after a
        successful re-home: the Master adopts the orphan."""
        self._rehome_sink = sink

    def set_event_sink(self, sink):
        """``sink(event, **fields)``: the chaos event log."""
        self._event_sink = sink

    def set_served_sink(self, sink):
        """``sink()`` at the first worker call served from here on
        (``get_task``, ``get_step_task``, ``heartbeat``,
        ``rehome_worker``): a restored master's end of the outage."""
        self._served_sink = sink

    def _note_served(self):
        sink = self._served_sink
        if sink is not None:
            self._served_sink = None
            sink()

    def _emit(self, event: str, **fields):
        if self._event_sink is None:
            return
        try:
            self._event_sink(event, **fields)
        except Exception:  # noqa: BLE001 — an event log never breaks RPCs
            logger.exception("Event sink failed")

    # ---- RPC handlers -----------------------------------------------------

    def get_task(self, request: msg.GetTaskRequest) -> msg.TaskResponse:
        """Lease the next task for ``worker_id``.  A WAIT response means
        new work may appear later (a re-queued lease, a deferred
        SAVE_MODEL): poll again after a short sleep."""
        self._note_served()
        with self._lock:
            self._heartbeats[request.worker_id] = self._clock()
        if request.task_type == int(TaskType.EVALUATION):
            task_id, task = self._task_d.get_eval_task(request.worker_id)
        else:
            task_id, task = self._task_d.get(request.worker_id)
        if task is not None:
            with self._lock:
                self._first_lease_at.setdefault(request.worker_id, self._clock())
            self._journal_durable()
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
        self._note_served()
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
                self._memoize_stream(request.seq, resp, request.cluster_version)
                # durable before any process of the world sees it
                self._journal_durable()
                return resp
            if (not self._task_d.finished()) or (
                self._task_d.invoke_deferred_callback()
            ):
                return self._wait()
            resp = self._end()
            self._memoize_stream(request.seq, resp, request.cluster_version)
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
    def _memoize_stream(self, seq: int, resp: msg.TaskResponse, generation: int):
        """Memoize and journal one stream resolution, pruning memos far
        behind the frontier.  ``generation`` is the fence the request
        passed, journaled with the record so that replay drops a
        resolution that raced a re-formation's generation bump."""
        self._step_stream[seq] = resp
        self._journal_stream(seq, resp, generation)
        if len(self._step_stream) > self.STREAM_MEMO_KEEP + 64:
            for old in sorted(self._step_stream)[
                : len(self._step_stream) - self.STREAM_MEMO_KEEP
            ]:
                del self._step_stream[old]

    def _journal_stream(self, seq: int, resp: msg.TaskResponse, generation: int):
        """A restarted master must answer already-resolved seqs
        identically, or the world desyncs across the outage."""
        if self._journal is None:
            return
        try:
            self._journal.record_stream(seq, asdict(resp), generation)
        except Exception:  # noqa: BLE001 — journaling never breaks RPCs
            logger.exception("Journal stream record failed")

    def _journal_durable(self):
        """Flush the journal (a new lease must outlive a master kill)."""
        if self._journal is not None:
            self._journal.flush()

    def stream_snapshot(self) -> dict:
        """JSON-safe copy of the memoized step stream (journal snapshots;
        keys stringified, as replay expects)."""
        with self._stream_lock:
            return self._stream_snapshot_locked()

    # lock-holding: _stream_lock
    def _stream_snapshot_locked(self) -> dict:
        return {str(seq): asdict(resp) for seq, resp in self._step_stream.items()}

    def journal_stream_snapshot(self):
        """Journal a full stream-memo capture from UNDER the stream lock,
        so the record's file position IS its capture point.  The master
        writes one right after each main snapshot, whose stream field was
        captured before its (dispatcher-atomic) append."""
        if self._journal is None:
            return
        with self._stream_lock:
            try:
                self._journal.record_stream_snapshot(self._stream_snapshot_locked())
            except Exception:  # noqa: BLE001 — journaling never breaks RPCs
                logger.exception("Journal stream snapshot failed")

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
            version = self._cluster_version
        if self._journal is not None:
            # the fence record flushes inline: a restarted master that
            # resurrected a fenced generation would un-fence stale workers
            self._journal.record_generation(version)
        return version

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
        """Workers report their step count (the model version), which
        drives the step-based evaluation trigger."""
        with self._lock:
            self._version = max(self._version, request.model_version)
        for callback in self._version_observers:
            try:
                callback(request.worker_id, request.model_version)
            except Exception:  # noqa: BLE001 — observers never break RPCs
                logger.exception("Version observer failed")
        if self._evaluation_service is not None:
            self._evaluation_service.add_evaluation_task_if_needed(
                master_locking=False, model_version=request.model_version
            )

    def report_evaluation_metrics(
        self, request: msg.ReportEvaluationMetricsRequest
    ):
        """Accumulate an evaluation task's outputs and labels, unless its
        lease is no longer active (reclaimed or re-queued: the re-run
        reports) or this lease already reported (a re-delivery)."""
        if request.task_id >= 0 and not self._task_d.is_active(request.task_id):
            logger.warning(
                "Dropping eval metrics for inactive task %d", request.task_id
            )
            return
        if request.task_id >= 0:
            with self._lock:
                duplicate = request.task_id in self._eval_metrics_seen
                self._eval_metrics_seen.add(request.task_id)
            if duplicate:
                logger.warning(
                    "Dropping duplicate eval metrics for task %d "
                    "(re-delivered report)", request.task_id,
                )
                return
        if self._evaluation_service is not None:
            self._evaluation_service.report_evaluation_metrics(
                request.model_outputs,
                request.labels,
                evaluated_version=request.evaluated_version,
            )

    def heartbeat(self, request: msg.HeartbeatRequest) -> msg.HeartbeatResponse:
        self._note_served()
        with self._lock:
            self._heartbeats[request.worker_id] = self._clock()
            if request.rpc:
                max_merge_counters(
                    self._worker_rpc_stats.setdefault(request.worker_id, {}),
                    request.rpc,
                    totals=self._rpc_totals,
                )
            if request.prefetch:
                max_merge_counters(
                    self._worker_prefetch_stats.setdefault(request.worker_id, {}),
                    request.prefetch,
                )
        # the directory synchronizes itself: outside the lock
        generation = self._cluster_version
        replica_peers: dict = {}
        if self._replica_directory is not None:
            if request.replica:
                self._replica_directory.update(request.worker_id, request.replica)
            replica_peers = self._replica_directory.peers(generation)
        return msg.HeartbeatResponse(
            should_quiesce=self._quiesce,
            cluster_version=generation,
            replica_peers=replica_peers,
            boot_id=self._boot_id,
        )

    # ---- master high availability: the re-homing handshake -----------------

    def rehome_worker(self, request: msg.RehomeRequest) -> msg.RehomeResponse:
        """A worker that outlived a master outage reconnects: fence its
        generation, reconcile its in-flight leases against the
        journal-restored active set (re-accept what it presents, requeue
        the outage leases it does not), and hand it to the master for
        adoption."""
        self._note_served()
        started_at = time.monotonic()
        generation = self._cluster_version
        if request.cluster_version != generation:
            # stale world: refused WITHOUT a liveness record, exactly as
            # the step-stream fence refuses
            self._emit(
                "worker_rehome", worker_id=request.worker_id, pid=request.pid,
                accepted=False, worker_generation=request.cluster_version,
                cluster_version=generation,
            )
            return msg.RehomeResponse(
                accepted=False, cluster_version=generation, boot_id=self._boot_id
            )
        presented = {int(t) for t in request.lease_ids}
        # only a lease held across the outage is the handshake's to
        # settle: one this master granted since is in the worker's stream
        # already, though the worker may not have recorded it when it
        # built its request (requeued, it would train twice)
        if self._outage_leases is not None:
            presented |= {
                tid for tid, (wid, *_where) in self._task_d.snapshot()["active"].items()
                if wid == request.worker_id and tid not in self._outage_leases
            }
        kept, requeued = self._task_d.reconcile_leases(request.worker_id, presented)
        with self._lock:
            self._heartbeats[request.worker_id] = self._clock()
        if self._rehome_sink is not None:
            try:
                self._rehome_sink(
                    request.worker_id, request.pid, kept, requeued, started_at
                )
            except Exception:  # noqa: BLE001 — adoption must not fail the
                # handshake the worker depends on
                logger.exception("Rehome sink failed")
        return msg.RehomeResponse(
            accepted=True,
            cluster_version=generation,
            boot_id=self._boot_id,
            accepted_leases=sorted(kept),
        )

    def restore_control_state(
        self, cluster_version: int, model_version: int, stream: dict | None = None,
        outage_leases=(),
    ):
        """Install journal-replayed control state (a master restart): the
        generation fence, the model-version floor, the memoized step
        stream, so already-resolved seqs replay their pre-outage answers,
        and the leases held at the outage (the re-homing handshake's)."""
        with self._lock:
            self._cluster_version = int(cluster_version)
            self._version = max(self._version, int(model_version))
            self._outage_leases = {int(t) for t in outage_leases}
        memos = {}
        for seq, resp in (stream or {}).items():
            try:
                memos[int(seq)] = msg.TaskResponse(**resp)
            except TypeError:
                logger.warning("Dropping unreplayable stream memo for seq %s", seq)
        if len(memos) > self.STREAM_MEMO_KEEP:
            for old in sorted(memos)[: len(memos) - self.STREAM_MEMO_KEEP]:
                del memos[old]
        with self._stream_lock:
            self._step_stream = memos

    # ---- replica restore stage ---------------------------------------------

    def set_restore_stage(self, stage: dict | None):
        """Install (or clear, with None) the harvested replica state the
        NEXT generation restores from (``Master._reform_lockstep``)."""
        with self._lock:
            self._restore_stage = stage

    def take_restore_stage(self) -> dict | None:
        """Remove the staged replica set and return it (a park keeps it
        for the world that un-parks)."""
        with self._lock:
            stage, self._restore_stage = self._restore_stage, None
        return stage

    def get_restore_state(
        self, request: msg.GetRestoreStateRequest
    ) -> msg.RestoreStateResponse:
        """Serve the staged replica set, only to the generation it was
        harvested FOR (any other asker gets the disk-fallback answer).
        The port's world restores on process 0 and broadcasts, so the
        stage is released from master RAM once process 0 has its copy
        (the JAX package serves every process and releases it after the
        last)."""
        with self._lock:
            stage = self._restore_stage
            if stage is None or stage["generation"] != request.cluster_version:
                return msg.RestoreStateResponse()
            released = request.process_id == 0
            if released:
                self._restore_stage = None
        if released and self._stage_released_sink is not None:
            # outside the lock: the sink appends to the journal, so that a
            # later restart does not report a served stage as lost
            try:
                self._stage_released_sink(stage["generation"])
            except Exception:  # noqa: BLE001 — bookkeeping must not fail
                # the restore the worker depends on
                logger.exception("Stage-released sink failed")
        return msg.RestoreStateResponse(
            has=True,
            version=stage["version"],
            checksum=stage["checksum"],
            payload=stage["payload"],
        )

    # ---- hot-standby world assignments --------------------------------------

    def post_world_assignment(self, standby_id: str, assignment: dict):
        """Instance manager -> standby mailbox: ``assignment`` carries the
        keys a local standby reads on its stdin (worker_id,
        coordinator_addr, num_processes, process_id, cluster_version and,
        in a multi-slice world, slice_id and num_slices)."""
        with self._lock:
            self._world_assignments[standby_id] = dict(assignment)

    def get_world_assignment(
        self, request: msg.GetWorldAssignmentRequest
    ) -> msg.WorldAssignmentResponse:
        """A standby's poll; not a liveness signal: a waiting standby is
        invisible to failure detection until it is activated."""
        with self._lock:
            assignment = self._world_assignments.pop(request.standby_id, None)
            if assignment is None:
                return msg.WorldAssignmentResponse(shutdown=self._standby_drain)
        return msg.WorldAssignmentResponse(has=True, **assignment)

    def drain_standbys(self):
        """The job is over: polling standbys are told to exit."""
        with self._lock:
            self._standby_drain = True
            self._world_assignments.clear()

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
        if self._replica_directory is not None:
            self._replica_directory.forget_worker(worker_id)

    def live_workers(self) -> list[int]:
        with self._lock:
            return sorted(set(self._heartbeats) - self._marked_dead)

    def first_lease_at(self, worker_id: int) -> float | None:
        """Monotonic time of ``worker_id``'s first ``get_task`` lease."""
        with self._lock:
            return self._first_lease_at.get(worker_id)

    def prefetch_stats(self) -> dict[int, dict[str, int]]:
        """Each worker's device-pipeline staging totals (groups staged,
        stall and staging ms, boundaries), as its heartbeats carried
        them."""
        with self._lock:
            return {wid: dict(stats) for wid, stats in self._worker_prefetch_stats.items()}

    def rpc_stats_totals(self) -> dict[str, int]:
        """Fleet-wide RPC outcome totals: per-worker maxima summed."""
        with self._lock:
            return dict(self._rpc_totals)

    @property
    def cluster_version(self) -> int:
        return self._cluster_version

    @property
    def is_quiescing(self) -> bool:
        return self._quiesce

    def begin_quiesce(self):
        """Ask every worker to pause at its next task boundary (a parked
        job waits so for a capacity grant)."""
        with self._lock:
            self._quiesce = True

    def clear_quiesce(self):
        """Drop the quiesce flag without bumping the generation (an
        unpark: the re-formation that relaunches bumped it already)."""
        with self._lock:
            self._quiesce = False

    def end_quiesce(self):
        """Drop the quiesce flag and advance the generation, journaled as
        any fence is."""
        with self._lock:
            self._quiesce = False
            self._cluster_version += 1
            generation = self._cluster_version
        if self._journal is not None:
            self._journal.record_generation(generation)
