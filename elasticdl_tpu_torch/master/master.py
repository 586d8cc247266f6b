"""The master: job orchestrator and control plane; the counterpart of
``elasticdl_tpu/master/master.py``.

It builds the task dispatcher over the training, validation and
prediction shards (with the SAVE_MODEL deferred task when ``--output``
is set), the evaluation service for jobs that evaluate, serves the
servicer over ``rpc/service.py``, starts the workers through an instance
manager (:class:`LocalInstanceManager`: local subprocesses), and polls
until the dispatcher is done.

Two kinds of worker, as in the JAX package:

- two or more workers form one ``torch.distributed`` world (the
  lockstep worker).  A world is one program: losing any process stalls
  every collective, so a worker failure (a non-zero process exit, or a
  heartbeat older than ``--heartbeat_timeout_secs``) re-forms the whole
  world (:meth:`Master._reform_lockstep`): fence the old generation,
  (with ``--replication``) harvest the freshest complete replica set
  from the survivors' RAM and stage it for the next generation,
  re-queue every leased task, reset the step stream and relaunch a fresh
  world (new cluster version, new coordinator port) that resumes from
  the stage, or else from the newest checkpoint, within the
  ``--relaunch_on_worker_failure`` budget;
- one worker runs the task-stream worker, which leases its own tasks:
  a failure re-queues the dead worker's leases and relaunches it under a
  new worker id.

With ``--master_journal_dir D`` (master high availability) the master
writes a write-ahead journal of its control plane to ``D/journal.jsonl``
(``master/journal.py``) and publishes its address in ``D/master_addr``.
A master relaunched with the same arguments replays the journal (the
dispatcher's todo and doing sets, the epoch cursor, the counters, the
generation fence, the model version, the memoized step stream, the
consumed deferred callbacks, the world and the replica stage), does not
start a second world on top of the journaled one, and waits up to
``--rehome_grace_secs`` for its workers to re-home: each presents its
generation, pid and in-flight leases (``MasterServicer.rehome_worker``)
and is adopted (:class:`_AdoptedProcess`: polled, fenced and killed by
signals, since it is not this process's child).  A worker that never
re-homes is declared dead, and the normal failure path re-forms the
world or relaunches it.  ``request_crash`` kills a master in process
with SIGKILL semantics (the chaos harness's master kill).  The restart
and each re-home go to the chaos event log (``ELASTICDL_TPU_CHAOS_EVENTS``
in ``--envs``), where the JAX package writes them to its telemetry.

A lockstep job keeps warm standby processes (``--standby_workers``,
``-1``: one per process of the world), and a re-formed world is handed
to them before any process is cold-started.  With ``--num_slices S``
the fleet splits into slices (``parallel/mesh.py::slice_assignments``):
a re-formation after a whole slice died shrinks the next world to the
surviving slices (:meth:`Master._plan_slice_topology`), and below
``--min_slices`` the job parks (:meth:`Master._park`): the world is
torn down and the master waits quiesced until a capacity grant
(``set_world_slices`` and ``request_reform``) or an autoscale grow
re-forms it.  With an ``--autoscale_*`` SLO the run loop asks
``master/autoscaler.py`` for a decision at every tick.  The slice loss,
the resize of the world (``mesh_resize``) and each autoscale decision go
to the chaos event log, as the restart and re-homes do.  A master
restored from a journal keeps the slice map and the parked flag, and
refills its pool with its next world.

Left out until the slices that bring them: the device mesh's DCN
planning (slice 8: the port's world is one flat process group), the
streaming backlog (slice 9), SLOs, live push, the TensorBoard service
and telemetry (slice 10).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.utils.args import derive_job_type
from elasticdl_tpu_torch.utils.constants import JobType, TaskType
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec


# how long a re-formation's standby refill waits for the new world's
# first step-task pull before it spawns anyway
STANDBY_REFILL_WAIT_SECS = 60.0
# how long a death in a multi-slice world waits for the rest of its slice
# to be seen dead: a slice's processes die within moments of each other,
# and a poll that fell between two of them would take a slice loss for a
# crash of one process
SLICE_DEATH_SETTLE_SECS = 2.0


class SimulatedMasterCrash(BaseException):
    """Raised by the in-process master kill (``Master.request_crash``):
    unwinds the run loop PAST every cleanup path (``stop()`` is never
    reached), the in-process analogue of SIGKILL.  A BaseException, so
    that no ``except Exception`` recovery can survive it."""


class Master:
    def __init__(self, args, instance_manager_factory=None):
        self._args = args
        self.job_type = derive_job_type(args)
        self._stop_requested = False
        self._job_failed = False
        self._heartbeat_timeout_secs = args.heartbeat_timeout_secs or 0.0
        self.reform_events: list[dict] = []
        # task-stream relaunches: {"detected_at", "dead_worker", "worker_id"}
        self.relaunch_events: list[dict] = []
        # callbacks(cluster_version, dead_workers, reason) invoked on
        # every re-formation — chaos invariant checking
        self.reform_callbacks: list = []
        # elective re-formation: external threads request, the run loop
        # performs (writes-guarded by the lock)
        self._reform_requested: str | None = None
        self._reform_request_lock = threading.Lock()

        self._spec = get_model_spec(
            args.model_zoo, args.model_def, model_params=args.model_params_dict
        )

        def shards_for(origin):
            if not origin:
                return {}
            return create_data_reader(
                origin,
                records_per_task=args.records_per_task,
                custom_reader=self._spec.custom_data_reader,
                **args.data_reader_params_dict,
            ).create_shards()

        self.task_d = TaskDispatcher(
            shards_for(args.training_data),
            shards_for(args.validation_data),
            shards_for(args.prediction_data),
            records_per_task=args.records_per_task,
            num_epochs=args.num_epochs,
            task_timeout_secs=args.task_timeout_secs,
            shuffle_seed=args.shuffle_seed,
        )
        self.evaluation_service = None
        if (
            self.job_type
            in (JobType.TRAINING_WITH_EVALUATION, JobType.EVALUATION_ONLY)
            and self._spec.eval_metrics_fn is not None
        ):
            eval_only = self.job_type == JobType.EVALUATION_ONLY
            self.evaluation_service = EvaluationService(
                None,  # the TensorBoard service comes with slice 10
                self.task_d,
                self._spec.eval_metrics_fn,
                start_delay_secs=args.evaluation_start_delay_secs,
                # the time-based trigger is for a job that trains; an
                # eval-only job evaluates once
                throttle_secs=0 if eval_only else args.evaluation_throttle_secs,
                evaluation_steps=args.evaluation_steps,
                eval_only=eval_only,
            )
            if (
                self.job_type == JobType.TRAINING_WITH_EVALUATION
                and not args.evaluation_steps
                and not args.evaluation_throttle_secs
            ):
                # neither trigger: one final evaluation when training
                # drains, before the SAVE_MODEL callback below
                self.task_d.add_deferred_callback(
                    lambda: self.evaluation_service.add_evaluation_task()
                )
        if args.output and self.job_type in (
            JobType.TRAINING_ONLY,
            JobType.TRAINING_WITH_EVALUATION,
        ):
            self.task_d.add_deferred_callback_create_save_model_task(args.output)
        self.servicer = MasterServicer(
            args.minibatch_size, self.task_d, evaluation_service=self.evaluation_service
        )
        # peer state replication (off by default: heartbeats and
        # re-formations are then those of a job without it)
        self.replica_directory = None
        if args.replication:
            from elasticdl_tpu_torch.replication.directory import ReplicaDirectory
            from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy

            self.replica_directory = ReplicaDirectory(
                # the harvest takes the job's deadline policy (its
                # state-transfer tier); None keeps the fixed timeout
                deadlines=DeadlinePolicy.from_secs(args.rpc_deadline_secs)
                if args.rpc_deadline_secs is not None
                else None
            )
            self.servicer.set_replica_directory(self.replica_directory)
        self._server = None
        self._port = None
        self.instance_manager = (
            instance_manager_factory(self) if instance_manager_factory else None
        )
        # slice-granular elasticity and the autoscaler (off by default:
        # with no --num_slices, --min_slices or --autoscale_* flag every
        # path below is dormant)
        self._min_slices = args.min_slices or 1
        # parked: below --min_slices, tasks re-queued and fenced, no world
        # running, the master waiting quiesced for a capacity grant
        self._parked = False
        # the replica stage harvested at the park, held for the world
        # that un-parks (it restores from peer RAM all the same)
        self._parked_stage: dict | None = None
        from elasticdl_tpu_torch.master.autoscaler import build_autoscaler

        self.autoscaler = build_autoscaler(
            args, getattr(self.instance_manager, "fleet_slices", 1)
        )
        if self.autoscaler is not None:
            # the p95 step time rides the version reports
            self.servicer.add_version_observer(self.autoscaler.note_version)
        # master high availability (off by default: with no
        # --master_journal_dir no journal exists, no address file is
        # written and heartbeats carry no boot id)
        self.journal = None
        self._journal_dir = args.master_journal_dir or ""
        self._events_path = args.envs_dict.get(chaos_hooks.EVENTS_ENV, "")
        # the pending set is mutated by RPC handler threads (a re-home
        # discards) while the run loop iterates it
        self._rehome_lock = threading.Lock()
        self._rehome_pending: set[int] = set()  # guarded-by: _rehome_lock
        self._rehome_deadline: float | None = None
        self._restored_world: dict | None = None
        self._restored = False
        self._restart_at: float | None = None
        # {"generation", "replay_secs", "journal_bytes", ...} of a restore
        self.restore_info: dict | None = None
        # {worker_id: {"pid", "adopted", "kept", "requeued", "at"}} of this life
        self.rehomed: dict[int, dict] = {}
        # the armed in-process kill site ("tick" or "reform"), or None
        self._crash_armed: str | None = None
        self.crashed_at: float | None = None
        # monotonic time of a restored master's first served worker call
        # (the end of its outage)
        self.first_rpc_at: float | None = None
        if self._journal_dir:
            from elasticdl_tpu_torch.master import journal as journal_mod

            restored = journal_mod.load_state(self._journal_dir)
            restored_callbacks = 0
            if restored is not None and not restored.get("clean_shutdown"):
                restored_callbacks = self._restore_from_journal(restored)
            self.journal = journal_mod.MasterJournal(self._journal_dir)
            self.journal.set_callbacks_invoked(restored_callbacks)
            self.servicer.set_journal(self.journal)
            self.servicer.set_rehome_sink(self._on_worker_rehomed)
            self.servicer.set_stage_released_sink(self.journal.record_stage_released)
            self.servicer.set_event_sink(self._record_event)
            self.servicer.set_boot_id(uuid.uuid4().hex)
            if self._restored:
                self.servicer.set_served_sink(self._note_served)
            # attach UNARMED (the backlog replay below is state the
            # initial snapshot already carries), then snapshot and arm
            self.task_d.add_observer(self.journal)
            self.servicer.add_version_observer(self.journal.on_version_report)
            self.journal.set_snapshot_provider(self._journal_snapshot)
            self.journal.start()

    # ---- master high availability ------------------------------------------

    def _record_event(self, event: str, **fields):
        """One record of the chaos event log (``chaos/hooks.py``): the
        master's restart and its workers' re-homes."""
        chaos_hooks.append_event(
            self._events_path,
            {"observation": event, "time": time.time(), "monotonic": time.monotonic(), **fields},
        )

    # single-threaded: replay runs from __init__, before the RPC server
    # and the run loop exist
    def _restore_from_journal(self, state: dict) -> int:
        """Install the journal-replayed control plane: the dispatcher's
        todo and doing sets, the generation fence, the model-version
        floor, the memoized step stream and the consumed deferred
        callbacks.  Returns the consumed-callback count (the journal
        writer resumes from it)."""
        from elasticdl_tpu_torch.master.journal import journal_path

        control = state.get("servicer", {})
        generation = int(control.get("cluster_version", 0))
        self._restart_at = time.monotonic()
        self._restored = True
        self.task_d.restore_state(state["dispatcher"])
        self.servicer.restore_control_state(
            cluster_version=generation,
            model_version=int(control.get("model_version", 0)),
            stream=control.get("stream"),
            outage_leases=self.task_d.snapshot()["active"],
        )
        consumed = int(state.get("callbacks_invoked", 0))
        self.task_d.drop_deferred_callbacks(consumed)
        world = state.get("world")
        if world:
            self._restored_world = world
            self._rehome_pending = set(world["worker_ids"])
            if world.get("parked"):
                # the previous life parked below --min_slices: this one
                # comes back parked (prepare() starts no world; the parked
                # replica stage died with the old master's RAM, so the
                # world that un-parks restores from disk)
                self._parked = True
        # the staged replica payload was the previous life's RAM and died
        # with it: a complete stage for a still-restoring generation means
        # those workers now take the disk fallback
        stage = state.get("stage")
        stage_lost = bool(
            stage and stage.get("complete") and stage["generation"] >= generation
        )
        if stage_lost:
            logger.warning(
                "Journal records a staged replica set (generation %d, version "
                "%s) lost with the previous master; restoring workers fall "
                "back to disk", stage["generation"], stage.get("version"),
            )
        snap = self.task_d.snapshot()
        path = journal_path(self._journal_dir)
        self.restore_info = {
            "generation": generation,
            "replay_secs": time.monotonic() - self._restart_at,
            "journal_bytes": sum(
                os.path.getsize(p) for p in (path, f"{path}.1", f"{path}.2", f"{path}.3")
                if os.path.exists(p)
            ),
            "pending": snap["pending"] + snap["pending_eval"],
            "active": len(snap["active"]),
            "epoch": snap["epoch"],
            "model_version": self.servicer.get_model_version(),
            "world": sorted(self._rehome_pending),
            "stage_lost": stage_lost,
        }
        self._record_event("master_restart", cluster_version=generation, **self.restore_info)
        logger.warning(
            "Master restored from journal: generation %d, epoch %d, %d pending "
            "/ %d active task(s), expecting %s to re-home",
            generation, snap["epoch"], snap["pending"] + snap["pending_eval"],
            len(snap["active"]), sorted(self._rehome_pending) or "no workers",
        )
        return consumed

    def _journal_snapshot(self, append):
        """Assemble the full control-plane state and ``append`` it as a
        journal ``snapshot`` record (run loop only).  The dispatcher
        capture and the append happen under the dispatcher transition
        lock, so no delta can land between them; the servicer fields
        captured just before are safe (replay applies generation and
        version deltas with max guards, and the stream field is
        superseded by the ``stream_snapshot`` journaled right after)."""
        servicer_state = {
            "cluster_version": self.servicer.cluster_version,
            "model_version": self.servicer.get_model_version(),
            "stream": self.servicer.stream_snapshot(),
        }
        world = self._restored_world
        self.task_d.atomic_state_snapshot(
            lambda dispatcher_state: append(
                {
                    "dispatcher": dispatcher_state,
                    "servicer": servicer_state,
                    "callbacks_invoked": self.journal.callbacks_invoked
                    if self.journal is not None
                    else 0,
                    "world": world,
                }
            )
        )
        self.servicer.journal_stream_snapshot()

    def _record_world(self):
        """Journal the live world's composition: what a restarted master
        waits on for re-homing."""
        im = self.instance_manager
        if im is None:
            return
        ids = im.worker_ids()
        world = {
            "cluster_version": self.servicer.cluster_version,
            "worker_ids": sorted(ids),
            "world_size": getattr(im, "world_size", len(ids)),
            "num_slices": getattr(im, "world_num_slices", 1),
            "slices": {
                str(k): int(v)
                for k, v in (im.worker_slices() if hasattr(im, "worker_slices") else {}).items()
            },
            # a restarted master comes back parked, and does not relaunch
            # a fleet the capacity cannot run
            "parked": self._parked,
        }
        self._restored_world = world
        if self.journal is not None:
            self.journal.record_world(
                world["cluster_version"], world["worker_ids"], world["world_size"],
                num_slices=world["num_slices"], slices=world["slices"],
                parked=world["parked"],
            )

    def _on_worker_rehomed(self, worker_id, pid, kept, requeued, started_at):
        """Servicer rehome sink: adopt the orphaned process (the dead
        master spawned it; this one holds no handle) and settle the
        re-home wait."""
        im = self.instance_manager
        adopted = bool(im is not None and pid and im.adopt_worker(worker_id, pid))
        with self._rehome_lock:
            self._rehome_pending.discard(worker_id)
        now = time.monotonic()
        self.rehomed[worker_id] = {
            "pid": pid, "adopted": adopted, "kept": list(kept), "requeued": list(requeued),
            "at": now,
        }
        self._record_event(
            "worker_rehome", worker_id=worker_id, pid=pid, accepted=True, adopted=adopted,
            cluster_version=self.servicer.cluster_version, kept=list(kept),
            requeued=list(requeued), handshake_secs=now - started_at,
        )

    def _check_rehome_deadline(self):
        """Run-loop tick: a restored master waits a bounded grace for its
        journaled world to re-home; workers that never do are dead."""
        if self._rehome_deadline is None:
            return
        with self._rehome_lock:
            if not self._rehome_pending:
                self._rehome_deadline = None
                logger.info("All restored workers re-homed")
                return
            if time.monotonic() < self._rehome_deadline:
                return
            pending = sorted(self._rehome_pending)
            self._rehome_pending = set()
        self._rehome_deadline = None
        # a pending worker that heartbeated THIS life is alive even if it
        # never presented the handshake (spawned just before the outage,
        # it may never have seen the previous boot id): settle it
        alive = set(self.servicer.live_workers())
        settled = [w for w in pending if w in alive]
        missing = [w for w in pending if w not in alive]
        if settled:
            logger.info("Workers %s heartbeated without re-homing; settled", settled)
        if not missing:
            return
        logger.warning(
            "Workers %s never re-homed after the master restart; recovering "
            "their tasks", missing,
        )
        self._handle_dead_workers(missing)

    def request_crash(self, site: str = "tick"):
        """Arm an in-process master kill at a named site: ``"tick"`` dies
        at the next run-loop tick, ``"reform"`` inside the next
        re-formation after the fence (generation journaled, old world
        fenced and its tasks recovered, no new world launched).  The kill
        has SIGKILL semantics: the RPC server stops at once, the
        journal's unflushed tail is dropped, and no cleanup runs."""
        self._crash_armed = site

    def _crash_if_armed(self, site: str):
        if self._crash_armed != site:
            return
        self._crash_armed = None
        logger.warning("CHAOS: simulating master kill at %r (SIGKILL semantics)", site)
        self.crashed_at = time.monotonic()
        if self._server is not None:
            self._server.stop(grace=0)
            self._server = None
        if self.journal is not None:
            self.journal.abort()
        raise SimulatedMasterCrash(site)

    # ---- lifecycle ---------------------------------------------------------

    @property
    def port(self):
        return self._port

    def prepare(self, port: int | None = None):
        """Start the control-plane server, then the workers (a restored
        master whose journaled world may still be alive waits for it to
        re-home instead)."""
        from elasticdl_tpu_torch.rpc.service import create_server

        if self.evaluation_service is not None:
            self.evaluation_service.start()
        port = port if port is not None else self._args.port
        self._server = create_server(self.servicer, port)
        self._server.start()
        self._port = self._server.port
        if self.journal is not None:
            # publish the (possibly new) address: workers that outlived a
            # previous master re-resolve from this file
            from elasticdl_tpu_torch.master.journal import write_master_addr

            write_master_addr(self._journal_dir, f"localhost:{self._port}")
        im = self.instance_manager
        if im is None:
            return
        with self._rehome_lock:
            rehome_wait = sorted(self._rehome_pending)
        if self._restored and rehome_wait:
            # the journaled world may outlive the dead master: do NOT
            # start a second world on top of it; the grace deadline
            # recovers whatever never comes back
            im.reserve_worker_ids(max(rehome_wait) + 1)
            restored = self._restored_world or {}
            if restored.get("num_slices", 1) > 1 and hasattr(im, "set_world_slices"):
                im.set_world_slices(restored["num_slices"])
            elif "world_size" in restored and hasattr(im, "set_world_size"):
                im.set_world_size(restored["world_size"])
            if restored.get("slices") and hasattr(im, "restore_worker_slices"):
                # the re-homed world keeps its slice map, so that a slice
                # loss after the restart still shrinks it right
                im.restore_worker_slices(restored["slices"])
            grace = self._args.rehome_grace_secs
            if grace is None:
                grace = max(10.0, 3.0 * self._heartbeat_timeout_secs)
            self._rehome_deadline = time.monotonic() + grace
            logger.warning(
                "Waiting up to %.1fs for workers %s to re-home", grace, rehome_wait
            )
        elif self._restored and self._parked:
            # restored PARKED: relaunching the fleet would crash-loop on
            # capacity that is not there; a capacity grant or an autoscale
            # grow un-parks
            if hasattr(im, "set_world_slices"):
                im.set_world_slices((self._restored_world or {}).get("num_slices", 1))
            self.servicer.begin_quiesce()
            logger.warning(
                "Master restored PARKED (capacity below --min_slices %d); waiting "
                "quiesced for a capacity grant", self._min_slices,
            )
        else:
            im.start_workers()
            self._record_world()

    def _note_served(self):
        """Servicer served sink (a restored master's): the first served
        worker call ends the outage."""
        with self._rehome_lock:
            if self.first_rpc_at is not None:
                return
            self.first_rpc_at = time.monotonic()
        # for a master relaunched in its own process the chaos event log
        # is the one place this shows
        self._record_event("master_serving", generation=self.servicer.cluster_version)

    def run(self, poll_secs: float = 0.5) -> int:
        """Poll until all tasks (the deferred SAVE_MODEL included) are
        done; 0 on success, 1 when the job gave up."""
        try:
            while True:
                self._crash_if_armed("tick")
                if self.task_d.finished() and not (
                    self.task_d.invoke_deferred_callback()
                ):
                    break
                if self._stop_requested:
                    break
                # a restored master first waits for its journaled world
                # to re-home (bounded by the grace deadline)
                self._check_rehome_deadline()
                if self.journal is not None:
                    self.journal.maybe_snapshot()
                if self.instance_manager is not None:
                    # process exits: an abnormal exit is detected in one
                    # poll instead of a heartbeat timeout
                    for worker_id in self.instance_manager.poll_failed_workers():
                        self.servicer.mark_worker_dead(worker_id)
                dead = self.servicer.dead_workers(self._heartbeat_timeout_secs)
                if dead and self.instance_manager is not None:
                    # a killed stale worker's last RPC can re-register its
                    # id after forget_worker: ids the instance manager no
                    # longer tracks are ghosts, not failures
                    live = set(self.instance_manager.worker_ids())
                    for ghost in [w for w in dead if w not in live]:
                        self.servicer.forget_worker(ghost)
                    dead = [w for w in dead if w in live]
                if dead:
                    self._handle_dead_workers(dead)
                elif self._reform_requested is not None:
                    with self._reform_request_lock:
                        reason, self._reform_requested = self._reform_requested, None
                    im = self.instance_manager
                    target = getattr(im, "world_size", None)
                    if target is not None and len(im.worker_ids()) == target:
                        # a failure's re-formation between the request and
                        # this tick already made a world of the target
                        # size: another would be pure downtime
                        logger.info(
                            "Skipping elective re-formation (%s): world already "
                            "at target size", reason,
                        )
                    else:
                        self._reform_lockstep([], reason=reason)
                if self.autoscaler is not None and not dead:
                    # the autoscaler only requests a resize; the next tick
                    # performs it through the elective path above
                    self._autoscale_tick()
                if self.relaunch_events and "latency_secs" not in self.relaunch_events[-1]:
                    # relaunch latency: detection to the new worker's
                    # first task lease
                    event = self.relaunch_events[-1]
                    lease_at = self.servicer.first_lease_at(event["worker_id"])
                    if lease_at is not None:
                        event["latency_secs"] = lease_at - event["detected_at"]
                if (
                    self.reform_events
                    and "latency_secs" not in self.reform_events[-1]
                ):
                    # re-formation latency: detection to the new world's
                    # first step-task pull
                    pull_at = self.servicer.first_stream_pull_at()
                    if pull_at is not None:
                        event = self.reform_events[-1]
                        event["latency_secs"] = pull_at - event["detected_at"]
                        logger.info(
                            "World re-formed in %.2fs (cluster version %d)",
                            event["latency_secs"], event["cluster_version"],
                        )
                time.sleep(poll_secs)
        except KeyboardInterrupt:
            logger.warning("Interrupted; shutting down")
        self.stop()
        return 1 if self._job_failed else 0

    def _handle_dead_workers(self, dead: list[int]):
        """A lockstep world is one program: any death re-forms it whole.
        Task-stream workers are independent: re-queue the dead worker's
        leases and relaunch it under a new id."""
        im = self.instance_manager
        if im is not None and im.lockstep:
            self._reform_lockstep(self._settle_slice_deaths(dead), reason="worker_failure")
            return
        for worker_id in dead:
            detected_at = time.monotonic()
            logger.warning("Worker %d died; recovering its tasks", worker_id)
            self.task_d.recover_tasks(worker_id)
            self.servicer.forget_worker(worker_id)
            if im is None:
                continue
            try:
                new_id = im.restart_worker(worker_id)
            except RuntimeError as ex:
                logger.error("Giving up on the job: %s", ex)
                self._job_failed = True
                self.request_stop()
                return
            self.relaunch_events.append(
                {"detected_at": detected_at, "dead_worker": worker_id, "worker_id": new_id}
            )
            # the journaled world names the relaunched worker, so that a
            # restarted master waits for it and not for the dead one
            self._record_world()

    def _reform_lockstep(self, dead: list[int], reason: str):
        """Fence, recover, relaunch: the whole-world re-formation.
        ``dead`` may be empty (an elective re-formation).

        On a multi-slice fleet a whole slice's death shrinks the next
        world to the surviving slices, a capacity grant grows it back,
        and a shrink below ``--min_slices`` parks the job instead of
        relaunching."""
        im = self.instance_manager
        t0 = time.monotonic()
        if self._parked and not dead:
            target = getattr(im, "world_num_slices", 1)
            if target < self._min_slices:
                # parked below the floor: only a request that restores at
                # least --min_slices relaunches a world
                logger.warning(
                    "Job parked below --min_slices %d; ignoring re-formation "
                    "request (%s) targeting %d slice(s)",
                    self._min_slices, reason, target,
                )
                return
        logger.warning(
            "Re-forming the distributed world (%s; dead workers: %s)",
            reason, dead or "none",
        )
        # any re-formation satisfies a pending elective request
        with self._reform_request_lock:
            self._reform_requested = None
        # a re-formation supersedes any outstanding re-home wait: the world
        # being fenced and relaunched IS the recovery
        self._rehome_deadline = None
        with self._rehome_lock:
            self._rehome_pending = set()
        # fence FIRST: from here every stale worker's get_step_task is
        # refused, so none can lease a task we are about to recover
        new_version = self.servicer.bump_cluster_version()
        all_ids = set(dead) | set(im.worker_ids())
        old_world_size = len(all_ids)
        worker_slices = im.worker_slices() if hasattr(im, "worker_slices") else {}
        # the LIVE world's slice count comes from its slice map ({}: one
        # slice); world_num_slices is the NEXT world's, which a capacity
        # grant or an autoscale decision has moved already
        old_slices = len(set(worker_slices.values())) or 1
        # a fully dead slice is lost capacity: the next world shrinks to
        # the surviving slices, and parks below --min_slices
        park = self._plan_slice_topology(new_version, dead, old_slices, worker_slices, t0)
        # harvest the survivors' replica shards BEFORE the loop below
        # forgets them (the directory drops their addresses) and before
        # the relaunch kills them (their RAM dies with them)
        harvest = self._stage_replica_restore(new_version, dead, old_world_size)
        for worker_id in all_ids:
            self.task_d.recover_tasks(worker_id)
            self.servicer.forget_worker(worker_id)
        self.servicer.reset_step_stream()
        # the master kill's "reform" site: generation bumped and
        # journaled, old world fenced and its tasks recovered, no new
        # world launched yet
        self._crash_if_armed("reform")
        if park:
            self._park(new_version, reason)
            self._notify_reform(new_version, dead, reason)
            return
        new_world_size = getattr(im, "world_size", old_world_size)
        new_slices = getattr(im, "world_num_slices", old_slices)
        if new_world_size != old_world_size or new_slices != old_slices:
            self._record_event(
                "mesh_resize", generation=new_version, old_world_size=old_world_size,
                new_world_size=new_world_size, old_slices=old_slices, new_slices=new_slices,
            )
        try:
            im.reform_world(
                new_version,
                # only failure recovery spends the crash-loop budget
                count_against_budget=reason == "worker_failure",
            )
        except RuntimeError as ex:
            logger.error("Giving up on the job: %s", ex)
            self._job_failed = True
            self.request_stop()
            return
        if self._parked:
            # a world runs again: a capacity grant or an autoscale grow
            # ended the park
            self._parked = False
            self.servicer.clear_quiesce()
            logger.warning("Job UNPARKED: world relaunched with %d slice(s)", new_slices)
        if self.autoscaler is not None:
            self.autoscaler.note_reform()
        self._record_world()
        event = {
            "detected_at": t0,
            "cluster_version": new_version,
            "dead_workers": sorted(dead),
            "reason": reason,
        }
        if harvest is not None:
            event["harvest"] = harvest
        self.reform_events.append(event)
        self._notify_reform(new_version, dead, reason)

    def _notify_reform(self, new_version: int, dead: list[int], reason: str):
        for callback in self.reform_callbacks:
            try:
                callback(new_version, sorted(dead), reason)
            except Exception:  # noqa: BLE001 — observers never break recovery
                logger.exception("Reform callback failed")

    def _settle_slice_deaths(self, dead: list[int]) -> list[int]:
        """``dead`` and the deaths that follow it within
        ``SLICE_DEATH_SETTLE_SECS`` while a slice of a multi-slice world
        is dead in part: the rest of a lost slice is then counted with
        it.  A world of one slice, or a death that leaves no slice in
        part, returns at once."""
        im = self.instance_manager
        slices = im.worker_slices() if hasattr(im, "worker_slices") else {}
        if len(set(slices.values())) <= 1:
            return dead
        dead_set = set(dead)
        deadline = time.monotonic() + SLICE_DEATH_SETTLE_SECS

        def partial():
            return any(
                {w in dead_set for w, ws in slices.items() if ws == s} == {True, False}
                for s in set(slices.values())
            )

        while partial() and time.monotonic() < deadline:
            time.sleep(0.05)
            dead_set.update(w for w in im.poll_failed_workers() if w in slices)
        return sorted(dead_set)

    def _plan_slice_topology(
        self, new_version: int, dead: list[int], old_slices: int,
        worker_slices: dict[int, int], detected_at: float,
    ) -> bool:
        """Slice-loss accounting: slices whose EVERY process died are lost
        capacity, and the next world shrinks to the survivors.  A slice
        that died in part is a software crash (its capacity presumed
        intact): the world relaunches at full size.  True when the shrink
        falls below ``--min_slices`` (the caller parks instead)."""
        if not dead or old_slices <= 1 or not worker_slices:
            return False
        dead_set = set(dead)
        lost = sorted(
            {
                s for s in set(worker_slices.values())
                if all(w in dead_set for w, ws in worker_slices.items() if ws == s)
            }
        )
        if not lost:
            return False
        if len(lost) >= old_slices:
            # the whole world died at once: not told apart from a
            # deterministic crash, so relaunch at full size (the budget
            # bounds a crash loop) rather than shrink to nothing
            logger.warning(
                "All %d slices report dead; treating as a whole-world crash "
                "(full-size relaunch), not a capacity loss", old_slices,
            )
            return False
        new_slices = old_slices - len(lost)
        park = new_slices < self._min_slices
        self._record_event(
            "slice_loss", generation=new_version, lost_slices=lost,
            dead_workers=sorted(dead), old_slices=old_slices, new_slices=new_slices,
            parked=park, detected_at=detected_at,
        )
        logger.warning(
            "Slice loss: slice(s) %s fully dead; shrinking the next world from %d "
            "to %d slice(s)%s", lost, old_slices, new_slices,
            " (BELOW --min_slices: parking)" if park else "",
        )
        im = self.instance_manager
        if hasattr(im, "set_world_slices"):
            im.set_world_slices(max(1, new_slices))
        return park

    def _park(self, new_version: int, reason: str):
        """Graceful degradation: the surviving capacity is below
        ``--min_slices``.  Tear the world down (its tasks are re-queued
        and its generation fenced already), hold the harvested replica
        stage for the world that un-parks, and wait quiesced."""
        self._parked = True
        # the stage was made for THIS generation, which will never run:
        # the master keeps it, and the un-parking re-formation re-stamps it
        self._parked_stage = self.servicer.take_restore_stage()
        self.servicer.begin_quiesce()
        im = self.instance_manager
        if hasattr(im, "teardown_world"):
            im.teardown_world(budget=False)
        else:  # no teardown of its own: a hard stop is the nearest
            im.stop_workers(grace_secs=0.0)
        if self.autoscaler is not None:
            self.autoscaler.note_reform()
        self._record_world()
        logger.warning(
            "Job PARKED quiesced (generation %d, %s): surviving capacity is below "
            "--min_slices %d; waiting for a capacity grant",
            new_version, reason, self._min_slices,
        )

    def _autoscale_tick(self):
        """Run-loop tick: the autoscaler's decision becomes a resize of
        the next world and an elective re-formation request."""
        im = self.instance_manager
        if im is None or not getattr(im, "lockstep", False):
            return
        snap = self.task_d.snapshot()
        backlog = snap["pending"] + snap["pending_eval"]
        decision = self.autoscaler.evaluate(backlog, getattr(im, "world_num_slices", 1))
        if decision is None:
            return
        if hasattr(im, "set_world_slices"):
            im.set_world_slices(decision["to_slices"])
        self._record_event(
            "autoscale_decision", generation=self.servicer.cluster_version, **decision
        )
        logger.warning(
            "Autoscale %s: %d -> %d slice(s) (%s)", decision["action"],
            decision["from_slices"], decision["to_slices"], decision["reason"],
        )
        self.request_reform(f"autoscale:{decision['action']}")

    def _stage_replica_restore(
        self, new_version: int, dead: list[int], old_world_size: int
    ) -> dict | None:
        """Harvest the freshest complete replica set from the surviving
        workers' RAM and stage it for generation ``new_version``; stages
        None (the disk fallback) when coverage is incomplete.  An
        un-parking re-formation re-stamps the stage held since the park
        instead.  Returns what the harvest found (``complete``,
        ``version``, ``bytes``, ``secs``), or None when replication is
        off."""
        if self.replica_directory is None:
            return None
        t0 = time.monotonic()
        stage = None
        if self._parked_stage is not None:
            # un-parking: the parked world's harvest waited in master RAM
            stage = dict(self._parked_stage, generation=new_version)
            self._parked_stage = None
            logger.info(
                "Unpark: serving the parked replica stage (version %s) to "
                "generation %d", stage["version"], new_version,
            )
        else:
            live = [w for w in self.instance_manager.worker_ids() if w not in set(dead)]
            try:
                stage = self.replica_directory.harvest(
                    live_worker_ids=live,
                    num_sources=old_world_size,
                    generation=new_version - 1,
                    staged_for=new_version,
                )
            except Exception:  # noqa: BLE001 — a harvest must never take
                # down recovery; the disk restore is always there
                logger.exception("Replica harvest failed; disk fallback")
        self.servicer.set_restore_stage(stage)
        if self.journal is not None:
            # metadata only: the staged payload is master RAM and dies
            # with the process (a restarted master serves the disk path)
            self.journal.record_stage(
                new_version, stage["version"] if stage else None, complete=stage is not None
            )
        found = {
            "complete": stage is not None,
            "version": stage["version"] if stage else None,
            "bytes": len(stage["payload"]) if stage else 0,
            "checksum": stage["checksum"] if stage else None,
            "secs": time.monotonic() - t0,
        }
        logger.info("Replica harvest for generation %d: %s", new_version, found)
        return found

    def request_reform(self, reason: str = "elective"):
        """Ask the run loop to re-form the world at its next tick; safe
        from any thread."""
        with self._reform_request_lock:
            self._reform_requested = reason

    def request_stop(self):
        self._stop_requested = True

    def stop(self):
        if self.evaluation_service is not None:
            self.evaluation_service.stop()
        # any polling standby learns that the job is over
        self.servicer.drain_standbys()
        if self.instance_manager is not None:
            # the voluntary-exit grace only when the queue drained: on
            # failure the world hangs in collectives
            clean_finish = not self._job_failed and self.task_d.finished()
            self.instance_manager.stop_workers(
                grace_secs=15.0 if clean_finish else 0.0
            )
        if self._server is not None:
            self._server.stop(grace=2)
            self._server = None
        if self.journal is not None:
            # a clean end is journaled: a relaunch knows there is nothing
            # to recover, and waits for no re-homes
            self.journal.record_job_end(1 if self._job_failed else 0)

    def job_summary(self) -> dict:
        out = {"job_type": self.job_type.value, "epoch": self.task_d.epoch}
        for tt in (TaskType.TRAINING, TaskType.EVALUATION, TaskType.PREDICTION):
            c = self.task_d.counters(tt)
            if c.total_records:
                out[tt.name.lower()] = {
                    "total_records": c.total_records,
                    "failed_records": c.failed_records,
                }
                if c.exec_metrics:
                    out[tt.name.lower()]["exec_metrics"] = dict(c.exec_metrics)
        summary = getattr(self.evaluation_service, "latest_summary", None)
        if summary:
            out["evaluation_metrics"] = summary
        if self.replica_directory is not None:
            out["replication"] = self.replica_directory.coverage_stats()
        if self.reform_events:
            keep = ("cluster_version", "dead_workers", "latency_secs", "reason", "harvest")
            out["reforms"] = [
                {k: v for k, v in event.items() if k in keep}
                for event in self.reform_events
            ]
        return out


class _AdoptedProcess:
    """Popen-alike handle for a worker process THIS master did not spawn:
    it outlived a previous master (orphaned, re-parented to init) and
    re-homed with its pid.  The subset of the Popen surface the instance
    manager uses (poll, kill, terminate, wait), by signals: a restarted
    master cannot ``waitpid`` a non-child.

    ``poll`` cannot observe a non-child's exit code: a vanished pid
    reports -1 with ``exit_unknown`` set (a clean exit at the stream's
    end looks the same: :meth:`LocalInstanceManager.poll_failed_workers`
    tells them apart)."""

    def __init__(self, pid: int):
        self.pid = pid
        self._rc: int | None = None
        self.exit_unknown = False

    def poll(self):
        if self._rc is not None:
            return self._rc
        try:
            # a master killed in process leaves its workers children of
            # this process: reap one that exited, with its exit code
            pid, status = os.waitpid(self.pid, os.WNOHANG)
            if pid:
                self._rc = os.waitstatus_to_exitcode(status)
                return self._rc
        except ChildProcessError:
            pass
        try:
            os.kill(self.pid, 0)
        except (ProcessLookupError, PermissionError):
            # gone, or the pid now belongs to someone else (reuse)
            self._rc, self.exit_unknown = -1, True
            return self._rc
        if _is_zombie(self.pid):
            # exited, and its parent (not this process) has not reaped it
            self._rc, self.exit_unknown = -1, True
        return self._rc

    def _signal(self, sig):
        try:
            os.kill(self.pid, sig)
        except (ProcessLookupError, PermissionError):
            self._rc = self._rc if self._rc is not None else -1

    def terminate(self):
        self._signal(signal.SIGTERM)

    def kill(self):
        self._signal(signal.SIGKILL)

    def wait(self, timeout: float | None = None):
        deadline = time.monotonic() + timeout if timeout is not None else None
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
            time.sleep(0.05)
        return self._rc


def _is_zombie(pid: int) -> bool:
    """Whether ``pid`` has exited and waits for its parent to reap it
    (``/proc``; False where there is none)."""
    try:
        with open(f"/proc/{pid}/stat", encoding="ascii") as f:
            return f.read().rpartition(")")[2].split()[0] == "Z"
    except (OSError, IndexError):
        return False


class LocalInstanceManager:
    """Workers as local subprocesses.  With ``lockstep`` (and two or more
    workers) they form one ``torch.distributed`` world: this manager
    picks the coordinator port, assigns process ids 0..N-1 and re-forms
    the whole world on failure (:meth:`reform_world`).  Otherwise each is
    a task-stream worker, relaunched alone under a new id
    (:meth:`restart_worker`).  Either way ``max_reforms``
    (``--relaunch_on_worker_failure``) bounds the relaunches a failure
    may cost.

    A lockstep fleet may split into ``num_slices`` slices of equal
    process counts: worlds then resize in whole slices (a slice loss
    shrinks the next world, a capacity grant grows it back), and each
    process learns its slice coordinates from its world kwargs.  A
    lockstep job keeps ``standby_workers`` warm standby processes
    (``-1``: as many as the world has processes): each has paid its
    imports and waits on its stdin, and a new world is handed to them
    before any process is cold-started."""

    def __init__(
        self, master, num_workers: int, build_argv, envs=None,
        lockstep: bool = True, max_reforms: int = 3,
        standby_workers: int = -1, num_slices: int = 1,
    ):
        self._master = master
        self._num_workers = num_workers
        # (worker_id, master_addr, **world_kwargs) -> argv
        self._build_argv = build_argv
        self._envs = dict(envs or {})
        self.lockstep = lockstep and num_workers > 1
        self._max_reforms = max_reforms
        num_slices = max(1, int(num_slices or 1))
        if num_slices > 1 and not self.lockstep:
            logger.warning(
                "--num_slices applies only to lockstep jobs (num_workers > 1); "
                "ignoring"
            )
            num_slices = 1
        if num_slices > 1 and num_workers % num_slices:
            raise ValueError(
                f"--num_workers {num_workers} not divisible by --num_slices "
                f"{num_slices}: the local backend needs equal processes per slice"
            )
        self._fleet_slices = num_slices
        self._procs_per_slice = num_workers // num_slices
        self._world_slices = num_slices
        # worker_id -> slice_id of the live world (the master's slice-loss
        # accounting and the journal's world record read it)
        self._worker_slices: dict[int, int] = {}
        self._reforms = 0
        self._procs: dict[int, subprocess.Popen] = {}
        self._next_worker_id = 0
        self._lock = threading.Lock()
        # the hot-standby pool: only a lockstep world re-forms whole, so
        # only there does a pool pay
        if standby_workers < 0:
            standby_workers = num_workers if self.lockstep else 0
        if standby_workers > 0 and not self.lockstep:
            logger.warning(
                "--standby_workers applies only to lockstep jobs (num_workers > 1); "
                "ignoring"
            )
        self._standby_target = standby_workers if self.lockstep else 0
        self._standbys: list = []
        self._draining = False
        self.standby_activations = 0
        # {"worker_id", "pid", "at"} of each activation (monotonic "at":
        # when the assignment was written)
        self.activations: list[dict] = []
        # the size of the next world: a slice loss or a capacity fault
        # shrinks it below num_workers
        self._world_size = num_workers

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def max_world_size(self) -> int:
        """The configured fleet: what a full capacity grant grows back to."""
        return self._num_workers

    @property
    def fleet_slices(self) -> int:
        """The slice count of the whole fleet (``--num_slices``)."""
        return self._fleet_slices

    @property
    def world_num_slices(self) -> int:
        """The slice count of the NEXT world (the live one's outside a
        resize)."""
        return self._world_slices

    def set_world_size(self, n: int):
        """Resize the NEXT world (the live one is untouched until a
        re-formation: ``Master.request_reform``), clamped to [1,
        num_workers].  On a multi-slice fleet the size snaps down to
        whole slices."""
        n = max(1, min(self._num_workers, int(n)))
        if self._fleet_slices > 1:
            slices = max(1, n // self._procs_per_slice)
            self._world_slices = min(slices, self._fleet_slices)
            n = self._world_slices * self._procs_per_slice
        self._world_size = n

    def set_world_slices(self, n: int):
        """Resize the NEXT world in slices (a slice loss shrinks it, a
        capacity grant grows it)."""
        n = max(1, min(self._fleet_slices, int(n)))
        self._world_slices = n
        self._world_size = min(self._num_workers, n * self._procs_per_slice)

    def worker_slices(self) -> dict[int, int]:
        """worker_id -> slice_id of the live world ({} in one slice)."""
        with self._lock:
            return dict(self._worker_slices)

    def restore_worker_slices(self, mapping: dict):
        """Install a journal-restored world's slice map (a restarted
        master adopts workers it never spawned)."""
        with self._lock:
            self._worker_slices = {int(k): int(v) for k, v in (mapping or {}).items()}

    def worker_ids(self) -> list[int]:
        with self._lock:
            return list(self._procs)

    def worker_pid(self, worker_id: int) -> int | None:
        with self._lock:
            proc = self._procs.get(worker_id)
        return proc.pid if proc is not None else None

    def adopt_worker(self, worker_id: int, pid: int) -> bool:
        """Track a worker a PREVIOUS master spawned (it re-homed after a
        master restart): from here it is polled, fenced and killed like
        any spawned worker.  False when the id is tracked already."""
        with self._lock:
            if worker_id in self._procs:
                return False
            self._procs[worker_id] = _AdoptedProcess(pid)
            self._next_worker_id = max(self._next_worker_id, worker_id + 1)
        logger.info("Adopted re-homed worker %d (pid %d)", worker_id, pid)
        return True

    def reserve_worker_ids(self, next_id: int):
        """A restored master's new workers take ids past its journaled
        world's, so that no id names two processes."""
        with self._lock:
            self._next_worker_id = max(self._next_worker_id, next_id)

    def start_workers(self):
        if self.lockstep:
            self._start_world(cluster_version=0)
            self._refill_in_background()
        else:
            for _ in range(self._num_workers):
                self._start(self._claim_worker_id())

    def _claim_worker_id(self) -> int:
        with self._lock:
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            return worker_id

    def _start_world(self, cluster_version: int):
        from elasticdl_tpu_torch.parallel import elastic
        from elasticdl_tpu_torch.parallel.mesh import slice_assignments

        n = self._world_size
        coordinator = f"localhost:{elastic.pick_coordinator_port()}"
        # slice coordinates ride the world kwargs only in a multi-slice
        # world: a one-slice worker's argv is the slice-blind one
        assign = slice_assignments(n, self._world_slices) if self._world_slices > 1 else None
        with self._lock:
            self._worker_slices = {}
        for process_id in range(n):
            world = dict(
                coordinator_addr=coordinator,
                num_processes=n,
                process_id=process_id,
                cluster_version=cluster_version,
            )
            if assign is not None:
                world["slice_id"] = assign[process_id]
                world["num_slices"] = self._world_slices
            worker_id = self._claim_worker_id()
            if assign is not None:
                with self._lock:
                    self._worker_slices[worker_id] = assign[process_id]
            if not self._activate_standby(worker_id, world):
                self._start(worker_id, **world)

    def _spawn(self, worker_id: int, stdin_pipe: bool = False, **world_kwargs):
        argv = self._build_argv(
            worker_id, f"localhost:{self._master.port}", **world_kwargs
        )
        env = dict(os.environ)
        env.update(self._envs)
        # the port importable whatever the master's working directory
        import elasticdl_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(elasticdl_tpu_torch.__file__))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH", "")) if p
        )
        return subprocess.Popen(
            [sys.executable, "-m", *argv], env=env,
            stdin=subprocess.PIPE if stdin_pipe else None,
        )

    def _start(self, worker_id: int, **world_kwargs):
        proc = self._spawn(worker_id, **world_kwargs)
        with self._lock:
            self._procs[worker_id] = proc
        logger.info("Started worker %d (pid %d)", worker_id, proc.pid)

    # ---- the hot-standby pool ------------------------------------------------

    def _replenish_standbys(self):
        with self._lock:
            if self._draining:
                return
            # prune standbys that died waiting, so the pool cannot grow
            # without bound across re-formations
            self._standbys = [p for p in self._standbys if p.poll() is None]
            missing = self._standby_target - len(self._standbys)
        for _ in range(max(0, missing)):
            try:
                proc = self._spawn(0, stdin_pipe=True, standby=1)
            except OSError:
                # one failed spawn (descriptors, process limits) must not
                # end the refill
                logger.exception("Failed to spawn a standby worker; continuing")
                continue
            with self._lock:
                accepted = not self._draining
                if accepted:
                    self._standbys.append(proc)
            if not accepted:
                # stop_workers ran while this one was spawned: nobody
                # would drain it
                _close_stdin(proc)
                proc.kill()
                proc.wait()
                return
            logger.info("Spawned standby worker (pid %d)", proc.pid)

    def _refill_in_background(self, after_join: bool = False):
        """Refill the pool off the recovery path.  ``after_join``: first
        wait (up to ``STANDBY_REFILL_WAIT_SECS``) for the new world's
        first step-task pull, so that the standbys' imports do not
        compete with the world's own start on the host."""

        def refill():
            if after_join and self._master is not None:
                deadline = time.monotonic() + STANDBY_REFILL_WAIT_SECS
                while (
                    self._master.servicer.first_stream_pull_at() is None
                    and time.monotonic() < deadline
                    and not self._draining
                ):
                    time.sleep(0.1)
            self._replenish_standbys()

        if self._standby_target > 0:
            threading.Thread(target=refill, name="standby-refill", daemon=True).start()

    def _activate_standby(self, worker_id: int, world: dict) -> bool:
        """Hand a warm standby its world assignment; False when none is
        usable (the caller cold-starts instead)."""
        while True:
            with self._lock:
                if not self._standbys:
                    return False
                proc = self._standbys.pop(0)
            if proc.poll() is not None:
                continue  # died while waiting: try the next
            try:
                line = json.dumps({"worker_id": worker_id, **world}) + "\n"
                proc.stdin.write(line.encode("utf-8"))
                proc.stdin.flush()
            except (OSError, ValueError):
                proc.kill()
                continue
            with self._lock:
                self._procs[worker_id] = proc
                self.standby_activations += 1
                self.activations.append(
                    {"worker_id": worker_id, "pid": proc.pid, "at": time.monotonic()}
                )
            logger.info(
                "Activated standby pid %d as worker %d (process %d/%d)",
                proc.pid, worker_id, world["process_id"], world["num_processes"],
            )
            return True

    def _drain_standbys(self):
        with self._lock:
            self._draining = True  # fences a concurrent refill
            standbys = list(self._standbys)
            self._standbys.clear()
        for proc in standbys:
            if proc.poll() is None:
                # EOF on its stdin is a standby's clean shutdown
                _close_stdin(proc)
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    def poll_failed_workers(self) -> list[int]:
        """Worker ids whose process exited abnormally (non-zero code or a
        signal).  A zero exit is not a failure: workers exit 0 at the end
        of the stream, racing the master's own ``finished()`` check.  An
        adopted worker's code is unknown unless this process reaped it:
        one that vanished once the dispatcher had finished (no worker is
        told the stream ended before) ended with the stream."""
        with self._lock:
            failed = {
                wid: proc for wid, proc in self._procs.items()
                if proc.poll() not in (None, 0)
            }
        if failed and self._master is not None and self._master.task_d.finished():
            return [
                wid for wid, proc in failed.items() if not getattr(proc, "exit_unknown", False)
            ]
        return list(failed)

    def _kill_all(self) -> list:
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
            self._worker_slices = {}
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                logger.error("Worker pid %d survived SIGKILL for 10 s", proc.pid)
        return procs

    def restart_worker(self, worker_id: int) -> int:
        """Relaunch a task-stream worker under a NEW id (a lockstep worker
        is never replaced alone: :meth:`reform_world`); returns the new
        id.  Raises ``RuntimeError`` past the relaunch budget."""
        with self._lock:
            proc = self._procs.pop(worker_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
        self._reforms += 1
        if self._reforms > self._max_reforms:
            raise RuntimeError(
                f"workers relaunched {self._reforms - 1} times "
                f"(--relaunch_on_worker_failure limit); giving up"
            )
        new_id = self._claim_worker_id()
        self._start(new_id)
        return new_id

    def reform_world(self, cluster_version: int, count_against_budget: bool = True):
        """Kill the old world and launch a new one of ``world_size``
        processes, standbys first.  Survivors may be blocked in a
        collective that will never complete, so SIGKILL.  The old world
        is always torn down; only the relaunch is subject to the budget
        (a deterministic crash must not loop forever).  The pool is
        refilled once the new world has joined."""
        self._kill_all()
        if count_against_budget:
            self._reforms += 1
        if self._reforms > self._max_reforms:
            raise RuntimeError(
                f"world re-formed {self._reforms - 1} times "
                f"(--relaunch_on_worker_failure limit); giving up"
            )
        self._start_world(cluster_version=cluster_version)
        self._refill_in_background(after_join=True)

    def teardown_world(self, budget: bool = False):
        """Kill the live world WITHOUT relaunching (a park: the master
        harvested the replicas first).  ``budget=False``: a park is not a
        crash loop."""
        self._kill_all()
        if budget:
            self._reforms += 1

    def stop_workers(self, grace_secs: float = 15.0):
        """Drain the standbys, then give the workers ``grace_secs`` to
        exit on their own (their epilogue, a final checkpoint and state
        dump, may still be in a collective when the queue drains), then
        terminate the rest."""
        self._drain_standbys()
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        deadline = time.monotonic() + max(0.0, grace_secs)
        for proc in procs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                pass
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _close_stdin(proc):
    try:
        proc.stdin.close()
    except (OSError, AttributeError):
        pass
