"""The master: job orchestrator and control plane; the counterpart of
``elasticdl_tpu/master/master.py`` for the lockstep path.

It builds the task dispatcher over the training shards (with the
SAVE_MODEL deferred task when ``--output`` is set), serves the servicer
over ``rpc/service.py``, starts the workers through an instance manager
(:class:`LocalInstanceManager`: local subprocesses forming one
``torch.distributed`` world), and polls until the dispatcher is done.

A lockstep world is one program: losing any process stalls every
collective, so a worker failure (a non-zero process exit, or a heartbeat
older than ``--heartbeat_timeout_secs``) re-forms the whole world
(:meth:`Master._reform_lockstep`): fence the old generation, re-queue
every leased task, reset the step stream and relaunch a fresh world
(new cluster version, new coordinator port) that resumes from the newest
checkpoint, within the ``--relaunch_on_worker_failure`` budget.

Left out until the next part of the slice: hot standbys, slices and
parking, the autoscaler, SLOs, streaming and live push, peer
replication, the journal (master high availability), the evaluation
and TensorBoard services, and telemetry.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.utils.args import derive_job_type
from elasticdl_tpu_torch.utils.constants import JobType, TaskType
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec


class Master:
    def __init__(self, args, instance_manager_factory=None):
        self._args = args
        self.job_type = derive_job_type(args)
        self._stop_requested = False
        self._job_failed = False
        self._heartbeat_timeout_secs = args.heartbeat_timeout_secs or 0.0
        self.reform_events: list[dict] = []
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
        if args.output and self.job_type in (
            JobType.TRAINING_ONLY,
            JobType.TRAINING_WITH_EVALUATION,
        ):
            self.task_d.add_deferred_callback_create_save_model_task(args.output)
        self.servicer = MasterServicer(args.minibatch_size, self.task_d)
        self._server = None
        self._port = None
        self.instance_manager = (
            instance_manager_factory(self) if instance_manager_factory else None
        )

    @property
    def port(self):
        return self._port

    def prepare(self, port: int | None = None):
        """Start the control-plane server, then the workers."""
        from elasticdl_tpu_torch.rpc.service import create_server

        port = port if port is not None else self._args.port
        self._server = create_server(self.servicer, port)
        self._server.start()
        self._port = self._server.port
        if self.instance_manager is not None:
            self.instance_manager.start_workers()

    def run(self, poll_secs: float = 0.5) -> int:
        """Poll until all tasks (the deferred SAVE_MODEL included) are
        done; 0 on success, 1 when the job gave up."""
        try:
            while True:
                if self.task_d.finished() and not (
                    self.task_d.invoke_deferred_callback()
                ):
                    break
                if self._stop_requested:
                    break
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
                    self._reform_lockstep([], reason=reason)
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
        """A lockstep world is one program: any death re-forms it whole."""
        self._reform_lockstep(dead, reason="worker_failure")

    def _reform_lockstep(self, dead: list[int], reason: str):
        """Fence, recover, relaunch: the whole-world re-formation.
        ``dead`` may be empty (an elective re-formation)."""
        im = self.instance_manager
        t0 = time.monotonic()
        logger.warning(
            "Re-forming the distributed world (%s; dead workers: %s)",
            reason, dead or "none",
        )
        # any re-formation satisfies a pending elective request
        with self._reform_request_lock:
            self._reform_requested = None
        # fence FIRST: from here every stale worker's get_step_task is
        # refused, so none can lease a task we are about to recover
        new_version = self.servicer.bump_cluster_version()
        for worker_id in set(dead) | set(im.worker_ids()):
            self.task_d.recover_tasks(worker_id)
            self.servicer.forget_worker(worker_id)
        self.servicer.reset_step_stream()
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
        self.reform_events.append(
            {
                "detected_at": t0,
                "cluster_version": new_version,
                "dead_workers": sorted(dead),
                "reason": reason,
            }
        )
        for callback in self.reform_callbacks:
            try:
                callback(new_version, sorted(dead), reason)
            except Exception:  # noqa: BLE001 — observers never break recovery
                logger.exception("Reform callback failed")

    def request_reform(self, reason: str = "elective"):
        """Ask the run loop to re-form the world at its next tick; safe
        from any thread."""
        with self._reform_request_lock:
            self._reform_requested = reason

    def request_stop(self):
        self._stop_requested = True

    def stop(self):
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
        if self.reform_events:
            keep = ("cluster_version", "dead_workers", "latency_secs", "reason")
            out["reforms"] = [
                {k: v for k, v in event.items() if k in keep}
                for event in self.reform_events
            ]
        return out


class LocalInstanceManager:
    """Workers as local subprocesses that form one ``torch.distributed``
    world: this manager picks the coordinator port, assigns process ids
    0..N-1 and re-forms the whole world on failure
    (:meth:`reform_world`)."""

    def __init__(self, master, num_workers: int, build_argv, envs=None, max_reforms: int = 3):
        self._master = master
        self._num_workers = num_workers
        # (worker_id, master_addr, **world_kwargs) -> argv
        self._build_argv = build_argv
        self._envs = dict(envs or {})
        self._max_reforms = max_reforms
        self._reforms = 0
        self._procs: dict[int, subprocess.Popen] = {}
        self._next_worker_id = 0
        self._lock = threading.Lock()

    @property
    def world_size(self) -> int:
        return self._num_workers

    def worker_ids(self) -> list[int]:
        with self._lock:
            return list(self._procs)

    def start_workers(self):
        self._start_world(cluster_version=0)

    def _claim_worker_id(self) -> int:
        with self._lock:
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            return worker_id

    def _start_world(self, cluster_version: int):
        from elasticdl_tpu_torch.parallel import elastic

        coordinator = f"localhost:{elastic.pick_coordinator_port()}"
        for process_id in range(self._num_workers):
            self._start(
                self._claim_worker_id(),
                coordinator_addr=coordinator,
                num_processes=self._num_workers,
                process_id=process_id,
                cluster_version=cluster_version,
            )

    def _start(self, worker_id: int, **world_kwargs):
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
        proc = subprocess.Popen([sys.executable, "-m", *argv], env=env)
        with self._lock:
            self._procs[worker_id] = proc
        logger.info("Started worker %d (pid %d)", worker_id, proc.pid)

    def poll_failed_workers(self) -> list[int]:
        """Worker ids whose process exited abnormally (non-zero code or a
        signal).  A zero exit is not a failure: workers exit 0 at the end
        of the stream, racing the master's own ``finished()`` check."""
        with self._lock:
            return [
                wid for wid, proc in self._procs.items()
                if proc.poll() not in (None, 0)
            ]

    def _kill_all(self) -> list:
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                logger.error("Worker pid %d survived SIGKILL for 10 s", proc.pid)
        return procs

    def reform_world(self, cluster_version: int, count_against_budget: bool = True):
        """Kill the old world and launch a new one.  Survivors may be
        blocked in a collective that will never complete, so SIGKILL.
        The old world is always torn down; only the relaunch is subject
        to the budget (a deterministic crash must not loop forever)."""
        self._kill_all()
        if count_against_budget:
            self._reforms += 1
        if self._reforms > self._max_reforms:
            raise RuntimeError(
                f"world re-formed {self._reforms - 1} times "
                f"(--relaunch_on_worker_failure limit); giving up"
            )
        self._start_world(cluster_version=cluster_version)

    def stop_workers(self, grace_secs: float = 15.0):
        """Give the workers ``grace_secs`` to exit on their own (their
        epilogue, a final checkpoint and state dump, may still be in a
        collective when the queue drains), then terminate the rest."""
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
