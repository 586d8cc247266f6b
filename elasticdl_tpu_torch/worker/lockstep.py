"""Lockstep worker: the multi-process data-parallel training runtime;
the counterpart of ``elasticdl_tpu/worker/lockstep.py``.

This is what makes ``--num_workers N`` train ONE model: the N worker
processes join one ``torch.distributed`` world (``parallel/elastic.py``)
and take the SAME sequence of steps, each on its own rows of every
global batch, with the gradients all-reduced in the step
(``SPMDTrainer`` with a process group).  The only coordination beyond
the collectives is the master's memoized step-task stream
(``MasterServicer.get_step_task``): every process asks for seq 0, 1,
... of its world generation and gets the same tasks.

Data path: tasks are small record ranges, so EVERY process reads the
whole range of each task, batches it the same way (the shuffle is a
pure function of the task), pads every batch to one canonical shape
with a row mask, and places only its own rows
(``SPMDTrainer.place_step``).  No data moves between hosts, the global
batches are those of a one-process run, and any process can be lost
without losing data: the task re-queues.

Error policy: an error on one process desyncs the world's collectives,
so the only sound recovery is to report the task failed and crash; the
master re-forms the world and re-queues the task, within its
``--relaunch_on_worker_failure`` budget.

Evaluation and prediction tasks come down the same stream: every
process runs the forward on its own rows of each batch (eval mode:
BatchNorm reads its running statistics, so no collective runs in it, and
dropout is off), the rows are gathered to process 0 in global batch
order (``parallel/elastic.py::gather_rows_to_chief``), and process 0
alone reports the evaluation's outputs and labels to the master, or
hands each prediction batch to the model's ``PredictionOutputsProcessor``.

``--device_prefetch`` (forwarded by the master through the environment,
so every process resolves it alike) stages a task's next dispatch groups
on the card while the current one computes, and drains at every task
boundary: a group staged across a re-formation fence on some processes
and not on others would split the world, so cross-task staging
(``--boundary_fusion``) is not wired here, as in the JAX package.

``--replication`` (worlds of two or more processes) gives each process
a replica server and a ring pusher (``replication/``): at every task
boundary due by ``--replication_steps``, after the periodic checkpoint,
each process snapshots its share of the state and pushes it to its ring
neighbor; the heartbeat carries the replicator's advertisement up and
the ring's addresses back.  A re-formed world's process 0 restores the
master's harvested replica stage when it is at least as new as the
newest disk checkpoint, else the checkpoint, and broadcasts, as before.
A process whose world broke lingers with its replica server up (gloo
fails fast when a peer dies: a survivor that exited at once would take
its replicas with it) until the master's re-formation kills it, or for
``ELASTICDL_TPU_REPLICA_LINGER_SECS`` (300 s) at most.

Master high availability (``--master_journal_dir``): the client retries
across a master outage and re-resolves the master's address
(``worker/main.py::build_master_client``); the heartbeat thread notices
the relaunched master's new boot id and re-homes, presenting this
process's generation, pid and its last two tasks (``_note_master_boot``;
a fence rejection is terminal).  The JAX worker presents its
current task alone, so a relaunched master requeues a task whose report
the chief has not landed yet when a peer one task ahead holds its lease.
A process whose world broke lingers under master HA too, replica server
or not, so that it is still there for the relaunched master: it watches
the master's address file, re-homes when a relaunched master rewrites
it, and leaves once fenced (the JAX package's lingering process waits
silently until the linger cap).

In a multi-slice world (``--num_slices``) each process knows its slice
coordinates from its world kwargs (``--slice_id``, ``--num_slices``):
a ``SLICE_LOSS`` fault arms on every process of its slice, and the
replica ring keeps each shard's replica off its owner's slice
(``parallel/mesh.py::slice_assignments``), and a survivor of a broken
world lingers as above: on gloo it learns of a dead peer at once, and
had it exited, the master would count its slice lost with the dead one
(JAX's survivors hang in the collective instead).  With
``--replication`` even a world shrunk to one process asks the master
for the replica stage.

Left out until later slices: per-process checkpoint parts: process 0
writes every checkpoint as one part (the name-keyed layout of a Local
run) and, at a world's start, restores it (or the replica stage) and
broadcasts the state to the others.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.data.fast_pipeline import build_task_batches
from elasticdl_tpu_torch.embeddings.sharded import tables_to_shard
from elasticdl_tpu_torch.layers.attention import to_torch_dtype
from elasticdl_tpu_torch.master.journal import MASTER_ADDR_FILE_ENV
from elasticdl_tpu_torch.master.task_dispatcher import FAIL_COUNT
from elasticdl_tpu_torch.ops.attention import dump_launch_counts_if_requested
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer, trim_pad
from elasticdl_tpu_torch.parallel.elastic import (
    batch_divisor,
    gather_rows_to_chief,
    gather_sharded_tables_to_chief,
    scatter_table_rows_from_chief,
    state_checkpoint_parts,
)
from elasticdl_tpu_torch.replication.replicator import (
    PeerReplicator,
    apply_restore_stage,
    fetch_restore_stage,
    replica_host,
    restore_from_replica,
)
from elasticdl_tpu_torch.replication.blob import decode_snapshot
from elasticdl_tpu_torch.replication.service import start_replica_server
from elasticdl_tpu_torch.replication.store import ReplicaStore
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import stats as rpc_stats
from elasticdl_tpu_torch.rpc.deadline import HEARTBEAT_INTERVAL_ENV
from elasticdl_tpu_torch.telemetry import anatomy as anatomy_mod
from elasticdl_tpu_torch.telemetry import compile_tracker, tracing, worker_hooks
from elasticdl_tpu_torch.trainer import device_pipeline
from elasticdl_tpu_torch.trainer.checkpointing import (
    PeriodicCheckpointer,
    restore_trainer_state,
)
from elasticdl_tpu_torch.trainer.local_executor import INIT_SEED, build_optimizer
from elasticdl_tpu_torch.trainer.stacking import (
    canonical_batch_rows,
    choose_stack_k,
    run_stacked_steps,
)
from elasticdl_tpu_torch.trainer.state import Modes
from elasticdl_tpu_torch.utils import save_utils
from elasticdl_tpu_torch.utils.args import derive_job_type
from elasticdl_tpu_torch.utils.constants import JobType, TaskType
from elasticdl_tpu_torch.utils.export_utils import export_model
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec
from elasticdl_tpu_torch.utils.profiling import StepProfiler, apply_profile_command
from elasticdl_tpu_torch.utils.tensor import ndarray_to_tensor
from elasticdl_tpu_torch.utils.timing_utils import Timing
from elasticdl_tpu_torch.utils.tree_utils import batch_rows, stack_trees

# Debug hook: when set, each process dumps its final dense state to
# $ELASTICDL_TPU_DUMP_STATE/final_state_p{process_id}.npz — tests and the
# smoke hold the processes' states bitwise equal — and a re-formed
# world's restored state to start_state_p{process_id}_g{generation}.npz
DUMP_STATE_ENV = "ELASTICDL_TPU_DUMP_STATE"

# the beat's cadence; a master with a short liveness timeout or a tight
# RPC deadline sends a faster one by env
# (rpc/deadline.py::heartbeat_interval_secs)
HEARTBEAT_INTERVAL_SECS = 2.0


def heartbeat_interval_from_env() -> float:
    """The beat's cadence: the master's, by env, or the default."""
    return float(os.environ.get(HEARTBEAT_INTERVAL_ENV, "") or HEARTBEAT_INTERVAL_SECS)


# how long a process whose world broke keeps its replica server up for
# the master's harvest (the master's re-formation kills it sooner)
REPLICA_LINGER_ENV = "ELASTICDL_TPU_REPLICA_LINGER_SECS"
REPLICA_LINGER_SECS = 300.0

# how often a lingering process under master HA looks at the master's
# address file
LINGER_POLL_SECS = 0.2

# how long a task boundary waits for the heartbeats to bring the ring
# neighbor's replica address (a push fails without it)
PEER_DISCOVERY_SECS = 30.0


class LockstepWorker:
    def __init__(self, args, master, world):
        """``master``: a ``MasterClient`` (or the servicer itself, in
        process); ``world``: this process's ``parallel.elastic.World``."""
        self._args = args
        self._master = master
        self._world = world
        self._worker_id = int(args.worker_id)
        self._process_id = world.process_id
        self._cluster_version = int(args.cluster_version)
        # slice coordinates of a multi-slice world, assigned with the
        # process id by the instance manager
        self._slice_id = int(getattr(args, "slice_id", 0) or 0)
        self._num_slices = int(getattr(args, "num_slices", 1) or 1)
        self._minibatch_size = args.minibatch_size
        self._job_type = derive_job_type(args)
        self._timing = Timing(enabled=args.log_level == "DEBUG", logger=logger)
        self._spec = get_model_spec(
            args.model_zoo,
            args.model_def,
            model_params=args.model_params_dict,
            dataset_fn=args.dataset_fn,
            loss=args.loss,
            optimizer=args.optimizer,
            eval_metrics_fn=args.eval_metrics_fn,
        )
        # the Local executor's seeded start: every process builds the same
        # weights (its tables on its device), and process 0's are
        # broadcast all the same
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(INIT_SEED)
            self._model = self._spec.build_model(device=world.device)
        # the model's sharding rules on this world: tables they row-shard
        # hold each process's rows, which every process checkpoints and
        # restores itself (one checkpoint part a process)
        self._sharding_rules = self._spec.rules_for(world.num_processes)
        self._sharded = world.num_processes > 1 and bool(
            tables_to_shard(self._model, self._sharding_rules)
        )
        # one reader serves every task of the job: a task names its shard
        self._reader = create_data_reader(
            args.prediction_data
            if self._job_type == JobType.PREDICTION_ONLY
            else args.training_data or args.validation_data,
            records_per_task=args.records_per_task,
            custom_reader=self._spec.custom_data_reader,
            **args.data_reader_params_dict,
        )
        # one canonical shape per step, a pure function of (minibatch,
        # world size): every process agrees on shapes and step counts
        self._canonical_rows = canonical_batch_rows(
            self._minibatch_size, batch_divisor(world.num_processes)
        )
        # the device pipeline, from the master-forwarded environment
        self._device_prefetch = device_pipeline.resolve_device_prefetch(
            args.device_prefetch
        )
        self._pipeline_depth = device_pipeline.resolve_pipeline_depth(
            args.pipeline_depth
        )
        self._trainer: SPMDTrainer | None = None
        self._stopped = False
        # master high availability: the boot id of the master last heard
        # from; the last two tasks this process pulled (presented on
        # re-homing: the lease of a world's task is held by whichever
        # process pulled it first, and a process may be one task ahead
        # of the chief's report of the previous one); whether a relaunched
        # master fenced this process's generation; and the address file's
        # stamp when this process last knew its master
        self._master_boot_id: str | None = None
        self._recent_task_ids: list[int] = []
        self._fenced = False
        self._addr_stamp = _addr_file_stamp()
        # deterministic fault injection: a no-op unless the master
        # exported a plan into this process's environment
        self._chaos = chaos_hooks.install_from_env(
            self._process_id, self._cluster_version, self._worker_id,
            slice_id=self._slice_id,
        )
        # telemetry (no-op unless the master exported its directory): a
        # re-formed world installs a fresh recorder of its generation;
        # the anatomy's phase totals ride the heartbeat; the chief ships
        # compile deltas with its task reports
        worker_hooks.install_from_env(
            worker_id=self._worker_id, process_id=self._process_id,
            generation=self._cluster_version,
        )
        anatomy_mod.install_from_env(model_def=args.model_def, device=world.device)
        self._compile_deltas = compile_tracker.ExecCounterReporter()
        # span tracing (worker/main.py installs it in a worker process;
        # this covers a world built in process)
        if tracing.get_tracer() is None:
            tracing.install_from_env(
                worker_id=self._worker_id, process_id=self._process_id,
                generation=self._cluster_version,
            )
        # the profiler window, in a directory of this process's own
        self._profiler = StepProfiler(
            os.path.join(args.profile_dir, f"process_{self._process_id}")
            if args.profile_dir else "",
            num_steps=args.profile_steps,
            device=world.device,
        )
        self._checkpointer = PeriodicCheckpointer(
            args.checkpoint_dir,
            args.checkpoint_steps,
            keep_checkpoint_max=args.keep_checkpoint_max,
            process_id=self._process_id,
            num_parts=world.num_processes if self._sharded else 1,
        )
        # peer state replication: a replica server and ring pusher per
        # process, in worlds of two or more (a lone process has no peer
        # to restore from)
        self._replicator: PeerReplicator | None = None
        self._replica_server = None
        if args.replication and world.num_processes > 1:
            store = ReplicaStore(generation=self._cluster_version)
            self._replica_server, replica_port = start_replica_server(store)
            self._replicator = PeerReplicator(
                store,
                process_id=self._process_id,
                num_processes=world.num_processes,
                generation=self._cluster_version,
                addr=f"{replica_host()}:{replica_port}",
                replication_steps=args.replication_steps or 0,
                # the slice-aware ring: no replica on its owner's slice
                num_slices=self._num_slices,
            )

    # ---- process-0-only master reporting -----------------------------------

    @property
    def _is_chief(self) -> bool:
        return self._process_id == 0

    @property
    def _writes_checkpoints(self) -> bool:
        """Process 0 writes a replicated state's checkpoints; every
        process writes its part of a sharded one."""
        return self._is_chief or self._sharded

    def _report_task_result(
        self, task_id, err_msg="", fail_count=0, include_timing=False, trace=None
    ):
        if not self._is_chief:
            return
        counters = {FAIL_COUNT: fail_count} if fail_count else {}
        if include_timing:
            counters.update(self._timing.exec_counters())
        compiles = self._compile_deltas.attach(counters)
        t0 = time.monotonic()
        self._master.report_task_result(
            msg.ReportTaskResultRequest(
                task_id=task_id, err_message=err_msg, exec_counters=counters,
                trace=dict(trace or {}),
            )
        )
        self._compile_deltas.commit(compiles)
        tracer = tracing.get_tracer()
        if tracer is not None:
            tracer.record_span(
                tracing.SPAN_REPORT_TASK, t0, time.monotonic(), trace_ctx=trace,
                task_id=task_id, error=bool(err_msg),
            )

    def _report_version(self):
        if self._is_chief and self._trainer is not None:
            self._master.report_version(
                msg.ReportVersionRequest(
                    model_version=self._trainer.step, worker_id=self._worker_id
                )
            )

    # ---- trainer lifecycle -------------------------------------------------

    def _ensure_trainer(self):
        """Build the trainer on the first step; process 0 restores the
        newest checkpoint (or the warm start) and every process takes its
        state by broadcast, so the world starts from one state."""
        if self._trainer is not None:
            return
        compute_dtype = self._args.compute_dtype
        # a re-formation's phase: on a relaunched world the build (the
        # state's start and placement) is a named term of the downtime,
        # with the restore's span inside it
        with tracing.trace_span(tracing.SPAN_TRAINER_BUILD):
            self._trainer = SPMDTrainer(
                self._model,
                self._spec.loss,
                build_optimizer(self._spec, self._args.learning_rate),
                compute_dtype=(
                    None if compute_dtype == "float32" else to_torch_dtype(compute_dtype)
                ),
                device=self._world.device,
                device_parse=self._spec.device_parse,
                remat=bool(self._args.remat),
                process_group=self._world.group,
                sharding_rules=self._sharding_rules,
            )
            if self._sharded:
                self._restore_sharded_state()
            elif self._is_chief:
                self._restore_state()
            version = self._trainer.broadcast_state()
        self._checkpointer.note_restored_version(version)
        if self._replicator is not None:
            self._replicator.note_restored_version(version)
        if self._cluster_version > 0:
            self._dump_state_if_requested(
                f"start_state_p{self._process_id}_g{self._cluster_version}.npz"
            )

    def _restore_state(self):
        """Process 0: the harvested replica stage first, when it is at
        least as new as the newest disk checkpoint; the disk second."""
        if self._args.replication:
            ckpt_dir = self._args.checkpoint_dir
            disk_floor = save_utils.latest_version(ckpt_dir) if ckpt_dir else None
            version = restore_from_replica(
                self._trainer,
                self._master,
                self._cluster_version,
                self._process_id,
                min_version=disk_floor,
            )
            if version is not None:
                return
        restore_trainer_state(self._trainer, self._args)

    def _restore_sharded_state(self):
        """A world holding row-sharded tables: process 0 chooses the
        source (the replica stage first, when at least as new as the
        newest disk checkpoint; then the disk) and tells the world.  From
        the stage, process 0 loads it and hands each process its rows by
        row id; from the disk, every process reads its own rows (and the
        dense values, which the broadcast then makes process 0's)."""
        source = torch.zeros(1, dtype=torch.int64, device=self._trainer.device)
        stage = None
        if self._is_chief:
            ckpt_dir = self._args.checkpoint_dir
            if self._args.replication:
                disk_floor = save_utils.latest_version(ckpt_dir) if ckpt_dir else None
                stage = fetch_restore_stage(
                    self._master, self._cluster_version, self._process_id,
                    min_version=disk_floor,
                )
            if stage is not None:
                stage = (stage, decode_snapshot(stage.payload))
                missing = set(self._trainer.sharded_tables) - set(stage[1][1])
                if missing:
                    # a replica set without a table's rows would restore
                    # the dense values beside freshly built tables
                    logger.warning(
                        "Replica stage at version %d lacks the rows of %s; "
                        "restoring from disk instead",
                        int(stage[0].version), sorted(missing),
                    )
                    stage = None
            source[0] = 1 if stage is not None else 2
        dist.broadcast(source, dist.get_global_rank(self._world.group, 0),
                       group=self._world.group)
        if int(source.item()) == 1:
            parts = None
            if self._is_chief:
                parts = apply_restore_stage(
                    self._trainer, stage[0], self._cluster_version,
                    self._process_id, decoded=stage[1],
                )
            scatter_table_rows_from_chief(
                self._trainer.state.model, parts, self._world.group
            )
        else:
            restore_trainer_state(self._trainer, self._args)

    def _maybe_checkpoint(self):
        """At task boundaries: the periodic checkpoint (by process 0
        alone, or by every process of a sharded state), then the
        replication due, on every process (the cadence is a function of
        the shared step)."""
        if self._writes_checkpoints:
            self._checkpointer.maybe_save(self._trainer)
        if self._replicator is not None:
            if not self._replicator.knows_neighbor():
                self._discover_peers()
            self._replicator.maybe_replicate(self._trainer, self._world.group)

    # ---- task execution ----------------------------------------------------

    def _task_batches(self, task, mode: Modes = Modes.TRAINING):
        """The global minibatches of one task, the same on every process:
        the shuffle (training only) is a pure function of the task, and
        an explicit ``--steps_per_dispatch k`` groups training batches
        identically."""
        training = mode == Modes.TRAINING
        return build_task_batches(
            self._reader,
            task,
            self._spec,
            mode,
            self._reader.metadata,
            self._minibatch_size,
            shuffle_records=training,
            # 'auto' would size k from a per-process probe, which could
            # differ between processes: the byte rule alone decides
            stack_k=choose_stack_k(
                self._args.steps_per_dispatch, training, allow_auto=False
            ),
            stack_divisor=batch_divisor(self._world.num_processes),
            dispatch_device=self._world.device,
        )

    def _train_task(self, task):
        def _pre(_features):
            self._ensure_trainer()
            self._profiler.on_step()
            # every process steps through the global batch: records is
            # the global minibatch (one early return when telemetry is off)
            worker_hooks.record_step(self._trainer.step, self._minibatch_size)
            # a sampled train_step span (the same early return)
            tracing.record_step_span(self._trainer.step)
            if self._chaos is not None:
                # per-step arming point: step-scheduled faults fire at
                # the exact model version the plan names
                self._chaos.on_step(int(self._trainer.step))

        # the task's span joins the master's dispatch trace (one task is
        # one trace across master and workers), and parents the fetch and
        # step spans recorded inside it
        with tracing.trace_span(
            tracing.SPAN_TASK_EXECUTE, trace_ctx=task.trace, task_id=task.task_id,
            shard=task.shard_name,
        ) as task_span, self._crash_on_error(task):
            batches = tracing.trace_fetches(
                self._task_batches(task), trace_ctx=task.trace, span=task_span
            )
            if self._chaos is not None:
                batches = self._chaos.wrap_batches(batches)
            run_stacked_steps(
                lambda: self._trainer,
                batches,
                self._args.steps_per_dispatch or 1,
                pre_batch=_pre,
                dispatch_ctx=lambda: self._timing.record("batch_process"),
                deterministic_auto=True,
                canonical_rows=self._canonical_rows,
                # staging changes when a group is copied, never what is
                # dispatched, and drains before this returns
                device_prefetch=self._device_prefetch,
                pipeline_depth=self._pipeline_depth,
                # the anatomy changes timing only, never shapes or the
                # dispatch count: the world's schedule stays agreed
                anatomy=anatomy_mod.get_recorder(),
            )
        device_pipeline.note_task_boundary()
        # the version before the task's report: a version that crosses an
        # --evaluation_steps milestone queues its evaluation tasks while
        # this task still holds the queue open, so no process of the world
        # can pull end-of-job in between (reported the other way round, as
        # the JAX package does, a peer's pull between the two reports
        # ends the stream without the last milestone's evaluation)
        self._report_version()
        self._report_task_result(task.task_id, include_timing=True, trace=task.trace)
        self._timing.report_timing(reset=True)
        self._maybe_checkpoint()

    @contextlib.contextmanager
    def _crash_on_error(self, task):
        """Report the task failed and re-raise: peers may already wait in
        a collective this process will never join, so carrying on would
        desync the world."""
        try:
            yield
        except Exception as ex:  # noqa: BLE001 — re-raised
            traceback.print_exc()
            self._report_task_result(
                task.task_id, str(ex), fail_count=task.end - task.start
            )
            self._stopped = True
            logger.error(
                "Process %d crashing after task %d failed: %s",
                self._process_id, task.task_id, ex,
            )
            raise

    def _forward_rows(self, features, n: int):
        """This process's rows of one canonical evaluation or prediction
        batch through the model (eval mode), gathered to process 0 and
        trimmed to the ``n`` real rows there; None on the others."""
        trainer = self._trainer
        padded = trainer.pad_to(features, self._canonical_rows)
        outputs = trainer.predict_step(trainer.place_local(padded))
        gathered = gather_rows_to_chief(outputs, self._world.group)
        return trim_pad(gathered, n) if gathered is not None else None

    def _eval_task(self, task):
        all_outputs, all_labels = [], []
        with tracing.trace_span(
            tracing.SPAN_TASK_EXECUTE, trace_ctx=task.trace, task_id=task.task_id,
            shard=task.shard_name, eval=True,
        ), self._crash_on_error(task):
            for features, labels in self._task_batches(task, Modes.EVALUATION):
                self._ensure_trainer()
                n = batch_rows(labels)
                outputs = self._forward_rows(features, n)
                if self._is_chief:
                    all_outputs.append(outputs)
                    all_labels.append(np.asarray(labels))
        if all_outputs:
            self._report_eval_metrics(
                stack_trees(all_outputs, np.concatenate), np.concatenate(all_labels), task
            )
        self._report_task_result(task.task_id)

    def _report_eval_metrics(self, outputs, labels, task):
        """One report per task, after all its batches: a report over the
        transport's message cap raises (``RESOURCE_EXHAUSTED``)."""
        if isinstance(outputs, dict):
            out_tensors = {k: ndarray_to_tensor(k, np.asarray(v)) for k, v in outputs.items()}
        else:
            out_tensors = {"output": ndarray_to_tensor("output", np.asarray(outputs))}
        self._master.report_evaluation_metrics(
            msg.ReportEvaluationMetricsRequest(
                model_outputs=out_tensors,
                labels=ndarray_to_tensor("labels", labels),
                model_version=task.model_version,
                task_id=task.task_id,
                evaluated_version=self._trainer.step if self._trainer else -1,
            )
        )

    def _predict_task(self, task):
        processor = self._spec.prediction_outputs_processor
        with self._crash_on_error(task):
            for features in self._task_batches(task, Modes.PREDICTION):
                self._ensure_trainer()
                outputs = self._forward_rows(features, batch_rows(features))
                if self._is_chief and processor is not None:
                    processor.process(outputs, self._worker_id)
        self._report_task_result(task.task_id)

    def _save_model_task(self, task):
        with self._crash_on_error(task):
            # a restart after training drained has no trainer yet: the
            # export is the restored state
            self._ensure_trainer()
            # row-sharded tables leave the world whole, through process 0
            tables = None
            if self._sharded:
                tables = gather_sharded_tables_to_chief(
                    self._trainer.state.model, self._world.group
                )
            if self._is_chief:
                path = task.extended.get("saved_model_path", "") or self._args.output
                export_model(
                    path,
                    self._trainer.state.model,
                    self._args.model_def,
                    model_params=self._args.model_params_dict,
                    model_zoo=self._args.model_zoo,
                    model_version=self._trainer.step,
                    tables=tables,
                )
        self._report_task_result(task.task_id)

    # ---- main loop ---------------------------------------------------------

    def _heartbeat(self):
        """One heartbeat, with the RPC outcome, anatomy phase and staging
        totals and the replicator's advertisement; the reply's peer map goes to the
        replicator."""
        replicator = self._replicator
        try:
            resp = self._master.heartbeat(
                msg.HeartbeatRequest(
                    worker_id=self._worker_id,
                    step=self._trainer.step if self._trainer else 0,
                    timestamp=time.time(),
                    replica=replicator.advertisement() if replicator else {},
                    rpc=rpc_stats.snapshot(),
                    phases=anatomy_mod.heartbeat_snapshot(),
                    prefetch=device_pipeline.heartbeat_snapshot(),
                )
            )
        except Exception:  # noqa: BLE001 — the master may be gone
            return
        if replicator is not None and resp is not None:
            replicator.set_peers(resp.replica_peers)
        if resp is not None:
            self._note_master_boot(resp.boot_id)
            if resp.profile:
                # an on-demand capture window (request_profile); a window
                # id seen already is absorbed
                apply_profile_command(
                    self._profiler, resp.profile,
                    telemetry_dir=os.environ.get(worker_hooks.TELEMETRY_DIR_ENV, ""),
                    tag=f"p{self._process_id}",
                )

    def _note_master_boot(self, boot_id: str):
        """Heartbeat-thread hook: a changed master boot id means the
        master restarted from its journal, so re-home: present this
        process's generation, pid and its last two tasks, so that the
        restarted dispatcher re-accepts those it holds for this process
        (a reported task's lease is gone, and is ignored) and requeues
        the rest.  A lockstep process's generation is fixed at spawn, so
        a fence rejection is terminal (the step stream then ends the
        process) and the boot id advances even then; it commits only
        AFTER the handshake, so a failed RPC retries on the next beat."""
        if not boot_id:
            return
        previous = self._master_boot_id
        if previous is None or previous == boot_id:
            self._master_boot_id = boot_id
            return
        logger.warning(
            "Master restarted (boot %s -> %s); re-homing worker %d",
            previous[:8], boot_id[:8], self._worker_id,
        )
        try:
            # one read: the training thread replaces the list
            self._rehome(list(self._recent_task_ids))
        except Exception:  # noqa: BLE001 — retried on the next beat
            logger.exception("Re-home RPC failed; will retry")
            return
        self._master_boot_id = boot_id

    def _rehome(self, leases: list):
        """The re-homing handshake; a rejection marks this process fenced."""
        logger.warning(
            "Re-homing worker %d (generation %d, in-flight leases %s)",
            self._worker_id, self._cluster_version, leases,
        )
        resp = self._master.rehome_worker(
            msg.RehomeRequest(
                worker_id=self._worker_id,
                cluster_version=self._cluster_version,
                pid=os.getpid(),
                lease_ids=leases,
            )
        )
        self._addr_stamp = _addr_file_stamp()
        if resp is not None and not resp.accepted:
            # the generation fence: this world is stale
            self._fenced = True
            logger.warning(
                "Re-home rejected: generation %d is fenced (master at %d)",
                self._cluster_version, resp.cluster_version,
            )

    def _discover_peers(self, timeout_secs: float = PEER_DISCOVERY_SECS):
        """Heartbeat until the reply names the ring neighbor's replica
        server, so a push has somewhere to go.  Called at a task boundary
        while the neighbor is unknown: by then every process of the world
        has taken a step with this one, so each has sent its first beat
        (which advertises it), and one round trip is enough."""
        deadline = time.monotonic() + timeout_secs
        while True:
            self._heartbeat()
            if self._replicator.knows_neighbor():
                return
            if time.monotonic() > deadline:
                logger.warning(
                    "Process %d: no replica address for process %d after "
                    "%.0f s; pushes fail until a heartbeat brings it",
                    self._process_id, self._replicator.neighbor, timeout_secs,
                )
                return
            time.sleep(0.05)

    def _start_heartbeats(self, interval_secs: float | None = None):
        if interval_secs is None:
            interval_secs = heartbeat_interval_from_env()

        def beat():
            while not self._stopped:
                if self._chaos is not None and self._chaos.heartbeat_suppressed():
                    # injected silence: the process lives on, but the
                    # master must see a dead worker
                    time.sleep(interval_secs)
                    continue
                t0 = time.monotonic()
                self._heartbeat()
                tracer = tracing.get_tracer()
                if tracer is not None:
                    tracer.record_span(
                        tracing.SPAN_HEARTBEAT, t0, time.monotonic(), sampled=True
                    )
                time.sleep(interval_secs)

        threading.Thread(target=beat, name="heartbeat", daemon=True).start()

    def run(self, wait_sleep_secs: float = 1.0):
        self._stopped = False
        self._start_heartbeats()
        ok = False
        try:
            seq = 0
            while True:
                t0 = time.monotonic()
                task = self._master.get_step_task(
                    msg.GetStepTaskRequest(
                        seq=seq,
                        worker_id=self._worker_id,
                        cluster_version=self._cluster_version,
                    )
                )
                tracer = tracing.get_tracer()
                if tracer is not None and task.shard_name:
                    # the lease joins the task's trace (WAIT polls are not
                    # leases and record nothing)
                    tracer.record_span(
                        tracing.SPAN_GET_TASK, t0, time.monotonic(), trace_ctx=task.trace,
                        task_id=task.task_id, seq=seq,
                    )
                if task.is_wait:
                    time.sleep(wait_sleep_secs)
                    continue
                if not task.shard_name:
                    logger.info(
                        "Process %d: stream ended at seq %d", self._process_id, seq
                    )
                    break
                seq += 1
                self._recent_task_ids = [*self._recent_task_ids[-1:], task.task_id]
                if task.type == int(TaskType.TRAINING):
                    self._train_task(task)
                elif task.type == int(TaskType.EVALUATION):
                    self._eval_task(task)
                elif task.type == int(TaskType.PREDICTION):
                    self._predict_task(task)
                elif task.type == int(TaskType.SAVE_MODEL):
                    self._save_model_task(task)
                else:
                    self._report_task_result(
                        task.task_id, f"unknown task type {task.type}"
                    )
            if (
                self._writes_checkpoints
                and self._checkpointer.enabled
                and self._trainer is not None
                and self._job_type
                in (JobType.TRAINING_ONLY, JobType.TRAINING_WITH_EVALUATION)
            ):
                # the final state as a checkpoint, as the Local executor
                # leaves it (the periodic ones stop at a milestone)
                self._checkpointer.save_now(self._trainer, skip_if_current=True)
            if self._replicator is not None:
                # every process's last push has landed before any replica
                # server stops (a peer's server gone mid-push is a failure)
                dist.barrier(group=self._world.group)
            self._dump_state_if_requested(f"final_state_p{self._process_id}.npz")
            dump_launch_counts_if_requested(f"w{self._worker_id}")
            # the last totals reach the master however short the run
            self._heartbeat()
            ok = True
        except BaseException:
            if self._lingers():
                # shown now: a lingering process would show it only when
                # it leaves, and a re-formation kills it first
                traceback.print_exc()
            raise
        finally:
            # a pending boundary mark must not outlive the run loop
            device_pipeline.clear_boundary_mark()
            try:
                # a job must not end with an unwritten checkpoint, and a
                # failed flush must not replace an exception in flight
                self._checkpointer.flush_on_unwind(clean_exit=ok)
            finally:
                # a leaked capture would poison a later window
                self._profiler.stop()
                self._stopped = True
                tracing.flush()
                if self._replicator is not None:
                    self._replicator.close()
                if not ok and self._lingers():
                    self._linger_for_harvest()
                if self._replica_server is not None:
                    self._replica_server.stop(grace=0)

    def _lingers(self) -> bool:
        """Whether a process whose world broke stays for the master's
        re-formation instead of exiting: with replica shards to harvest,
        under master HA, and in a multi-slice world (a survivor that
        exited at once would count as dead with the lost slice, and a
        slice loss would look like a whole-world crash)."""
        return self._replica_server is not None or self._ha_mode() or self._num_slices > 1

    @staticmethod
    def _ha_mode() -> bool:
        """Master HA is on for this job (the master exported its address
        file)."""
        return bool(os.environ.get(MASTER_ADDR_FILE_ENV, ""))

    def _linger_for_harvest(self):
        """The world broke: stay until the master's re-formation kills
        this process, or for the linger cap.  On the CPU and on gloo a
        collective on a dead peer raises at once; exiting then would take
        this process's replicas with it (``--replication``), or, under
        master HA, beat a relaunched master to the fence.  Under master HA
        the wait watches the address file: a relaunched master rewrites
        it, this process re-homes (presenting no lease: it trains no
        more), and leaves once the handshake fences it."""
        try:
            linger_secs = float(os.environ.get(REPLICA_LINGER_ENV, REPLICA_LINGER_SECS))
        except ValueError:
            linger_secs = REPLICA_LINGER_SECS
        if linger_secs <= 0:
            return
        logger.warning(
            "Process %d stopped on an error: lingering up to %.0f s so the "
            "(relaunched) master can fence this world%s",
            self._process_id, linger_secs,
            " and harvest its replica shards" if self._replica_server is not None else "",
        )
        if not self._ha_mode():
            time.sleep(linger_secs)
            return
        deadline = time.monotonic() + linger_secs
        while not self._fenced and time.monotonic() < deadline:
            if _addr_file_stamp() != self._addr_stamp:
                try:
                    self._rehome([])
                except Exception:  # noqa: BLE001 — the master may be gone
                    # again: retried when the file changes next
                    logger.exception("Re-home from the linger failed")
                    self._addr_stamp = _addr_file_stamp()
            time.sleep(LINGER_POLL_SECS)
        if self._fenced:
            logger.warning("Process %d fenced by the relaunched master; leaving", self._process_id)

    def _dump_state_if_requested(self, name: str):
        out_dir = os.environ.get(DUMP_STATE_ENV, "")
        if not out_dir or self._trainer is None:
            return
        os.makedirs(out_dir, exist_ok=True)
        # a row-sharded table as this process's (ids, rows), under the
        # checkpoint's part names
        dense, parts = state_checkpoint_parts(self._trainer.state)
        for table, (ids, rows) in parts.items():
            dense[f"emb_ids/{table}"], dense[f"emb_rows/{table}"] = ids, rows
        np.savez(os.path.join(out_dir, name), **dense)

    @property
    def trainer(self):
        return self._trainer


def _addr_file_stamp():
    """The master address file's modification time (None without master
    HA, or before the master writes it): a relaunched master rewrites
    the file, so a changed stamp means a restart."""
    path = os.environ.get(MASTER_ADDR_FILE_ENV, "")
    try:
        return os.stat(path).st_mtime_ns if path else None
    except OSError:
        return None
