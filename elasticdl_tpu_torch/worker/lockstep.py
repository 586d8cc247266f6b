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

Left out until the next part of the slice: evaluation and prediction
tasks, ``--device_prefetch``, peer replication and master high
availability; and per-process checkpoint parts: process 0 writes every
checkpoint as one part (the name-keyed layout of a Local run) and, at a
world's start, restores it and broadcasts the state to the others.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import traceback

import numpy as np
import torch

from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.data.fast_pipeline import build_task_batches
from elasticdl_tpu_torch.layers.attention import to_torch_dtype
from elasticdl_tpu_torch.master.task_dispatcher import FAIL_COUNT
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
from elasticdl_tpu_torch.parallel.elastic import batch_divisor
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import stats as rpc_stats
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
from elasticdl_tpu_torch.trainer.state import Modes, state_to_checkpoint
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.export_utils import export_model
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec
from elasticdl_tpu_torch.utils.timing_utils import Timing

# Debug hook: when set, each process dumps its final dense state to
# $ELASTICDL_TPU_DUMP_STATE/final_state_p{process_id}.npz — tests and the
# smoke hold the processes' states bitwise equal
DUMP_STATE_ENV = "ELASTICDL_TPU_DUMP_STATE"

HEARTBEAT_INTERVAL_SECS = 2.0


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
        self._minibatch_size = args.minibatch_size
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
        # weights, and process 0's are broadcast all the same
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(INIT_SEED)
            self._model = self._spec.build_model()
        self._reader = create_data_reader(
            args.training_data,
            records_per_task=args.records_per_task,
            custom_reader=self._spec.custom_data_reader,
            **args.data_reader_params_dict,
        )
        # one canonical shape per step, a pure function of (minibatch,
        # world size): every process agrees on shapes and step counts
        self._canonical_rows = canonical_batch_rows(
            self._minibatch_size, batch_divisor(world.num_processes)
        )
        self._trainer: SPMDTrainer | None = None
        self._stopped = False
        # deterministic fault injection: a no-op unless the master
        # exported a plan into this process's environment
        self._chaos = chaos_hooks.install_from_env(
            self._process_id, self._cluster_version, self._worker_id
        )
        self._checkpointer = PeriodicCheckpointer(
            args.checkpoint_dir,
            args.checkpoint_steps,
            keep_checkpoint_max=args.keep_checkpoint_max,
        )

    # ---- process-0-only master reporting -----------------------------------

    @property
    def _is_chief(self) -> bool:
        return self._process_id == 0

    def _report_task_result(self, task_id, err_msg="", fail_count=0, include_timing=False):
        if not self._is_chief:
            return
        counters = {FAIL_COUNT: fail_count} if fail_count else {}
        if include_timing:
            counters.update(self._timing.exec_counters())
        self._master.report_task_result(
            msg.ReportTaskResultRequest(
                task_id=task_id, err_message=err_msg, exec_counters=counters
            )
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
        )
        if self._is_chief:
            restore_trainer_state(self._trainer, self._args)
        version = self._trainer.broadcast_state()
        self._checkpointer.note_restored_version(version)

    def _maybe_checkpoint(self):
        """Periodic checkpoint at task boundaries, by process 0 alone."""
        if self._is_chief:
            self._checkpointer.maybe_save(self._trainer)

    # ---- task execution ----------------------------------------------------

    def _task_batches(self, task):
        """The global minibatches of one training task, the same on every
        process: the shuffle is a pure function of the task, and an
        explicit ``--steps_per_dispatch k`` groups them identically."""
        return build_task_batches(
            self._reader,
            task,
            self._spec,
            Modes.TRAINING,
            self._reader.metadata,
            self._minibatch_size,
            shuffle_records=True,
            # 'auto' would size k from a per-process probe, which could
            # differ between processes: the byte rule alone decides
            stack_k=choose_stack_k(
                self._args.steps_per_dispatch, True, allow_auto=False
            ),
            stack_divisor=batch_divisor(self._world.num_processes),
            dispatch_device=self._world.device,
        )

    def _train_task(self, task):
        def _pre(_features):
            self._ensure_trainer()
            if self._chaos is not None:
                # per-step arming point: step-scheduled faults fire at
                # the exact model version the plan names
                self._chaos.on_step(int(self._trainer.step))

        with self._crash_on_error(task):
            batches = self._task_batches(task)
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
            )
        self._report_task_result(task.task_id, include_timing=True)
        self._timing.report_timing(reset=True)
        self._report_version()
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

    def _save_model_task(self, task):
        with self._crash_on_error(task):
            # a restart after training drained has no trainer yet: the
            # export is the restored state
            self._ensure_trainer()
            if self._is_chief:
                path = task.extended.get("saved_model_path", "") or self._args.output
                export_model(
                    path,
                    self._trainer.state.model,
                    self._args.model_def,
                    model_params=self._args.model_params_dict,
                    model_zoo=self._args.model_zoo,
                    model_version=self._trainer.step,
                )
        self._report_task_result(task.task_id)

    # ---- main loop ---------------------------------------------------------

    def _start_heartbeats(self, interval_secs: float = HEARTBEAT_INTERVAL_SECS):
        def beat():
            while not self._stopped:
                if self._chaos is not None and self._chaos.heartbeat_suppressed():
                    # injected silence: the process lives on, but the
                    # master must see a dead worker
                    time.sleep(interval_secs)
                    continue
                try:
                    self._master.heartbeat(
                        msg.HeartbeatRequest(
                            worker_id=self._worker_id,
                            step=self._trainer.step if self._trainer else 0,
                            timestamp=time.time(),
                            rpc=rpc_stats.snapshot(),
                        )
                    )
                except Exception:  # noqa: BLE001 — the master may be gone
                    pass
                time.sleep(interval_secs)

        threading.Thread(target=beat, name="heartbeat", daemon=True).start()

    def run(self, wait_sleep_secs: float = 1.0):
        self._stopped = False
        self._start_heartbeats()
        ok = False
        try:
            seq = 0
            while True:
                task = self._master.get_step_task(
                    msg.GetStepTaskRequest(
                        seq=seq,
                        worker_id=self._worker_id,
                        cluster_version=self._cluster_version,
                    )
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
                if task.type == int(TaskType.TRAINING):
                    self._train_task(task)
                elif task.type == int(TaskType.SAVE_MODEL):
                    self._save_model_task(task)
                else:
                    # evaluation and prediction tasks come with the next
                    # part of the slice; the master never makes them for
                    # a distributed job (utils/args.py refuses the flags)
                    self._report_task_result(
                        task.task_id, f"task type {task.type} is not ported"
                    )
            if self._is_chief and self._trainer is not None:
                # the final state as a checkpoint, as the Local executor
                # leaves it (the periodic ones stop at a milestone)
                self._checkpointer.save_now(self._trainer, skip_if_current=True)
            self._dump_state_if_requested()
            ok = True
        finally:
            try:
                # a job must not end with an unwritten checkpoint, and a
                # failed flush must not replace an exception in flight
                self._checkpointer.flush_on_unwind(clean_exit=ok)
            finally:
                self._stopped = True

    def _dump_state_if_requested(self):
        out_dir = os.environ.get(DUMP_STATE_ENV, "")
        if not out_dir or self._trainer is None:
            return
        os.makedirs(out_dir, exist_ok=True)
        np.savez(
            os.path.join(out_dir, f"final_state_p{self._process_id}.npz"),
            **state_to_checkpoint(self._trainer.state),
        )

    @property
    def trainer(self):
        return self._trainer
