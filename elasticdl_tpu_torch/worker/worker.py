"""The task-stream worker: one process that leases its own tasks and
trains, evaluates and predicts on one device; the counterpart of
``elasticdl_tpu/worker/worker.py``, which a distributed job of one
worker runs (``--num_workers 1``).

The task flow is the JAX package's:

- training tasks stream through the vectorized per-task pipeline
  (``build_task_batches``) with a ``TaskPrefetcher`` leasing and
  decoding the next task while the device runs; each batch's records
  are counted into ``TaskDataService.report_record_done``, which reports
  every task exactly once, whatever the batch size;
- at a task boundary the worker reports its model version (which may
  queue a step-based evaluation on the master), may write a periodic
  checkpoint, and drains the evaluation tasks the master holds;
- an evaluation task's outputs and labels are reported once, with the
  task's lease id, just before the task's own report;
- prediction streams like training and hands every batch's outputs to
  the model's ``PredictionOutputsProcessor``;
- the SAVE_MODEL task, when the stream pauses for it, exports the state.

A compute failure is retried up to ``MAX_MINIBATCH_RETRY_NUM`` times and
then reported with the task (the master re-queues it); a decode failure
crashes the worker, and the master relaunches it under a new id.

``--device_prefetch`` stages each training task's batches on the card
while the current one computes (``trainer/device_pipeline.py``);
``--boundary_fusion`` keeps one stager across task boundaries.  A
staged batch dispatches once; its retry places it again from the host.

Unlike the JAX worker, this one writes a last checkpoint when its stream
ends (as the port's lockstep worker and Local executor do).  Left out
until the slices that bring them: re-homing to a restarted master
(slice 6b-2), and the step anatomy, tracing, profiling and compile
counters (slice 10).
"""

from __future__ import annotations

import threading
import time
import traceback

import numpy as np
import torch

from elasticdl_tpu_torch.data.fast_pipeline import build_task_batches
from elasticdl_tpu_torch.layers.attention import to_torch_dtype
from elasticdl_tpu_torch.ops.attention import dump_launch_counts_if_requested
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer, trim_pad
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import stats as rpc_stats
from elasticdl_tpu_torch.trainer import device_pipeline as dp
from elasticdl_tpu_torch.trainer.checkpointing import (
    PeriodicCheckpointer,
    restore_trainer_state,
)
from elasticdl_tpu_torch.trainer.host_pipeline import TaskPrefetcher
from elasticdl_tpu_torch.trainer.local_executor import INIT_SEED, build_optimizer
from elasticdl_tpu_torch.trainer.stacking import (
    MAX_AUTO_K,
    PreStacked,
    canonical_batch_rows,
    choose_stack_k,
    prestacked_weights,
    warm_dispatch_overhead_async,
)
from elasticdl_tpu_torch.trainer.state import Modes
from elasticdl_tpu_torch.utils.args import derive_job_type
from elasticdl_tpu_torch.utils.constants import (
    MAX_MINIBATCH_RETRY_NUM,
    JobType,
    TaskType,
)
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.export_utils import export_model
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec
from elasticdl_tpu_torch.utils.tensor import ndarray_to_tensor
from elasticdl_tpu_torch.utils.timing_utils import Timing
from elasticdl_tpu_torch.utils.tree_utils import batch_rows, stack_trees
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

HEARTBEAT_INTERVAL_SECS = 5.0


class Worker:
    def __init__(self, args, master, job_type: JobType | None = None):
        """``master``: a ``MasterClient``, or the servicer itself in
        process."""
        self._args = args
        self._master = master
        self._worker_id = int(args.worker_id)
        self._minibatch_size = args.minibatch_size
        self._job_type = job_type or derive_job_type(args)
        self._device = resolve_device(args.device)
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
        # the Local executor's seeded start
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(INIT_SEED)
            self._model = self._spec.build_model()
        self._task_data_service = TaskDataService(
            self,
            training_with_evaluation=(
                self._job_type == JobType.TRAINING_WITH_EVALUATION
            ),
            data_reader_params=args.data_reader_params_dict,
            data_origin=(
                args.prediction_data
                if self._job_type == JobType.PREDICTION_ONLY
                else args.training_data or args.validation_data
            ),
            custom_data_reader=self._spec.custom_data_reader,
        )
        self._trainer: SPMDTrainer | None = None
        self._stopped = False
        # shape-canonical batching on one device
        self._canonical_rows = canonical_batch_rows(self._minibatch_size, 1)
        self._steps_per_dispatch = args.steps_per_dispatch or 1
        # the device pipeline, from the master-forwarded environment;
        # cross-task staging needs staging
        self._device_prefetch = dp.resolve_device_prefetch(args.device_prefetch)
        self._boundary_fusion = self._device_prefetch and dp.resolve_boundary_fusion(
            args.boundary_fusion
        )
        self._pipeline_depth = dp.resolve_pipeline_depth(args.pipeline_depth)
        if self._steps_per_dispatch == "auto":
            # the auto sizing's probe, off the first dispatch's path
            warm_dispatch_overhead_async(self._device)
        self._checkpointer = PeriodicCheckpointer(
            args.checkpoint_dir,
            args.checkpoint_steps,
            keep_checkpoint_max=args.keep_checkpoint_max,
        )

    # ---- master protocol ---------------------------------------------------

    def get_task(self, task_type: int = -1) -> msg.TaskResponse:
        return self._master.get_task(
            msg.GetTaskRequest(worker_id=self._worker_id, task_type=task_type)
        )

    def report_task_result(
        self, task_id, err_msg="", exec_counters=None, include_timing=False
    ):
        counters = dict(exec_counters or {})
        if include_timing:
            # training reports only, so evaluation and save reports never
            # absorb training's buckets
            counters.update(self._timing.exec_counters())
        self._master.report_task_result(
            msg.ReportTaskResultRequest(
                task_id=task_id, err_message=err_msg, exec_counters=counters
            )
        )

    def report_version(self):
        if self._trainer is not None:
            self._master.report_version(
                msg.ReportVersionRequest(
                    model_version=self._trainer.step, worker_id=self._worker_id
                )
            )

    def report_evaluation_metrics(self, outputs, labels, model_version, task_id=-1):
        if isinstance(outputs, dict):
            out_tensors = {k: ndarray_to_tensor(k, np.asarray(v)) for k, v in outputs.items()}
        else:
            out_tensors = {"output": ndarray_to_tensor("output", np.asarray(outputs))}
        self._master.report_evaluation_metrics(
            msg.ReportEvaluationMetricsRequest(
                model_outputs=out_tensors,
                labels=ndarray_to_tensor("labels", np.asarray(labels)),
                model_version=model_version,
                task_id=task_id,
                # the state the worker evaluated with, not a restore of
                # the milestone's checkpoint (as in the JAX package)
                evaluated_version=self._trainer.step if self._trainer else -1,
            )
        )

    # ---- trainer lifecycle -------------------------------------------------

    def _ensure_trainer(self):
        """Build the trainer on the first batch, then resume from
        ``--checkpoint_dir`` or warm-start from
        ``--checkpoint_dir_for_init``."""
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
            device=self._device,
            device_parse=self._spec.device_parse,
            remat=bool(self._args.remat),
        )
        version = restore_trainer_state(self._trainer, self._args)
        if version is not None:
            self._checkpointer.note_restored_version(version)

    @property
    def trainer(self):
        return self._trainer

    # ---- minibatch processing ----------------------------------------------

    def _place(self, tree):
        return self._trainer.place_canonical(tree, self._canonical_rows)

    def _process_minibatch(self, task_type, features, labels, staged=None) -> str:
        """One minibatch, retried up to ``MAX_MINIBATCH_RETRY_NUM`` times
        after a failure; returns the last error, or "".  ``staged``: the
        batch as the device pipeline placed it, dispatched by the first
        attempt only (its buffers belong to that dispatch); a retry
        places it again from the host arrays."""
        err = ""
        for attempt in range(MAX_MINIBATCH_RETRY_NUM):
            try:
                self._ensure_trainer()
                if task_type == int(TaskType.TRAINING):
                    with self._timing.record("batch_process"):
                        if staged is not None and attempt == 0:
                            self._trainer.train_step(*staged.take()[0])
                        else:
                            n = batch_rows(labels)
                            self._trainer.train_step(
                                self._place(features),
                                self._place(labels),
                                self._trainer.place_mask(n, self._canonical_rows),
                            )
                elif task_type == int(TaskType.PREDICTION):
                    self._predict_minibatch(features)
                else:
                    raise RuntimeError(f"Unknown task type {task_type}")
                return ""
            except Exception as ex:  # noqa: BLE001 — reported with the task
                err = str(ex)
                traceback.print_exc()
        return err

    def _process_stacked_group(self, group: PreStacked, staged=None) -> str:
        """A ``PreStacked`` group of k steps (one dispatch) under the
        retry and staging contract of :meth:`_process_minibatch`."""
        err = ""
        for attempt in range(MAX_MINIBATCH_RETRY_NUM):
            try:
                self._ensure_trainer()
                with self._timing.record("batch_process"):
                    if staged is not None and attempt == 0:
                        self._trainer.train_steps_stacked(*staged.take())
                    else:
                        self._trainer.train_steps_stacked(
                            *self._trainer.place_group(
                                group.features, group.labels, prestacked_weights(group)
                            )
                        )
                return ""
            except Exception as ex:  # noqa: BLE001 — reported with the task
                err = str(ex)
                traceback.print_exc()
        return err

    def _predict_minibatch(self, features):
        n = batch_rows(features)
        outputs = trim_pad(self._trainer.predict_step(self._place(features)), n)
        if self._spec.prediction_outputs_processor is not None:
            self._spec.prediction_outputs_processor.process(outputs, self._worker_id)

    # ---- job flows ---------------------------------------------------------

    def on_wait(self):
        """Called by ``TaskDataService`` while the master says WAIT:
        evaluation tasks may be all that is left, so drain them."""
        if self._job_type == JobType.TRAINING_WITH_EVALUATION:
            self._evaluate_only()

    def _train_and_evaluate(self):
        tds = self._task_data_service
        while True:
            first = tds.start_task_stream()
            if first is None:
                # the job finished, or its SAVE_MODEL task arrived
                self._process_save_model_task_if_needed()
                break
            self._train_task_stream(first)
            self._timing.report_timing(reset=True)
            if self._job_type == JobType.TRAINING_WITH_EVALUATION:
                self._evaluate_only()
            self._process_save_model_task_if_needed()

    def _train_task_stream(self, first_task) -> int:
        """Consume training tasks until the master pauses the stream.
        ``first_task`` is leased and registered; the prefetcher's
        producer thread leases the rest.  A compute failure is retried
        and reported with its task; a decode failure (raised here by the
        prefetcher) crashes the worker: corrupt data fails loudly rather
        than re-queueing forever."""
        tds = self._task_data_service
        k = self._steps_per_dispatch
        k_bound = MAX_AUTO_K if k == "auto" else int(k)
        prefetcher = self._task_prefetcher(
            first_task, self._task_batches, max_buffered_batches=max(4, 2 * k_bound)
        )
        total = 0

        def account(n, err):
            nonlocal total
            total += n
            if tds.report_record_done(n, err):
                # a task boundary: arm the stall clock, report the
                # version (which may queue a step-based evaluation),
                # checkpoint, and drain the evaluation tasks
                dp.note_task_boundary()
                self._timing.report_timing(reset=True)
                self.report_version()
                self._checkpointer.maybe_save(self._trainer)
                if self._job_type == JobType.TRAINING_WITH_EVALUATION:
                    self._evaluate_only()

        def run_serial(task, batches):
            for batch in batches:
                dp.note_boundary_dispatch()
                if isinstance(batch, PreStacked):
                    err = self._process_stacked_group(batch)
                    n = batch.num_records
                else:
                    features, labels = batch
                    err = self._process_minibatch(task.type, features, labels)
                    n = batch_rows(labels)
                account(n, err)

        def handle_staged(task, staged):
            if staged.error is not None:
                # staging failed off-thread: this group goes the serial
                # way, placed from the host under the retry
                logger.warning(
                    "Device staging failed (%s); retrying the group from host",
                    staged.error,
                )
                staged_arg = None
            else:
                staged_arg = staged
            dp.note_boundary_dispatch()
            if isinstance(staged.host, PreStacked):
                err = self._process_stacked_group(staged.host, staged=staged_arg)
            else:
                ((features, labels, _n),) = staged.host
                err = self._process_minibatch(
                    task.type, features, labels, staged=staged_arg
                )
            account(staged.records, err)

        def run_staged(task, batches):
            # plain batches stage as groups of one, PreStacked groups whole
            stager = dp.DeviceStager(
                lambda: self._trainer, iter(batches), 1, self._canonical_rows,
                depth=dp.stage_depth(None, self._pipeline_depth),
            )
            try:
                for staged in stager:
                    handle_staged(task, staged)
            finally:
                stager.close()

        def run_fused(stream):
            # one stager walks the whole task stream, task marks between
            # the tasks; a group staged but never dispatched (the loop
            # unwinds) dies untaken: never dispatched, never reported
            def feed():
                for tid, task, batches in stream:
                    yield dp.TaskMark(dp.TaskMark.START, tid, task)
                    yield from batches
                    yield dp.TaskMark(dp.TaskMark.END, tid, task)

            stager = dp.DeviceStager(
                lambda: self._trainer, feed(), 1, self._canonical_rows,
                depth=dp.stage_depth(None, self._pipeline_depth),
            )
            task = None
            try:
                while True:
                    kind, payload = stager.next_event()
                    if kind == dp._STAGE_KIND_DONE:
                        break
                    if kind == dp._STAGE_KIND_ERROR:
                        raise payload
                    if kind == dp._STAGE_KIND_MARK:
                        task = payload.task if payload.kind == dp.TaskMark.START else None
                        continue
                    handle_staged(task, payload)
            finally:
                stager.close()

        try:
            if self._boundary_fusion:
                stream = iter(prefetcher)
                # until the trainer exists (staging places for it), tasks
                # run serially: normally just the first one
                while self._trainer is None:
                    item = next(stream, None)
                    if item is None:
                        return total
                    _tid, task, batches = item
                    run_serial(task, batches)
                run_fused(stream)
                return total
            for _tid, task, batches in prefetcher:
                if self._device_prefetch and self._trainer is not None:
                    run_staged(task, batches)
                else:
                    run_serial(task, batches)
        finally:
            dp.clear_boundary_mark()
            prefetcher.close()
        return total

    def _task_prefetcher(self, first_task, make_batches, **kwargs):
        """Serve the already-leased first task, then let the producer
        thread lease the rest."""
        tds = self._task_data_service
        served = [first_task]

        def next_task():
            if served:
                task = served.pop()
                return task.task_id, task
            return tds.lease_task()

        return TaskPrefetcher(next_task, make_batches, **kwargs)

    def _task_batches(self, task, mode: Modes = Modes.TRAINING, prefetch: int = 0):
        """One task's minibatches; ``PreStacked`` groups when
        ``--steps_per_dispatch`` asks for them (training only)."""
        reader = self._task_data_service.data_reader
        return build_task_batches(
            reader,
            task,
            self._spec,
            mode,
            reader.metadata,
            self._minibatch_size,
            shuffle_records=mode == Modes.TRAINING,
            prefetch=prefetch,
            stack_k=choose_stack_k(self._steps_per_dispatch, mode == Modes.TRAINING),
            dispatch_device=self._device,
        )

    def _evaluate_only(self, wait: bool = False) -> bool:
        """Drain evaluation tasks.  ``wait`` (an evaluation-only job): a
        WAIT means another worker may still give one back, so poll until
        the master says the job is done; otherwise WAIT means none now."""
        executed = False
        while True:
            task = self.get_task(int(TaskType.EVALUATION))
            if not task.shard_name:
                if wait and task.is_wait:
                    time.sleep(self._task_data_service._wait_sleep_secs)
                    continue
                break
            self._process_eval_task(task)
            executed = True
        return executed

    def _process_eval_task(self, task):
        """Evaluate one task and report its outputs and labels ONCE, with
        the task's lease id, just before the task's report: a retried or
        reclaimed task cannot count twice (the master drops reports of
        inactive leases and second reports of one lease)."""
        err = ""
        all_outputs, all_labels = [], []
        # in-dataset prefetch: evaluation consumes on this thread
        for features, labels in self._task_batches(task, Modes.EVALUATION, prefetch=2):
            for _ in range(MAX_MINIBATCH_RETRY_NUM):
                try:
                    self._ensure_trainer()
                    n = batch_rows(labels)
                    outputs, _loss = self._trainer.eval_step(
                        self._place(features),
                        self._place(labels),
                        self._trainer.place_mask(n, self._canonical_rows),
                    )
                    all_outputs.append(trim_pad(outputs, n))
                    all_labels.append(np.asarray(labels))
                    err = ""
                    break
                except Exception as ex:  # noqa: BLE001 — reported with the task
                    err = str(ex)
                    traceback.print_exc()
            if err:
                break
        if not err and all_outputs:
            self.report_evaluation_metrics(
                stack_trees(all_outputs, np.concatenate), np.concatenate(all_labels),
                task.model_version, task_id=task.task_id,
            )
        self.report_task_result(task.task_id, err)

    def _predict_only(self):
        """Prediction on the per-task pipeline, the next task decoded
        while the device runs."""
        tds = self._task_data_service
        while True:
            first = tds.start_task_stream()
            if first is None:
                break
            prefetcher = self._task_prefetcher(
                first, lambda task: self._task_batches(task, Modes.PREDICTION)
            )
            try:
                for _tid, task, batches in prefetcher:
                    for features in batches:
                        err = self._process_minibatch(task.type, features, None)
                        tds.report_record_done(batch_rows(features), err)
            finally:
                prefetcher.close()

    def _process_save_model_task_if_needed(self) -> bool:
        task, _ = self._task_data_service.get_save_model_task_and_dataset()
        if task is None:
            return False
        path = task.extended.get("saved_model_path", "") or self._args.output
        err = ""
        try:
            if self._trainer is None:
                raise RuntimeError("no trained state to save")
            export_model(
                path,
                self._trainer.state.model,
                self._args.model_def,
                model_params=self._args.model_params_dict,
                model_zoo=self._args.model_zoo,
                model_version=self._trainer.step,
            )
        except Exception as ex:  # noqa: BLE001 — reported with the task
            err = str(ex)
            traceback.print_exc()
        self.report_task_result(task.task_id, err)
        return True

    def _start_heartbeats(self, interval_secs: float = HEARTBEAT_INTERVAL_SECS):
        """Liveness across long compute gaps (every ``get_task`` counts
        too), with the RPC outcome and staging totals."""

        def beat():
            while not self._stopped:
                try:
                    self._master.heartbeat(
                        msg.HeartbeatRequest(
                            worker_id=self._worker_id,
                            step=self._trainer.step if self._trainer else 0,
                            timestamp=time.time(),
                            rpc=rpc_stats.snapshot(),
                            prefetch=dp.heartbeat_snapshot(),
                        )
                    )
                except Exception:  # noqa: BLE001 — the master may be gone
                    pass
                time.sleep(interval_secs)

        threading.Thread(target=beat, name="heartbeat", daemon=True).start()

    def run(self):
        self._stopped = False
        self._start_heartbeats()
        ok = False
        try:
            if self._job_type == JobType.PREDICTION_ONLY:
                self._predict_only()
            elif self._job_type == JobType.EVALUATION_ONLY:
                self._evaluate_only(wait=True)
            else:
                self._train_and_evaluate()
                if self._checkpointer.enabled and self._trainer is not None:
                    # the final state as a checkpoint, as the Local
                    # executor leaves it
                    self._checkpointer.save_now(self._trainer, skip_if_current=True)
            dump_launch_counts_if_requested(f"w{self._worker_id}")
            ok = True
        finally:
            try:
                # a job must not end with an unwritten checkpoint, and a
                # failed flush must not replace an exception in flight
                self._checkpointer.flush_on_unwind(clean_exit=ok)
            finally:
                self._stopped = True
