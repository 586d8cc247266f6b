"""Single-process training, evaluation and prediction; the counterpart of
``elasticdl_tpu/trainer/local_executor.py`` (the Local strategy).

No master process and no RPC, but the same task-based data traversal: a
real in-process :class:`TaskDispatcher` hands out the tasks, a
:class:`TaskPrefetcher` decodes them ahead on a host thread, every batch
is padded to one canonical shape with a row mask, and the port's
:class:`SPMDTrainer` takes the optimizer steps on the device
``--device`` names: one per batch, or ``--steps_per_dispatch k`` per
dispatch (one CUDA graph replay on the card), with ``--device_prefetch``
staging the next group while the current one computes
(``trainer/device_pipeline.py``).  Periodic checkpoints, a final
evaluation and an export close the run.

With ``--telemetry_dir D`` every step's sample goes to
``D/events.jsonl`` (``telemetry/worker_hooks.py``), and with
``--step_anatomy`` every dispatch group's sum-exact phases too
(``telemetry/anatomy.py``), which ``telemetry/report.py::goodput_section``
reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.data.fast_pipeline import build_task_batches
from elasticdl_tpu_torch.layers.attention import to_torch_dtype
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer, trim_pad
from elasticdl_tpu_torch.telemetry import anatomy as anatomy_mod
from elasticdl_tpu_torch.telemetry import tracing, worker_hooks
from elasticdl_tpu_torch.trainer import metrics as metrics_lib
from elasticdl_tpu_torch.trainer.checkpointing import (
    PeriodicCheckpointer,
    restore_trainer_state,
)
from elasticdl_tpu_torch.trainer import device_pipeline
from elasticdl_tpu_torch.trainer.host_pipeline import TaskPrefetcher
from elasticdl_tpu_torch.trainer.stacking import (
    MAX_AUTO_K,
    canonical_batch_rows,
    choose_stack_k,
    run_stacked_steps,
    warm_dispatch_overhead_async,
)
from elasticdl_tpu_torch.trainer.state import (
    LRSchedule,
    Modes,
    TrainState,
    takes_named_parameters,
    wants_named_parameters,
)
from elasticdl_tpu_torch.trainer.step import resolve_optimizer
from elasticdl_tpu_torch.utils.args import check_ported_flags
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.export_utils import export_model
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec
from elasticdl_tpu_torch.utils.profiling import StepProfiler
from elasticdl_tpu_torch.utils.timing_utils import Timing
from elasticdl_tpu_torch.utils.tree_utils import batch_rows

# the seed of the weights a run starts from when no checkpoint gives them
INIT_SEED = 0

# the model's hooks that the JAX package always looks up by their default
# names, whatever its flags say: flag -> default name
FIXED_HOOKS = {
    "custom_data_reader": "custom_data_reader",
    "prediction_outputs_processor": "PredictionOutputsProcessor",
}


def build_optimizer(spec, learning_rate=None):
    """The optimizer factory, honoring ``learning_rate_scheduler``.

    The JAX package passes the scheduler to optax as a schedule of the
    optimizer's update count; here an :class:`LRSchedule` step pre-hook
    sets every parameter group's lr to ``scheduler(count)`` before update
    ``count`` (0, 1, ...), which is the same learning rate at the same
    update.  The optimizer carries it as ``lr_schedule``."""
    factory = resolve_optimizer(spec.optimizer, learning_rate)
    if learning_rate is not None or spec.learning_rate_scheduler is None:
        return factory
    scheduler = spec.learning_rate_scheduler

    def build(params):
        opt = factory(params)
        opt.lr_schedule = LRSchedule(scheduler)
        opt.register_step_pre_hook(opt.lr_schedule)
        return opt

    return takes_named_parameters(build) if wants_named_parameters(factory) else build


class LocalExecutor:
    def __init__(self, args):
        check_ported_flags(args)
        self._args = args
        self._device = resolve_device(getattr(args, "device", "cuda"))
        self._spec = get_model_spec(
            args.model_zoo,
            args.model_def,
            model_params=args.model_params_dict,
            dataset_fn=args.dataset_fn,
            loss=args.loss,
            optimizer=args.optimizer,
            eval_metrics_fn=args.eval_metrics_fn,
        )
        for flag, default in FIXED_HOOKS.items():
            value = getattr(args, flag, default)
            if value != default:
                logger.warning(
                    "--%s=%r is ignored: the model's %r hook is used, as "
                    "the JAX package uses it", flag, value, default,
                )
        # torch modules initialise eagerly; a fixed seed makes the start
        # of a run without a checkpoint reproducible, and the fork keeps
        # the caller's generator as it was
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(INIT_SEED)
            # its tables built on the device
            self._model = self._spec.build_model(device=self._device)
        self._tx = build_optimizer(self._spec, args.learning_rate)
        self._train_reader = self._reader(args.training_data)
        self._eval_reader = self._reader(args.validation_data)
        self._predict_reader = self._reader(args.prediction_data)
        self._trainer: SPMDTrainer | None = None
        # shape-canonical batching: every train/eval/predict batch is
        # padded to this row count (one device, so the divisor is 1)
        self._canonical_rows = canonical_batch_rows(args.minibatch_size, 1)
        self._steps_per_dispatch = args.steps_per_dispatch or 1
        if self._steps_per_dispatch == "auto":
            # the auto sizing's probe, off the first dispatch's path
            warm_dispatch_overhead_async(self._device)
        # the device pipeline, resolved once: staging (--device_prefetch),
        # cross-task staging (--boundary_fusion, which needs staging) and
        # the retire window (--pipeline_depth)
        self._device_prefetch = device_pipeline.resolve_device_prefetch(
            args.device_prefetch
        )
        self._boundary_fusion = (
            self._device_prefetch
            and device_pipeline.resolve_boundary_fusion(args.boundary_fusion)
        )
        self._pipeline_depth = device_pipeline.resolve_pipeline_depth(
            args.pipeline_depth
        )
        self._checkpointer = PeriodicCheckpointer(
            args.checkpoint_dir,
            args.checkpoint_steps,
            keep_checkpoint_max=args.keep_checkpoint_max,
        )
        self._timing = Timing(enabled=args.log_level == "DEBUG", logger=logger)
        # per-step samples in the run's event log (--telemetry_dir, or the
        # environment a master exported), and the per-dispatch anatomy
        telemetry_dir = args.telemetry_dir or os.environ.get(
            worker_hooks.TELEMETRY_DIR_ENV, ""
        )
        worker_hooks.install(telemetry_dir)
        anatomy_mod.install_if_enabled(
            args.step_anatomy, model_def=args.model_def, device=self._device
        )
        # the span tracer on the same directory (sampled step spans, the
        # trainer build, checkpoint and profile-window spans): the one
        # process's part of the distributed trace
        tracing.install(telemetry_dir, sample_rate=args.trace_sample_rate)
        self._last_eval_milestone = 0
        self._profiler = StepProfiler(
            args.profile_dir, num_steps=args.profile_steps, device=self._device
        )

    def _reader(self, data_origin: str):
        if not data_origin:
            return None
        return create_data_reader(
            data_origin,
            records_per_task=self._args.records_per_task,
            custom_reader=self._spec.custom_data_reader,
            **self._args.data_reader_params_dict,
        )

    # ---- plumbing ---------------------------------------------------------

    def _task_dataset(self, reader, task, mode: Modes, prefetch: int = 2):
        # prefetch=0 on the training path: TaskPrefetcher's producer
        # thread is the overlap there; eval/predict (main-thread
        # consumers) keep the in-dataset prefetch.  A Dataset, so a task
        # can be re-iterated.  Training batches of the vectorized path
        # arrive as ready-made PreStacked groups under
        # --steps_per_dispatch > 1, built on the producer thread.
        return build_task_batches(
            reader,
            task,
            self._spec,
            mode,
            reader.metadata,
            self._args.minibatch_size,
            shuffle_records=mode == Modes.TRAINING,
            prefetch=prefetch,
            stack_k=choose_stack_k(
                self._steps_per_dispatch, mode == Modes.TRAINING
            ),
            dispatch_device=self._device,
        )

    def _ensure_trainer(self):
        """Build the trainer on the first batch, then restore its state:
        resume from ``--checkpoint_dir``, else warm-start from
        ``--checkpoint_dir_for_init``."""
        if self._trainer is not None:
            return
        compute_dtype = self._args.compute_dtype
        with tracing.trace_span(tracing.SPAN_TRAINER_BUILD):
            self._trainer = SPMDTrainer(
                self._model,
                self._spec.loss,
                self._tx,
                compute_dtype=(
                    None if compute_dtype == "float32"
                    else to_torch_dtype(compute_dtype)
                ),
                device=self._device,
                device_parse=self._spec.device_parse,
                remat=bool(self._args.remat),
                # one process: no rule shards (the JAX executor's call)
                sharding_rules=self._spec.rules_for(1),
            )
            version = restore_trainer_state(self._trainer, self._args)
        if version is not None:
            self._checkpointer.note_restored_version(version)
            if self._args.evaluation_steps:
                # milestones evaluated before the restore point must not
                # fire again on the first step after it
                self._last_eval_milestone = (
                    version // self._args.evaluation_steps
                )

    def _place_canonical(self, tree):
        return self._trainer.place_canonical(tree, self._canonical_rows)

    @property
    def _version(self) -> int:
        return self._trainer.step if self._trainer is not None else 0

    # ---- phases -----------------------------------------------------------

    def _train_task(self, batches) -> int:
        """One task's batches through the shared grouping policy
        (``trainer.stacking.run_stacked_steps``; k = 1 is a group of
        one).  The milestone hooks run after each dispatch."""
        return run_stacked_steps(
            lambda: self._trainer,
            batches,
            self._steps_per_dispatch,
            pre_batch=self._pre_batch,
            post_group=self._post_step_hooks,
            dispatch_ctx=lambda: self._timing.record("batch_process"),
            canonical_rows=self._canonical_rows,
            device_prefetch=self._device_prefetch,
            pipeline_depth=self._pipeline_depth,
            anatomy=anatomy_mod.get_recorder(),
        )

    def _pre_batch(self, _features):
        self._ensure_trainer()
        # the profiler counts calls, one a minibatch: the version moves
        # only at a dispatch, so it repeats inside a stacked group
        self._profiler.on_step()
        # one early return each when telemetry is off
        worker_hooks.record_step(self._version, self._args.minibatch_size)
        tracing.record_step_span(self._version)

    def _post_step_hooks(self):
        # milestone-crossing, not exact-multiple, as in the JAX package:
        # one dispatch may advance the version by k
        if self._args.evaluation_steps:
            milestone = self._version // self._args.evaluation_steps
            if milestone > self._last_eval_milestone:
                self._last_eval_milestone = milestone
                self.evaluate(tag=f"step {self._version}")
        self._checkpointer.maybe_save(self._trainer)

    def evaluate(self, tag: str = "final") -> dict:
        if self._eval_reader is None or self._trainer is None:
            return {}
        eval_metrics = (
            self._spec.eval_metrics_fn()
            if self._spec.eval_metrics_fn
            else {"loss": metrics_lib.Mean()}
        )
        dispatcher = TaskDispatcher(
            None,
            evaluation_shards=self._eval_reader.create_shards(),
            records_per_task=self._args.records_per_task,
        )
        loss_mean = metrics_lib.Mean()
        while True:
            tid, task = dispatcher.get_eval_task(0)
            if task is None:
                break
            for features, labels in self._task_dataset(
                self._eval_reader, task, Modes.EVALUATION
            ):
                n = batch_rows(labels)
                # mask-weighted in-step loss: exact over the real rows
                outputs, loss = self._trainer.eval_step(
                    self._place_canonical(features),
                    self._place_canonical(labels),
                    self._trainer.place_mask(n, self._canonical_rows),
                )
                outputs = trim_pad(outputs, n)
                metrics_lib.update_metric_tree(
                    eval_metrics, np.asarray(labels), outputs
                )
                loss_mean.update_value(float(loss), n)
            dispatcher.report(tid, True)
        results = metrics_lib.metric_tree_results(eval_metrics)
        results["loss"] = loss_mean.result()
        logger.info("Evaluation (%s): %s", tag, results)
        return results

    def predict(self) -> list:
        if self._predict_reader is None:
            return []
        dispatcher = TaskDispatcher(
            None,
            prediction_shards=self._predict_reader.create_shards(),
            records_per_task=self._args.records_per_task,
        )
        outputs_all = []
        while True:
            tid, task = dispatcher.get(0)
            if task is None:
                break
            for features in self._task_dataset(
                self._predict_reader, task, Modes.PREDICTION
            ):
                self._ensure_trainer()
                n = batch_rows(features)
                outputs = self._trainer.predict_step(
                    self._place_canonical(features)
                )
                processed = trim_pad(outputs, n)
                if self._spec.prediction_outputs_processor is not None:
                    self._spec.prediction_outputs_processor.process(
                        processed, worker_id=0
                    )
                outputs_all.append(processed)
            dispatcher.report(tid, True)
        return outputs_all

    def run(self) -> dict:
        """Train (with periodic evaluation and checkpoints), then
        evaluate and export; returns the final evaluation's metrics.  A
        job without training data evaluates, or predicts."""
        if self._train_reader is None:
            if self._eval_reader is not None:
                self._init_from_eval_data()
                return self.evaluate()
            self.predict()
            return {}
        dispatcher = TaskDispatcher(
            self._train_reader.create_shards(),
            records_per_task=self._args.records_per_task,
            num_epochs=self._args.num_epochs,
            shuffle_seed=self._args.shuffle_seed,
        )
        total = 0
        ok = False
        # decode-ahead bounded to about two dispatch groups of batches
        # (an auto k is sized later: the largest it can be)
        k = self._steps_per_dispatch
        k = MAX_AUTO_K if k == "auto" else int(k)
        prefetcher = TaskPrefetcher(
            lambda: dispatcher.get(0),
            lambda task: self._task_dataset(
                self._train_reader, task, Modes.TRAINING, prefetch=0
            ),
            max_buffered_batches=max(4, 2 * k),
        )
        try:
            if self._boundary_fusion:
                # one stager walks the whole task stream; a task is
                # reported once its own dispatches retired
                total = device_pipeline.run_pipelined_task_stream(
                    lambda: self._trainer,
                    iter(prefetcher),
                    self._steps_per_dispatch,
                    pre_batch=self._pre_batch,
                    post_group=self._post_step_hooks,
                    dispatch_ctx=lambda: self._timing.record("batch_process"),
                    canonical_rows=self._canonical_rows,
                    task_done=lambda tid, _task, _n: dispatcher.report(tid, True),
                    pipeline_depth=self._pipeline_depth,
                    anatomy=anatomy_mod.get_recorder(),
                )
            else:
                for tid, task, batches in prefetcher:
                    with self._timing.record("task_process"):
                        total += self._train_task(batches)
                    # the task's window drained: the gap to the next
                    # task's first dispatch is the boundary stall
                    device_pipeline.note_task_boundary()
                    dispatcher.report(tid, True)
            ok = True
        finally:
            # a pending mark must not leak into a later run in this process
            device_pipeline.clear_boundary_mark()
            prefetcher.close()
            try:
                # an in-flight async checkpoint must not be abandoned by a
                # mid-training exception, nor may a failed flush replace it
                self._checkpointer.flush_on_unwind(clean_exit=ok)
            finally:
                # close (or diagnose) the capture even on an error: a
                # leaked one poisons a later start_trace
                self._profiler.stop()
                tracing.flush()
        logger.info(
            "Training complete: %d records, %d steps", total, self._version
        )
        worker_hooks.publish_timing(self._timing)
        self._timing.report_timing(reset=True)
        if self._checkpointer.enabled and self._trainer is not None:
            self._checkpointer.save_now(self._trainer, skip_if_current=True)
            self._checkpointer.flush()
        results = self.evaluate()
        if self._args.output and self._trainer is not None:
            export_model(
                self._args.output,
                self._trainer.state.model,
                self._args.model_def,
                model_params=self._args.model_params_dict,
                model_zoo=self._args.model_zoo,
                model_version=self._trainer.step,
            )
        return results

    def _init_from_eval_data(self):
        """Build (and restore) the trainer for an evaluation-only job,
        from the first evaluation task's first batch."""
        dispatcher = TaskDispatcher(
            None,
            evaluation_shards=self._eval_reader.create_shards(),
            records_per_task=self._args.records_per_task,
        )
        _tid, task = dispatcher.get_eval_task(0)
        if task is None:
            return
        for _batch in self._task_dataset(
            self._eval_reader, task, Modes.EVALUATION
        ):
            self._ensure_trainer()
            break

    @property
    def state(self) -> TrainState | None:
        return self._trainer.state if self._trainer is not None else None

    @property
    def trainer(self) -> SPMDTrainer | None:
        return self._trainer

