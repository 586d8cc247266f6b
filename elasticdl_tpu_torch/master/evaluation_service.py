"""Master-side evaluation: jobs, triggers, metric accumulation; a copy
of ``elasticdl_tpu/master/evaluation_service.py``.

``EvaluationJob`` accumulates the model's metrics (``eval_metrics_fn``)
from the output and label tensors the workers report; the
``_EvaluationTrigger`` thread queues time-based evaluations
(``--evaluation_start_delay_secs``, ``--evaluation_throttle_secs``);
``add_evaluation_task_if_needed`` queues step-based ones when a reported
model version crosses a ``--evaluation_steps`` milestone.  The
evaluation tasks themselves are created in the task dispatcher.  The
port has no TensorBoard service yet (slice 10): the master passes None,
as the JAX master does when ``--tensorboard_log_dir`` is empty.
"""

from __future__ import annotations

import threading
import time

from elasticdl_tpu_torch.trainer.metrics import (
    metric_tree_results,
    update_metric_tree,
)
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger


class EvaluationJob:
    """One evaluation pass at a model version (reference :14-124)."""

    def __init__(
        self,
        metrics_tree,
        model_version: int,
        total_tasks: int = -1,
        job_id: int = 0,
    ):
        self.model_version = model_version
        # identity used to tie task completions to THIS job: a stale eval
        # task re-queued by a lease timeout and finished after the job
        # rotated must not count toward the next job's total
        self.job_id = job_id
        self._total_tasks = total_tasks
        self._completed_tasks = 0
        self._metrics = metrics_tree
        # the step the reporting worker actually evaluated with (may be
        # later than the milestone version — documented deviation from the
        # reference, which restores the checkpoint at the milestone)
        self.evaluated_version = -1

    def complete_task(self):
        self._completed_tasks += 1

    def finished(self) -> bool:
        return 0 <= self._total_tasks <= self._completed_tasks

    def report_evaluation_metrics(
        self, model_outputs, labels, evaluated_version: int = -1
    ) -> bool:
        """``model_outputs``: name -> Tensor (wire format); labels Tensor."""
        if labels is None:
            return False
        self.evaluated_version = max(self.evaluated_version, evaluated_version)
        outputs = {
            name: t.values for name, t in model_outputs.items()
        }
        if len(outputs) == 1:
            outputs = next(iter(outputs.values()))
        update_metric_tree(self._metrics, labels.values, outputs)
        return True

    def get_evaluation_summary(self) -> dict:
        return metric_tree_results(self._metrics)


class _EvaluationTrigger(threading.Thread):
    """Time-based trigger (reference :127-159)."""

    def __init__(self, eval_service, start_delay_secs, throttle_secs):
        super().__init__(daemon=True)
        self._eval_service = eval_service
        self._stopper = threading.Event()
        self._throttle_secs = throttle_secs
        self._eval_min_time = time.time() + start_delay_secs

    def stop(self):
        self._stopper.set()

    def _wait_enough_time(self, cur_time_secs, previous_round_start_secs):
        if cur_time_secs < self._eval_min_time:
            return False
        if (
            previous_round_start_secs != -1
            and cur_time_secs - previous_round_start_secs < self._throttle_secs
        ):
            return False
        return True

    def run(self):
        previous_round_start_secs = -1
        while not self._stopper.is_set():
            time_now = time.time()
            if self._wait_enough_time(time_now, previous_round_start_secs):
                self._eval_service.add_evaluation_task(is_time_based_eval=True)
                previous_round_start_secs = time_now
            time.sleep(5)


class EvaluationService:
    """Schedules EVALUATION tasks and aggregates their metrics
    (reference :162-293)."""

    def __init__(
        self,
        tensorboard_service,
        task_dispatcher,
        eval_metrics_fn,
        start_delay_secs: float = 0,
        throttle_secs: float = 0,
        evaluation_steps: int = 0,
        eval_only: bool = False,
        eval_exporter=None,
    ):
        self._tensorboard_service = tensorboard_service
        self._task_d = task_dispatcher
        self._lock = threading.Lock()
        self._eval_job: EvaluationJob | None = None
        self.trigger = threading.Event()
        self._time_based = throttle_secs > 0
        self._eval_throttle_secs = throttle_secs
        self._eval_start_delay_secs = start_delay_secs
        self._eval_checkpoint_versions: list[int] = []
        self._latest_published_job = 0
        # highest milestone index (model_version // evaluation_steps)
        # already queued by the step-based trigger
        self._last_eval_milestone = 0
        self._job_seq = 0
        self._eval_metrics_fn = eval_metrics_fn
        self._evaluation_steps = evaluation_steps
        self._eval_only = eval_only
        self._eval_exporter = eval_exporter
        self._master_servicer = None
        self._eval_trigger: _EvaluationTrigger | None = None
        task_dispatcher.set_evaluation_service(self)

    def set_master_servicer(self, servicer):
        self._master_servicer = servicer

    # ---- lifecycle ---------------------------------------------------------

    def start(self):
        if self._time_based:
            self._eval_trigger = _EvaluationTrigger(
                self, self._eval_start_delay_secs, self._eval_throttle_secs
            )
            self._eval_trigger.start()

    def stop(self):
        if self._eval_trigger is not None:
            self._eval_trigger.stop()

    # ---- task creation -----------------------------------------------------

    def init_eval_only_job(self, num_tasks: int):
        # eval-only tasks are created by the dispatcher constructor with no
        # job id; completions arriving with job_id=None are accepted
        self._eval_job = EvaluationJob(self._eval_metrics_fn(), -1, num_tasks)

    def add_evaluation_task(
        self, is_time_based_eval: bool = False, model_version: int | None = None
    ):
        """Queue an evaluation at ``model_version``; it starts immediately
        if no eval job is running, else when the current one drains
        (milestone queueing, reference ``_eval_checkpoint_versions``)."""
        if is_time_based_eval and self._task_d.finished():
            # time-based fires are for in-progress training only; after the
            # job drains they would re-create work forever
            return
        if model_version is None:
            model_version = (
                self._master_servicer.get_model_version()
                if self._master_servicer
                else -1
            )
        with self._lock:
            self._eval_checkpoint_versions.append(model_version)
        self._try_start_next()

    def _try_start_next(self):
        with self._lock:
            if self._eval_job is not None and not self._eval_job.finished():
                return
            if not self._eval_checkpoint_versions:
                return
            model_version = self._eval_checkpoint_versions.pop(0)
            self._job_seq += 1
            job_id = self._job_seq
            n = self._task_d.create_evaluation_tasks(
                model_version, eval_job_id=job_id
            )
            if n == 0:
                return
            self._eval_job = EvaluationJob(
                self._eval_metrics_fn(), model_version, n, job_id=job_id
            )
        logger.info(
            "Created evaluation job %d at model version %d (%d tasks)",
            job_id,
            model_version,
            n,
        )

    def add_evaluation_task_if_needed(self, master_locking, model_version):
        """Step-based trigger on milestone *crossing*: workers report
        versions only at task boundaries, so requiring an exact multiple of
        ``evaluation_steps`` (the reference's check, :246-261) silently
        skips milestones whenever the boundary step isn't aligned.  Trigger
        whenever ``model_version // evaluation_steps`` advances instead,
        with the check-and-set under the lock (concurrent report_version
        RPCs must not queue the same milestone twice)."""
        del master_locking  # no master-side version lock on the TPU build
        if not self._evaluation_steps:
            return
        if model_version is None and self._master_servicer:
            model_version = self._master_servicer.get_model_version()
        if not model_version:
            return
        with self._lock:
            milestone = model_version // self._evaluation_steps
            if milestone <= self._last_eval_milestone:
                return
            self._last_eval_milestone = milestone
            # enqueue under the SAME lock: concurrent reports crossing
            # different milestones must land in version order
            self._eval_checkpoint_versions.append(model_version)
        self._try_start_next()

    # ---- metric flow -------------------------------------------------------

    def report_evaluation_metrics(
        self, model_outputs, labels, evaluated_version: int = -1
    ) -> bool:
        with self._lock:
            if self._eval_job is None:
                return False
            return self._eval_job.report_evaluation_metrics(
                model_outputs, labels, evaluated_version=evaluated_version
            )

    def complete_task(self, eval_job_id: int | None = None):
        with self._lock:
            if self._eval_job is None:
                return None
            if (
                eval_job_id is not None
                and eval_job_id != self._eval_job.job_id
            ):
                # a lease-reclaimed task from an earlier job finished late:
                # its metrics were already dropped by the lease guard, and
                # its completion must not advance THIS job's count
                logger.warning(
                    "Dropping completion for stale eval job %d "
                    "(current job %d)",
                    eval_job_id,
                    self._eval_job.job_id,
                )
                return None
            self._eval_job.complete_task()
            if not self._eval_job.finished():
                return None
            job, self._eval_job = self._eval_job, None

        # job done: publish results (reference :271-293).  The published
        # summary carries BOTH versions: the milestone the eval was
        # scheduled at and the step the workers actually evaluated with —
        # deviation D5 (no checkpoint restore at the milestone), so the
        # two can legitimately differ and the user must be able to see it.
        summary = job.get_evaluation_summary()
        logger.info(
            "Evaluation @version %d (evaluated with step-%d state): %s",
            job.model_version,
            job.evaluated_version,
            summary,
        )
        if self._tensorboard_service is not None:
            self._tensorboard_service.write_dict_to_summary(
                summary, version=max(job.model_version, 0)
            )
        summary = dict(summary)
        if job.model_version >= 0:
            summary["model_version"] = job.model_version
        if job.evaluated_version >= 0:
            summary["evaluated_version"] = job.evaluated_version
        if self._eval_exporter is not None:
            self._eval_exporter(job.model_version, summary)
        if self._eval_only:
            self.trigger.set()
        with self._lock:
            # this publish section runs unlocked, so a slow thread holding
            # an OLD finished job could otherwise overwrite a newer job's
            # summary; job ids are monotonic, so publish only forward
            if job.job_id >= self._latest_published_job:
                self._latest_published_job = job.job_id
                self.latest_summary = summary
        self._try_start_next()  # queued milestones run back-to-back
        return summary
