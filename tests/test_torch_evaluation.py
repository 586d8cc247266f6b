"""The master's evaluation service (``elasticdl_tpu_torch/master/
evaluation_service.py``, the servicer's evaluation reports and the
master's wiring) against the JAX package's, on the CPU: the cases of
``tests/test_master_eval.py``, each run against both packages' masters
on the same wire tensors.

- Metrics from wire tensors; the step trigger queues a milestone once,
  also under concurrent version reports and when versions are reported
  again after a restore; a milestone that arrives while an evaluation
  runs waits its turn.
- A report for an inactive lease, and a second report for one lease, are
  dropped; the summary carries the milestone and the evaluated version.
- A job with validation data and no trigger evaluates once at the end;
  an evaluation-only job evaluates once (each with the package's own
  task-stream worker in process).
- Both services give the same summary from the same reports.
"""

from __future__ import annotations

import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("jax", "port")
MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"


def _pkg(name: str):
    if name == "jax":
        from elasticdl_tpu.data.recordio_gen import synthetic
        from elasticdl_tpu.master import evaluation_service as es
        from elasticdl_tpu.master.master import Master
        from elasticdl_tpu.rpc import messages as msg
        from elasticdl_tpu.trainer.metrics import Accuracy
        from elasticdl_tpu.utils import args
        from elasticdl_tpu.utils.tensor import ndarray_to_tensor
        from elasticdl_tpu.worker.worker import Worker

        extra = []
    else:
        from elasticdl_tpu_torch.data.recordio_gen import synthetic
        from elasticdl_tpu_torch.master import evaluation_service as es
        from elasticdl_tpu_torch.master.master import Master
        from elasticdl_tpu_torch.rpc import messages as msg
        from elasticdl_tpu_torch.trainer.metrics import Accuracy
        from elasticdl_tpu_torch.utils import args
        from elasticdl_tpu_torch.utils.tensor import ndarray_to_tensor
        from elasticdl_tpu_torch.worker.worker import Worker

        extra = ["--device", "cpu"]
    return SimpleNamespace(
        name=name, es=es, Master=Master, msg=msg, Accuracy=Accuracy, args=args,
        tensor=ndarray_to_tensor, Worker=Worker, synthetic=synthetic, extra=extra,
    )


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    root = tmp_path_factory.mktemp("eval_service")
    return {
        "train": gen_mnist(str(root / "t"), num_records=64, num_shards=1, seed=0),
        "eval": gen_mnist(str(root / "e"), num_records=32, num_shards=1, seed=1),
    }


def _master(p, train="", evaluation="", extra=()):
    argv = [
        "--model_def", MNIST_DEF, "--minibatch_size", "16", "--records_per_task", "32",
        "--compute_dtype", "float32", "--port", "0",
    ]
    if train:
        argv += ["--training_data", train]
    if evaluation:
        argv += ["--validation_data", evaluation]
    return p.Master(p.args.parse_master_args(argv + list(extra)))


def _worker(p, master, train="", evaluation="", job_type=None):
    argv = [
        "--model_def", MNIST_DEF, "--minibatch_size", "16", "--worker_id", "0",
        "--master_addr", "inprocess", "--compute_dtype", "float32", *p.extra,
    ]
    if train:
        argv += ["--training_data", train]
    if evaluation:
        argv += ["--validation_data", evaluation]
    kwargs = {"job_type": job_type} if job_type is not None else {}
    return p.Worker(p.args.parse_worker_args(argv), master.servicer, **kwargs)


def _report(p, master, task_id, outputs, labels, evaluated_version=-1):
    master.servicer.report_evaluation_metrics(
        p.msg.ReportEvaluationMetricsRequest(
            model_outputs={"output": p.tensor("output", outputs)},
            labels=p.tensor("labels", labels),
            task_id=task_id,
            evaluated_version=evaluated_version,
        )
    )


def _version(p, master, version, worker_id=0):
    master.servicer.report_version(
        p.msg.ReportVersionRequest(model_version=version, worker_id=worker_id)
    )


@pytest.mark.parametrize("pkg", PKGS)
def test_metrics_from_wire_tensors(pkg):
    p = _pkg(pkg)
    job = p.es.EvaluationJob({"accuracy": p.Accuracy()}, model_version=3, total_tasks=2)
    outputs = {"output": p.tensor("output", np.eye(3, dtype=np.float32))}
    assert job.report_evaluation_metrics(outputs, p.tensor("labels", np.array([0, 1, 2])))
    assert job.get_evaluation_summary() == {"accuracy": 1.0}
    job.complete_task()
    assert not job.finished()
    job.complete_task()
    assert job.finished()


@pytest.mark.parametrize("pkg", PKGS)
def test_step_trigger_queues_a_milestone_once(pkg, data):
    p = _pkg(pkg)
    master = _master(p, data["train"], data["eval"], ["--evaluation_steps", "2"])
    _version(p, master, 2)
    n = len(master.task_d._pending_eval)
    assert n == 1
    _version(p, master, 2)
    _version(p, master, 3)
    assert len(master.task_d._pending_eval) == n
    # a milestone crossed while the first job runs waits for it
    _version(p, master, 4)
    svc = master.evaluation_service
    assert svc._eval_job.model_version == 2
    assert svc._eval_checkpoint_versions == [4]


@pytest.mark.parametrize("pkg", PKGS)
def test_concurrent_reports_queue_each_milestone_once(pkg, data):
    p = _pkg(pkg)
    master = _master(p, data["train"], data["eval"], ["--evaluation_steps", "2"])
    barrier = threading.Barrier(16)

    def ping(worker_id):
        barrier.wait()
        for version in (2, 3, 4):  # milestones 1, 1, 2
            _version(p, master, version, worker_id)

    threads = [threading.Thread(target=ping, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(not t.is_alive() for t in threads)
    svc = master.evaluation_service
    assert len(master.task_d._pending_eval) == 1
    assert svc._eval_checkpoint_versions == [4]
    # completing the first job starts the queued one
    for want in (2, 4):
        task_id, task = master.task_d.get_eval_task(worker_id=0)
        assert task.model_version == want
        master.task_d.report(task_id, success=True)
    assert svc._eval_job is None and not master.task_d._pending_eval


def _smoke_schedule():
    """The versions ``chip_smoke.py``'s phase 11a reports: task
    boundaries every 4 steps up to the kill at step 6, the re-formed
    world restoring version 4 and reporting again to the end."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cfg = chip_smoke.EVAL_MNIST
    task_steps = cfg["records_per_task"] // cfg["batch"]
    steps = cfg["train_records"] * cfg["epochs"] // cfg["batch"]
    first_world = [task_steps]  # killed at step 6, in the second task
    restored = task_steps  # the newest checkpoint at the kill
    second_world = list(range(restored + task_steps, steps + 1, task_steps))
    return cfg, first_world + second_world, chip_smoke.eval_milestones(cfg)


@pytest.mark.parametrize("pkg", PKGS)
def test_milestones_of_the_smoke_schedule_with_a_restore(pkg, tmp_path):
    """Each milestone is queued once, also when the re-formed world
    reports versions again after its restore; both packages queue the
    milestones the smoke's gate expects."""
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    p = _pkg(pkg)
    cfg, versions, milestones = _smoke_schedule()
    evaluation = gen_mnist(str(tmp_path / "e"), num_records=16, num_shards=1, seed=1)
    master = _master(
        p, evaluation, evaluation, ["--evaluation_steps", str(cfg["evaluation_steps"])]
    )
    queued = []
    for version in versions:
        _version(p, master, version)
        while True:
            task_id, task = master.task_d.get_eval_task(worker_id=0)
            if task is None:
                break
            queued.append(task.model_version)
            master.task_d.report(task_id, success=True)
    assert queued == milestones == [16, 32, 48, 64]


@pytest.mark.parametrize("pkg", PKGS)
def test_inactive_and_duplicate_reports_are_dropped(pkg, data):
    p = _pkg(pkg)
    master = _master(p, "", data["eval"])
    eye, labels = np.eye(3, dtype=np.float32), np.array([0, 1, 2])
    _report(p, master, 999, eye, labels)  # never leased
    job = master.evaluation_service._eval_job
    assert job.get_evaluation_summary()["accuracy"] == 0.0
    task_id, task = master.task_d.get_eval_task(worker_id=0)
    _report(p, master, task_id, eye, labels)
    _report(p, master, task_id, eye, np.array([1, 2, 0]))  # a re-delivery
    assert job.get_evaluation_summary()["accuracy"] == 1.0
    master.task_d.report(task_id, success=True)
    _report(p, master, task_id, eye, np.array([1, 2, 0]))  # after the task
    assert master.evaluation_service.latest_summary["accuracy"] == 1.0


@pytest.mark.parametrize("pkg", PKGS)
def test_summary_carries_the_evaluated_version(pkg, data):
    p = _pkg(pkg)
    master = _master(p, data["train"], data["eval"], ["--evaluation_steps", "2"])
    _version(p, master, 4)
    task_id, task = master.task_d.get_eval_task(worker_id=0)
    assert task.model_version == 4
    _report(p, master, task_id, np.eye(10, dtype=np.float32), np.arange(10), evaluated_version=7)
    master.task_d.report(task_id, success=True)
    summary = master.evaluation_service.latest_summary
    assert (summary["model_version"], summary["evaluated_version"], summary["accuracy"]) == (4, 7, 1.0)
    assert master.job_summary()["evaluation_metrics"] == summary


def test_both_services_agree_on_the_same_wire_tensors(data):
    """The same reports through both packages' masters give the same
    summary, bit for bit."""
    rng = np.random.RandomState(0)
    batches = [
        (rng.randn(n, 10).astype(np.float32), rng.randint(0, 10, n))
        for n in (32, 7, 19)
    ]
    summaries = []
    for pkg in PKGS:
        p = _pkg(pkg)
        master = _master(p, "", data["eval"])
        task_id, _task = master.task_d.get_eval_task(worker_id=0)
        outputs = np.concatenate([b[0] for b in batches])
        labels = np.concatenate([b[1] for b in batches])
        _report(p, master, task_id, outputs, labels, evaluated_version=5)
        master.task_d.report(task_id, success=True)
        summaries.append(master.job_summary()["evaluation_metrics"])
    assert summaries[0] == summaries[1]
    assert summaries[0]["accuracy"] == float(
        np.mean(np.argmax(np.concatenate([b[0] for b in batches]), -1)
                == np.concatenate([b[1] for b in batches]))
    )


@pytest.mark.parametrize("pkg", PKGS)
def test_final_evaluation_without_triggers(pkg, data):
    """With validation data and neither --evaluation_steps nor
    --evaluation_throttle_secs, the job evaluates once when training
    drains, on all the validation records."""
    from elasticdl_tpu_torch.utils.constants import TaskType

    p = _pkg(pkg)
    master = _master(p, data["train"], data["eval"])
    _worker(p, master, data["train"], data["eval"]).run()
    assert master.task_d.finished()
    summary = master.job_summary()
    assert summary["evaluation"]["total_records"] == 32
    assert summary["evaluation_metrics"]["model_version"] == 4  # 64 records / 16
    assert master.task_d.counters(TaskType.TRAINING).total_records == 64


@pytest.mark.parametrize("pkg", PKGS)
def test_evaluation_only_job(pkg, data):
    p = _pkg(pkg)
    master = _master(p, "", data["eval"])
    worker = _worker(p, master, "", data["eval"])
    worker.run()
    assert master.task_d.finished()
    assert master.evaluation_service.trigger.is_set()
    assert "accuracy" in master.job_summary()["evaluation_metrics"]
