"""The task-stream worker (``elasticdl_tpu_torch/worker/worker.py`` and
``task_data_service.py``) against the JAX package's, on the CPU: the
counterpart of ``tests/test_worker.py``.

- ``TaskDataService``'s count-based exactly-once accounting reports every
  task once, in order, for counts that straddle tasks or cover several,
  in both packages, with the same reports.
- In process, on the master's servicer: the worker trains to the end,
  predicts through the model's processor (from one JAX-written
  checkpoint, as the JAX worker predicts), and runs the SAVE_MODEL task.
- A one-worker ``AllreduceStrategy`` job through the CLI equals the
  port's Local run bit for bit, with and without ``--device_prefetch``:
  from the JAX init of seed 1 (ROADMAP.md queue 3: mnist from flax's
  initial BatchNorm is chaotic, seed 1 is not), one intra-op thread on
  both sides.
- A worker that finds no card raises.
- ``chip_smoke.py``'s phase 11c at a small size: a SIGKILLed worker is
  relaunched under a new id with exact records, and the LM's task-stream
  run equals Local bit for bit.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch import client
from elasticdl_tpu_torch.utils import save_utils

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
PREDICT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    """The worker processes this file starts inherit the environment: one
    intra-op thread each, as the in-process side sets for itself."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _pkg(name):
    if name == "jax":
        from elasticdl_tpu.rpc import messages as msg
        from elasticdl_tpu.utils.constants import TaskType
        from elasticdl_tpu.worker.task_data_service import TaskDataService
    else:
        from elasticdl_tpu_torch.rpc import messages as msg
        from elasticdl_tpu_torch.utils.constants import TaskType
        from elasticdl_tpu_torch.worker.task_data_service import TaskDataService
    return msg, TaskType, TaskDataService


class _ScriptedWorker:
    """Feeds a ``TaskDataService`` a fixed task list; records reports."""

    def __init__(self, msg, tasks):
        self._msg = msg
        self._tasks = list(tasks)
        self.reported = []

    def get_task(self, task_type=-1):
        return self._tasks.pop(0) if self._tasks else self._msg.TaskResponse()

    def report_task_result(self, task_id, err_msg="", exec_counters=None, include_timing=False):
        self.reported.append((task_id, err_msg, dict(exec_counters or {})))


def _wire_tds(cls, scripted):
    tds = cls.__new__(cls)
    tds._worker = scripted
    tds._training_with_evaluation = False
    tds._wait_sleep_secs = 0
    tds.data_reader = None
    tds._lock = threading.Lock()
    tds._pending_save_model_task = None
    tds._has_warmed_up = True  # no reader to warm up
    tds._failed_record_count = 0
    tds._reported_record_count = 0
    tds._current_task = None
    tds._pending_tasks = deque()
    tds._last_poll_was_wait = False
    return tds


ACCOUNTING_CASES = [
    ([10, 10, 10], 4, None),  # counts straddle task boundaries
    ([3, 3, 3], 7, None),  # one count covers several whole tasks
    ([8], 8, None),  # exact fit
    ([5, 2, 9], 6, 1),  # mixed, the second count failed
]


@pytest.mark.parametrize("pkg", ("jax", "port"))
@pytest.mark.parametrize(
    "task_sizes, batch, failed", ACCOUNTING_CASES,
    ids=["straddle", "cover", "exact", "mixed-failed"],
)
def test_exactly_once_task_accounting(pkg, task_sizes, batch, failed):
    msg, TaskType, TaskDataService = _pkg(pkg)
    starts = np.cumsum([0] + task_sizes[:-1])
    tasks = [
        msg.TaskResponse(
            task_id=i + 1, shard_name="s0", start=int(s), end=int(s) + n,
            type=int(TaskType.TRAINING),
        )
        for i, (s, n) in enumerate(zip(starts, task_sizes))
    ]
    scripted = _ScriptedWorker(msg, tasks)
    tds = _wire_tds(TaskDataService, scripted)
    leased = []
    while True:
        _tid, task = tds.lease_task()
        if task is None:
            break
        leased.append(task.task_id)
    assert leased == [t.task_id for t in tasks]
    total = sum(task_sizes)
    counts = [batch] * (total // batch) + ([total % batch] if total % batch else [])
    for i, n in enumerate(counts):
        tds.report_record_done(n, "boom" if i == failed else "")
    assert [r[0] for r in scripted.reported] == [t.task_id for t in tasks]
    assert not tds._pending_tasks
    if failed is not None:
        # the failed count's records go with the task it completed, as a
        # fail count beside the error
        errs = [(r[0], r[1], r[2]) for r in scripted.reported if r[1]]
        assert errs == [(2, "boom", {"fail_count": 6})]


# ---- the worker in process -------------------------------------------------


def _jax_checkpoint(path, seed=1):
    """A JAX-written mnist checkpoint of flax's init of ``seed``."""
    import optax

    from elasticdl_tpu.models import mnist_functional_api as jax_mnist
    from elasticdl_tpu.trainer.state import TrainState, init_model, state_to_checkpoint
    from elasticdl_tpu.utils import save_utils as jax_save

    model = jax_mnist.custom_model()
    params, stats = init_model(model, {"image": np.zeros((1, 28, 28), np.float32)}, rng_seed=seed)
    jax_save.CheckpointSaver(path).save(
        0, state_to_checkpoint(TrainState.create(model.apply, params, optax.sgd(0.1), stats)),
        extra={"model_version": 0},
    )
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    root = tmp_path_factory.mktemp("task_stream")
    return {
        "train": gen_mnist(str(root / "t"), num_records=192, num_shards=2, seed=3),
        "predict": gen_mnist(str(root / "p"), num_records=48, num_shards=1, seed=4),
        "init": _jax_checkpoint(str(root / "init")),
        "root": root,
    }


def _in_process(pkg, data, job_flag, job_dir, extra=()):
    """A master of ``pkg`` over ``job_dir`` and its task-stream worker on
    the servicer, in this process."""
    if pkg == "jax":
        from elasticdl_tpu.master.master import Master
        from elasticdl_tpu.utils import args
        from elasticdl_tpu.worker.worker import Worker

        device = []
    else:
        from elasticdl_tpu_torch.master.master import Master
        from elasticdl_tpu_torch.utils import args
        from elasticdl_tpu_torch.worker.worker import Worker

        device = ["--device", "cpu"]
    common = [
        "--model_def", MNIST_DEF, job_flag, job_dir, "--minibatch_size", "16",
        "--records_per_task", "32", "--compute_dtype", "float32",
        "--checkpoint_dir_for_init", data["init"], *extra,
    ]
    master = Master(args.parse_master_args(common + ["--port", "0"]))
    worker = Worker(
        args.parse_worker_args(common + ["--worker_id", "0", "--master_addr", "x", *device]),
        master.servicer,
    )
    return master, worker


@pytest.mark.parametrize("pkg", ("jax", "port"))
def test_worker_trains_to_completion(pkg, data, tmp_path):
    from elasticdl_tpu_torch.utils.constants import TaskType

    master, worker = _in_process(pkg, data, "--training_data", data["train"])
    worker.run()
    assert master.task_d.finished()
    counters = master.task_d.counters(TaskType.TRAINING)
    assert (counters.total_records, counters.failed_records) == (192, 0)
    assert worker.trainer.step == 192 // 16 == master.servicer.get_model_version()


def test_worker_predicts_through_the_processor_as_the_jax_worker(data):
    """Both packages' workers predict the same records from one
    JAX-written checkpoint, each batch through the model's processor:
    every record once, the same outputs within ``PREDICT_TOL``."""
    outputs = {}
    for pkg in ("jax", "port"):
        master, worker = _in_process(pkg, data, "--prediction_data", data["predict"])
        collected = []

        class Collector:
            def process(self, predictions, worker_id):
                collected.append(np.asarray(predictions))

        worker._spec.prediction_outputs_processor = Collector()
        worker.run()
        assert master.task_d.finished()
        outputs[pkg] = np.concatenate(collected)
    assert outputs["port"].shape == outputs["jax"].shape == (48, 10)
    np.testing.assert_allclose(outputs["port"], outputs["jax"], rtol=PREDICT_TOL, atol=PREDICT_TOL)


def test_worker_runs_the_save_model_task(data, tmp_path):
    from elasticdl_tpu_torch.utils.export_utils import load_exported_model
    from elasticdl_tpu_torch.utils.flax_weights import flax_flat_from_torch

    export = str(tmp_path / "export")
    master, worker = _in_process(
        "port", data, "--training_data", data["train"], extra=["--output", export]
    )
    worker.run()
    assert master.task_d.finished()
    _model, flat, _meta = load_exported_model(export, device="cpu")
    trained = flax_flat_from_torch(worker.trainer.state.model)
    assert set(flat) == set(trained)
    for key, value in trained.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)


# ---- one worker through the CLI -------------------------------------------


def _cli_argv(data, ckpt, *extra):
    return [
        "train", "--model_def", MNIST_DEF, "--training_data", data["train"],
        "--minibatch_size", "32", "--records_per_task", "64", "--shuffle_seed", "11",
        "--compute_dtype", "float32", "--checkpoint_dir_for_init", data["init"],
        "--checkpoint_dir", ckpt, "--device", "cpu", *extra,
    ]


@pytest.fixture(scope="module")
def local_run(data):
    """The port's Local run, on one intra-op thread as the workers run."""
    ckpt = str(data["root"] / "local_ckpt")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert client.main(_cli_argv(data, ckpt)) == 0
    finally:
        torch.set_num_threads(threads)
    return save_utils.restore_checkpoint(ckpt)


@pytest.mark.parametrize("flags", [(), ("--device_prefetch", "true")], ids=["serial", "staged"])
def test_one_worker_job_equals_the_local_run_bit_for_bit(data, local_run, tmp_path, flags):
    want, want_extra = local_run
    ckpt = str(tmp_path / "ckpt")
    assert client.main(_cli_argv(
        data, ckpt, "--distribution_strategy", "AllreduceStrategy", "--num_workers", "1",
        "--port", "0", *flags,
    )) == 0
    got, extra = save_utils.restore_checkpoint(ckpt)
    # 192 records in tasks of 64 at 32 rows a step: 6 steps
    assert extra == want_extra == {"model_version": 6}
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_a_task_stream_worker_raises_without_a_card(monkeypatch):
    from elasticdl_tpu_torch.worker import main as worker_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker_main.main([
            "--model_def", MNIST_DEF, "--worker_id", "0", "--master_addr", "localhost:1",
        ])


# ---- chip_smoke.py's phase 11c, small --------------------------------------


def test_smoke_phase11c_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """Phase 11c's checks at a small size: DeepFM under one task-stream
    worker SIGKILLed at version 6 or later (one relaunch under a new id,
    its leases re-queued, exact records), and the LM (2 layers, width 32)
    under the task-stream worker equal to Local bit for bit, then its
    two-worker prediction and evaluation against Local (the CPU takes the
    kernels' plain path, so their launch counts read 0)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "GPT2S", dict(
        vocab_size=64, embed_dim=32, num_heads=2, num_layers=2, dtype="float32",
    ))
    monkeypatch.setattr(chip_smoke, "SEQ", 16)
    deepfm = dict(
        chip_smoke.TS_DEEPFM, train_records=2048, eval_records=256, batch=32,
        records_per_task=128, min_accuracy=0.0,
    )
    row = chip_smoke.task_stream_zoo_run(str(tmp_path / "deepfm"), deepfm, device="cpu")
    assert row["relaunches"][0]["worker_id"] != row["killed"]["worker_id"]
    assert row["total_records"] == 2048 and row["requeued_leases"] >= 1
    # bit for bit on the CPU needs the workers' one intra-op thread here too
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lm = chip_smoke.task_stream_lm_run(str(tmp_path / "lm"), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert lm["task_stream"]["weights_differing"] == []
    assert lm["predict"]["max_err"] == 0.0
    assert set(lm["launches"].values()) == {0}
