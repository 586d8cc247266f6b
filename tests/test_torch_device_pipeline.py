"""The port's device pipeline (``trainer/device_pipeline.py``) on the CPU:
``--device_prefetch``, ``--boundary_fusion`` and ``--pipeline_depth``.

The contracts of ``tests/test_device_pipeline.py``, held here: the
pipelined path equals the serial path bit for bit (the trainer's
groups, and the Local executor with and without boundary fusion), a
staged group is taken once, the stager keeps stream order and raises an
upstream error at its position, the retire window bounds the groups in
flight and drains at the end, and the hooks keep the serial cadence.
mnist's stacked, pipelined Local run reaches the JAX package's accuracy
with the same flags within 0.02 (the two runs' dropout bits differ).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.data import recordio as jax_recordio
from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
from elasticdl_tpu.trainer import local_executor as jax_le
from elasticdl_tpu.utils.args import parse_master_args as jax_parse
from elasticdl_tpu_torch.models import mnist_functional_api as port_mnist
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
from elasticdl_tpu_torch.trainer import device_pipeline
from elasticdl_tpu_torch.trainer import local_executor as port_le
from elasticdl_tpu_torch.trainer.device_pipeline import (
    BOUNDARY_FUSION_ENV,
    DEVICE_PREFETCH_ENV,
    PIPELINE_DEPTH_ENV,
    STAGING_BUDGET_ENV,
    DeviceStager,
    RetiredBufferError,
    StagedGroup,
    resolve_boundary_fusion,
    resolve_device_prefetch,
    resolve_pipeline_depth,
    run_pipelined_steps,
    run_pipelined_task_stream,
    stage_depth,
    staging_budget_bytes,
)
from elasticdl_tpu_torch.trainer.host_pipeline import TaskPrefetcher
from elasticdl_tpu_torch.trainer.stacking import PreStacked, run_stacked_steps
from elasticdl_tpu_torch.utils import flax_weights
from elasticdl_tpu_torch.utils.args import parse_master_args as port_parse

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
ACCURACY_TOL = 0.02  # the two packages' dropout bits differ


@pytest.fixture(autouse=True, scope="module")
def _two_intra_op_threads():
    """At most two torch intra-op threads in this module, as in
    ``tests/test_torch_resnet.py``: under the suite's six test processes,
    the phase-9 rehearsal with one thread per core waited at each
    barrier for threads the other processes had descheduled."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in (DEVICE_PREFETCH_ENV, BOUNDARY_FUSION_ENV, PIPELINE_DEPTH_ENV, STAGING_BUDGET_ENV):
        monkeypatch.delenv(env, raising=False)
    device_pipeline._reset_totals_for_tests()
    yield
    device_pipeline._reset_totals_for_tests()


# ---- flag resolution ----------------------------------------------------------


@pytest.mark.parametrize(
    "resolve, env",
    [(resolve_device_prefetch, DEVICE_PREFETCH_ENV), (resolve_boundary_fusion, BOUNDARY_FUSION_ENV)],
    ids=["device_prefetch", "boundary_fusion"],
)
def test_flag_wins_and_env_parses_like_the_flag(monkeypatch, resolve, env):
    assert resolve(None) is False
    assert resolve(True) is True
    monkeypatch.setenv(env, "1")
    assert resolve(None) is True
    assert resolve(False) is False  # the flag wins
    for falsey in ("0", "false", "FALSE", "no", "off", " "):
        monkeypatch.setenv(env, falsey)
        assert resolve(None) is False
    monkeypatch.setenv(env, "flase")  # a typo leaves it off
    assert resolve(None) is False


def test_pipeline_depth_resolution(monkeypatch):
    assert resolve_pipeline_depth(None) == device_pipeline.RETIRE_WINDOW
    assert resolve_pipeline_depth(3) == 3
    assert resolve_pipeline_depth(0) == 1
    monkeypatch.setenv(PIPELINE_DEPTH_ENV, "5")
    assert resolve_pipeline_depth(None) == 5
    for bad in ("zero", "0", "-2"):
        monkeypatch.setenv(PIPELINE_DEPTH_ENV, bad)
        assert resolve_pipeline_depth(None) == device_pipeline.RETIRE_WINDOW


def test_stage_depth_collapses_to_barrier_under_anatomy():
    assert stage_depth(None) == device_pipeline.RETIRE_WINDOW
    assert stage_depth(None, 4) == 4
    assert stage_depth(object()) == 1


def test_staging_budget_from_env_and_none_on_the_cpu(monkeypatch):
    assert staging_budget_bytes("cpu") is None
    monkeypatch.setenv(STAGING_BUDGET_ENV, "1024")
    assert staging_budget_bytes("cpu") == 1024
    monkeypatch.setenv(STAGING_BUDGET_ENV, "lots")
    assert staging_budget_bytes("cpu") is None


def test_disabled_gates_take_no_clock_reads(monkeypatch):
    def boom():
        raise AssertionError("clock read on the disabled path")

    monkeypatch.setattr("time.monotonic", boom)
    assert device_pipeline.heartbeat_snapshot() == {}
    device_pipeline.note_task_boundary()
    device_pipeline.note_boundary_dispatch()


# ---- the trainer's groups, pipelined against serial -------------------------


def _mnist_trainer():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = port_mnist.custom_model()
    return SPMDTrainer(
        model, port_mnist.loss, port_mnist.optimizer(), device="cpu",
        device_parse=port_mnist.device_parse,
    )


def _batches(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [
        ({"image": rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)},
         rng.randint(0, 10, n).astype(np.int32))
        for n in sizes
    ]


def _state(trainer):
    model = trainer.state.model
    return {
        **flax_weights.flax_flat_from_torch(model),
        **flax_weights.flax_state_from_torch(model),
    }


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _prestacked(batches):
    feats = {"image": np.stack([f["image"] for f, _l in batches])}
    labels = np.stack([l for _f, l in batches])
    return PreStacked(feats, labels, sum(len(l) for l in labels), {"image": feats["image"][0]})


class TestPipelinedParity:
    def test_train_parity_full_groups_and_masked_tail(self):
        batches = _batches([8, 8, 8, 8, 5])
        serial, piped = _mnist_trainer(), _mnist_trainer()
        n1 = run_stacked_steps(lambda: serial, iter(batches), 2, canonical_rows=8)
        n2 = run_stacked_steps(
            lambda: piped, iter(batches), 2, canonical_rows=8, device_prefetch=True
        )
        assert n1 == n2 == 37 and serial.step == piped.step == 5
        assert piped.dispatch_counts == serial.dispatch_counts
        _assert_bitwise(_state(piped), _state(serial))

    def test_train_parity_prestacked_and_trailing_singles(self):
        plain = _batches([8, 8, 8, 5], seed=3)
        stream = [_prestacked(plain[:2]), plain[2], plain[3]]
        serial, piped = _mnist_trainer(), _mnist_trainer()
        n1 = run_stacked_steps(lambda: serial, iter(stream), 2, canonical_rows=8)
        n2 = run_stacked_steps(
            lambda: piped, iter(stream), 2, canonical_rows=8, device_prefetch=True
        )
        assert n1 == n2 == 29
        _assert_bitwise(_state(piped), _state(serial))

    def test_hook_cadence_matches_serial(self):
        batches = _batches([8, 8, 8], seed=7)
        calls, posts = {True: [], False: []}, {True: [], False: []}
        for prefetch in (False, True):
            trainer = _mnist_trainer()
            run_stacked_steps(
                lambda: trainer, iter(batches), 2,
                pre_batch=lambda f, p=prefetch: calls[p].append(f["image"].shape),
                post_group=lambda p=prefetch: posts[p].append(1),
                canonical_rows=8, device_prefetch=prefetch,
            )
        # one pre_batch per step, one post_group per dispatch group
        assert calls[True] == calls[False] == [(8, 28, 28)] * 3
        assert len(posts[True]) == len(posts[False]) == 2


def _local_run(package, argv):
    module, parse = (jax_le, jax_parse) if package == "jax" else (port_le, port_parse)
    if package == "port":
        argv = argv + ["--device", "cpu"]
    tasks, reports = [], []

    class Recording(module.TaskDispatcher):
        def get(self, worker_id):
            tid, task = super().get(worker_id)
            if task is not None:
                tasks.append((os.path.basename(task.shard_name), task.start, task.end))
            return tid, task

        def report(self, task_id, success, *args, **kwargs):
            reports.append(task_id)
            return super().report(task_id, success, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "TaskDispatcher", Recording)
        executor = module.LocalExecutor(parse(argv))
        result = executor.run()
    return executor, result, tasks, reports


@pytest.fixture(scope="module")
def mnist_data(tmp_path_factory):
    jax_recordio.ensure_native_codec()  # the JAX side's vectorized path
    root = tmp_path_factory.mktemp("pipeline")
    return {
        "small": jax_synthetic.gen_mnist(str(root / "small"), num_records=200, num_shards=2, seed=0),
        "train": jax_synthetic.gen_mnist(str(root / "train"), num_records=512, num_shards=2, seed=0),
        "eval": jax_synthetic.gen_mnist(str(root / "eval"), num_records=200, num_shards=1, seed=1),
    }


def _small_argv(data, *extra):
    # tasks of 64 and 36 records, 16 rows a step, k = 4: PreStacked groups
    # of 4 and of 2, and a masked single, in 4 tasks
    return [
        "--model_def", MNIST_DEF, "--training_data", data["small"],
        "--records_per_task", "64", "--minibatch_size", "16",
        "--num_epochs", "1", "--shuffle_seed", "7", "--steps_per_dispatch", "4",
        *extra,
    ]


@pytest.fixture(scope="module")
def serial_small(mnist_data):
    return _local_run("port", _small_argv(mnist_data))


@pytest.mark.parametrize(
    "flags",
    [
        ("--device_prefetch", "true"),
        ("--device_prefetch", "true", "--boundary_fusion", "true"),
        ("--device_prefetch", "true", "--boundary_fusion", "true", "--pipeline_depth", "3"),
    ],
    ids=["prefetch", "prefetch+fusion", "prefetch+fusion+depth3"],
)
def test_local_executor_pipelined_equals_serial_bit_for_bit(mnist_data, serial_small, flags):
    """The whole executor path (reader, decode, TaskPrefetcher, grouping,
    staging, dispatch) with the pipeline on equals it off: the same
    tasks, reported as many times, the same steps by the same route,
    the same weights and statistics."""
    serial, _r, serial_tasks, serial_reports = serial_small
    piped, _r, tasks, reports = _local_run("port", _small_argv(mnist_data, *flags))
    assert tasks == serial_tasks and len(tasks) == 4
    assert sorted(reports) == sorted(serial_reports) and len(reports) == 4
    assert piped.trainer.step == serial.trainer.step == 14
    assert piped.trainer.dispatch_counts == serial.trainer.dispatch_counts
    _assert_bitwise(_state(piped.trainer), _state(serial.trainer))
    snapshot = device_pipeline.heartbeat_snapshot()
    assert snapshot["groups"] > 0
    if "--boundary_fusion" in flags:
        # every task after the first closed a boundary mark
        assert snapshot["boundaries"] == 3


def test_stacked_pipelined_mnist_reaches_jax_accuracy(mnist_data):
    """``--steps_per_dispatch 4 --device_prefetch true`` in both packages
    (4 epochs of 4 tasks of 128 records, 32 rows a step)."""
    argv = [
        "--model_def", MNIST_DEF, "--training_data", mnist_data["train"],
        "--validation_data", mnist_data["eval"], "--records_per_task", "128",
        "--minibatch_size", "32", "--num_epochs", "4", "--shuffle_seed", "0",
        "--steps_per_dispatch", "4", "--device_prefetch", "true",
    ]
    port, port_result, port_tasks, _ = _local_run("port", argv)
    jax_run, jax_result, jax_tasks, _ = _local_run("jax", argv)
    assert port_tasks == jax_tasks
    assert port.trainer.step == int(jax_run.trainer.step) == 64
    assert port.trainer.dispatch_counts["eager_groups"] == 16
    assert abs(port_result["accuracy"] - jax_result["accuracy"]) <= ACCURACY_TOL
    assert port_result["accuracy"] > 0.8


# ---- staged groups and the stager ---------------------------------------------


def test_staged_group_take_twice_is_caught():
    staged = StagedGroup(
        StagedGroup.KIND_STACKED, ("placed",), steps=1, records=8, hook_features=()
    )
    assert staged.take() == ("placed",)
    with pytest.raises(RetiredBufferError):
        staged.take()


class _FakeTrainer:
    """Host-only trainer double: real padding, identity placement."""

    device = torch.device("cpu")
    step = 0

    def pad_to(self, tree, rows):
        def pad(x):
            x = np.asarray(x)
            if x.shape[0] == rows:
                return x
            return np.concatenate([x, np.repeat(x[-1:], rows - x.shape[0], axis=0)])

        if isinstance(tree, dict):
            return {k: pad(v) for k, v in tree.items()}
        return pad(tree)

    def row_mask(self, n, rows):
        mask = np.zeros(rows, np.float32)
        mask[:n] = 1.0
        return mask

    def place_batch(self, tree):
        return tree

    def place_group(self, *trees):
        return trees

    def place_step(self, *trees):
        return trees

    def train_step(self, f, l, w=None):
        return {}

    def train_steps_stacked(self, f, l, w):
        return {}


def test_stager_preserves_stream_order_and_group_policy():
    batches = _batches([8, 8, 8, 8, 5], seed=1)
    stager = DeviceStager(lambda: _FakeTrainer(), iter(batches), 2, canonical_rows=8)
    try:
        groups = list(stager)
    finally:
        stager.close()
    assert [g.kind for g in groups] == [
        StagedGroup.KIND_STACKED, StagedGroup.KIND_STACKED, StagedGroup.KIND_SINGLES,
    ]
    assert [g.records for g in groups] == [16, 16, 5]
    first = groups[0].take()
    np.testing.assert_array_equal(first[0]["image"][0], batches[0][0]["image"])
    np.testing.assert_array_equal(first[0]["image"][1], batches[1][0]["image"])


def test_stager_propagates_upstream_error_in_stream_position():
    good = _batches([8, 8], seed=2)

    def stream():
        yield good[0]
        yield good[1]
        raise ValueError("decode exploded")

    stager = DeviceStager(lambda: _FakeTrainer(), stream(), 2, canonical_rows=8)
    try:
        first = stager.next_staged()
        assert first is not None and first.records == 16
        with pytest.raises(ValueError, match="decode exploded"):
            while stager.next_staged() is not None:
                pass
    finally:
        stager.close()
    assert not stager._thread.is_alive()


def test_stager_degrades_staging_failures_to_error_groups():
    class BadPad(_FakeTrainer):
        def pad_to(self, tree, rows):
            raise ValueError("batch exceeds the canonical shape")

    batches = _batches([8, 8], seed=21)
    stager = DeviceStager(lambda: BadPad(), iter(batches), 2, canonical_rows=8)
    try:
        staged = stager.next_staged()
        assert staged is not None and "canonical shape" in str(staged.error)
        assert staged.records == 16
        with pytest.raises(RetiredBufferError):
            staged.take()  # nothing was placed
        assert stager.next_staged() is None
    finally:
        stager.close()


def test_run_pipelined_reraises_staging_failures_like_serial():
    class BadPadAfterFirst(_FakeTrainer):
        calls = 0

        def pad_to(self, tree, rows):
            type(self).calls += 1
            if type(self).calls > 2:  # the first group pads fine
                raise ValueError("bad batch")
            return super().pad_to(tree, rows)

    trainer = BadPadAfterFirst()
    with pytest.raises(ValueError, match="bad batch"):
        run_pipelined_steps(
            lambda: trainer, iter(_batches([8] * 4, seed=22)), 2, canonical_rows=8
        )


def test_stager_close_releases_a_blocked_producer():
    stager = DeviceStager(
        lambda: _FakeTrainer(), iter(_batches([8] * 32, seed=4)), 1, canonical_rows=8
    )
    time.sleep(0.05)  # the producer fills the bounded queue
    stager.close()
    assert not stager._thread.is_alive()


def test_task_prefetcher_feeds_stager_errors_and_order():
    """decode -> stage -> compute: an error raised on the TaskPrefetcher's
    thread crosses both queues and surfaces on the consumer, in order."""
    tasks = [(1, "t1"), (2, "t2")]

    def next_task():
        return tasks.pop(0) if tasks else (0, None)

    def make_batches(task):
        if task == "t2":
            raise ValueError("shard corrupt")
        return _batches([8, 8], seed=6)

    prefetcher = TaskPrefetcher(next_task, make_batches)
    seen = []
    with pytest.raises(ValueError, match="shard corrupt"):
        for _tid, _task, batches in prefetcher:
            stager = DeviceStager(lambda: _FakeTrainer(), iter(batches), 2, canonical_rows=8)
            try:
                seen += [staged.records for staged in stager]
            finally:
                stager.close()
    prefetcher.close()
    assert seen == [16]


# ---- the retire window and the hooks --------------------------------------------


def test_retire_window_bounds_inflight_and_drains_at_end(monkeypatch):
    dispatched, retired = [], []
    monkeypatch.setattr(device_pipeline, "_dispatch_event", lambda trainer: len(dispatched))
    monkeypatch.setattr(device_pipeline, "_wait", lambda event: retired.append((event, len(dispatched))))

    class Tracking(_FakeTrainer):
        def train_steps_stacked(self, f, l, w):
            dispatched.append(1)

        def train_step(self, f, l, w=None):
            dispatched.append(1)

    trainer = Tracking()
    n = run_pipelined_steps(
        lambda: trainer, iter(_batches([8] * 10, seed=8)), 2, canonical_rows=8
    )
    assert n == 80 and len(dispatched) == 5
    # the first retire waits for the first group once the third was
    # dispatched (window 2), and every group retired before the return
    assert retired[0] == (1, 3)
    assert [event for event, _ in retired] == [1, 2, 3, 4, 5]


def test_post_group_runs_per_dispatch_not_per_retire():
    posts = []
    trainer = _FakeTrainer()
    run_pipelined_steps(
        lambda: trainer, iter(_batches([8] * 6, seed=10)), 2,
        post_group=lambda: posts.append(1), canonical_rows=8,
    )
    assert len(posts) == 3


def test_task_stream_reports_each_task_after_its_window_drained(monkeypatch):
    events = []
    monkeypatch.setattr(device_pipeline, "_dispatch_event", lambda trainer: "event")
    monkeypatch.setattr(device_pipeline, "_wait", lambda event: events.append("retire"))

    class Tracking(_FakeTrainer):
        def train_steps_stacked(self, f, l, w):
            events.append("dispatch")

        def train_step(self, f, l, w=None):
            events.append("dispatch")

    tasks = [(tid, f"t{tid}", _batches([8, 8, 8], seed=tid)) for tid in (1, 2, 3)]
    trainer = Tracking()
    total = run_pipelined_task_stream(
        lambda: trainer, iter(tasks), 2, canonical_rows=8,
        task_done=lambda tid, _task, n: events.append(("report", tid, n)),
    )
    assert total == 72
    # per task: a group of 2 and a trailing single, both retired before
    # the report
    for tid in (1, 2, 3):
        at = events.index(("report", tid, 24))
        assert events[at - 4:at] == ["dispatch", "dispatch", "retire", "retire"]
    assert device_pipeline.heartbeat_snapshot()["boundaries"] == 2


def test_task_stream_leaves_staged_groups_untaken_when_a_report_fails():
    """A report that raises (a reclaimed lease) closes the stager: the
    next task's group, staged meanwhile, is never dispatched."""
    dispatched = []

    class Tracking(_FakeTrainer):
        def train_steps_stacked(self, f, l, w):
            dispatched.append(int(l[0, 0]))

    def task_done(tid, _task, _n):
        if tid == 2:
            # let the stager stage task 3's group first
            time.sleep(0.2)
            raise RuntimeError(f"lease of task {tid} reclaimed")

    tasks = [
        (tid, f"t{tid}", [({"image": np.zeros((8, 28, 28), np.uint8)}, np.full(8, tid, np.int32))] * 2)
        for tid in (1, 2, 3)
    ]
    with pytest.raises(RuntimeError, match="task 2"):
        run_pipelined_task_stream(
            lambda: Tracking(), iter(tasks), 2, canonical_rows=8, task_done=task_done
        )
    assert dispatched == [1, 2]  # one group each of tasks 1 and 2, none of 3


def test_smoke_phase9_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s phase 9 at a small size, on the CPU (no graphs
    there, so the dispatch counters and the device trace are the card's
    checks): every other check runs, the eager replays equal the stacked
    runs exactly, and the LM's staged, stacked remat run trains every
    record once."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    mnist = dict(
        chip_smoke.MNIST, train_records=1024, eval_records=256, shards=2, batch=64,
        records_per_task=384, checkpoint_steps=5, min_accuracy=0.1,
    )
    row = chip_smoke.stacked_zoo_run(
        str(tmp_path / "mnist"), mnist, chip_smoke.STACKED_MNIST, device="cpu",
        variants=chip_smoke.STACKED_MNIST_VARIANTS,
    )
    assert row["checked"]["steps"] == 16 and row["checked"]["replay_max_abs_diff"] == 0.0
    # the milestones crossed by groups of 6 and 2 (tasks of 384 and 128)
    assert row["checked"]["checkpoint_versions"][-1] == 16
    # bench.py's e2e flags: the same steps, checked the same way
    auto = row["checked_auto_staged"]
    assert auto["steps"] == 16 and auto["replay_max_abs_diff"] == 0.0
    # every flag set timed STACKED_TIMED_ROUNDS times, the first run apart
    runs = 1 + len(chip_smoke.STACKED_MNIST_VARIANTS)
    assert len(row["timed_runs"]) == chip_smoke.STACKED_TIMED_ROUNDS * runs - 1
    assert row["timed"]["flags"] == list(chip_smoke.STACKED_MNIST["flags"])
    monkeypatch.setattr(chip_smoke, "GPT2S", dict(
        vocab_size=256, embed_dim=32, num_heads=2, num_layers=2, dtype="bfloat16"
    ))
    monkeypatch.setattr(chip_smoke, "SEQ", 64)
    row = chip_smoke.stacked_lm_run(str(tmp_path / "lm"), device="cpu", bare_tokens_per_s=1.0)
    checked = row["checked"]
    assert checked["tasks"] == 8 and checked["steps"] == chip_smoke.STACKED_LM_STEPS
    assert checked["replay_max_abs_diff"] == 0.0
    assert checked["checkpoint_versions"][-1] == chip_smoke.STACKED_LM_STEPS
    assert [t["flags"] for t in row["timed"]] == [
        list(chip_smoke.STACKED_LM["flags"]), list(chip_smoke.STACKED_LM["flags"][:2])
    ]
