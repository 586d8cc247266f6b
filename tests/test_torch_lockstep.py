"""Multi-process lockstep training through the port's master, on the CPU
(gloo): the counterpart of ``tests/test_lockstep.py`` (:88 and :229),
fast enough to run with the rest.

- A two-worker ``AllreduceStrategy`` job through the port's train CLI
  equals the port's Local run on the same data, task order and global
  batch, within ``tests/test_lockstep.py``'s rtol 5e-3, atol 3e-2, and
  its two processes end bitwise equal.  One step agrees to about 1e-7
  (``tests/test_torch_elastic.py`` pins it at 1e-6); over 6 steps of SGD
  at lr 0.1 from flax's initial BatchNorm, mnist amplifies that
  reduction-order noise by a factor that depends on the initial
  weights: from the JAX init of seed 1 to about 2e-5, of seed 0 to about
  2e-2, of seed 3 to about 0.9, where a 1e-7 relative perturbation of
  the initial weights alone moves the Local run by 0.04.  The test
  starts from seed 1's.  Both start from a checkpoint
  the JAX package wrote (``--checkpoint_dir_for_init``), and the world's
  final checkpoint evaluates in the JAX package's Local executor as in
  the port's: the name-keyed layout both ways.
- The ``preempt_one_worker`` plan (process 1 SIGKILLs itself at step 6)
  re-forms the world once and finishes: the dispatcher's records are
  exactly epochs x records, the invariant checker finds no violation,
  the new world restored the newest checkpoint, and its two processes
  end bitwise equal.
- With validation data the world evaluates (the master's evaluation
  service, the lockstep worker's evaluation tasks, each rank's rows
  gathered to process 0), and the JAX package's Local evaluate of the
  world's checkpoint gives the same accuracy; ``--device_prefetch``
  leaves the weights bit for bit as they were; an evaluation task that a
  re-formation re-queued is counted once.
- The flags ported so far no longer raise; the ones left raise and name
  slice 6b-2.
- ``chip_smoke.py``'s phases 10 and 11a-b at a small size.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from elasticdl_tpu_torch import api as port_api
from elasticdl_tpu_torch import client
from elasticdl_tpu_torch.master.main import build_master
from elasticdl_tpu_torch.utils import args as port_args
from elasticdl_tpu_torch.utils import save_utils
from elasticdl_tpu_torch.worker.lockstep import DUMP_STATE_ENV

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
DP_RTOL, DP_ATOL = 5e-3, 3e-2
RECORDS = 192


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    """The worker processes this file starts inherit the environment: one
    intra-op thread each, so that they do not oversubscribe the CPU the
    test runner's other workers share (on an oversubscribed CPU, the JAX
    package's mnist step beside them was seen to abort)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _argv(data, *extra):
    return [
        "--model_def", MNIST_DEF, "--training_data", data["train"],
        "--minibatch_size", "32", "--records_per_task", "96",
        "--compute_dtype", "float32", "--shuffle_seed", "11",
        "--device", "cpu", *extra,
    ]


def _dist(*extra):
    return [
        "--distribution_strategy", "AllreduceStrategy", "--num_workers", "2",
        "--port", "0", *extra,
    ]


def _run_keeping_master(argv):
    """``client.main(argv)``; returns its exit code and the master."""
    from unittest import mock

    from elasticdl_tpu_torch.master import main as master_main

    kept = {}
    original = master_main.build_master

    def build(args):
        kept["master"] = original(args)
        return kept["master"]

    with mock.patch.object(master_main, "build_master", build):
        rc = client.main(argv)
    return rc, kept["master"]


def _dumps(dump_dir):
    out = []
    for p in (0, 1):
        with np.load(os.path.join(dump_dir, f"final_state_p{p}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    assert set(out[0]) == set(out[1]) and out[0]
    for key in out[0]:
        assert np.array_equal(out[0][key], out[1][key]), key
    return out[0]


@pytest.fixture(scope="module")
def world_and_local(tmp_path_factory):
    """A JAX-written warm-start checkpoint; the two-worker CLI job (with
    validation data: it evaluates at the end) and the Local run from it,
    with their final checkpoints; and the world again with
    ``--device_prefetch``."""
    import optax

    from elasticdl_tpu.models import mnist_functional_api as jax_mnist
    from elasticdl_tpu.trainer.state import TrainState, init_model, state_to_checkpoint
    from elasticdl_tpu.utils import save_utils as jax_save
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    root = tmp_path_factory.mktemp("lockstep")
    data = {
        "train": gen_mnist(str(root / "t"), num_records=RECORDS, num_shards=2, seed=3),
        "eval": gen_mnist(str(root / "e"), num_records=64, num_shards=1, seed=4),
        "init": str(root / "init"),
    }
    model = jax_mnist.custom_model()
    params, stats = init_model(model, {"image": np.zeros((1, 28, 28), np.float32)}, rng_seed=1)
    jax_save.CheckpointSaver(data["init"]).save(
        0, state_to_checkpoint(TrainState.create(model.apply, params, optax.sgd(0.1), stats)),
        extra={"model_version": 0},
    )
    dump_dir, staged_dump = str(root / "dump"), str(root / "dump_staged")
    world_ckpt, local_ckpt = str(root / "world_ckpt"), str(root / "local_ckpt")
    init = ["--checkpoint_dir_for_init", data["init"]]
    rc, master = _run_keeping_master(["train", *_argv(
        data, *init, "--checkpoint_dir", world_ckpt, "--validation_data", data["eval"],
        *_dist("--envs", f"{DUMP_STATE_ENV}={dump_dir}"),
    )])
    assert rc == 0
    rc, staged = _run_keeping_master(["train", *_argv(
        data, *init, "--checkpoint_dir", str(root / "staged_ckpt"), "--device_prefetch", "true",
        *_dist("--envs", f"{DUMP_STATE_ENV}={staged_dump}"),
    )])
    assert rc == 0
    rc = client.main(["train", *_argv(data, *init, "--checkpoint_dir", local_ckpt)])
    assert rc == 0
    return dict(
        data=data, dump=_dumps(dump_dir), world_ckpt=world_ckpt, local_ckpt=local_ckpt,
        summary=master.job_summary(), staged_dump=_dumps(staged_dump),
        staged_prefetch=staged.servicer.prefetch_stats(),
    )


def test_two_worker_job_equals_the_local_run(world_and_local):
    dump = world_and_local["dump"]
    local, extra = save_utils.restore_checkpoint(world_and_local["local_ckpt"])
    world, world_extra = save_utils.restore_checkpoint(world_and_local["world_ckpt"])
    # 192 records in tasks of 96 at 32 rows a step: 6 steps
    assert extra == world_extra == {"model_version": 6}
    assert set(local) == set(dump) == set(world)
    assert {"batch_stats/BatchNorm_0/mean", "batch_stats/BatchNorm_0/var"} <= set(local)
    for key, want in local.items():
        np.testing.assert_allclose(dump[key], want, rtol=DP_RTOL, atol=DP_ATOL, err_msg=key)
        # the world's final checkpoint is its final state
        np.testing.assert_array_equal(world[key], dump[key], err_msg=key)
        if key.startswith("params/"):
            assert not np.array_equal(want, save_utils.restore_checkpoint(
                world_and_local["data"]["init"])[0][key]), key  # it trained


def test_the_jax_package_evaluates_the_worlds_checkpoint(world_and_local):
    """The two-rank world's checkpoint in the JAX package's Local
    executor, against the port's, over the same validation data."""
    from elasticdl_tpu import api as jax_api
    from elasticdl_tpu.utils.args import parse_master_args as jax_parse

    data = world_and_local["data"]
    argv = [
        "--model_def", MNIST_DEF, "--validation_data", data["eval"],
        "--minibatch_size", "32", "--records_per_task", "96",
        "--checkpoint_dir_for_init", world_and_local["world_ckpt"],
    ]
    want = jax_api.evaluate(jax_parse(argv))
    got = port_api.evaluate(port_args.parse_master_args(argv + ["--device", "cpu"]))
    # f32 over the same checkpoint: relative 1e-6 (6 steps at lr 0.1 from
    # the initial weights leave the validation loss in the hundreds)
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 64 + 1e-9


def test_the_worlds_evaluation_equals_the_jax_local_evaluate(world_and_local):
    """The world's own final evaluation (the master's service over the
    records process 0 gathered and reported) gives the accuracy the JAX
    package's Local evaluate gives on the world's checkpoint, over all 64
    validation records once.  The master's summary holds the model's
    metrics (``eval_metrics_fn``: mnist's accuracy), as the JAX master's
    does; the loss is the Local executors' own, held in the test above."""
    from elasticdl_tpu import api as jax_api
    from elasticdl_tpu.utils.args import parse_master_args as jax_parse

    data, summary = world_and_local["data"], world_and_local["summary"]
    want = jax_api.evaluate(jax_parse([
        "--model_def", MNIST_DEF, "--validation_data", data["eval"],
        "--minibatch_size", "32", "--records_per_task", "96",
        "--checkpoint_dir_for_init", world_and_local["world_ckpt"],
    ]))
    metrics = summary["evaluation_metrics"]
    assert summary["evaluation"]["total_records"] == 64
    assert (metrics["model_version"], metrics["evaluated_version"]) == (6, 6)
    assert metrics["accuracy"] == want["accuracy"]


def test_device_prefetch_under_lockstep_gives_the_same_weights(world_and_local):
    """Staging changes when a group is copied, never what is dispatched:
    the staged world ends bit for bit where the unstaged one did, and
    both ranks staged groups (their heartbeats carried the totals)."""
    plain, staged = world_and_local["dump"], world_and_local["staged_dump"]
    assert set(plain) == set(staged)
    for key, value in plain.items():
        np.testing.assert_array_equal(staged[key], value, err_msg=key)
    groups = [stats.get("groups", 0) for stats in world_and_local["staged_prefetch"].values()]
    assert len(groups) == 2 and all(n > 0 for n in groups)


def test_an_evaluation_task_requeued_by_a_reformation_is_counted_once(tmp_path):
    """A world leases an evaluation task and is re-formed before it
    reports: the task is re-queued, the old lease's late report is
    dropped, and the new world's report is the round's only one."""
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.rpc import messages as msg
    from elasticdl_tpu_torch.utils.constants import TaskType
    from elasticdl_tpu_torch.utils.tensor import ndarray_to_tensor

    class Manager:
        lockstep = True

        def __init__(self, master):
            self.master = master

        def worker_ids(self):
            return [0, 1]

        def poll_failed_workers(self):
            return []

        def reform_world(self, cluster_version, count_against_budget=True):
            self.master.request_stop()

        def stop_workers(self, grace_secs=15.0):
            pass

    train = gen_mnist(str(tmp_path / "t"), num_records=64, num_shards=1, seed=0)
    evaluation = gen_mnist(str(tmp_path / "e"), num_records=32, num_shards=1, seed=1)
    args = port_args.parse_master_args(_argv(
        {"train": train}, "--records_per_task", "32", "--validation_data", evaluation,
        "--evaluation_steps", "2", *_dist(),
    ))
    master = Master(args, instance_manager_factory=Manager)
    master.servicer.report_version(msg.ReportVersionRequest(model_version=2))
    old = master.servicer.get_step_task(msg.GetStepTaskRequest(seq=0, worker_id=0))
    assert old.type == int(TaskType.EVALUATION)
    master.request_reform("capacity")
    assert master.run(poll_secs=0.01) == 0

    def report(task_id, labels):
        master.servicer.report_evaluation_metrics(msg.ReportEvaluationMetricsRequest(
            model_outputs={"output": ndarray_to_tensor("output", np.eye(10, dtype=np.float32)[labels])},
            labels=ndarray_to_tensor("labels", labels), task_id=task_id,
        ))

    report(old.task_id, np.zeros(32, np.int64))  # the old world's, late
    new = master.servicer.get_step_task(
        msg.GetStepTaskRequest(seq=0, worker_id=2, cluster_version=1)
    )
    assert new.type == int(TaskType.EVALUATION) and new.task_id != old.task_id
    labels = np.arange(32) % 10
    report(new.task_id, labels)
    report(new.task_id, labels)  # a re-delivery
    master.servicer.report_task_result(msg.ReportTaskResultRequest(task_id=new.task_id))
    summary = master.job_summary()
    assert summary["evaluation"]["total_records"] == 32
    assert summary["evaluation_metrics"]["accuracy"] == 1.0


def test_preempt_one_worker_reforms_and_finishes(tmp_path):
    import json

    from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
    from elasticdl_tpu_torch.chaos.invariants import InvariantChecker
    from elasticdl_tpu_torch.chaos.plan import builtin_plans
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist
    from elasticdl_tpu_torch.utils.constants import TaskType

    train = gen_mnist(str(tmp_path / "t"), num_records=384, num_shards=2, seed=5)
    plan = str(tmp_path / "plan.json")
    builtin_plans(2)["preempt_one_worker"].save(plan)
    events, dump_dir = str(tmp_path / "events.jsonl"), str(tmp_path / "dump")
    envs = {chaos_hooks.PLAN_ENV: plan, chaos_hooks.EVENTS_ENV: events, DUMP_STATE_ENV: dump_dir}
    args = port_args.parse_master_args(_argv(
        {"train": train}, "--records_per_task", "64", "--num_epochs", "2",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--checkpoint_steps", "2",
        "--heartbeat_timeout_secs", "3",
        *_dist("--envs", ",".join(f"{k}={v}" for k, v in envs.items())),
    ))
    master = build_master(args)
    checker = InvariantChecker(expected_records=768)
    master.task_d.add_observer(checker)
    master.servicer.add_version_observer(checker.on_version_report)
    master.reform_callbacks.append(checker.on_reform)
    master.prepare()
    assert master.run() == 0
    counters = master.task_d.counters(TaskType.TRAINING)
    # 2 epochs x 384 records, created once per epoch: recovery re-queues
    # without re-counting, so the total is exact
    assert counters.total_records == 768 and master.task_d.finished()
    assert checker.check(counters) == []
    (event,) = master.reform_events
    assert event["dead_workers"] == [1] and event["latency_secs"] > 0
    assert master.job_summary()["reforms"][0]["cluster_version"] == 1
    with open(events) as f:
        fired = [json.loads(line) for line in f]
    assert fired[0]["fault_id"] == "preempt-p1" and fired[0]["step"] == 6
    # the new world's process 0 restored the newest checkpoint by step 6
    restore = fired[1]
    assert restore["observation"] == "checkpoint_restore" and restore["cluster_version"] == 1
    assert restore["version"] in (4, 6)
    state = _dumps(dump_dir)
    assert all(np.isfinite(v).all() for v in state.values())


def test_an_elective_reform_fences_recovers_and_relaunches(tmp_path):
    """``Master.request_reform`` from another thread: the run loop bumps
    the cluster version, re-queues the leased tasks, resets the step
    stream and relaunches the world, without spending the
    ``--relaunch_on_worker_failure`` budget."""
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.rpc import messages as msg

    class Manager:
        def __init__(self, master):
            self.master, self.reforms = master, []

        def worker_ids(self):
            return [0, 1]

        def poll_failed_workers(self):
            return []

        def reform_world(self, cluster_version, count_against_budget=True):
            self.reforms.append((cluster_version, count_against_budget))
            self.master.request_stop()

        def stop_workers(self, grace_secs=15.0):
            pass

    train = gen_mnist(str(tmp_path / "t"), num_records=64, num_shards=1, seed=0)
    args = port_args.parse_master_args(_argv({"train": train}, "--records_per_task", "32", *_dist()))
    master = Master(args, instance_manager_factory=Manager)
    leased = master.servicer.get_step_task(msg.GetStepTaskRequest(seq=0, worker_id=0))
    assert leased.task_id >= 0
    master.request_reform("capacity")
    assert master.run(poll_secs=0.01) == 0
    assert master.instance_manager.reforms == [(1, False)]
    (event,) = master.reform_events
    assert (event["reason"], event["dead_workers"], event["cluster_version"]) == ("capacity", [], 1)
    # the old world is fenced, and the new one pulls the re-queued task
    stale = master.servicer.get_step_task(msg.GetStepTaskRequest(seq=1, worker_id=0))
    assert stale.is_empty
    again = master.servicer.get_step_task(
        msg.GetStepTaskRequest(seq=0, worker_id=2, cluster_version=1)
    )
    assert again.task_id >= 0


# ---- flags ---------------------------------------------------------------

# the flags taken off UNPORTED_FLAGS or out of the distributed refusals,
# with a value each (DATA: a directory of records)
LIFTED = [
    ("distribution_strategy", "ParameterServerStrategy"), ("num_workers", "3"),
    ("envs", "A=1,B=2"), ("port", "0"), ("relaunch_on_worker_failure", "1"),
    ("heartbeat_timeout_secs", "3"), ("task_timeout_secs", "9"),
    ("rpc_retry_secs", "1"), ("rpc_deadline_secs", "1"),
    ("num_workers", "1"), ("validation_data", "DATA"), ("prediction_data", "DATA"),
    ("device_prefetch", "true"), ("evaluation_start_delay_secs", "5"),
    ("evaluation_throttle_secs", "5"), ("replication", "true"), ("replication_steps", "3"),
    ("master_journal_dir", "JOURNAL"), ("rehome_grace_secs", "1"),
]


@pytest.mark.parametrize(
    "flag, value", LIFTED,
    ids=[f if (f, v) != ("num_workers", "1") else "num_workers=1" for f, v in LIFTED],
)
def test_lifted_flag_builds_a_master(tmp_path, flag, value):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist
    from elasticdl_tpu_torch.master.journal import MASTER_ADDR_FILE_ENV
    from elasticdl_tpu_torch.master.main import worker_envs
    from elasticdl_tpu_torch.rpc.retry import RETRY_SECS_ENV
    from elasticdl_tpu_torch.trainer.device_pipeline import DEVICE_PREFETCH_ENV

    assert flag not in port_args.UNPORTED_FLAGS
    train = gen_mnist(str(tmp_path / "t"), num_records=32, num_shards=1, seed=0)
    value = {"DATA": train, "JOURNAL": str(tmp_path / "journal")}.get(value, value)
    argv = _argv({"train": train}, *_dist(), f"--{flag}", value)
    args = port_args.parse_master_args(argv)
    master = build_master(args)
    assert master.instance_manager.world_size == args.num_workers
    # one worker is the task-stream worker, two or more one world
    assert master.instance_manager.lockstep == (args.num_workers > 1)
    envs = worker_envs(args)
    if flag == "envs":
        assert envs == {"A": "1", "B": "2"}
    if flag in ("rpc_retry_secs", "rpc_deadline_secs"):
        # the policies travel by env, never argv
        assert set(envs.values()) == {value + ".0"}
    if flag == "device_prefetch":
        # as does the device pipeline, so that every rank resolves it alike
        assert envs == {DEVICE_PREFETCH_ENV: "1"}
    if flag == "master_journal_dir":
        # and the master's address file, which implies the retry budget
        assert set(envs) == {MASTER_ADDR_FILE_ENV, RETRY_SECS_ENV}
        assert envs[MASTER_ADDR_FILE_ENV] == os.path.join(value, "master_addr")
    # the journal comes with --master_journal_dir alone
    assert (master.journal is not None) == (flag == "master_journal_dir")
    if flag == "validation_data":
        assert master.evaluation_service is not None
    # the master's replica directory comes with --replication alone
    assert (master.replica_directory is not None) == (flag == "replication")
    worker_argv = port_args.build_worker_arguments(args, 0, "localhost:1")
    assert f"--{flag}" not in worker_argv or flag in (
        "distribution_strategy", "num_workers", "envs", "validation_data",
        "prediction_data", "evaluation_start_delay_secs", "evaluation_throttle_secs",
        "replication", "replication_steps",
    )
    if flag.startswith("replication"):
        # the worker argv carries the replication flags, as they were given
        i = worker_argv.index(f"--{flag}")
        assert worker_argv[i + 1] == value
    # and the worker parses it back
    parsed = port_args.parse_worker_args(worker_argv)
    assert (parsed.worker_id, parsed.model_def) == (0, MNIST_DEF)


# what a distributed job cannot do yet: the device mesh's flags, each
# raising naming slice 8 (the port's world is one flat process group)
SLICE_6B = [
    (flag, [f"--{flag}", value]) for flag, value in (
        ("mesh_shape", "dp=2"), ("dcn_mesh_shape", "dp=2"),
    )
]


@pytest.mark.parametrize("flag, extra", SLICE_6B, ids=[f for f, _ in SLICE_6B])
def test_slice_6b_flag_raises_naming_it(tmp_path, flag, extra):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    train = gen_mnist(str(tmp_path / "t"), num_records=32, num_shards=1, seed=0)
    args = port_args.parse_master_args(_argv({"train": train}, *_dist(), *extra))
    with pytest.raises(NotImplementedError, match="slice 8") as err:
        build_master(args)
    assert f"--{flag}" in str(err.value)


# standbys, slices and the autoscaler (slice 6b-2c): each flag builds a
# master whose instance manager and autoscaler are the JAX package's
# master's from the same argv
SLICE_6B_2C = [
    ("num_slices", "2"), ("min_slices", "2"), ("autoscale_p95_step_ms", "9"),
    ("autoscale_backlog_tasks", "2"), ("autoscale_cooldown_secs", "1"),
    ("autoscale_shrink", "true"), ("standby_workers", "0"),
]


def _slice_surface(master):
    im, scaler = master.instance_manager, master.autoscaler
    return {
        "world_size": im.world_size, "max_world_size": im.max_world_size,
        "fleet_slices": im.fleet_slices, "world_num_slices": im.world_num_slices,
        "standbys": im._standby_target, "lockstep": im.lockstep,
        "min_slices": master._min_slices, "parked": master._parked,
        "autoscaler": None if scaler is None else (
            scaler.p95_step_ms, scaler.backlog_tasks, scaler.cooldown_secs,
            scaler.shrink_enabled, scaler.min_slices, scaler.max_slices,
        ),
    }


@pytest.mark.parametrize("flag, value", SLICE_6B_2C, ids=[f for f, _ in SLICE_6B_2C])
def test_slice_6b_2c_flag_builds_the_jax_masters_surface(tmp_path, flag, value):
    from elasticdl_tpu.master.main import build_master as jax_build_master
    from elasticdl_tpu.utils.args import build_worker_arguments as jax_worker_arguments
    from elasticdl_tpu.utils.args import parse_master_args as jax_parse
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    assert flag not in port_args.UNPORTED_FLAGS
    train = gen_mnist(str(tmp_path / "t"), num_records=32, num_shards=1, seed=0)
    argv = _argv({"train": train}, *_dist(), f"--{flag}", value)
    port_master = build_master(port_args.parse_master_args(argv))
    jax_args = jax_parse([a for a in argv if a not in ("--device", "cpu")] + ["--metrics_port", "-1"])
    jax_master = jax_build_master(jax_args)
    got, want = _slice_surface(port_master), _slice_surface(jax_master)
    assert got == want
    default = _slice_surface(build_master(port_args.parse_master_args(_argv({"train": train}, *_dist()))))
    # the flag acts: the surface moves off the default's
    assert got != default or flag in ("min_slices", "autoscale_cooldown_secs", "autoscale_shrink")
    if flag in ("min_slices", "autoscale_cooldown_secs", "autoscale_shrink"):
        # read at a park or with an SLO flag: held by the master's state
        assert (port_master._min_slices, jax_master._min_slices) == (
            (2, 2) if flag == "min_slices" else (1, 1)
        )
    # a master-only flag: neither package forwards it to its workers
    assert f"--{flag}" not in port_args.build_worker_arguments(
        port_master._args, 0, "localhost:1"
    )
    assert f"--{flag}" not in jax_worker_arguments(jax_args, 0, "localhost:1")


# a world's process and what its replicator does: none in a world of one
# (no peer to restore from), else a push at every task boundary or at
# each crossing of a multiple of --replication_steps
REPLICATION_WORLDS = [
    (["--replication", "true"], 2, [2, 4, 6]),
    (["--replication", "true", "--replication_steps", "3"], 2, [4, 6]),
    (["--replication", "true"], 1, None),
    (["--replication_steps", "3"], 2, None),
]


@pytest.mark.parametrize(
    "flags, processes, pushes", REPLICATION_WORLDS,
    ids=["every_boundary", "steps_3", "world_of_one", "steps_without_replication"],
)
def test_a_lockstep_world_acts_on_the_replication_flags(flags, processes, pushes, monkeypatch):
    """The flags as the worker parses them: a replicator and its replica
    server in a world of two or more, pushing at the cadence the flags
    set (the steps a world's task boundaries fall on: 2, 4, 6)."""
    import torch

    from elasticdl_tpu_torch.parallel import elastic
    from elasticdl_tpu_torch.parallel.elastic import World
    from elasticdl_tpu_torch.worker.lockstep import LockstepWorker

    monkeypatch.setattr(
        elastic, "state_checkpoint_parts",
        lambda state, mesh=None, materialize_dense=True: ({}, {}),
    )
    args = port_args.parse_worker_args([
        "--model_def", MNIST_DEF, "--worker_id", "0", "--master_addr", "localhost:1",
        "--device", "cpu", *flags,
    ])
    world = World(0, processes, "gloo", torch.device("cpu"))
    worker = LockstepWorker(args, master=None, world=world)
    try:
        if pushes is None:
            assert worker._replicator is None and worker._replica_server is None
            return
        assert worker._replica_server is not None
        # a neighbor address that refuses at once: each push fails fast
        worker._replicator.set_peers({"1": "127.0.0.1:1"})
        done = []
        for step in (2, 4, 6):
            worker._trainer = type("T", (), {"step": step, "state": None})()
            worker._maybe_checkpoint()
            if worker._replicator.last_push.get("version") == step:
                done.append(step)
        assert done == pushes
    finally:
        if worker._replica_server is not None:
            worker._replica_server.stop(grace=0)


def test_a_worker_without_a_world_raises_naming_slice_6b():
    """A worker without a world runs the task-stream worker; asked for a
    feature not ported yet (here a mesh of two devices, which slice 8
    brings since slice 6b-2 ported the rest), it refuses by name, as the
    master does."""
    from elasticdl_tpu_torch.worker import main as worker_main

    with pytest.raises(NotImplementedError, match="slice 8"):
        worker_main.main([
            "--model_def", MNIST_DEF, "--worker_id", "0", "--master_addr", "localhost:1",
            "--mesh_shape", "dp=2", "--device", "cpu",
        ])


def test_a_worker_raises_without_a_card(monkeypatch):
    import torch

    from elasticdl_tpu_torch.worker import main as worker_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker_main.main([
            "--model_def", MNIST_DEF, "--worker_id", "0", "--master_addr", "localhost:1",
            "--coordinator_addr", "localhost:2", "--num_processes", "2",
        ])


# ---- chip_smoke.py's phase 10, small ----------------------------------------


def test_smoke_phase10_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """Every check of phase 10 at a small size: mnist and DeepFM under
    the preemption plan, the fault-free world against Local, and the LM's
    two ranks against one (2 layers, width 32; the CPU takes the kernels'
    plain path, so their launch counts read 0)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "GPT2S", dict(
        vocab_size=64, embed_dim=32, num_heads=2, num_layers=2, dtype="float32",
    ))
    monkeypatch.setattr(chip_smoke, "SEQ", 16)
    mnist = dict(
        chip_smoke.ELASTIC_MNIST, train_records=512, eval_records=256, batch=32,
        records_per_task=64, min_accuracy=0.1,
    )
    run = chip_smoke.elastic_preempt_run(str(tmp_path / "mnist"), mnist, device="cpu")
    row = run["row"]
    assert row["backend"] == "gloo" and row["total_records"] == 1024
    assert row["fired"][:2] == ["preempt-p1", "checkpoint_restore"]
    deepfm = dict(
        chip_smoke.ELASTIC_DEEPFM, train_records=512, eval_records=256, batch=32,
        records_per_task=64, min_accuracy=0.0,
    )
    assert chip_smoke.elastic_preempt_run(str(tmp_path / "deepfm"), deepfm, device="cpu")[
        "row"]["total_records"] == 512
    parity = chip_smoke.elastic_parity_run(
        str(tmp_path / "parity"), mnist, run["data"], run["ckpt"], device="cpu"
    )
    assert parity["max_abs_diff_to_local"] < 1e-4
    dp_lm = chip_smoke.dp_lm_run(device="cpu")
    assert dp_lm["backend"] == "gloo" and dp_lm["rows_per_rank"] == [4, 4]
    assert set(dp_lm["launches"].values()) == {0}
    assert dp_lm["grad_rel_err"] < 1e-5 and dp_lm["update_rel_err"] < 1e-2


def test_smoke_phase11ab_rehearsal_on_the_cpu(tmp_path):
    """Phase 11a and 11b at a small size: mnist with validation data in a
    two-rank world with the device pipeline on, under
    ``preempt_one_worker`` (one re-formation, exact training records,
    every round's records once, the rounds' milestones, staged groups on
    each rank, the final round as the Local evaluate CLI on the final
    checkpoint), then two-worker evaluate (the final round's accuracy)
    and predict (every record once, as Local's prediction)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cfg = dict(
        chip_smoke.EVAL_MNIST, train_records=512, eval_records=128, batch=32,
        records_per_task=64, evaluation_steps=4, min_accuracy=0.0,
    )
    run = chip_smoke.eval_preempt_run(str(tmp_path / "mnist"), cfg, device="cpu")
    row = run["row"]
    assert [r["milestone"] for r in row["rounds"]] == [4, 8, 12, 16]
    assert row["backend"] == "gloo" and row["reforms"] == 1
    # the Local predict on the workers' one intra-op thread: on the CPU
    # the thread count moves f32 sums in the last bits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.eval_predict_run(
            str(tmp_path / "ep"), cfg, run["data"], run["ckpt"], run["final"], device="cpu"
        )
    finally:
        torch.set_num_threads(threads)
    assert out["predicted_rows"] == 128 and out["max_abs_err_to_local"] == 0.0
