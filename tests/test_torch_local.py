"""The port's Local ``train``/``evaluate``/``predict`` path end to end
(``elasticdl_tpu_torch.client`` -> ``api`` -> ``LocalExecutor`` ->
``TaskDispatcher`` -> EDLIO reader -> ``dataset_fn`` -> canonical batches
-> ``SPMDTrainer`` -> checkpoints -> evaluation -> export) against the
JAX package's, on the CPU.

The LM is small (2 layers, width 32, 2 heads, vocab 256, sequence 64,
f32).  Both packages read the same ``gen_sequence`` shards and
warm-start from one checkpoint the JAX package wrote.  The JAX side
runs as its own tests run it: on the 8 virtual CPU devices of
``tests/conftest.py``, with its flash kernels in interpret mode; the
port runs on ``--device cpu`` with its kernels' plain versions.

Held equal: the tasks handed out, the records trained and the steps
taken.  Held to the tolerances of
``tests/test_torch_train.py::test_three_adam_steps_match_jax`` (1e-4,
and 2·lr·steps for the key biases, whose exact gradient is 0, so that
each framework's Adam steps them by its own rounding noise): the final
weights, the evaluation's loss and accuracy, and the predictions."""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu import api as jax_api
from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
from elasticdl_tpu.models import long_seq_transformer as jax_lm
from elasticdl_tpu.trainer import local_executor as jax_le
from elasticdl_tpu.trainer.state import TrainState, init_model, state_to_checkpoint
from elasticdl_tpu.utils import save_utils as jax_save
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu.utils.args import parse_master_args as jax_parse
from elasticdl_tpu.utils.export_utils import load_exported_model as jax_load_export
from elasticdl_tpu_torch import api as port_api
from elasticdl_tpu_torch import client
from elasticdl_tpu_torch.models import long_seq_transformer as port_lm
from elasticdl_tpu_torch.trainer import local_executor as port_le
from elasticdl_tpu_torch.utils import args as port_args
from elasticdl_tpu_torch.utils.export_utils import load_exported_model
from elasticdl_tpu_torch.utils.flax_weights import flax_flat_from_torch
from elasticdl_tpu_torch.utils.model_utils import get_model_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TOL = 1e-4
LR = 3e-3  # the zoo's Adam
LM_DEF = "long_seq_transformer.long_seq_transformer.custom_model"
LM_KW = dict(vocab_size=256, embed_dim=32, num_heads=2, num_layers=2)
SEQ = 64
STEPS = 6  # tasks of 16, 4, 16 and 4 records in batches of 8


def _argv(data, *extra):
    return [
        "--model_def", LM_DEF,
        "--model_params", ";".join(f"{k}={v}" for k, v in LM_KW.items()),
        "--records_per_task", "16", "--minibatch_size", "8",
        "--num_epochs", "1", "--shuffle_seed", "0",
        "--compute_dtype", "float32", "--validation_data", data["eval"],
        *extra,
    ]


def _recording(module, log):
    """The module's ``TaskDispatcher``, logging each training task it
    hands out as ``(shard file, start, end)``."""

    class Recording(module.TaskDispatcher):
        def get(self, worker_id):
            tid, task = super().get(worker_id)
            if task is not None:
                log.append((os.path.basename(task.shard_name), task.start, task.end))
            return tid, task

    return Recording


def _run(package, argv, train=True):
    """Build the package's executor on ``argv`` and run it; returns
    ``(executor, result, tasks)``."""
    module, parse = (jax_le, jax_parse) if package == "jax" else (
        port_le, port_args.parse_master_args
    )
    tasks: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "TaskDispatcher", _recording(module, tasks))
        executor = module.LocalExecutor(parse(argv))
        result = executor.run() if train else None
    return executor, result, tasks


def _jax_flat(executor):
    return {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(executor.state.params).items()}


def _port_flat(executor):
    return flax_flat_from_torch(executor.state.model)


def _assert_weights_close(got, want, steps):
    """The tolerance of ``test_three_adam_steps_match_jax``."""
    assert set(got) == set(want)
    for name in want:
        off = np.abs(got[name] - want[name]) > TOL + TOL * np.abs(want[name])
        if off.any():
            assert name.endswith("attn/key/bias"), name
            assert np.abs(got[name] - want[name]).max() <= 2 * LR * steps, name


def _assert_metrics_close(got, want):
    assert set(got) == set(want) == {"accuracy", "loss"}
    assert abs(got["loss"] - want["loss"]) < TOL
    # one token of 512 flipping its argmax moves accuracy by 1/512
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 512 + 1e-9


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The data, a JAX warm-start checkpoint, and one Local train run of
    each package from it, with checkpoints every 4 steps and an export."""
    root = tmp_path_factory.mktemp("local")
    data = {
        "train": jax_synthetic.gen_sequence(
            str(root / "train"), num_records=40, num_shards=2, seed=0,
            seq_len=SEQ, vocab=LM_KW["vocab_size"],
        ),
        "eval": jax_synthetic.gen_sequence(
            str(root / "eval"), num_records=8, num_shards=1, seed=1,
            seq_len=SEQ, vocab=LM_KW["vocab_size"],
        ),
        "init": str(root / "init"),
    }
    model = jax_lm.custom_model(**LM_KW)
    sample = {"tokens": np.zeros((1, SEQ), np.int32)}
    params, _ = init_model(model, sample, rng_seed=3)
    state = TrainState.create(model.apply, params, optax.adam(LR))
    jax_save.CheckpointSaver(data["init"]).save(
        0, state_to_checkpoint(state), extra={"model_version": 0}
    )
    out = {"data": data, "root": root}
    for package in ("jax", "port"):
        ckpt, export = str(root / f"{package}_ckpt"), str(root / f"{package}_out")
        extra = ["--device", "cpu"] if package == "port" else []
        executor, result, tasks = _run(package, _argv(
            data, "--training_data", data["train"],
            "--checkpoint_dir_for_init", data["init"], "--checkpoint_dir", ckpt,
            "--checkpoint_steps", "4", "--output", export, *extra,
        ))
        flat = _jax_flat(executor) if package == "jax" else _port_flat(executor)
        out[package] = dict(
            result=result, tasks=tasks, step=int(executor.trainer.step),
            flat=flat, ckpt=ckpt, export=export,
        )
    return out


def test_same_tasks_records_and_steps(runs):
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["tasks"] == jax_run["tasks"]
    assert sorted(port_run["tasks"]) == [
        ("sequence-000.edlio", 0, 16), ("sequence-000.edlio", 16, 20),
        ("sequence-001.edlio", 0, 16), ("sequence-001.edlio", 16, 20),
    ]
    assert sum(e - s for _f, s, e in port_run["tasks"]) == 40
    assert port_run["step"] == jax_run["step"] == STEPS


def test_final_weights_and_evaluation_match_jax(runs):
    _assert_weights_close(runs["port"]["flat"], runs["jax"]["flat"], STEPS)
    _assert_metrics_close(runs["port"]["result"], runs["jax"]["result"])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_checkpoints_every_four_steps_and_at_the_end(runs, package):
    run = runs[package]
    assert jax_save.latest_version(run["ckpt"]) == STEPS
    assert sorted(os.listdir(run["ckpt"])) == ["version-4", "version-6"]
    dense, _emb, extra = jax_save.restore_checkpoint(run["ckpt"])
    assert extra == {"model_version": STEPS}
    for name, value in run["flat"].items():
        np.testing.assert_array_equal(dense[f"params/{name}"], value)


@pytest.mark.parametrize("loader, writer", [("port", "jax"), ("jax", "port")])
def test_each_package_loads_the_others_export(runs, loader, writer):
    export = runs[writer]["export"]
    want = runs[writer]["flat"]
    if loader == "port":
        model, _flat, _state = load_exported_model(export, device="cpu")
        got = flax_flat_from_torch(model)
    else:
        _model, got, _state = jax_load_export(export)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.fixture(scope="module")
def resumed(runs):
    """``(package, writer)`` -> the package's run resumed from a copy of
    the writer's ``--checkpoint_dir``, training the same tasks once
    more."""
    out = {}
    for package, writer in (
        ("port", "jax"), ("jax", "jax"), ("jax", "port"), ("port", "port"),
    ):
        ckpt = str(runs["root"] / f"{package}_resumes_{writer}")
        shutil.copytree(runs[writer]["ckpt"], ckpt)
        extra = ["--device", "cpu"] if package == "port" else []
        executor, result, tasks = _run(package, _argv(
            runs["data"], "--training_data", runs["data"]["train"],
            "--checkpoint_dir", ckpt, "--checkpoint_steps", "4", *extra,
        ))
        flat = _jax_flat(executor) if package == "jax" else _port_flat(executor)
        out[package, writer] = dict(
            result=result, step=int(executor.trainer.step), flat=flat,
            ckpt=ckpt, tasks=tasks,
        )
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_from_the_others_checkpoints(resumed, writer):
    """The package that did not write the checkpoints resumes from them
    as the one that did: from the same step, over the same tasks, to
    the same weights and evaluation (both start from the writer's
    weights, so they differ only by each framework's rounding)."""
    reader = "port" if writer == "jax" else "jax"
    got, want = resumed[reader, writer], resumed[writer, writer]
    # the restored step counts on: 6 more steps from version 6
    assert got["step"] == want["step"] == 2 * STEPS
    assert got["tasks"] == want["tasks"]
    for run in (got, want):
        # milestones 8 and 12 saved; --keep_checkpoint_max 3 evicted 4
        assert sorted(os.listdir(run["ckpt"])) == [
            "version-12", "version-6", "version-8",
        ]
    _assert_weights_close(got["flat"], want["flat"], STEPS)
    _assert_metrics_close(got["result"], want["result"])


def test_evaluate_job_from_a_checkpoint_matches_jax(runs):
    data, ckpt = runs["data"], runs["jax"]["ckpt"]
    want = jax_api.evaluate(jax_parse(_argv(data, "--checkpoint_dir_for_init", ckpt)))
    got = port_api.evaluate(port_args.parse_master_args(
        _argv(data, "--checkpoint_dir_for_init", ckpt, "--device", "cpu")
    ))
    _assert_metrics_close(got, want)
    # the job evaluated the checkpoint's weights, which the training run
    # evaluated at its end
    _assert_metrics_close(got, runs["port"]["result"])


def test_predict_job_matches_jax(runs):
    data, ckpt = runs["data"], runs["port"]["ckpt"]
    argv = _argv(
        data, "--prediction_data", data["eval"], "--checkpoint_dir_for_init", ckpt,
    )
    jax_exec, _, _ = _run("jax", argv, train=False)
    port_exec, _, _ = _run("port", argv + ["--device", "cpu"], train=False)
    want, got = jax_exec.predict(), port_exec.predict()
    assert len(got) == len(want) == 1 and got[0].shape == (8, SEQ, LM_KW["vocab_size"])
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=TOL, rtol=TOL)
    # and the port's predict job through the API runs to its end
    assert port_api.predict(port_args.parse_master_args(argv + ["--device", "cpu"])) == {}


def test_client_trains_evaluates_and_exports_on_the_cpu(runs, tmp_path, caplog):
    data = runs["data"]
    rc = client.main([
        "train", *_argv(data, "--training_data", data["train"],
                        "--checkpoint_dir_for_init", data["init"],
                        "--output", str(tmp_path / "out"), "--device", "cpu"),
    ])
    assert rc == 0
    model, flat, _state = load_exported_model(str(tmp_path / "out"), device="cpu")
    _assert_weights_close(flat, runs["jax"]["flat"], STEPS)
    assert client.main([]) == 2 and client.main(["bogus"]) == 2
    assert client.main(["clean"]) == 0
    # clean takes no flags: the JAX package's select images, and there are none
    for flag in ("--all", "--docker_image_repository=repo"):
        with pytest.raises(SystemExit) as exit_info:
            client.main(["clean", flag])
        assert exit_info.value.code == 2


def test_client_without_device_cpu_raises_when_cuda_is_absent(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = runs["data"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        client.main(["train", *_argv(data, "--training_data", data["train"])])


def test_api_refuses_jobs_without_their_data():
    args = port_args.parse_master_args(["--model_def", LM_DEF])
    for job in (port_api.train, port_api.evaluate, port_api.predict):
        with pytest.raises(ValueError, match="requires"):
            job(args)


# a value other than the default for every flag the port parses but
# cannot act on yet
UNPORTED_VALUES = {
    "mesh_shape": "dp=2", "dcn_mesh_shape": "dp=2", "telemetry_dir": "/t", "tensorboard_log_dir": "/tb", "metrics_port": "9",
    "metrics_host": "0.0.0.0", "trace_sample_rate": "1.0", "step_anatomy": "true",
    "profile_dir": "/p", "profile_steps": "2", "slo_config": "default",
    "serving_addr": "localhost:1", "instance_backend": "k8s", "namespace": "ns",
    "docker_image": "img", "docker_image_repository": "repo",
    "docker_base_image": "base", "worker_resource_request": "cpu=2",
    "worker_resource_limit": "cpu=2", "worker_pod_priority": "high",
    "master_resource_request": "cpu=2", "master_resource_limit": "cpu=2",
    "master_pod_priority": "high", "volume": "v", "image_pull_policy": "Never",
    "cluster_spec": "spec.py", "yaml": "job.yaml", "streaming": "true",
    "stream_lag_tasks": "2", "live_push_addr": "localhost:2",
    "donate_state": "false", "compilation_cache_dir": "/c",
}


def test_every_unported_flag_has_a_case():
    assert set(UNPORTED_VALUES) == set(port_args.UNPORTED_FLAGS)


UNPORTED_CASES = sorted(UNPORTED_VALUES.items())


@pytest.mark.parametrize(
    "flag, value", UNPORTED_CASES,
    ids=[f if v == UNPORTED_VALUES[f] else f"{f}={v}" for f, v in UNPORTED_CASES],
)
def test_unported_flag_raises_at_executor_build(runs, flag, value):
    data = runs["data"]
    args = port_args.parse_master_args(_argv(
        data, "--training_data", data["train"], "--device", "cpu",
        f"--{flag}", value,
    ))
    with pytest.raises(NotImplementedError, match=f"--{flag}="):
        port_le.LocalExecutor(args)


# the flags of stacked steps, remat and the device pipeline, ported; and
# the evaluation service's time trigger, peer replication, the master
# journal, standbys, slices and the autoscaler, which a Local run takes
# and, as the JAX package's Local executor, does not read
PORTED_CASES = [
    ("steps_per_dispatch", "2"), ("steps_per_dispatch", "auto"),
    ("remat", "true"), ("device_prefetch", "true"),
    ("boundary_fusion", "true"), ("pipeline_depth", "3"),
    ("evaluation_start_delay_secs", "5"), ("evaluation_throttle_secs", "5"),
    ("replication", "true"), ("replication_steps", "3"),
    ("master_journal_dir", "/j"), ("rehome_grace_secs", "1"),
    ("num_slices", "2"), ("min_slices", "2"), ("autoscale_p95_step_ms", "9"),
    ("autoscale_backlog_tasks", "2"), ("autoscale_cooldown_secs", "1"),
    ("autoscale_shrink", "true"), ("standby_workers", "0"),
]


@pytest.mark.parametrize(
    "flag, value", PORTED_CASES, ids=[f"{f}={v}" for f, v in PORTED_CASES]
)
def test_ported_training_flag_builds_an_executor(runs, flag, value):
    data = runs["data"]
    args = port_args.parse_master_args(_argv(
        data, "--training_data", data["train"], "--device", "cpu",
        f"--{flag}", value,
    ))
    assert flag not in port_args.UNPORTED_FLAGS
    port_le.LocalExecutor(args)


def test_one_device_mesh_and_defaults_build_an_executor(runs):
    data = runs["data"]
    for extra in ([], ["--mesh_shape", "dp=1"], ["--steps_per_dispatch", "1"]):
        port_le.LocalExecutor(port_args.parse_master_args(_argv(
            data, "--training_data", data["train"], "--device", "cpu", *extra,
        )))


def test_build_optimizer_follows_the_learning_rate_scheduler():
    spec = get_model_spec("", LM_DEF, model_params=LM_KW)
    assert port_le.build_optimizer(spec)(
        [torch.nn.Parameter(torch.zeros(2))]
    ).defaults["lr"] == LR
    spec.learning_rate_scheduler = lambda step: 0.1 if step < 2 else 0.01
    param = torch.nn.Parameter(torch.zeros(1))
    opt = port_le.build_optimizer(spec)([param])
    lrs = []
    for _ in range(4):
        param.grad = torch.ones(1)
        opt.step()
        lrs.append(opt.param_groups[0]["lr"])
    # optax evaluates the schedule at the update count before each update
    assert lrs == [0.1, 0.1, 0.01, 0.01]
    # an explicit --learning_rate wins over the scheduler, as in JAX
    assert port_le.build_optimizer(spec, 0.5)([param]).defaults["lr"] == 0.5


class _StepTrainer:
    """A stand-in trainer that records what ``run_stacked_steps`` feeds
    it, placed as the port's ``SPMDTrainer`` places batches."""

    def __init__(self):
        from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer

        self.trainer = SPMDTrainer(
            port_lm.custom_model(**LM_KW), port_lm.loss, port_lm.optimizer(),
            device="cpu",
        )
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.trainer, name)

    def train_step(self, features, labels, weights):
        self.calls.append((features["tokens"].shape, labels.shape, weights.tolist()))
        return {"loss": torch.zeros(())}


def test_run_stacked_steps_pads_every_batch_to_the_canonical_rows():
    from elasticdl_tpu_torch.trainer.stacking import run_stacked_steps

    trainer = _StepTrainer()
    rng = np.random.RandomState(0)
    batches = [
        ({"tokens": rng.randint(0, 256, (n, SEQ)).astype(np.int32)},
         rng.randint(0, 256, (n, SEQ)).astype(np.int32))
        for n in (8, 3, 8, 1)
    ]
    seen, hooks = [], []
    processed = run_stacked_steps(
        lambda: trainer, batches, 1,
        pre_batch=lambda f: seen.append(len(f["tokens"])),
        post_group=lambda: hooks.append(len(trainer.calls)),
        canonical_rows=8,
    )
    assert processed == 20 and seen == [8, 3, 8, 1] and hooks == [1, 2, 3, 4]
    assert [c[0] for c in trainer.calls] == [(8, SEQ)] * 4
    assert [sum(c[2]) for c in trainer.calls] == [8, 3, 8, 1]
    assert trainer.calls[1][2] == [1.0] * 3 + [0.0] * 5


def test_periodic_checkpointer_writes_host_arrays_off_the_training_thread(
    tmp_path, monkeypatch
):
    """Milestone-crossing saves; the writer thread gets numpy arrays
    only (the snapshot is taken on the calling thread); a failed write
    surfaces on the next flush, and only as a log while unwinding."""
    import threading
    from types import SimpleNamespace

    from elasticdl_tpu_torch.trainer import checkpointing
    from elasticdl_tpu_torch.trainer.state import TrainState

    model = port_lm.custom_model(**LM_KW)
    trainer = SimpleNamespace(state=TrainState(0, model, None), step=0)
    writes = []
    save = checkpointing.save_utils.CheckpointSaver.save

    def recording_save(saver, version, dense, **kwargs):
        writes.append((version, threading.current_thread() is threading.main_thread(),
                       {type(v) for v in dense.values()}))
        return save(saver, version, dense, **kwargs)

    monkeypatch.setattr(checkpointing.save_utils.CheckpointSaver, "save", recording_save)
    ckpt = checkpointing.PeriodicCheckpointer(str(tmp_path), 4)
    saved = []
    for step in (1, 3, 5, 6, 9, 12):
        trainer.state.step = step
        trainer.step = step
        saved.append(ckpt.maybe_save(trainer))
    ckpt.save_now(trainer, skip_if_current=True)  # 12 was just saved
    ckpt.flush()
    assert saved == [False, False, True, False, True, True]
    assert [w[0] for w in writes] == [5, 9, 12]
    assert all(not on_main and types == {np.ndarray} for _v, on_main, types in writes)
    dense, extra = checkpointing.save_utils.restore_checkpoint(str(tmp_path))
    assert extra == {"model_version": 12}
    assert set(dense) == {f"params/{k}" for k in flax_flat_from_torch(model)}

    def failing_save(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpointing.save_utils.CheckpointSaver, "save", failing_save)
    trainer.step = trainer.state.step = 16
    ckpt.save_now(trainer)
    with pytest.raises(OSError, match="disk full"):
        ckpt.flush()
    ckpt.save_now(trainer)
    logged = []
    monkeypatch.setattr(checkpointing.logger, "exception", logged.append)
    ckpt.flush_on_unwind(clean_exit=False)  # logged, not raised
    assert len(logged) == 1 and "write failed" in logged[0]


def test_smoke_phase6_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s Local train phase at a small size: every check
    of the phase runs, and the launch counts read 0 (the CPU takes the
    plain path)."""
    monkeypatch.setattr(chip_smoke, "GPT2S", dict(LM_KW, dtype="bfloat16"))
    monkeypatch.setattr(chip_smoke, "SEQ", SEQ)
    launches = chip_smoke.local_train_lm(str(tmp_path), device="cpu", bare_tokens_per_s=1.0)
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.parametrize(
    "flags, device",
    [
        ([], "cuda"), (["--device", "cpu"], "cpu"),
        (["--jax_platform", "cpu"], "cpu"), (["--jax_platform", "gpu"], "cuda"),
        (["--jax_platform", "cpu", "--device", "cpu"], "cpu"),
        (["--jax_platform", "gpu", "--device", "cuda"], "cuda"),
    ],
    ids=["default", "device-cpu", "jax-cpu", "jax-gpu", "both-cpu", "both-cuda"],
)
def test_jax_platform_maps_onto_the_device(flags, device):
    args = port_args.parse_master_args(["--model_def", LM_DEF, *flags])
    assert args.device == device


@pytest.mark.parametrize(
    "flags, match",
    [
        (["--jax_platform", "tpu"], r"--jax_platform='tpu' has no counterpart.*--device"),
        (["--jax_platform", "cuda"], r"--jax_platform='cuda' has no counterpart"),
        (["--jax_platform", "cpu,tpu"], r"--jax_platform='cpu,tpu' has no counterpart"),
        (["--jax_platform", "cpu", "--device", "cuda"], "disagrees with --device='cuda'"),
        (["--jax_platform", "gpu", "--device", "cpu"], "disagrees with --device='cpu'"),
    ],
    ids=["tpu", "cuda", "list", "cpu-vs-cuda", "gpu-vs-cpu"],
)
def test_jax_platform_refuses_what_the_port_cannot_run(flags, match):
    with pytest.raises(ValueError, match=match):
        port_args.parse_master_args(["--model_def", LM_DEF, *flags])


def test_client_with_jax_platform_cpu_trains_on_the_cpu(runs, monkeypatch, tmp_path):
    """A JAX command line that pins the CPU runs on the CPU, not on the
    card (and needs none)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = runs["data"]
    rc = client.main([
        "train", *_argv(data, "--training_data", data["train"],
                        "--checkpoint_dir_for_init", data["init"],
                        "--output", str(tmp_path / "out"), "--jax_platform", "cpu"),
    ])
    assert rc == 0
    _model, flat, _state = load_exported_model(str(tmp_path / "out"), device="cpu")
    _assert_weights_close(flat, runs["jax"]["flat"], STEPS)


_HOOKS_ZOO = '''
from elasticdl_tpu_torch.models.long_seq_transformer import *  # noqa: F401,F403


def custom_data_reader(data_origin, records_per_task=None, **kwargs):
    from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader

    return RecordIODataReader(data_dir=data_origin)


def renamed_reader(data_origin, records_per_task=None, **kwargs):
    raise AssertionError("the renamed reader hook was called")


class PredictionOutputsProcessor:
    def __init__(self):
        self.rows = 0

    def process(self, predictions, worker_id):
        self.rows += len(predictions)


class RenamedProcessor(PredictionOutputsProcessor):
    pass
'''


def test_hook_flags_leave_the_default_hooks_in_place_and_say_so(
    runs, tmp_path, monkeypatch
):
    """As in the JAX package, the model's ``custom_data_reader`` and
    ``PredictionOutputsProcessor`` are looked up by their default names
    whatever ``--custom_data_reader`` and ``--prediction_outputs_processor``
    say; the port logs a warning that names each flag set."""
    zoo = tmp_path / "zoo"
    zoo.mkdir()
    (zoo / "hooks_lm.py").write_text(_HOOKS_ZOO)
    data = runs["data"]
    argv = [
        "--model_zoo", str(zoo), "--model_def", "hooks_lm.custom_model",
        "--model_params", ";".join(f"{k}={v}" for k, v in LM_KW.items()),
        "--prediction_data", data["eval"], "--checkpoint_dir_for_init", data["init"],
        "--minibatch_size", "8", "--compute_dtype", "float32", "--device", "cpu",
        "--custom_data_reader", "renamed_reader",
        "--prediction_outputs_processor", "RenamedProcessor",
    ]
    warnings = []
    monkeypatch.setattr(
        port_le.logger, "warning", lambda msg, *a: warnings.append(msg % a)
    )
    executor = port_le.LocalExecutor(port_args.parse_master_args(argv))
    spec = executor._spec
    assert spec.custom_data_reader.__name__ == "custom_data_reader"
    processor = spec.prediction_outputs_processor
    assert type(processor).__name__ == "PredictionOutputsProcessor"
    warned = " ".join(warnings)
    assert "--custom_data_reader='renamed_reader' is ignored" in warned
    assert "--prediction_outputs_processor='RenamedProcessor' is ignored" in warned
    executor.predict()  # through the default reader hook and processor
    assert processor.rows == 8
