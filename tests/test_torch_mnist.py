"""The port's mnist CNN against the JAX package's, on the CPU.

Weights come from the flax tree through ``utils/flax_weights.py``; the
inputs are uint8 images from a numpy seed, sent through each package's
``device_parse``.  Each trap of the port is pinned here:

- flax flattens NHWC activations, so its Dense rows are in (H, W, C)
  order, and its conv kernels are HWIO (the eval-mode logits and the
  layer-by-layer test);
- flax's BatchNorm rule: momentum 0.9 on the old value, the biased batch
  variance, and statistics that include a canonical batch's zero-weight
  padding rows (the running statistics after one step);
- the fixed ``Dropout(0.25)``: the SGD step is held to the JAX step with
  the JAX step's own dropout mask fed to the port's dropout (patched in
  this test, not switched in the port);
- the bf16 ``dtype``: parameters and statistics stay f32, logits come out
  f32.

Tolerances: f32 logits within 1e-4; after one SGD step every parameter
within 1e-5 in relative norm and the running statistics within 1e-6 (f32
reductions in another order); bf16 logits within 8e-3, two bf16 ulps
of a logit of magnitude 1 (they are below 1 here).
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.models import mnist_functional_api as jax_mnist
from elasticdl_tpu.trainer import step as jax_step
from elasticdl_tpu.trainer.state import TrainState as JaxState
from elasticdl_tpu.trainer.state import init_model
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.layers.attention import dense, dropout_generator
from elasticdl_tpu_torch.models import mnist_functional_api as port_mnist
from elasticdl_tpu_torch.trainer import step as port_step
from elasticdl_tpu_torch.trainer.state import Modes, TrainState
from elasticdl_tpu_torch.utils import flax_weights

LOGIT_TOL = 1e-4
STEP_REL_TOL = 1e-5
STATS_TOL = 1e-6
BF16_LOGIT_TOL = 8e-3
ROWS = 8


def _images(rows, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (rows, 28, 28)).astype(np.uint8)


def _labels(rows, seed=0):
    return np.random.RandomState(seed + 100).randint(0, 10, rows).astype(np.int32)


def _jax_variables(seed=0, dtype=None, moved=True):
    """A JAX mnist model with its seeded parameters, and running
    statistics and a BatchNorm scale/bias moved off their initial values
    (so that the eval-mode forward depends on each); ``moved=False``
    keeps flax's initial BatchNorm (scale 1, bias 0, mean 0, var 1)."""
    model = jax_mnist.custom_model(dtype=dtype)
    params, stats = init_model(
        model, {"image": np.zeros((1, 28, 28), np.float32)}, rng_seed=seed
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    if not moved:
        return model, params, jax.tree_util.tree_map(np.asarray, stats)
    rng = np.random.RandomState(seed + 1)
    params["BatchNorm_0"] = {
        "scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
        "bias": rng.normal(0, 0.1, 64).astype(np.float32),
    }
    stats = {"batch_stats": {"BatchNorm_0": {
        "mean": rng.normal(0, 0.1, 64).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, 64).astype(np.float32),
    }}}
    return model, params, stats


def _port_model(params, stats, dtype=None):
    model = port_mnist.custom_model(dtype=dtype)
    model.load_state_dict(flax_weights.torch_state_from_flax(
        tree_utils.tree_to_dict(params), model, tree_utils.tree_to_dict(stats)
    ))
    return model


def _jax_parse(images):
    return jax_mnist.device_parse({"image": jnp.asarray(images)})


def _port_parse(images):
    return port_mnist.device_parse({"image": torch.from_numpy(images)})


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_logits_match_jax(seed):
    """Conv kernels (HWIO to OIHW), the Dense rows' (H, W, C) order and
    BatchNorm with running statistics: a wrong layout or row order still
    trains, but gives other logits from the same weights."""
    model, params, stats = _jax_variables(seed)
    images = _images(ROWS, seed)
    want = np.asarray(model.apply({"params": params, **stats}, _jax_parse(images)))
    port = _port_model(params, stats).eval()
    with torch.no_grad():
        got = port(_port_parse(images)).numpy()
    assert got.shape == (ROWS, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    assert np.abs(want).max() > 0.1  # the logits are not all near zero


def test_conv_kernels_and_dense_rows_follow_flax_layouts():
    """Layer by layer: the port's first conv (NCHW, OIHW) equals flax's
    (NHWC, HWIO), and its Dense over NHWC-flattened activations equals
    flax's Dense."""
    _model, params, stats = _jax_variables(0)
    port = _port_model(params, stats)
    x = np.random.RandomState(3).normal(size=(2, 28, 28, 1)).astype(np.float32)
    want = nn.Conv(32, (3, 3), padding="VALID").apply(
        {"params": params["Conv_0"]}, x
    )
    got = port_mnist.conv(torch.from_numpy(x).permute(0, 3, 1, 2), port.conv_0, None)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want), atol=1e-5
    )
    h = np.random.RandomState(4).normal(size=(2, 12, 12, 64)).astype(np.float32)
    want = nn.Dense(10).apply({"params": params["Dense_0"]}, h.reshape(2, -1))
    got = dense(torch.from_numpy(h).reshape(2, -1), port.dense, None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def test_flax_weights_round_trip_with_batch_stats():
    _model, params, stats = _jax_variables(2)
    port = _port_model(params, stats)
    flat, flat_stats = tree_utils.tree_to_dict(params), tree_utils.tree_to_dict(stats)
    got = flax_weights.flax_flat_from_torch(port)
    got_stats = flax_weights.flax_state_from_torch(port)
    assert set(got) == set(flat) and set(got_stats) == set(flat_stats) == {
        "batch_stats/BatchNorm_0/mean", "batch_stats/BatchNorm_0/var",
    }
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    for k in flat_stats:
        np.testing.assert_array_equal(got_stats[k], flat_stats[k])
    # without the statistics, a state dict holds the parameters only
    assert set(flax_weights.torch_state_from_flax(flat, port)) == {
        n for n, _ in port.named_parameters()
    }
    with pytest.raises(KeyError, match="model state lack"):
        flax_weights.torch_state_from_flax(flat, port, {})


def _jax_dropout_keep(model, variables, images, step):
    """The keep mask (NHWC) the JAX train step's dropout draws at
    ``step``: the same rng, ``fold_in(PRNGKey(0), step)``, read from the
    Dropout itself by running it on ones (flax draws its mask from the
    rng and the shape alone).  Its output on the real activations cannot
    tell a kept exact zero (a dead channel) from a dropped element."""
    keep = []

    def on_ones(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            keep.append(np.asarray(out) != 0)
            return out
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(on_ones):
        model.apply(
            variables, _jax_parse(images), training=True,
            rngs={"dropout": jax.random.fold_in(jax.random.PRNGKey(0), step)},
            mutable=["batch_stats"],
        )
    (mask,) = keep
    return mask


def _rel_norm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _one_step(images, labels, weights, monkeypatch, seed=0, moved=True):
    """One SGD step of each package from the same weights, the port's
    dropout fed the JAX step's mask; returns ``(port flats, jax flats,
    port loss, jax loss)``, each flat being ``(params, stats)``."""
    model, params, stats = _jax_variables(seed, moved=moved)
    keep = torch.from_numpy(
        _jax_dropout_keep(model, {"params": params, **stats}, images, 0)
    )

    def jax_mask_dropout(x, rate, generator):
        if generator is None:
            return x
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    monkeypatch.setattr(port_mnist, "dropout", jax_mask_dropout)
    state = JaxState.create(model.apply, params, optax.sgd(0.1), stats)
    jax_train = jax_step.build_train_step(
        jax_mnist.loss, device_parse=jax_mnist.device_parse, donate=False
    )
    new_state, jax_metrics = jax_train(
        state, {"image": jnp.asarray(images)}, jnp.asarray(labels),
        jnp.asarray(weights),
    )
    port = _port_model(params, stats)
    port_state = TrainState.create(port, port_mnist.optimizer())
    port_train = port_step.build_train_step(
        port_mnist.loss, device_parse=port_mnist.device_parse
    )
    _, port_metrics = port_train(
        port_state, {"image": torch.from_numpy(images)}, torch.from_numpy(labels),
        torch.from_numpy(weights),
    )
    return (
        (flax_weights.flax_flat_from_torch(port), flax_weights.flax_state_from_torch(port)),
        (
            {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.params).items()},
            {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.model_state).items()},
        ),
        float(port_metrics["loss"]), float(jax_metrics["loss"]),
    )


@pytest.mark.parametrize("moved", [True, False], ids=["moved", "initial"])
def test_one_sgd_step_matches_jax_with_its_dropout_mask(monkeypatch, moved):
    """From BatchNorm moved off its initial values, and from flax's
    initial scale 1 and bias 0, where some channels are dead (ReLU zero
    everywhere, so BatchNorm passes its bias alone) and their bias
    gradient comes only through the elements dropout keeps."""
    images, labels = _images(ROWS, 5), _labels(ROWS, 5)
    weights = np.ones(ROWS, np.float32)
    (got, got_stats), (want, want_stats), port_loss, jax_loss = _one_step(
        images, labels, weights, monkeypatch, moved=moved
    )
    assert abs(port_loss - jax_loss) < LOGIT_TOL
    _model, before, _stats = _jax_variables(0, moved=moved)
    before = tree_utils.tree_to_dict(before)
    for name in want:
        assert _rel_norm(got[name], want[name]) < STEP_REL_TOL, name
        # and the update itself, not only the weights it was added to
        assert _rel_norm(got[name] - before[name], want[name] - before[name]) < 1e-3, name
    for name in want_stats:
        np.testing.assert_allclose(got_stats[name], want_stats[name], atol=STATS_TOL, rtol=0)


def test_batch_norm_running_statistics_follow_flax_and_see_the_padding(monkeypatch):
    """A canonical batch of 5 real rows and 3 padding rows (the last row
    repeated, weight 0): the running statistics after one step are flax's
    (momentum 0.9 on the old value, biased variance) over all 8 rows, as
    the JAX step computes them; torch's BatchNorm2d rule, or statistics
    over the real rows alone, would give others."""
    images, labels = _images(5, 6), _labels(5, 6)
    images = np.concatenate([images, np.repeat(images[-1:], 3, axis=0)])
    labels = np.concatenate([labels, np.repeat(labels[-1:], 3)])
    weights = np.array([1] * 5 + [0] * 3, np.float32)
    (got, got_stats), (want, want_stats), *_ = _one_step(
        images, labels, weights, monkeypatch
    )
    for name in want_stats:
        np.testing.assert_allclose(got_stats[name], want_stats[name], atol=STATS_TOL, rtol=0)
    for name in want:
        assert _rel_norm(got[name], want[name]) < STEP_REL_TOL, name

    # what the statistics of the real rows alone, and torch's own rule,
    # would have made of the same batch
    _model, params, stats = _jax_variables(0)
    port = _port_model(params, stats)
    x = torch.from_numpy(images).float().reshape(8, 1, 28, 28) / 255.0
    with torch.no_grad():
        h = torch.relu(port_mnist.conv(torch.relu(port_mnist.conv(x, port.conv_0, None)), port.conv_1, None))
    old_mean = torch.from_numpy(stats["batch_stats"]["BatchNorm_0"]["mean"])
    old_var = torch.from_numpy(stats["batch_stats"]["BatchNorm_0"]["var"])
    real_only = 0.9 * old_mean + 0.1 * h[:5].mean((0, 2, 3))
    assert np.abs(real_only.numpy() - want_stats["batch_stats/BatchNorm_0/mean"]).max() > 1e-4
    torch_bn = torch.nn.BatchNorm2d(64, momentum=0.1)
    with torch.no_grad():
        torch_bn.running_mean.copy_(old_mean)
        torch_bn.running_var.copy_(old_var)
    torch_bn.train()(h)
    np.testing.assert_allclose(
        torch_bn.running_mean.numpy(), want_stats["batch_stats/BatchNorm_0/mean"],
        atol=1e-5,
    )  # the momentum conventions agree; the variance rules do not
    n = 8 * 24 * 24
    gap = np.abs(torch_bn.running_var.numpy() - want_stats["batch_stats/BatchNorm_0/var"])
    assert gap.max() > 0.1 * (n / (n - 1) - 1) * float(h.var((0, 2, 3)).min())


def test_dropout_draws_from_the_step_generator():
    _model, params, stats = _jax_variables(0)
    port = _port_model(params, stats)
    features = _port_parse(_images(ROWS))

    def train_forward(step):
        state_before = {k: v.clone() for k, v in port.state_dict().items()}
        with torch.no_grad():
            out = port(features, training=True, generator=dropout_generator(step, "cpu"))
        port.load_state_dict(state_before)  # undo the statistics' move
        return out

    np.testing.assert_array_equal(train_forward(3), train_forward(3))
    assert not torch.equal(train_forward(3), train_forward(4))
    with pytest.raises(ValueError, match="generator"):
        port(features, training=True)
    port.eval()
    with torch.no_grad():
        a, b = port(features), port(features, generator=dropout_generator(3, "cpu"))
    np.testing.assert_array_equal(a, b)  # no dropout when not training


def test_bfloat16_dtype_keeps_parameters_and_statistics_f32(monkeypatch):
    model, params, stats = _jax_variables(0, dtype="bfloat16")
    images = _images(ROWS, 7)
    want = np.asarray(model.apply({"params": params, **stats}, _jax_parse(images)))
    port = _port_model(params, stats, dtype="bfloat16").eval()
    with torch.no_grad():
        got = port(_port_parse(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_LOGIT_TOL, rtol=0)
    port.train()
    state = TrainState.create(port, port_mnist.optimizer())
    train = port_step.build_train_step(
        port_mnist.loss, compute_dtype=torch.bfloat16,
        device_parse=port_mnist.device_parse,
    )
    train(state, {"image": torch.from_numpy(images)}, torch.from_numpy(_labels(ROWS)),
          torch.ones(ROWS))
    assert {t.dtype for t in port.state_dict().values()} == {torch.float32}
    moved = flax_weights.flax_state_from_torch(port)["batch_stats/BatchNorm_0/mean"]
    assert np.isfinite(moved).all() and not np.array_equal(
        moved, stats["batch_stats"]["BatchNorm_0"]["mean"]
    )


def test_device_parse_matches_dataset_fn_and_jax():
    from elasticdl_tpu_torch.data.reader import encode_example

    images = _images(4, 9)
    records = [encode_example({"image": im, "label": np.int64(i)}) for i, im in enumerate(images)]
    parsed = list(port_mnist.dataset_fn(Dataset.from_generator(lambda: records), Modes.EVALUATION, None))
    host = np.stack([f["image"] for f, _l in parsed])
    on_device = _port_parse(images)["image"]
    assert on_device.dtype == torch.float32
    np.testing.assert_array_equal(on_device.numpy(), host)
    np.testing.assert_array_equal(on_device.numpy(), np.asarray(_jax_parse(images)["image"]))
    features, labels = port_mnist.batch_parse(
        {"image": images, "label": np.arange(4, dtype=np.int64)}, Modes.TRAINING
    )
    assert features["image"].dtype == np.uint8 and labels.dtype == np.int32
    assert set(port_mnist.batch_parse({"image": images}, Modes.PREDICTION)) == {"image"}


# ---- the Local train CLI of both packages ---------------------------------

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
# 512 training records in 2 shards: with 128 records a task and 32 rows a
# step (a multiple of the JAX test mesh's 8 devices), 4 tasks and 16 steps
# an epoch, for 4 epochs, enough for both packages to learn the classes;
# 200 validation records, in 7 batches
LOCAL_EPOCHS, LOCAL_STEPS, EVAL_BATCHES = 4, 64, 7
ACCURACY_TOL = 0.02  # the two runs' dropout bits differ


def _local_argv(data, *extra, epochs=LOCAL_EPOCHS):
    return [
        "--model_def", MNIST_DEF, "--records_per_task", "128",
        "--minibatch_size", "32", "--num_epochs", str(epochs),
        "--shuffle_seed", "0",
        "--validation_data", data["eval"], *extra,
    ]


def _local_run(package, argv):
    """``(executor, evaluation, tasks handed out)`` of one Local train
    job of ``package`` (the port's on ``--device cpu``)."""
    import os

    from elasticdl_tpu.trainer import local_executor as jax_le
    from elasticdl_tpu.utils.args import parse_master_args as jax_parse
    from elasticdl_tpu_torch.trainer import local_executor as port_le
    from elasticdl_tpu_torch.utils.args import parse_master_args as port_parse

    module, parse = (jax_le, jax_parse) if package == "jax" else (port_le, port_parse)
    if package == "port":
        argv = argv + ["--device", "cpu"]
    tasks = []

    class Recording(module.TaskDispatcher):
        def get(self, worker_id):
            tid, task = super().get(worker_id)
            if task is not None:
                tasks.append((os.path.basename(task.shard_name), task.start, task.end))
            return tid, task

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "TaskDispatcher", Recording)
        executor = module.LocalExecutor(parse(argv))
        result = executor.run()
    return executor, result, tasks


def _state_flats(package, state):
    """``(params, batch_stats)`` flats of a package's train state."""
    if package == "jax":
        return (
            {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(state.params).items()},
            {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(state.model_state).items()},
        )
    return (
        flax_weights.flax_flat_from_torch(state.model),
        flax_weights.flax_state_from_torch(state.model),
    )


@pytest.fixture(scope="module")
def local_runs(tmp_path_factory):
    """The data, a JAX warm-start checkpoint with its batch statistics,
    and one Local train run of each package from it, with a checkpoint at
    the end and an export."""
    from elasticdl_tpu.data import recordio as jax_recordio
    from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
    from elasticdl_tpu.trainer.state import state_to_checkpoint
    from elasticdl_tpu.utils import save_utils as jax_save
    from elasticdl_tpu_torch.data import fast_pipeline

    # the JAX package takes its vectorized path only with its codec built
    jax_recordio.ensure_native_codec()
    root = tmp_path_factory.mktemp("mnist_local")
    data = {
        "train": jax_synthetic.gen_mnist(str(root / "train"), num_records=512, num_shards=2, seed=0),
        "eval": jax_synthetic.gen_mnist(str(root / "eval"), num_records=200, num_shards=1, seed=1),
        "init": str(root / "init"),
    }
    model = jax_mnist.custom_model()
    params, stats = init_model(
        model, {"image": np.zeros((1, 28, 28), np.float32)}, rng_seed=3
    )
    state = JaxState.create(model.apply, params, optax.sgd(0.1), stats)
    jax_save.CheckpointSaver(data["init"]).save(
        0, state_to_checkpoint(state), extra={"model_version": 0}
    )
    out = {"data": data, "root": root}
    for package in ("jax", "port"):
        fast_pipeline.reset_path_counts()
        ckpt, export = str(root / f"{package}_ckpt"), str(root / f"{package}_out")
        executor, result, tasks = _local_run(package, _local_argv(
            data, "--training_data", data["train"],
            "--checkpoint_dir_for_init", data["init"], "--checkpoint_dir", ckpt,
            "--output", export,
        ))
        out[package] = dict(
            result=result, tasks=tasks, step=int(executor.trainer.step),
            flats=_state_flats(package, executor.state), ckpt=ckpt, export=export,
            paths=dict(fast_pipeline.path_counts),
        )
    return out


def test_local_runs_train_the_same_tasks_records_and_steps(local_runs):
    jax_run, port_run = local_runs["jax"], local_runs["port"]
    assert port_run["tasks"] == jax_run["tasks"]
    assert sorted(set(port_run["tasks"])) == [
        ("mnist-000.edlio", 0, 128), ("mnist-000.edlio", 128, 256),
        ("mnist-001.edlio", 0, 128), ("mnist-001.edlio", 128, 256),
    ]
    assert sum(e - s for _f, s, e in port_run["tasks"]) == 512 * LOCAL_EPOCHS
    assert port_run["step"] == jax_run["step"] == LOCAL_STEPS
    # every training batch, and the evaluation's, took the vectorized path
    assert port_run["paths"] == {"vectorized": LOCAL_STEPS + EVAL_BATCHES, "classic": 0}


def test_local_runs_reach_the_same_accuracy(local_runs):
    jax_result, port_result = local_runs["jax"]["result"], local_runs["port"]["result"]
    assert set(port_result) == set(jax_result) == {"accuracy", "loss"}
    assert abs(port_result["accuracy"] - jax_result["accuracy"]) <= ACCURACY_TOL
    assert np.isfinite(port_result["loss"])
    # the running statistics moved off the checkpoint's
    start = np.zeros(64, np.float32)  # the initial running mean
    for package in ("jax", "port"):
        moved = local_runs[package]["flats"][1]["batch_stats/BatchNorm_0/mean"]
        assert np.isfinite(moved).all() and np.abs(moved - start).max() > 1e-3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_carry_batch_stats_and_the_other_package_resumes_them(
    local_runs, writer
):
    """The writer's last checkpoint holds its trained parameters and
    running statistics under the JAX names; the other package restores
    both exactly, and an evaluation job of each package over it agrees
    (eval mode normalises with the restored statistics)."""
    import shutil

    from elasticdl_tpu.trainer.state import checkpoint_to_state as jax_restore
    from elasticdl_tpu.utils import save_utils as jax_save
    from elasticdl_tpu_torch import api as port_api
    from elasticdl_tpu_torch.utils.args import parse_master_args as port_parse
    from elasticdl_tpu import api as jax_api
    from elasticdl_tpu.utils.args import parse_master_args as jax_parse

    run, data = local_runs[writer], local_runs["data"]
    dense, _emb, extra = jax_save.restore_checkpoint(run["ckpt"])
    assert extra == {"model_version": LOCAL_STEPS}
    params, stats = run["flats"]
    assert set(dense) == {f"params/{k}" for k in params} | set(stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(dense[k], v)

    reader = "port" if writer == "jax" else "jax"
    if reader == "port":
        model = port_mnist.custom_model()
        from elasticdl_tpu_torch.trainer.state import checkpoint_to_state

        got = _state_flats("port", checkpoint_to_state(
            TrainState.create(model, port_mnist.optimizer()), dense
        ))
    else:
        model, p0, s0 = _jax_variables(0)
        got = _state_flats("jax", jax_restore(
            JaxState.create(model.apply, p0, optax.sgd(0.1), s0), dense
        ))
    for want, have in zip(run["flats"], got):
        assert set(have) == set(want)
        for k in want:
            np.testing.assert_array_equal(have[k], want[k])

    argv = _local_argv(data, "--checkpoint_dir_for_init", run["ckpt"])
    got = port_api.evaluate(port_parse(argv + ["--device", "cpu"]))
    want = jax_api.evaluate(jax_parse(argv))
    assert abs(got["loss"] - want["loss"]) < LOGIT_TOL
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 200 + 1e-9

    # and training resumes from it: the step counts on from the writer's
    ckpt = str(local_runs["root"] / f"{reader}_resumes_{writer}")
    shutil.copytree(run["ckpt"], ckpt)
    executor, result, _tasks = _local_run(reader, _local_argv(
        data, "--training_data", data["train"], "--checkpoint_dir", ckpt, epochs=1,
    ))
    assert int(executor.trainer.step) == LOCAL_STEPS + LOCAL_STEPS // LOCAL_EPOCHS
    assert result["accuracy"] >= run["result"]["accuracy"] - ACCURACY_TOL


@pytest.mark.parametrize("loader, writer", [("port", "jax"), ("jax", "port")])
def test_each_package_loads_the_others_export_with_its_statistics(
    local_runs, loader, writer
):
    from elasticdl_tpu.utils.export_utils import load_exported_model as jax_load_export
    from elasticdl_tpu_torch.utils.export_utils import load_exported_model

    export = local_runs[writer]["export"]
    want_params, want_stats = local_runs[writer]["flats"]
    if loader == "port":
        model, _flat, _state = load_exported_model(export, device="cpu")
        got_params = flax_weights.flax_flat_from_torch(model)
        got_stats = flax_weights.flax_state_from_torch(model)
    else:
        _model, got_params, got_stats = jax_load_export(export)
    for want, got in ((want_params, got_params), (want_stats, got_stats)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_predict_job_uses_the_default_processor_lookup(local_runs, monkeypatch):
    """mnist defines no ``PredictionOutputsProcessor``: the port's
    predict job looks the default name up, finds none, and returns the
    trained model's outputs for every record."""
    from elasticdl_tpu_torch.trainer import local_executor as port_le
    from elasticdl_tpu_torch.utils.args import parse_master_args as port_parse

    data = local_runs["data"]
    argv = _local_argv(
        data, "--prediction_data", data["eval"],
        "--checkpoint_dir_for_init", local_runs["port"]["ckpt"], "--device", "cpu",
    )
    executor = port_le.LocalExecutor(port_parse(argv))
    assert executor._spec.prediction_outputs_processor is None
    outputs = executor.predict()
    assert sum(len(o) for o in outputs) == 200
    assert all(o.shape[1:] == (10,) and np.isfinite(o).all() for o in outputs)


def test_smoke_phase7_rehearsal_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s mnist phase at a small size: every check of
    the phase runs (its accuracy bar lowered for 16 steps), and the bare
    loop's device times read none on the CPU."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cfg = dict(
        chip_smoke.MNIST, train_records=1024, eval_records=256, batch=64,
        records_per_task=256, checkpoint_steps=5, min_accuracy=0.1,
    )
    row = chip_smoke.train_zoo_model(str(tmp_path), cfg, device="cpu")
    checked = row["checked"]
    assert (checked["tasks"], checked["records"], checked["steps"]) == (8, 1024, 16)
    assert checked["paths"] == {"vectorized": 20, "classic": 0}
    assert checked["checkpoint_versions"] == [10, 15, 16]
    assert row["timed"]["steady_tasks"] == 7 and row["bare"]["device_ms_per_step"] is None
