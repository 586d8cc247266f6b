"""The port's ResNet-50 against the JAX package's, on the CPU.

Weights come from the flax tree through ``utils/flax_weights.py``;
inputs are made with numpy from a seed.  Each trap of the port is pinned:

- the stem's SAME max-pool pads asymmetrically (one more row and column
  after the input than before it); ``F.max_pool2d(padding=1)`` differs;
- the strided ConvBlock strides its 1x1 ``conv_a`` and shortcut;
- the convolutions have no bias, and BatchNorm runs at epsilon 1e-5 and
  momentum 0.9 (the blocks' outputs and running statistics, in training
  and evaluation);
- the decoupled weight decay reaches the conv and dense kernels and
  ``fc``'s bias and never BatchNorm (the decay set, and one SGD step of
  the whole network, which a plain SGD with ``weight_decay`` on every
  parameter fails).

The whole network is compared once, in one module-scoped fixture (the
JAX package's compiles on the CPU are the cost), on 2 images of
128 x 128.  At 32 x 32 the last stage's BatchNorm would normalise 2 values
a channel (1 x 1 x 2), which sends each to about +-1 and magnifies the
last f32 bits of its input without bound: the two packages' f32
probabilities then differ by 0.4 with nothing wrong in either.  At 128 x
128 it sees 32 a channel.

Tolerances:

- blocks at narrow widths, f32: 1e-5 on outputs and statistics;
- the whole network in f32: probabilities within 2e-4 (53 layers of f32
  in another order; 4e-5 measured);
- one SGD step in f64 (``jax.enable_x64`` on the JAX side, the port's
  model in f64): every parameter's update within 1e-6 relative, and the
  running statistics within 1e-9.  Both models take their softmax in f32,
  so f64 holds the rest of the network to about 1e-7 (6e-8 measured);
  f32 would not do: at initialisation each BatchNorm's backward cancels
  most of its input gradient, and f32 alone moves the updates by 1.5%
  against f64 in the port itself;
- bf16 probabilities within 0.1 of the JAX bf16 forward.  Each package's
  bf16 lands about 0.03 from its f32 probabilities here (the 53 layers
  round at 8 bits, each in its own order), and the two at 0.05 apart.
"""

from __future__ import annotations

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from elasticdl_tpu.models import resnet50_model as jax_model
from elasticdl_tpu.models import resnet50_subclass as jax_resnet
from elasticdl_tpu.trainer import step as jax_step
from elasticdl_tpu.trainer.state import TrainState as JaxState
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu_torch.layers.initializers import he_normal_
from elasticdl_tpu_torch.layers.normalization import BatchNorm
from elasticdl_tpu_torch.models import imagenet_resnet50 as port_imagenet
from elasticdl_tpu_torch.models import resnet50_model as port_model
from elasticdl_tpu_torch.models import resnet50_subclass as port_resnet
from elasticdl_tpu_torch.trainer import step as port_step
from elasticdl_tpu_torch.trainer.state import TrainState
from elasticdl_tpu_torch.utils import flax_weights

BLOCK_TOL = 1e-5
PROB_TOL = 2e-4
STEP_REL_TOL = 1e-6
STATS_TOL_F64 = 1e-9
BF16_PROB_TOL = 0.1
ROWS, SIDE = 2, 128
LABELS = np.array([3, 7], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _two_intra_op_threads():
    """At most two torch intra-op threads in this module: the suite runs
    several test processes on the machine's cores, and a large op split
    over one thread per core waits at each barrier for threads the other
    processes have descheduled (ResNet-50 steps ran 50 times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(tree).items()}


def _load(port, flat, flat_state):
    port.load_state_dict(flax_weights.torch_state_from_flax(flat, port, flat_state))
    return port


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---- building blocks --------------------------------------------------------


def _entries_load(block, flat, flat_stats):
    """``block``'s state from flax block variables (``flax_weights``'
    block entries, here rooted at the block)."""
    state = {}
    for e in flax_weights._resnet_block("b", block):
        key = e.flax_key[len("b/"):]
        arr = flat[key] if e.collection == "params" else flat_stats[key]
        state[e.torch_key[len("b."):]] = torch.from_numpy(
            flax_weights._to_torch(e, np.asarray(arr, np.float32))
        )
    block.load_state_dict(state)
    return block


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["identity", "conv"])
def test_blocks_match_flax(kind, training):
    """Narrow filters (4, 4, 16); the strided ConvBlock halves 8 x 8,
    its stride on ``conv_a`` and the shortcut."""
    filters = (4, 4, 16)
    rng = np.random.RandomState(7)
    if kind == "identity":
        jax_block = jax_model.IdentityBlock(3, filters)
        port_block = port_model.IdentityBlock(16, 3, filters)
        x = rng.normal(size=(4, 8, 8, 16)).astype(np.float32)
    else:
        jax_block = jax_model.ConvBlock(3, filters)
        port_block = port_model.ConvBlock(6, 3, filters, strides=2)
        x = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)
    variables = _np_tree(jax_block.init(jax.random.PRNGKey(1), jnp.asarray(x), training=True))
    stats = {
        k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32) if k.endswith("var")
        else rng.normal(0, 0.1, v.shape).astype(np.float32)
        for k, v in tree_utils.tree_to_dict(variables["batch_stats"]).items()
    }
    variables["batch_stats"] = tree_utils.dict_to_tree(stats, variables["batch_stats"])
    want, moved = jax_block.apply(
        variables, jnp.asarray(x), training=training, mutable=["batch_stats"]
    )
    _entries_load(port_block, tree_utils.tree_to_dict(variables["params"]), stats)
    with torch.no_grad():
        got = port_block(torch.from_numpy(x).permute(0, 3, 1, 2), training)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=BLOCK_TOL, rtol=0)
    got_stats = {
        e.flax_key[len("b/"):]: flax_weights._to_flax(e, port_block.state_dict()[e.torch_key[len("b."):]].numpy())
        for e in flax_weights._resnet_block("b", port_block) if e.collection != "params"
    }
    for k, v in tree_utils.tree_to_dict(moved["batch_stats"]).items():
        np.testing.assert_allclose(got_stats[k], np.asarray(v), atol=BLOCK_TOL, rtol=0)
    # the convolutions have no bias
    assert all(m.bias is None for m in port_block.modules() if isinstance(m, torch.nn.Conv2d))


@pytest.mark.parametrize("side", [16, 112])
def test_same_max_pool_pads_after_the_input(side):
    """XLA's SAME pads (0, 1) at 16 and at 112; a symmetric pad of 1
    shifts every window by one."""
    x = np.random.RandomState(side).normal(size=(2, side, side, 5)).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port_model.max_pool_same(xt, 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    symmetric = F.max_pool2d(xt, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert symmetric.shape == want.shape and not np.array_equal(symmetric, want)


def test_he_normal_matches_flax_distribution():
    """Truncated at two standard deviations, variance 2 / fan_in with
    fan_in = I*H*W (OIHW), as flax's he_normal on HWIO."""
    torch.manual_seed(0)
    w = he_normal_(torch.empty(256, 64, 3, 3))
    fan_in = 64 * 9
    flax_w = np.asarray(nn.initializers.he_normal()(jax.random.PRNGKey(0), (3, 3, 64, 256)))
    assert abs(w.std().item() / np.sqrt(2.0 / fan_in) - 1) < 0.01
    assert abs(w.std().item() / flax_w.std() - 1) < 0.01
    bound = 2 * np.sqrt(2.0 / fan_in) / 0.87962566103423978
    assert w.abs().max().item() <= bound and np.abs(flax_w).max() <= bound * (1 + 1e-6)


# ---- the whole network ------------------------------------------------------


def _images(seed=0):
    return np.random.RandomState(seed).rand(ROWS, SIDE, SIDE, 3).astype(np.float32)


def _port_f64_step(flat, flat_stats, x, tx):
    port = _load(port_resnet.custom_model(), flat, flat_stats).double()
    state = TrainState.create(port, tx)
    _, metrics = port_step.build_train_step(port_resnet.loss)(
        state, {"image": torch.from_numpy(x.astype(np.float64))},
        torch.from_numpy(LABELS), torch.ones(ROWS),
    )
    return port, float(metrics["loss"])


def _port_f64_flats(port):
    """The port's parameters and statistics in flax's names, at f64."""
    state = port.state_dict()
    out = {}
    for e in flax_weights._entries(port):
        key = e.flax_key if e.collection == "params" else f"{e.collection}/{e.flax_key}"
        out[key] = flax_weights._to_flax(e, state[e.torch_key].detach().numpy())
    return out


@pytest.fixture(scope="module")
def resnet():
    # the port's seeded weights, carried to the JAX tree (flax's init of
    # the whole network runs op by op on the CPU, for about 15 s)
    model = jax_resnet.custom_model()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        seeded = port_resnet.custom_model()
    flat = flax_weights.flax_flat_from_torch(seeded)
    flat_stats = flax_weights.flax_state_from_torch(seeded)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))}
    ))
    params = tree_utils.dict_to_tree(flat, shapes["params"])
    stats = tree_utils.dict_to_tree(flat_stats, {"batch_stats": shapes["batch_stats"]})
    x = _images()
    out = {"model": model, "params": params, "stats": stats, "flat": flat,
           "flat_stats": flat_stats, "x": x}

    # training-mode probabilities, f32 and bf16
    for dtype in (None, "bfloat16"):
        jm = jax_resnet.custom_model(dtype=dtype)
        probs, _ = jax.jit(
            lambda v, f, jm=jm: jm.apply(v, f, training=True, mutable=["batch_stats"])
        )({"params": params, **stats}, {"image": jnp.asarray(x)})
        out[f"jax_probs_{dtype}"] = np.asarray(probs)

    # one SGD step in f64
    with jax.enable_x64(True):
        p64, s64 = (
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
            for t in (params, stats)
        )
        state = JaxState.create(model.apply, p64, jax_resnet.optimizer(), s64)
        train = jax_step.build_train_step(jax_resnet.loss, donate=False)
        new_state, metrics = train(
            state, {"image": jnp.asarray(x, jnp.float64)}, jnp.asarray(LABELS),
            jnp.ones(ROWS, jnp.float32),
        )
        out["jax_step"] = {
            **{k: np.asarray(v) for k, v in _flat(new_state.params).items()},
            **{k: np.asarray(v) for k, v in _flat(new_state.model_state).items()},
        }
        out["jax_loss"] = float(metrics["loss"])

    # running statistics set to this batch's (momentum 0), so that the
    # evaluation-mode probabilities are neither saturated nor the initial
    # statistics' identity
    port = _load(port_resnet.custom_model(), flat, flat_stats)
    for layer in port.modules():
        if isinstance(layer, BatchNorm):
            layer.momentum = 0.0
    with torch.no_grad():
        port({"image": torch.from_numpy(x)}, training=True)
    out["eval_stats"] = flax_weights.flax_state_from_torch(port)
    eval_fn = jax.jit(model.apply)
    out["jax_eval"] = lambda p, s: np.asarray(
        eval_fn({"params": p, **s}, {"image": jnp.asarray(x)})
    )
    return out


def test_the_decay_set_is_the_jax_mask(resnet):
    """53 conv kernels, ``fc/kernel`` and ``fc/bias``: the JAX mask's
    leaves, by the flax names ``flax_weights`` gives the port's
    parameters; never BatchNorm's scale or bias."""
    port = port_resnet.custom_model()
    mask = tree_utils.tree_to_dict(jax_resnet._decay_mask(resnet["params"]))
    want = {k for k, v in mask.items() if bool(v)}
    names = {e.torch_key: e.flax_key for e in flax_weights._entries(port)}
    got = {names[n] for n, _ in port.named_parameters() if port_resnet.decays(n)}
    assert got == want
    assert len(want) == 55 and {"fc/kernel", "fc/bias"} <= want
    assert sum(k.endswith("/kernel") and k != "fc/kernel" for k in want) == 53
    opt = TrainState.create(port, port_resnet.optimizer()).optimizer
    assert [g["weight_decay"] for g in opt.param_groups] == [2e-4, 0.0]
    assert [len(g["params"]) for g in opt.param_groups] == [55, 106]


def test_a_named_parameter_factory_keeps_its_groups_under_a_schedule():
    """``build_optimizer`` wraps the factory for a learning-rate
    schedule and keeps it taking ``named_parameters()``; the schedule
    sets the lr of both groups, and ``resolve_optimizer`` takes the
    marked factory as it is."""
    from elasticdl_tpu_torch.trainer.local_executor import build_optimizer
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    spec = get_model_spec("", RESNET_DEF)
    factory = port_resnet.optimizer()
    assert port_step.resolve_optimizer(factory) is factory
    spec.learning_rate_scheduler = lambda version: 0.5 / (version + 1)
    model = port_resnet.custom_model()
    opt = TrainState.create(model, build_optimizer(spec)).optimizer
    assert [g["weight_decay"] for g in opt.param_groups] == [2e-4, 0.0]
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    opt.step()
    assert [g["lr"] for g in opt.param_groups] == [0.25, 0.25]


def test_probabilities_match_jax(resnet):
    port = _load(port_resnet.custom_model(), resnet["flat"], resnet["flat_stats"])
    with torch.no_grad():
        got = port({"image": torch.from_numpy(resnet["x"])}, training=True).numpy()
    want = resnet["jax_probs_None"]
    assert got.shape == (ROWS, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
    assert want.max() < 0.9  # not saturated: the comparison means something


def test_bfloat16_forward_matches_jax_bfloat16(resnet):
    port = _load(
        port_resnet.custom_model(dtype="bfloat16"), resnet["flat"], resnet["flat_stats"]
    )
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        got = port({"image": torch.from_numpy(resnet["x"])}, training=True)
    assert got.dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in port.buffers())
    np.testing.assert_allclose(got.numpy(), resnet["jax_probs_bfloat16"], atol=BF16_PROB_TOL, rtol=0)
    # bf16 moved the result: the convolutions did compute in bf16
    assert np.abs(got.numpy() - resnet["jax_probs_None"]).max() > 1e-3


def test_one_sgd_step_matches_jax_and_plain_decay_does_not(resnet):
    flat, flat_stats, x = resnet["flat"], resnet["flat_stats"], resnet["x"]
    port, loss = _port_f64_step(flat, flat_stats, x, port_resnet.optimizer())
    assert abs(loss - resnet["jax_loss"]) < 1e-6
    got, want = _port_f64_flats(port), resnet["jax_step"]
    assert set(got) == set(want)
    for name, value in want.items():
        if name.startswith("batch_stats/"):
            np.testing.assert_allclose(got[name], value, atol=STATS_TOL_F64, rtol=0)
        else:
            assert _rel(got[name] - flat[name], value - flat[name]) < STEP_REL_TOL, name
    # torch's SGD(weight_decay) over every parameter, the plain
    # translation, also decays BatchNorm's scale and bias
    plain, _ = _port_f64_step(
        flat, flat_stats, x,
        lambda params: torch.optim.SGD(params, lr=0.02, weight_decay=2e-4),
    )
    plain = _port_f64_flats(plain)
    off = [
        n for n in want
        if not n.startswith("batch_stats/")
        and _rel(plain[n] - flat[n], want[n] - flat[n]) > STEP_REL_TOL
    ]
    assert off and all(n.split("/")[-2].startswith("bn") for n in off)


def test_the_loss_runs_under_vmap_with_row_weights():
    """``weighted_mean_loss`` vmaps the loss over rows: zero-weight rows
    add nothing, all-ones weights give the plain mean."""
    probs = torch.softmax(torch.randn(5, 10, generator=torch.Generator().manual_seed(0)), -1)
    labels = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    full = port_step.weighted_mean_loss(port_resnet.loss, labels, probs, torch.ones(5))
    assert torch.allclose(full, port_resnet.loss(labels, probs))
    masked = port_step.weighted_mean_loss(
        port_resnet.loss, labels, probs, torch.tensor([1.0, 1, 1, 0, 0])
    )
    assert torch.allclose(masked, port_resnet.loss(labels[:3], probs[:3]))
    want = jax_resnet.loss(jnp.asarray(labels.numpy()), jnp.asarray(probs.numpy()))
    assert abs(float(full) - float(want)) < 1e-6


# ---- checkpoints across the packages ---------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages(resnet, tmp_path, writer):
    """A checkpoint one package writes restores in the other, with its
    batch statistics, to the same evaluation-mode probabilities."""
    from elasticdl_tpu.trainer.state import checkpoint_to_state as jax_from_ckpt
    from elasticdl_tpu.trainer.state import state_to_checkpoint as jax_to_ckpt
    from elasticdl_tpu.utils import save_utils as jax_save
    from elasticdl_tpu_torch.trainer.state import checkpoint_to_state, state_to_checkpoint
    from elasticdl_tpu_torch.utils import save_utils as port_save

    params, flat = resnet["params"], resnet["flat"]
    stats = tree_utils.dict_to_tree(resnet["eval_stats"], resnet["stats"])
    ckpt = str(tmp_path / "ckpt")
    if writer == "jax":
        state = JaxState.create(resnet["model"].apply, params, jax_resnet.optimizer(), stats)
        jax_save.CheckpointSaver(ckpt).save(3, jax_to_ckpt(state), extra={"model_version": 3})
        port = TrainState.create(port_resnet.custom_model(), port_resnet.optimizer())
        checkpoint_to_state(port, port_save.restore_checkpoint(ckpt)[0])
        model = port.model.eval()
        with torch.no_grad():
            got = model({"image": torch.from_numpy(resnet["x"])}).numpy()
        want = resnet["jax_eval"](params, stats)
    else:
        port = _load(port_resnet.custom_model(), flat, resnet["eval_stats"]).eval()
        port_save.CheckpointSaver(ckpt).save(
            3, state_to_checkpoint(TrainState.create(port, port_resnet.optimizer())),
            extra={"model_version": 3},
        )
        fresh = JaxState.create(
            resnet["model"].apply, jax.tree_util.tree_map(np.zeros_like, params),
            jax_resnet.optimizer(), jax.tree_util.tree_map(np.zeros_like, stats),
        )
        restored = jax_from_ckpt(fresh, jax_save.restore_checkpoint(ckpt)[0])
        want = resnet["jax_eval"](restored.params, restored.model_state)
        with torch.no_grad():
            got = port({"image": torch.from_numpy(resnet["x"])}).numpy()
    assert want.max() < 0.9
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)


# ---- the imagenet module ----------------------------------------------------


def test_imagenet_module_builds_1000_classes_and_preps_records():
    import io

    from PIL import Image

    from elasticdl_tpu.models import imagenet_resnet50 as jax_imagenet
    from elasticdl_tpu_torch.data.reader import decode_example

    model = port_imagenet.custom_model()
    assert model.fc.out_features == 1000 and port_imagenet.loss is port_resnet.loss
    buf = io.BytesIO()
    Image.fromarray(
        np.random.RandomState(0).randint(0, 256, (40, 60, 3)).astype(np.uint8)
    ).save(buf, format="PNG")
    payload = buf.getvalue()
    got = port_imagenet.prepare_data_for_a_single_file(io.BytesIO(payload), "dir/7_x.JPEG")
    want = jax_imagenet.prepare_data_for_a_single_file(io.BytesIO(payload), "dir/7_x.JPEG")
    assert got == want
    ex = decode_example(got)
    assert ex["image"].shape == (224, 224, 3) and int(ex["label"]) == 7
    with pytest.raises(ValueError, match="not a decodable image"):
        port_imagenet.prepare_data_for_a_single_file(io.BytesIO(b"junk"), "1_x.JPEG")


def test_imagenet_prep_without_pil_raises_at_prep_time(monkeypatch):
    import builtins
    import io

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="needs PIL"):
        port_imagenet.prepare_data_for_a_single_file(io.BytesIO(b"x"), "1_x.JPEG")


# ---- the Local train CLI of both packages -----------------------------------


RESNET_DEF = "resnet50_subclass.resnet50_subclass.custom_model"


def test_local_cli_trains_the_same_tasks_and_records_as_jax(tmp_path):
    """32 ``gen_cifar10`` records in 2 shards, 8 a task, 8 rows a step,
    one epoch: both packages hand out the same 4 tasks and take 4 steps
    (the port's evaluation of ResNet-50 runs in the smoke's rehearsal,
    ``test_torch_zoo.py``)."""
    from elasticdl_tpu.data import recordio as jax_recordio
    from elasticdl_tpu.trainer import local_executor as jax_le
    from elasticdl_tpu.utils.args import parse_master_args as jax_parse
    from elasticdl_tpu_torch.data.recordio_gen import synthetic
    from elasticdl_tpu_torch.trainer import local_executor as port_le
    from elasticdl_tpu_torch.utils.args import parse_master_args as port_parse

    jax_recordio.ensure_native_codec()
    train = synthetic.gen_cifar10(str(tmp_path / "train"), num_records=32, num_shards=2, seed=0)
    argv = [
        "--model_def", RESNET_DEF, "--training_data", train,
        "--records_per_task", "8",
        "--minibatch_size", "8", "--num_epochs", "1", "--shuffle_seed", "0",
        "--mesh_shape", "dp=1",
    ]
    runs = {}
    for package, module, parse, extra in (
        ("jax", jax_le, jax_parse, []), ("port", port_le, port_parse, ["--device", "cpu"]),
    ):
        tasks = []

        class Recording(module.TaskDispatcher):
            def get(self, worker_id):
                tid, task = super().get(worker_id)
                if task is not None:
                    tasks.append((os.path.basename(task.shard_name), task.start, task.end, task.type.name))
                return tid, task

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "TaskDispatcher", Recording)
            executor = module.LocalExecutor(parse(argv + extra))
            executor.run()
        runs[package] = (tasks, int(executor.trainer.step))
    (jax_tasks, jax_steps), (tasks, steps) = runs["jax"], runs["port"]
    assert tasks == jax_tasks
    assert len(tasks) == 4 and all(t[3] == "TRAINING" for t in tasks)
    assert sum(e - s for _f, s, e, _t in tasks) == 32
    assert steps == jax_steps == 4
