"""The rest of the port's single-device zoo against the JAX package's, on
the CPU: the CIFAR-10 CNNs, mnist_subclass, the feature-column models
(heart, the three census styles) and iris, their data generators, the
image converter, the feature columns and the string hash.

Each model takes one step from the same seeded weights (the port's,
carried to the JAX model with ``utils/flax_weights.py``) on the same
numpy batch; a CNN's dropout is
fed the JAX step's own mask (patched in this test, not switched in the
port).  Tolerances: after one step every parameter within 1e-5 in
relative norm, its update within 1e-3 in relative norm (the update is
small beside the weight it is added to, so its f32 rounding is larger),
the running statistics within 1e-6 and the loss within 1e-5: f32
arithmetic in another order.  heart's SGD(1e-6) would move its weights
by less than their f32 rounding, so its step runs at lr 0.1 in both
packages (``optimizer(lr=0.1)``).

The CIFAR-10 CNN's step is compared in f64 (``jax.enable_x64``; both
models take their softmax in f32, so the updates agree to about 4e-8):
the JAX package's f32 step on the CPU sits 1e-3 from both packages' f64
steps in the lower layers' gradients, where the port's f32 step sits
1e-6 from them.
"""

from __future__ import annotations

import gzip
import os
import struct

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu import feature_column as jax_fc
from elasticdl_tpu.data.recordio_gen import image_label as jax_image_label
from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
from elasticdl_tpu.trainer import step as jax_step
from elasticdl_tpu.trainer.state import TrainState as JaxState
from elasticdl_tpu.utils import hash_utils as jax_hash
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu_torch import feature_column as port_fc
from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.data.recordio_gen import image_label
from elasticdl_tpu_torch.data.recordio_gen import synthetic
from elasticdl_tpu_torch.trainer import step as port_step
from elasticdl_tpu_torch.trainer.state import TrainState
from elasticdl_tpu_torch.utils import flax_weights, hash_utils

STEP_REL_TOL = 1e-5
UPDATE_REL_TOL = 1e-3
STATS_TOL = 1e-6
LOSS_TOL = 1e-5
F64_UPDATE_TOL = 1e-6
F64_STATS_TOL = 1e-12
ZERO_UPDATE_TOL = 1e-12


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


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _modules(name):
    """``(jax module, port module)`` of one zoo module path."""
    import importlib

    return (
        importlib.import_module(f"elasticdl_tpu.models.{name}"),
        importlib.import_module(f"elasticdl_tpu_torch.models.{name}"),
    )


ZOO_DEFS = (
    "resnet50_subclass.resnet50_subclass.custom_model",
    "imagenet_resnet50.imagenet_resnet50.custom_model",
    "cifar10_functional_api.cifar10_functional_api.custom_model",
    "cifar10_subclass.cifar10_subclass.custom_model",
    "mnist_subclass.mnist_subclass.custom_model",
    "heart_functional_api.heart_functional_api.custom_model",
    "census_dnn_model.census_functional_api.custom_model",
    "census_dnn_model.census_sequential.custom_model",
    "census_dnn_model.census_subclass.custom_model",
    "odps_iris_dnn_model.odps_iris_dnn_model.custom_model",
)


@pytest.mark.parametrize("model_def", ZOO_DEFS)
def test_model_defs_resolve_as_in_the_jax_package(model_def):
    """The JAX package's ``--model_def`` strings name the port's modules,
    whose spec carries the same hooks."""
    from elasticdl_tpu.utils.model_utils import get_model_spec as jax_spec
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    spec, want = get_model_spec("", model_def), jax_spec("", model_def)
    assert spec.module.__name__ == want.module.__name__.replace(
        "elasticdl_tpu.", "elasticdl_tpu_torch.", 1
    )
    for hook in ("dataset_fn", "batch_parse", "device_parse", "eval_metrics_fn",
                 "learning_rate_scheduler"):
        assert (getattr(spec, hook) is None) == (getattr(want, hook) is None), hook


# ---- data: generators, the image converter, hashing -------------------------


def _read_records(directory):
    out = []
    for name in sorted(os.listdir(directory)):
        with recordio.Scanner(os.path.join(directory, name)) as scanner:
            out += [decode_example(r) for r in scanner]
    return out


@pytest.mark.parametrize("dataset", ["cifar10", "census", "heart", "iris"])
def test_generators_write_the_jax_packages_shards(tmp_path, dataset):
    """The same seed gives byte-identical shards, so the same records."""
    kwargs = dict(num_records=24, num_shards=2, seed=3)
    got = synthetic.GENERATORS[dataset](str(tmp_path / "port"), **kwargs)
    want = jax_synthetic.GENERATORS[dataset](str(tmp_path / "jax"), **kwargs)
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and len(names) == 2
    for name in names:
        with open(os.path.join(got, name), "rb") as a, open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name
    records = _read_records(got)
    assert len(records) == 24
    assert set(synthetic.GENERATORS) == set(jax_synthetic.GENERATORS)


def _write_idx(path, array, dtype_code):
    data = np.ascontiguousarray(array)
    with gzip.open(path, "wb") as f:
        f.write(struct.pack("BBBB", 0, 0, dtype_code, data.ndim))
        f.write(struct.pack(f">{data.ndim}I", *data.shape))
        f.write(data.tobytes())


@pytest.mark.parametrize("source", ["idx", "npz"])
def test_image_label_ingests_idx_and_npz_as_jax_does(tmp_path, source):
    rng = np.random.RandomState(0)
    if source == "idx":
        src = tmp_path / "idx"
        src.mkdir()
        images = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
        labels = rng.randint(0, 10, 5).astype(np.uint8)
        _write_idx(str(src / "train-images-idx3-ubyte.gz"), images, 0x08)
        _write_idx(str(src / "train-labels-idx1-ubyte.gz"), labels, 0x08)
        _write_idx(str(src / "t10k-images-idx3-ubyte.gz"), images[:2], 0x08)
        _write_idx(str(src / "t10k-labels-idx1-ubyte.gz"), labels[:2], 0x08)
        dataset, splits = "mnist", {"train": 5, "test": 2}
    else:
        src = tmp_path / "cifar.npz"
        images = rng.randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
        labels = rng.randint(0, 10, (6, 1)).astype(np.int64)
        np.savez(src, x_train=images, y_train=labels)
        dataset, splits = "cifar10", {"train": 6}
    argv = ["--dataset", dataset, "--source", str(src), "--records_per_shard", "4"]
    assert image_label.main([str(tmp_path / "port"), *argv]) == 0
    assert jax_image_label.main([str(tmp_path / "jax"), *argv]) == 0
    for split, count in splits.items():
        got_dir = tmp_path / "port" / dataset / split
        want_dir = tmp_path / "jax" / dataset / split
        names = sorted(os.listdir(want_dir))
        assert sorted(os.listdir(got_dir)) == names
        for name in names:
            assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes()
        records = _read_records(str(got_dir))
        assert len(records) == count
        np.testing.assert_array_equal(records[0]["image"], images[0])
        assert int(records[-1]["label"]) == int(np.asarray(labels[count - 1]).reshape(()))
    with pytest.raises(ValueError, match="IDX directory or .npz"):
        image_label.load_source(str(tmp_path / "nothing"))


def test_string_hash_matches_jax():
    for name in ("", "thal", "fixed", "Never-married", "x" * 100):
        for buckets in (1, 7, 64, 100):
            assert hash_utils.string_to_id(name, buckets) == jax_hash.string_to_id(name, buckets)
    ids = np.arange(-5, 50)
    assert hash_utils.int_to_id(12, 5) == jax_hash.int_to_id(12, 5)
    for got, want in zip(hash_utils.scatter_ids(ids, 4), jax_hash.scatter_ids(ids, 4)):
        np.testing.assert_array_equal(got, want)


# ---- feature columns ---------------------------------------------------------


def _columns(fc):
    return (
        fc.numeric_column("age"),
        fc.numeric_column("pair", shape=(2,)),
        fc.bucketized_column(fc.numeric_column("age"), (20, 40, 60)),
        fc.embedding_column(fc.categorical_column_with_hash_bucket("city", 16), 4),
        fc.embedding_column(
            fc.categorical_column_with_vocabulary_list("color", ["red", "blue"]), 3,
            combiner="sum",
        ),
        fc.indicator_column(fc.categorical_column_with_identity("slot", 5)),
        fc.indicator_column(fc.categorical_column_with_vocabulary_list("color", ["red", "blue"])),
    )


def test_feature_columns_match_jax():
    """Every column kind, host half and device half: the same ids from
    strings, vocabularies and identities (out-of-vocabulary and
    out-of-range values absent), and the same dense output from the same
    tables."""
    raw = {
        "age": np.array([15.0, 25.0, 45.0, 70.0], np.float32),
        "pair": np.arange(8, dtype=np.float32).reshape(4, 2),
        "city": np.array(["paris", "rome", "oslo", "paris"]),
        "color": np.array([[b"red", b"green"], [b"blue", b"blue"], [b"x", b"red"], [b"red", b"red"]]),
        "slot": np.array([[0, 4], [9, 1], [-1, 2], [3, 3]]),
    }
    want_host = jax_fc.transform_features(_columns(jax_fc), raw)
    got_host = port_fc.transform_features(_columns(port_fc), raw)
    assert set(got_host) == set(want_host) and "city" not in got_host
    for k in want_host:
        np.testing.assert_array_equal(got_host[k], want_host[k])
    assert (got_host["color_embedding"] == -1).any() and (got_host["slot_indicator"] == -1).any()

    jax_layer = jax_fc.DenseFeatures(columns=_columns(jax_fc))
    params = jax_layer.init(jax.random.PRNGKey(0), want_host)["params"]
    want = np.asarray(jax_layer.apply({"params": params}, want_host))
    port_layer = port_fc.DenseFeatures(_columns(port_fc))
    assert port_layer.output_dim == want.shape[1] == 1 + 2 + 4 + 4 + 3 + 5 + 2
    with torch.no_grad():
        for name, table in tree_utils.tree_to_dict(params).items():
            getattr(port_layer, name.split("/")[0]).embedding.copy_(torch.from_numpy(np.asarray(table)))
        got = port_layer({k: torch.from_numpy(np.asarray(v)) for k, v in got_host.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---- one step of each model --------------------------------------------------


def _port_model(port_mod, flat, flat_state, **kwargs):
    model = port_mod.custom_model(**kwargs)
    model.load_state_dict(flax_weights.torch_state_from_flax(flat, model, flat_state or None))
    return model


def _port_flats(port) -> dict:
    """The port's parameters and statistics in flax's names and layouts,
    at the model's own dtype (``flax_weights`` gives f32)."""
    state = port.state_dict()
    out = {}
    for e in flax_weights._entries(port):
        key = e.flax_key if e.collection == "params" else f"{e.collection}/{e.flax_key}"
        out[key] = flax_weights._to_flax(e, state[e.torch_key].detach().numpy())
    return out


def _jax_dropout_keeps(model, variables, features):
    """The keep masks (in call order) the JAX train step's dropout layers
    draw at step 0, read from each Dropout run on ones."""
    keeps = []

    def on_ones(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            keeps.append(torch.from_numpy(np.asarray(out) != 0))
            return out
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(on_ones):
        model.apply(
            variables, features, training=True,
            rngs={"dropout": jax.random.fold_in(jax.random.PRNGKey(0), 0)},
            mutable=["batch_stats"],
        )
    return keeps


def _seeded_variables(model, port_mod, sample):
    """``(params, collections)`` for the JAX ``model``: the port model's
    seeded weights carried to flax's tree (flax's own init runs op by op
    on the CPU, about 10 s the first time)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        seeded = port_mod.custom_model()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, sample)
    ))
    params = tree_utils.dict_to_tree(flax_weights.flax_flat_from_torch(seeded), shapes["params"])
    stats = {c: t for c, t in shapes.items() if c != "params"}
    if stats:
        stats = tree_utils.dict_to_tree(flax_weights.flax_state_from_torch(seeded), stats)
    return params, stats


def _one_step(jax_mod, port_mod, sample, features, labels, monkeypatch, opt_kwargs=None,
              dropout_module=None, f64=False):
    """One step of each package from the JAX model's seeded weights:
    ``(port flats, jax flats, before, port loss, jax loss)``.  ``f64``:
    both models and their float inputs in f64 (``jax.enable_x64``), the
    images scaled on the host instead of by ``device_parse``."""
    with jax.enable_x64(f64):
        return _steps(jax_mod, port_mod, sample, features, labels, monkeypatch,
                      opt_kwargs, dropout_module, f64)


def _steps(jax_mod, port_mod, sample, features, labels, monkeypatch, opt_kwargs,
           dropout_module, f64):
    opt_kwargs = opt_kwargs or {}
    model = jax_mod.custom_model()
    params, stats = _seeded_variables(model, port_mod, sample)
    flat, flat_stats = tree_utils.tree_to_dict(params), tree_utils.tree_to_dict(stats)
    device_parse = getattr(jax_mod, "device_parse", None)
    if f64:
        params, stats = (
            jax.tree_util.tree_map(lambda a: a.astype(np.float64), t) for t in (params, stats)
        )
        features = {k: v.astype(np.float64) / 255.0 for k, v in features.items()}
        device_parse = None
    jax_features = {k: jnp.asarray(v) for k, v in features.items()}
    if dropout_module is not None:
        parsed = device_parse(jax_features) if device_parse else jax_features
        keeps = iter(_jax_dropout_keeps(model, {"params": params, **stats}, parsed))

        def jax_mask_dropout(x, rate, generator):
            if generator is None:
                return x
            return torch.where(next(keeps), x / (1.0 - rate), torch.zeros_like(x))

        monkeypatch.setattr(dropout_module, "dropout", jax_mask_dropout)
    weights = np.ones(len(labels), np.float32)
    state = JaxState.create(model.apply, params, jax_mod.optimizer(**opt_kwargs), stats)
    train = jax_step.build_train_step(jax_mod.loss, device_parse=device_parse, donate=False)
    new_state, jax_metrics = train(state, jax_features, jnp.asarray(labels), jnp.asarray(weights))

    port = _port_model(port_mod, flat, flat_stats)
    if f64:
        port = port.double()
    port_state = TrainState.create(port, port_mod.optimizer(**opt_kwargs))
    _, port_metrics = port_step.build_train_step(
        port_mod.loss, device_parse=None if f64 else getattr(port_mod, "device_parse", None)
    )(
        port_state, {k: torch.from_numpy(np.asarray(v)) for k, v in features.items()},
        torch.from_numpy(labels), torch.from_numpy(weights),
    )
    got = _port_flats(port)
    want = {
        **{k: np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.params).items()},
        **{k: np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.model_state).items()},
    }
    return got, want, {**flat, **flat_stats}, float(port_metrics["loss"]), float(jax_metrics["loss"])


def _check_step(got, want, before, port_loss, jax_loss, f64=False):
    """``f64``: the updates within ``F64_UPDATE_TOL``, the statistics
    within ``F64_STATS_TOL``; a conv bias just before a BatchNorm, whose
    gradient is zero but for rounding (the normalisation subtracts it
    again), moves by less than ``ZERO_UPDATE_TOL`` in both."""
    update_tol, stats_tol = (F64_UPDATE_TOL, F64_STATS_TOL) if f64 else (UPDATE_REL_TOL, STATS_TOL)
    assert set(got) == set(want)
    assert abs(port_loss - jax_loss) < LOSS_TOL, (port_loss, jax_loss)
    for name, value in want.items():
        if name.startswith("batch_stats/"):
            np.testing.assert_allclose(got[name], value, atol=stats_tol, rtol=0)
            continue
        step, want_step = got[name] - before[name], value - before[name]
        if f64 and name.startswith("Conv_") and name.endswith("/bias"):
            assert np.abs(step).max() < ZERO_UPDATE_TOL > np.abs(want_step).max(), name
            continue
        assert _rel(got[name], value) < STEP_REL_TOL, name
        assert _rel(step, want_step) < update_tol, name


def _images(rows, shape, seed):
    return np.random.RandomState(seed).randint(0, 256, (rows, *shape)).astype(np.uint8)


@pytest.mark.parametrize("name", ["cifar10_functional_api", "cifar10_subclass"])
def test_cifar10_one_step_matches_jax(monkeypatch, name):
    import elasticdl_tpu_torch.models.cifar10_functional_api as port_cifar

    jax_mod, port_mod = _modules(name)
    features = {"image": _images(8, (32, 32, 3), 2)}
    labels = np.random.RandomState(3).randint(0, 10, 8).astype(np.int32)
    _check_step(*_one_step(
        jax_mod, port_mod, {"image": np.zeros((1, 32, 32, 3), np.float32)}, features,
        labels, monkeypatch, dropout_module=port_cifar, f64=True,
    ), f64=True)


def test_mnist_subclass_one_step_matches_jax(monkeypatch):
    import elasticdl_tpu_torch.models.mnist_functional_api as port_mnist

    jax_mod, port_mod = _modules("mnist_subclass")
    assert port_mod.optimizer().keywords == {"lr": 0.01}
    features = {"image": _images(8, (28, 28), 4)}
    labels = np.random.RandomState(5).randint(0, 10, 8).astype(np.int32)
    _check_step(*_one_step(
        jax_mod, port_mod, {"image": np.zeros((1, 28, 28), np.float32)}, features,
        labels, monkeypatch, dropout_module=port_mnist,
    ))


def _tabular_batch(name, rows=16):
    """A decoded ``gen_heart`` or ``gen_census`` batch for the model
    ``name``, through the JAX model's column transform (the port's equals
    it: ``test_feature_columns_match_jax``), and its labels."""
    import tempfile

    from elasticdl_tpu.models import heart_functional_api
    from elasticdl_tpu.models.census_dnn_model import census_functional_api

    heart = name.startswith("heart")
    dataset, label_key = ("heart", "target") if heart else ("census", "label")
    columns = (heart_functional_api if heart else census_functional_api).COLUMNS
    with tempfile.TemporaryDirectory() as d:
        records = _read_records(synthetic.GENERATORS[dataset](d, num_records=rows, num_shards=1, seed=6))
    batch = {k: np.stack([r[k] for r in records]) for k in records[0]}
    labels = batch.pop(label_key).astype(np.int32)
    return jax_fc.transform_features(columns, batch), labels


@pytest.mark.parametrize(
    "name", [
        "heart_functional_api", "census_dnn_model.census_functional_api",
        "census_dnn_model.census_sequential", "census_dnn_model.census_subclass",
    ],
)
def test_feature_column_models_one_step_matches_jax(monkeypatch, name):
    jax_mod, port_mod = _modules(name)
    heart = name.startswith("heart")
    features, labels = _tabular_batch(name)
    sample = {k: v[:1] for k, v in features.items()}
    got, want, before, port_loss, jax_loss = _one_step(
        jax_mod, port_mod, sample, features, labels, monkeypatch,
        opt_kwargs={"lr": 0.1} if heart else None,
    )
    _check_step(got, want, before, port_loss, jax_loss)
    embeddings = [k for k in want if k.startswith("DenseFeatures_0/")]
    assert embeddings and all(k.endswith("_embedding/embedding") for k in embeddings)


def test_iris_one_step_matches_jax(monkeypatch):
    jax_mod, port_mod = _modules("odps_iris_dnn_model")
    rng = np.random.RandomState(8)
    features = {"features": rng.normal(size=(12, 4)).astype(np.float32)}
    labels = rng.randint(0, 3, 12).astype(np.int32)
    got, want, *rest = _one_step(
        jax_mod, port_mod, {"features": features["features"][:1]}, features, labels,
        monkeypatch,
    )
    assert set(want) == {"output/kernel", "output/bias"}
    _check_step(got, want, *rest)


def test_cifar10_schedule_matches_jax():
    jax_mod, port_mod = _modules("cifar10_functional_api")
    for version in (0, 1, 4999, 5000, 5001, 14999, 15000, 10**6):
        want = float(jax_mod.learning_rate_scheduler(jnp.asarray(version)))
        assert port_mod.learning_rate_scheduler(version) == pytest.approx(want, rel=1e-6)
    assert not hasattr(_modules("cifar10_subclass")[1], "learning_rate_scheduler")


@pytest.mark.parametrize(
    "name", [
        "cifar10_functional_api", "mnist_subclass", "heart_functional_api",
        "census_dnn_model.census_subclass", "odps_iris_dnn_model",
    ],
)
def test_flax_weights_round_trip_and_name_the_jax_tree(name):
    """The port's names are the JAX model's tree, and a state dict
    survives the trip to flax and back bit for bit."""
    jax_mod, port_mod = _modules(name)
    if name.startswith(("heart", "census")):
        features, _ = _tabular_batch(name, rows=2)
        sample = {k: v[:1] for k, v in features.items()}
    elif name.startswith("odps"):
        sample = {"features": np.zeros((1, 4), np.float32)}
    else:
        side = (32, 32, 3) if name.startswith("cifar") else (28, 28)
        sample = {"image": np.zeros((1, *side), np.float32)}
    shapes = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jax_mod.custom_model().init(
            jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, sample)
        )),
    )
    port = port_mod.custom_model()
    flat = flax_weights.flax_flat_from_torch(port)
    flat_state = flax_weights.flax_state_from_torch(port)
    want_params = {k: v.shape for k, v in tree_utils.tree_to_dict(shapes["params"]).items()}
    assert {k: v.shape for k, v in flat.items()} == want_params
    want_state = {
        k: v.shape for k, v in tree_utils.tree_to_dict(
            {c: t for c, t in shapes.items() if c != "params"}
        ).items()
    }
    assert {k: v.shape for k, v in flat_state.items()} == want_state
    back = flax_weights.torch_state_from_flax(flat, port, flat_state or None)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


# ---- the smoke's phase 13 ------------------------------------------------------


def test_smoke_phase13_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s zoo phase at a small size, every check of it
    run on the CPU: ResNet-50 through the train CLI for 2 epochs (no
    accuracy bar, and no bar on its bf16 forward against f32, in 8
    steps), the imagenet shape through the trainer at 2
    rows of 64 x 64, and the rest of the zoo through the CLI (no accuracy
    bar but iris's in 8 steps)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "ZOO_BARE_STEPS", 2)
    cfg = dict(
        chip_smoke.RESNET_CIFAR, train_records=64, eval_records=16, shards=2, batch=16,
        records_per_task=32, checkpoint_steps=3, min_accuracy=-1.0, bf16_tol=1.0,
        held_rows=8,
    )
    row = chip_smoke.train_resnet_cifar(str(tmp_path / "resnet"), "cpu", cfg)
    checked = row["checked"]
    assert (checked["tasks"], checked["records"], checked["steps"]) == (4, 128, 8)
    assert checked["paths"] == {"vectorized": 9, "classic": 0}
    assert checked["checkpoint_versions"] == [3, 6, 8]
    assert row["held"]["prob_max_abs_err"] == 0.0 and row["steady"]["steady_tasks"] == 3
    assert row["bare"]["device_ms_per_step"] is None

    imagenet = chip_smoke.imagenet_resnet_steps(
        "cpu", dict(rows=2, side=64, classes=1000, steps=3, warmup=1)
    )
    assert len(imagenet["losses"]) == 3 and imagenet["peak_memory_gb"] is None

    small = [
        dict(c, train_records=256, eval_records=64, batch=32, records_per_task=64,
             min_accuracy=0.9 if c["name"] == "odps_iris" else None)
        for c in chip_smoke.ZOO_REST
    ]
    rows = chip_smoke.train_zoo_rest(str(tmp_path / "rest"), "cpu", small)
    assert set(rows) == {c["name"] for c in chip_smoke.ZOO_REST}
    for name, r in rows.items():
        assert (r["tasks"], r["records"], r["steps"]) == (4, 256, 8), name
