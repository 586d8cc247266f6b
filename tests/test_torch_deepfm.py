"""The port's embedding layers and DeepFM against the JAX package's, on the
CPU.

Weights come from the flax tree through ``utils/flax_weights.py`` (both
tables at their padded height, the deep tower's ``Dense_1`` hidden and
``Dense_0`` output layers); ids come from a numpy seed, with 0 (the
``mask_zero`` padding id) among them.

Tolerances: logits, probabilities, lookups and combines within 1e-5;
after one SGD step every parameter within 1e-5 in relative norm.  Ids
below 0 or past a table's rows give exactly zero vectors and exactly
zero gradient, and ``batch_parse`` refuses them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.layers import embedding as jax_embedding
from elasticdl_tpu.models import deepfm_edl_embedding as jax_edl
from elasticdl_tpu.models import deepfm_functional_api as jax_deepfm
from elasticdl_tpu.trainer import step as jax_step
from elasticdl_tpu.trainer.state import TrainState as JaxState
from elasticdl_tpu.trainer.state import init_model
from elasticdl_tpu.trainer.state import Modes as JaxModes
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu_torch.layers import embedding
from elasticdl_tpu_torch.models import deepfm_edl_embedding as port_edl
from elasticdl_tpu_torch.models import deepfm_functional_api as port_deepfm
from elasticdl_tpu_torch.trainer import step as port_step
from elasticdl_tpu_torch.trainer.state import Modes, TrainState
from elasticdl_tpu_torch.utils import flax_weights

TOL = 1e-5
SMALL = dict(input_dim=300, embedding_dim=8, input_length=10, fc_unit=16)
ROWS = 16


def _ids(rows=ROWS, vocab=SMALL["input_dim"], seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, (rows, 10))
    ids[:, -3:] = 0  # mask_zero padding
    return ids


def _models(seed=0, **kwargs):
    kwargs = {**SMALL, **kwargs}
    model = jax_deepfm.custom_model(**kwargs)
    params, _ = init_model(model, {"feature": np.zeros((1, 10), np.int32)}, rng_seed=seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    # the tables' rows start small and equal-signed (U[0, 0.05)); spread
    # them so that every term of the model shows in the logits
    rng = np.random.RandomState(seed + 1)
    for table in ("embedding", "id_bias"):
        shape = params[table]["embedding"].shape
        params[table]["embedding"] = rng.normal(0, 0.3, shape).astype(np.float32)
    port = port_deepfm.custom_model(**kwargs)
    port.load_state_dict(flax_weights.torch_state_from_flax(tree_utils.tree_to_dict(params), port))
    return model, params, port


def test_flax_weights_round_trip_at_the_padded_heights():
    _model, params, port = _models()
    flat = tree_utils.tree_to_dict(params)
    assert flat["embedding/embedding"].shape == (384, 8)
    assert flat["id_bias/embedding"].shape == (384, 1)
    assert flat["Dense_1/kernel"].shape == (80, 16) and flat["Dense_0/kernel"].shape == (16, 1)
    got = flax_weights.flax_flat_from_torch(port)
    assert set(got) == set(flat) and flax_weights.flax_state_from_torch(port) == {}
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_and_probs_match_jax(seed):
    model, params, port = _models(seed)
    ids = _ids(seed=seed)
    want = model.apply({"params": params}, {"feature": ids.astype(np.int16)})
    with torch.no_grad():
        got = port({"feature": torch.from_numpy(ids.astype(np.int16))})
    assert got["logits"].shape == (ROWS,) and got["probs"].shape == (ROWS, 1)
    for key in ("logits", "probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, rtol=0)
    assert np.abs(np.asarray(want["logits"])).max() > 0.1


def test_one_sgd_step_matches_jax():
    model, params, port = _models(2)
    ids = _ids(seed=2).astype(np.int16)
    labels = np.random.RandomState(7).randint(0, 2, ROWS).astype(np.int32)
    weights = np.array([1.0] * 12 + [0.0] * 4, np.float32)
    state = JaxState.create(model.apply, params, optax.sgd(0.1))
    jax_train = jax_step.build_train_step(jax_deepfm.loss, donate=False)
    new_state, jax_metrics = jax_train(
        state, {"feature": jnp.asarray(ids)}, jnp.asarray(labels), jnp.asarray(weights)
    )
    port_state = TrainState.create(port, port_deepfm.optimizer())
    _, port_metrics = port_step.build_train_step(port_deepfm.loss)(
        port_state, {"feature": torch.from_numpy(ids)}, torch.from_numpy(labels),
        torch.from_numpy(weights),
    )
    assert abs(float(port_metrics["loss"]) - float(jax_metrics["loss"])) < TOL
    want = tree_utils.tree_to_dict(new_state.params)
    got = flax_weights.flax_flat_from_torch(port)
    before = tree_utils.tree_to_dict(params)
    for name in want:
        w = np.asarray(want[name])
        assert np.linalg.norm(got[name] - w) / np.linalg.norm(w) < TOL, name
        assert not np.array_equal(w, before[name]), name  # every tensor moved


def _tables(rows=12, dim=4, seed=0):
    table = np.random.RandomState(seed).normal(size=(rows, dim)).astype(np.float32)
    return table, torch.tensor(table, requires_grad=True)


def test_embedding_lookup_masks_ids_out_of_range():
    table, t = _tables()
    ids = np.array([[0, 3, -1, 11], [12, 40, 5, -7]])
    want = np.asarray(jax_embedding.embedding_lookup(jnp.asarray(table), jnp.asarray(ids)))
    got = embedding.embedding_lookup(t, torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)
    out_of_range = (ids < 0) | (ids >= 12)
    assert (got.detach().numpy()[out_of_range] == 0).all()
    got.sum().backward()
    grad = t.grad.numpy()
    used = np.zeros(12)
    np.add.at(used, ids[~out_of_range], 1)
    # every row's gradient counts its in-range lookups exactly; the ids
    # past the table did not land on the last row, nor the negative ones
    # on row 0
    np.testing.assert_array_equal(grad, np.repeat(used[:, None], 4, axis=1))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_safe_embedding_lookup_sparse_matches_jax(combiner, weighted):
    table, t = _tables(seed=1)
    ids = np.array([[1, 2, embedding.PAD_ID], [11, 12, 3], [-1, -1, -1], [0, 0, 30]])
    w = np.random.RandomState(2).uniform(0.5, 2.0, ids.shape).astype(np.float32)
    want = np.asarray(jax_embedding.safe_embedding_lookup_sparse(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w) if weighted else None, combiner,
    ))
    got = embedding.safe_embedding_lookup_sparse(
        t, torch.from_numpy(ids), torch.from_numpy(w) if weighted else None, combiner,
    )
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)
    assert (got.detach().numpy()[2] == 0).all()  # no id in range: zeros
    got.sum().backward()
    # row 12 does not exist, 30 neither; no other row took their gradient
    touched = np.abs(t.grad.numpy()).sum(1) > 0
    np.testing.assert_array_equal(np.flatnonzero(touched), [0, 1, 2, 3, 11])
    with pytest.raises(ValueError, match="combiner"):
        embedding.safe_embedding_lookup_sparse(t, torch.from_numpy(ids), combiner="max")


def test_embedding_layers_pad_their_tables_and_check_their_input():
    layer = embedding.Embedding(5383, 4, vocab_pad_multiple=128)
    assert layer.padded_input_dim == 5504 and layer.embedding.shape == (5504, 4)
    # flax's uniform(0.05): every initial value in [0, 0.05)
    table = layer.embedding.detach()
    assert 0.0 <= float(table.min()) and float(table.max()) < 0.05
    # the mask bounds are the table's rows, padding included, as in JAX
    out = layer(np.array([[1, 5503, 5504, -1]], np.int16))
    assert out.shape == (1, 4, 4) and (out[0, 2:] == 0).all() and (out[0, :2] != 0).all()
    combined = embedding.Embedding(10, 4, combiner="sum")
    with pytest.raises(ValueError, match="max_ids"):
        combined(np.zeros((2, 3, 1), np.int64))
    sparse = embedding.SparseEmbedding(10, 4, combiner="mean", vocab_pad_multiple=8)
    assert sparse.embedding.shape == (16, 4)
    ids = np.array([[1, 2, -1]])
    np.testing.assert_allclose(
        sparse(ids).detach().numpy(),
        sparse.embedding.detach().numpy()[[1, 2]].mean(0, keepdims=True),
        atol=TOL,
    )
    with pytest.raises(ValueError, match="unknown embedding initializer"):
        embedding.Embedding(4, 2, embeddings_initializer="bogus")


def test_the_model_gives_out_of_vocab_ids_nothing():
    """An id at or past ``input_dim``'s padded table, or below 0, fed
    straight to the model (``batch_parse`` would refuse it): the model's
    output and gradients are those of the same rows with that id
    replaced by the padding id 0."""
    _model, _params, port = _models(3)
    ids = _ids(seed=3)
    bad = ids.copy()
    bad[0, 0], bad[1, 1], bad[2, 2] = 384, 10_000, -5
    clean = bad.copy()
    clean[0, 0] = clean[1, 1] = clean[2, 2] = 0
    grads = []
    for x in (bad, clean):
        port.zero_grad()
        out = port({"feature": torch.from_numpy(x)})
        out["logits"].sum().backward()
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()})
        grads[-1]["logits"] = out["logits"].detach()
    for name in grads[0]:
        torch.testing.assert_close(grads[0][name], grads[1][name], atol=0, rtol=0)


def test_batch_parse_checks_ids_and_narrows_the_wire():
    port_deepfm.custom_model(input_dim=5383)
    jax_deepfm.custom_model(input_dim=5383)
    batch = {"feature": _ids(vocab=5383, seed=4).astype(np.int64),
             "label": np.arange(ROWS, dtype=np.int64) % 2}
    got_f, got_l = port_deepfm.batch_parse(batch, Modes.TRAINING)
    want_f, want_l = jax_deepfm.batch_parse(batch, JaxModes.TRAINING)
    assert got_f["feature"].dtype == np.int16 and got_l.dtype == np.int32
    np.testing.assert_array_equal(got_f["feature"], want_f["feature"])
    np.testing.assert_array_equal(got_l, want_l)
    assert set(port_deepfm.batch_parse(batch, Modes.PREDICTION)) == {"feature"}
    for bad, match in ((-1, "negative feature id"), (40_000, "exceeds int16")):
        corrupt = {**batch, "feature": batch["feature"].copy()}
        corrupt["feature"][3, 4] = bad
        with pytest.raises(ValueError, match=match):
            port_deepfm.batch_parse(corrupt, Modes.TRAINING)
    try:
        # a vocabulary past int16 widens the wire, as in the JAX module
        port_deepfm.custom_model(input_dim=40_000, embedding_dim=2, fc_unit=2)
        wide, _ = port_deepfm.batch_parse(
            {**batch, "feature": np.full((2, 10), 39_999)}, Modes.TRAINING
        )
        assert wide["feature"].dtype == np.int32
    finally:
        port_deepfm.custom_model(input_dim=5383)


def test_the_edl_embedding_module_reexports_the_functional_model():
    assert port_edl.PADDED_VOCAB == jax_edl.PADDED_VOCAB == 5504
    for name in ("DeepFM", "batch_parse", "custom_data_reader", "custom_model",
                 "dataset_fn", "eval_metrics_fn", "loss", "optimizer"):
        assert getattr(port_edl, name) is getattr(port_deepfm, name)
    model = port_edl.custom_model()
    assert model.embedding.embedding.shape == (5504, 64)
    assert model.id_bias.embedding.shape == (5504, 1)
    reader = port_edl.custom_data_reader("/nowhere")
    assert hasattr(reader, "read_record_chunks")


# ---- the Local train CLI of both packages ---------------------------------

DEEPFM_DEF = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"
# 1024 frappe records over a vocabulary of 512 in 2 shards: with 256
# records a task and 64 rows a step (a multiple of the JAX test mesh's 8
# devices), 4 tasks and 16 steps; 256 validation records
LOCAL_STEPS = 16
WEIGHT_REL_TOL = 1e-4


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


@pytest.fixture(scope="module")
def local_runs(tmp_path_factory):
    from elasticdl_tpu.data import recordio as jax_recordio
    from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
    from elasticdl_tpu.trainer.state import state_to_checkpoint
    from elasticdl_tpu.utils import save_utils as jax_save
    from elasticdl_tpu_torch.data import fast_pipeline

    # the JAX package takes its vectorized path only with its codec built
    jax_recordio.ensure_native_codec()
    root = tmp_path_factory.mktemp("deepfm_local")
    data = {
        "train": jax_synthetic.gen_frappe(
            str(root / "train"), num_records=1024, num_shards=2, seed=0, vocab_size=512
        ),
        "eval": jax_synthetic.gen_frappe(
            str(root / "eval"), num_records=256, num_shards=1, seed=1, vocab_size=512
        ),
        "init": str(root / "init"),
    }
    model = jax_deepfm.custom_model(input_dim=512)
    params, _ = init_model(model, {"feature": np.zeros((1, 10), np.int32)}, rng_seed=3)
    jax_save.CheckpointSaver(data["init"]).save(
        0, state_to_checkpoint(JaxState.create(model.apply, params, optax.sgd(0.1))),
        extra={"model_version": 0},
    )
    argv = [
        "--model_def", DEEPFM_DEF, "--model_params", "input_dim=512",
        "--training_data", data["train"], "--validation_data", data["eval"],
        "--records_per_task", "256", "--minibatch_size", "64",
        "--num_epochs", "1", "--shuffle_seed", "0",
        "--checkpoint_dir_for_init", data["init"],
    ]
    out = {}
    for package in ("jax", "port"):
        fast_pipeline.reset_path_counts()
        executor, result, tasks = _local_run(package, argv)
        if package == "jax":
            flat = {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(executor.state.params).items()}
        else:
            flat = flax_weights.flax_flat_from_torch(executor.state.model)
        out[package] = dict(
            result=result, tasks=tasks, step=int(executor.trainer.step), flat=flat,
            paths=dict(fast_pipeline.path_counts),
        )
    return out


def test_local_runs_train_the_same_tasks_and_records_to_the_same_weights(local_runs):
    jax_run, port_run = local_runs["jax"], local_runs["port"]
    assert port_run["tasks"] == jax_run["tasks"]
    assert sorted(port_run["tasks"]) == [
        ("frappe-000.edlio", 0, 256), ("frappe-000.edlio", 256, 512),
        ("frappe-001.edlio", 0, 256), ("frappe-001.edlio", 256, 512),
    ]
    assert port_run["step"] == jax_run["step"] == LOCAL_STEPS
    # the training batches and the evaluation's 4 took the vectorized path
    assert port_run["paths"] == {"vectorized": LOCAL_STEPS + 4, "classic": 0}
    assert set(port_run["flat"]) == set(jax_run["flat"])
    for name, want in jax_run["flat"].items():
        got = port_run["flat"][name]
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < WEIGHT_REL_TOL, name


def test_local_runs_evaluate_alike(local_runs):
    got, want = local_runs["port"]["result"], local_runs["jax"]["result"]
    assert set(got) == set(want) == {"accuracy_logits", "auc_probs", "loss"}
    assert abs(got["loss"] - want["loss"]) < WEIGHT_REL_TOL
    assert abs(got["auc_probs"] - want["auc_probs"]) < WEIGHT_REL_TOL
    assert abs(got["accuracy_logits"] - want["accuracy_logits"]) <= 1 / 256 + 1e-9


def test_smoke_phase8_rehearsal_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s DeepFM phase at a small size: every check of
    the phase runs, the out-of-vocab one included (its accuracy bar
    lowered for 16 steps)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    accuracy = dict(
        chip_smoke.DEEPFM_ACCURACY, train_records=2048, eval_records=512,
        batch=128, records_per_task=512, checkpoint_steps=5, min_accuracy=0.1,
    )
    wide = dict(chip_smoke.DEEPFM_WIDE, train_records=4096, batch=256, records_per_task=512)
    row = chip_smoke.train_deepfm(str(tmp_path), "cpu", accuracy, wide)
    assert row["checked"]["steps"] == 16 and row["checked"]["wire"] == "int16 on cpu"
    assert row["timed"]["steady_steps"] == 14
    assert row["out_of_vocab"] == {
        "oov_ids": 4, "zero_lookup_rows": True,
        "table_grad_is_in_range_counts": True, "model_same_as_padding_id": True,
    }
