"""``--steps_per_dispatch k|auto`` and ``--remat`` in the port, on the CPU.

- The ``auto`` sizing rule and ``choose_stack_k`` pinned to the JAX
  package's values (``tests/test_stacking_auto.py``).
- k steps in one dispatch are k single steps: the trainer's stacked
  groups (eager on the CPU) and the Local executor's k = 4 runs equal
  its k = 1 runs bit for bit, with full groups, a masked tail, ready-made
  ``PreStacked`` groups and trailing singles.
- A stacked Local run of the LM (dropout 0) and of DeepFM against the
  JAX package's run with the same flags, at the tolerances of
  ``tests/test_torch_local.py`` (1e-4, and 2·lr·steps for the LM's key
  biases, whose exact gradient is 0) and ``tests/test_torch_deepfm.py``
  (1e-4 in relative norm).
- ``--remat`` (the whole forward and loss under
  ``torch.utils.checkpoint``, as the JAX package wraps its whole
  ``forward_loss`` in ``jax.checkpoint``): the same gradients and
  BatchNorm statistics as without it, bit for bit in the port, and
  against the JAX step's ``remat=True`` at ``tests/test_torch_mnist.py``'s
  tolerances (1e-5 relative norm, statistics 1e-6).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.data import recordio as jax_recordio
from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
from elasticdl_tpu.models import deepfm_functional_api as jax_deepfm
from elasticdl_tpu.models import long_seq_transformer as jax_lm
from elasticdl_tpu.models import mnist_functional_api as jax_mnist
from elasticdl_tpu.trainer import local_executor as jax_le
from elasticdl_tpu.trainer import step as jax_step
from elasticdl_tpu.trainer.state import TrainState as JaxState
from elasticdl_tpu.trainer.state import init_model, state_to_checkpoint
from elasticdl_tpu.utils import save_utils as jax_save
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu.utils.args import parse_master_args as jax_parse
from elasticdl_tpu_torch.models import mnist_functional_api as port_mnist
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
from elasticdl_tpu_torch.trainer import local_executor as port_le
from elasticdl_tpu_torch.trainer import stacking
from elasticdl_tpu_torch.trainer import step as port_step
from elasticdl_tpu_torch.trainer.state import LRSchedule, TrainState, make_capturable
from elasticdl_tpu_torch.utils import flax_weights
from elasticdl_tpu_torch.utils.args import parse_master_args as port_parse

LM_TOL = 1e-4
LM_LR = 3e-3  # the zoo's Adam
DEEPFM_REL_TOL = 1e-4
STEP_REL_TOL = 1e-5
STATS_TOL = 1e-6
LM_DEF = "long_seq_transformer.long_seq_transformer.custom_model"
LM_KW = dict(vocab_size=256, embed_dim=32, num_heads=2, num_layers=2)
SEQ = 64
MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
DEEPFM_DEF = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"


# ---- the `auto` sizing rule --------------------------------------------------


def test_auto_k_pins_the_sizing_rule():
    """The JAX package's rule, as it is: a 7 MB transfer target sizes
    the group on an expensive link (130 ms a dispatch), MAX_AUTO_K caps
    it, and a cheap dispatch gives k = 1 on any batch."""
    mnist_bytes = 256 * 28 * 28 * 4 + 256 * 4  # f32 images + i32 labels
    assert stacking.auto_steps_per_dispatch(mnist_bytes, 0.13) == 9
    mnist_u8 = 256 * 28 * 28 + 256 * 4  # the uint8 wire
    assert stacking.auto_steps_per_dispatch(mnist_u8, 0.13) == 36
    deepfm_bytes = 4096 * 10 * 2 + 4096 * 4  # int16 ids
    assert stacking.auto_steps_per_dispatch(deepfm_bytes, 0.13) == stacking.MAX_AUTO_K
    assert stacking.auto_steps_per_dispatch(mnist_bytes, 0.0005) == 1
    assert stacking.auto_steps_per_dispatch(0, 0.13) == 1
    assert stacking.auto_steps_per_dispatch(stacking.TRANSFER_CLIFF_BYTES * 2, 0.13) == 1


def test_choose_stack_k_shared_rule():
    assert stacking.choose_stack_k(4, training=True) == 4
    assert stacking.choose_stack_k("auto", training=True) == "auto"
    assert stacking.choose_stack_k("auto", True, allow_auto=False) is None
    assert stacking.choose_stack_k(4, training=False) is None
    assert stacking.choose_stack_k(1, training=True) is None
    assert stacking.choose_stack_k(None, training=True) is None
    assert stacking.choose_stack_k(0, training=True) is None


def test_resolve_explicit_k_passthrough():
    assert stacking.resolve_steps_per_dispatch(4) == 4
    assert stacking.resolve_steps_per_dispatch(None) == 1
    assert stacking.resolve_steps_per_dispatch(0) == 1


def test_resolve_auto_uses_batch_bytes(monkeypatch):
    feats = {"image": np.zeros((256, 28, 28), np.float32)}
    labels = np.zeros(256, np.int32)
    monkeypatch.setattr(stacking, "_DISPATCH_OVERHEAD", {"cpu": 0.13})
    assert stacking.resolve_steps_per_dispatch("auto", (feats, labels), device="cpu") == 9
    # bytes alone, as if the dispatch were expensive
    monkeypatch.setattr(stacking, "_DISPATCH_OVERHEAD", {"cpu": 0.0001})
    assert stacking.resolve_steps_per_dispatch("auto", (feats, labels), device="cpu") == 1
    assert stacking.resolve_steps_per_dispatch(
        "auto", (feats, labels), deterministic=True, device="cpu"
    ) == 9


def test_probe_measures_once_per_device(monkeypatch):
    monkeypatch.setattr(stacking, "_DISPATCH_OVERHEAD", {})
    thread = stacking.warm_dispatch_overhead_async("cpu")
    thread.join(timeout=30)
    assert not thread.is_alive()
    first = stacking.measured_dispatch_overhead("cpu")
    assert 0 < first < float("inf")
    assert stacking.measured_dispatch_overhead("cpu") == first  # cached
    assert stacking.warm_dispatch_overhead_async("cpu") is None


class _FakeTrainer:
    """Records what the grouping loop dispatches; placement is identity."""

    device = torch.device("cpu")

    def __init__(self):
        self.stacked, self.singles = [], 0

    def pad_to(self, tree, rows):
        return tree

    def row_mask(self, n, rows):
        return np.ones(rows, np.float32)

    def place_batch(self, tree):
        return tree

    def place_group(self, *trees):
        return trees

    def place_step(self, *trees):
        return trees

    def train_step(self, f, l, w=None):
        self.singles += 1

    def train_steps_stacked(self, f, l, w):
        self.stacked.append(f["x"].shape[0])


def test_run_stacked_steps_resolves_auto(monkeypatch):
    """``auto`` flows through the grouping loop: on an expensive link the
    first batch's bytes (about 1 MB) pick k = 6."""
    monkeypatch.setattr(stacking, "_DISPATCH_OVERHEAD", {"cpu": 0.13})
    batch = ({"x": np.zeros((256, 1024), np.float32)}, np.zeros(256))
    trainer = _FakeTrainer()
    n = stacking.run_stacked_steps(
        lambda: trainer, iter([batch] * 26), "auto", canonical_rows=256
    )
    assert n == 26 * 256
    # four full groups, then a trailing partial of 2 as single steps
    assert trainer.stacked == [6, 6, 6, 6] and trainer.singles == 2


def test_run_stacked_steps_needs_the_canonical_rows():
    with pytest.raises(TypeError, match="canonical_rows"):
        stacking.run_stacked_steps(lambda: None, iter([]), 2)


# ---- k steps in one dispatch are k single steps ------------------------------


def _mnist_trainer(remat=False):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = port_mnist.custom_model()
    return SPMDTrainer(
        model, port_mnist.loss, port_mnist.optimizer(), device="cpu",
        device_parse=port_mnist.device_parse, remat=remat,
    )


def _mnist_batches(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [
        ({"image": rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)},
         rng.randint(0, 10, n).astype(np.int32))
        for n in sizes
    ]


def _trainer_state(trainer):
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
    rows = sum(len(l) for _f, l in batches)
    return stacking.PreStacked(feats, labels, rows, {"image": feats["image"][0]})


# (the stream's batch sizes, how many of its first batches arrive as one
# ready-made group, the groups of 4): a full group with a masked tail
# then trailing singles; a PreStacked group, a plain group and a
# trailing single
STREAMS = {
    "masked_tail_and_singles": ([8, 8, 8, 5, 8, 8, 3], 0, 1),
    "prestacked_then_plain": ([8, 8, 8, 8, 8, 8, 8, 8, 5], 4, 2),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_stacked_groups_equal_single_steps_bit_for_bit(stream):
    """mnist's dropout (drawn per step) and BatchNorm statistics
    included: a group of k on the trainer is k single steps."""
    sizes, pre, groups = STREAMS[stream]
    batches = _mnist_batches(sizes)
    single = _mnist_trainer()
    n1 = stacking.run_stacked_steps(lambda: single, iter(batches), 1, canonical_rows=8)
    stacked = _mnist_trainer()
    items = ([_prestacked(batches[:pre])] if pre else []) + batches[pre:]
    n4 = stacking.run_stacked_steps(lambda: stacked, iter(items), 4, canonical_rows=8)
    assert n1 == n4 == sum(sizes)
    assert single.step == stacked.step == len(sizes)
    assert single.dispatch_counts["single_steps"] == len(sizes)
    assert stacked.dispatch_counts["eager_groups"] == groups
    assert stacked.dispatch_counts["single_steps"] == len(sizes) - 4 * groups
    assert stacked.dispatch_counts["graph_replays"] == 0  # the CPU has none
    _assert_bitwise(_trainer_state(stacked), _trainer_state(single))


def _recording(module, log):
    class Recording(module.TaskDispatcher):
        def get(self, worker_id):
            tid, task = super().get(worker_id)
            if task is not None:
                log.append((os.path.basename(task.shard_name), task.start, task.end))
            return tid, task

    return Recording


def _local_run(package, argv):
    """``(executor, tasks handed out)`` of one Local train job of
    ``package`` (the port's on ``--device cpu``)."""
    module, parse = (jax_le, jax_parse) if package == "jax" else (port_le, port_parse)
    if package == "port":
        argv = argv + ["--device", "cpu"]
    tasks: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "TaskDispatcher", _recording(module, tasks))
        executor = module.LocalExecutor(parse(argv))
        executor.run()
    return executor, tasks


def _jax_flat(executor):
    return {
        k: np.asarray(v)
        for k, v in tree_utils.tree_to_dict(executor.state.params).items()
    }


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The LM's, mnist's and DeepFM's shards, and JAX warm-start
    checkpoints of the LM and DeepFM.  LM: 2 shards of 44 records, tasks
    of 28 and 16 records in batches of 8 (8, 8, 8, 4 and 8, 8): at k = 4
    a full group with a masked tail, then two trailing singles."""
    jax_recordio.ensure_native_codec()  # the JAX side's vectorized path
    root = tmp_path_factory.mktemp("stacking")
    out = {
        "lm": jax_synthetic.gen_sequence(
            str(root / "lm"), num_records=88, num_shards=2, seed=0,
            seq_len=SEQ, vocab=LM_KW["vocab_size"],
        ),
        "mnist": jax_synthetic.gen_mnist(
            str(root / "mnist"), num_records=200, num_shards=2, seed=0
        ),
        "deepfm": jax_synthetic.gen_frappe(
            str(root / "deepfm"), num_records=1024, num_shards=2, seed=0,
            vocab_size=512,
        ),
    }
    model = jax_lm.custom_model(**LM_KW)
    params, _ = init_model(model, {"tokens": np.zeros((1, SEQ), np.int32)}, rng_seed=3)
    out["lm_init"] = str(root / "lm_init")
    jax_save.CheckpointSaver(out["lm_init"]).save(
        0, state_to_checkpoint(JaxState.create(model.apply, params, optax.adam(LM_LR))),
        extra={"model_version": 0},
    )
    model = jax_deepfm.custom_model(input_dim=512)
    params, _ = init_model(model, {"feature": np.zeros((1, 10), np.int32)}, rng_seed=3)
    out["deepfm_init"] = str(root / "deepfm_init")
    jax_save.CheckpointSaver(out["deepfm_init"]).save(
        0, state_to_checkpoint(JaxState.create(model.apply, params, optax.sgd(0.1))),
        extra={"model_version": 0},
    )
    return out


def _lm_argv(data, *extra):
    return [
        "--model_def", LM_DEF,
        "--model_params", ";".join(f"{k}={v}" for k, v in LM_KW.items()),
        "--training_data", data["lm"], "--records_per_task", "28",
        "--minibatch_size", "8", "--num_epochs", "1", "--shuffle_seed", "0",
        "--compute_dtype", "float32", "--checkpoint_dir_for_init", data["lm_init"],
        *extra,
    ]


def _mnist_argv(data, *extra):
    # 2 shards of 100 records in tasks of 64 and 36, 16 rows a step: a
    # PreStacked group of 4, then one of 2 and a masked single
    return [
        "--model_def", MNIST_DEF, "--training_data", data["mnist"],
        "--records_per_task", "64", "--minibatch_size", "16",
        "--num_epochs", "1", "--shuffle_seed", "0", *extra,
    ]


def _deepfm_argv(data, *extra):
    # 4 tasks of 256 records, 64 rows a step: one PreStacked group each
    return [
        "--model_def", DEEPFM_DEF, "--model_params", "input_dim=512",
        "--training_data", data["deepfm"], "--records_per_task", "256",
        "--minibatch_size", "64", "--num_epochs", "1", "--shuffle_seed", "0",
        "--checkpoint_dir_for_init", data["deepfm_init"], *extra,
    ]


@pytest.fixture(scope="module")
def lm_runs(data):
    return {
        (package, k): _local_run(package, _lm_argv(data, "--steps_per_dispatch", k))
        for package, k in (("port", "1"), ("port", "4"), ("jax", "4"))
    }


def test_lm_k4_run_equals_its_k1_run_bit_for_bit(lm_runs):
    (one, tasks1), (four, tasks4) = lm_runs["port", "1"], lm_runs["port", "4"]
    assert tasks1 == tasks4 and sorted(t[1:] for t in tasks4) == [
        (0, 28), (0, 28), (28, 44), (28, 44),
    ]
    assert one.trainer.step == four.trainer.step == 12
    assert four.trainer.dispatch_counts == {
        "single_steps": 4, "eager_groups": 2, "graph_captures": 0, "graph_replays": 0,
    }
    _assert_bitwise(_trainer_state(four.trainer), _trainer_state(one.trainer))


def test_lm_k4_run_matches_jax_k4_run(lm_runs):
    (port, port_tasks), (jax_run, jax_tasks) = lm_runs["port", "4"], lm_runs["jax", "4"]
    assert port_tasks == jax_tasks
    assert port.trainer.step == int(jax_run.trainer.step) == 12
    got, want = flax_weights.flax_flat_from_torch(port.state.model), _jax_flat(jax_run)
    assert set(got) == set(want)
    for name in want:
        off = np.abs(got[name] - want[name]) > LM_TOL + LM_TOL * np.abs(want[name])
        if off.any():
            assert name.endswith("attn/key/bias"), name
            assert np.abs(got[name] - want[name]).max() <= 2 * LM_LR * 12, name


def test_mnist_k4_run_equals_its_k1_run_bit_for_bit(data):
    """The vectorized pipeline's PreStacked groups (of 4, and of the 2
    full batches a 36-record task holds) and a masked single."""
    (one, tasks1) = _local_run("port", _mnist_argv(data))
    (four, tasks4) = _local_run("port", _mnist_argv(data, "--steps_per_dispatch", "4"))
    assert tasks1 == tasks4 and one.trainer.step == four.trainer.step == 14
    assert four.trainer.dispatch_counts["eager_groups"] == 4
    assert four.trainer.dispatch_counts["single_steps"] == 2
    _assert_bitwise(_trainer_state(four.trainer), _trainer_state(one.trainer))


def test_deepfm_k4_run_matches_jax_k4_run(data):
    port, port_tasks = _local_run("port", _deepfm_argv(data, "--steps_per_dispatch", "4"))
    jax_run, jax_tasks = _local_run("jax", _deepfm_argv(data, "--steps_per_dispatch", "4"))
    assert port_tasks == jax_tasks and port.trainer.step == int(jax_run.trainer.step) == 16
    assert port.trainer.dispatch_counts["eager_groups"] == 4
    got, want = flax_weights.flax_flat_from_torch(port.state.model), _jax_flat(jax_run)
    assert set(got) == set(want)
    for name, w in want.items():
        assert np.linalg.norm(got[name] - w) / np.linalg.norm(w) < DEEPFM_REL_TOL, name


# ---- --remat -------------------------------------------------------------------


def _grads_and_stats(trainer, features, labels, weights):
    """One step's gradients (``.grad`` after the step) and the running
    statistics it left."""
    trainer.train_step(
        trainer.place_batch(features), trainer.place_batch(labels),
        trainer.place_batch(weights),
    )
    model = trainer.state.model
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return grads, flax_weights.flax_state_from_torch(model)


def test_remat_gives_the_same_gradients_and_statistics():
    """Trap (d): the recompute moves BatchNorm's running statistics no
    second time, and draws the same dropout mask."""
    (features, labels), = _mnist_batches([8], seed=3)
    weights = np.array([1] * 6 + [0] * 2, np.float32)
    plain = _grads_and_stats(_mnist_trainer(), features, labels, weights)
    remat = _grads_and_stats(_mnist_trainer(remat=True), features, labels, weights)
    for name in plain[0]:
        torch.testing.assert_close(remat[0][name], plain[0][name], atol=0, rtol=0)
    _assert_bitwise(remat[1], plain[1])
    # the statistics moved once: a second move would take them further
    twice = _mnist_trainer()
    twice.state.model.train()
    with torch.no_grad():
        for _ in range(2):
            twice.state.model(
                port_mnist.device_parse({"image": torch.from_numpy(features["image"])}),
                training=True, generator=torch.Generator().manual_seed(0),
            )
    moved_twice = flax_weights.flax_state_from_torch(twice.state.model)
    assert not np.allclose(moved_twice["batch_stats/BatchNorm_0/mean"],
                           remat[1]["batch_stats/BatchNorm_0/mean"])


def test_remat_step_matches_the_jax_remat_step(monkeypatch):
    """The port's ``remat`` step against the JAX step's ``remat=True``
    from the same weights, the port's dropout fed the JAX step's mask
    (as ``tests/test_torch_mnist.py`` feeds it).  As there, BatchNorm's
    scale, bias and statistics start off their initial values: at scale 1
    and bias 0 the ReLU zeros tie inside max-pool windows, where the two
    frameworks route the bias gradient differently, with or without
    remat."""
    import flax.linen as nn
    import jax

    model = jax_mnist.custom_model()
    params, _ = init_model(model, {"image": np.zeros((1, 28, 28), np.float32)}, rng_seed=0)
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["BatchNorm_0"] = {
        "scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
        "bias": rng.normal(0, 0.1, 64).astype(np.float32),
    }
    stats = {"batch_stats": {"BatchNorm_0": {
        "mean": rng.normal(0, 0.1, 64).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, 64).astype(np.float32),
    }}}
    (features, labels), = _mnist_batches([8], seed=5)
    images = features["image"]
    weights = np.array([1] * 7 + [0], np.float32)
    variables = {"params": params, **stats}
    _out, captured = model.apply(
        variables, jax_mnist.device_parse({"image": jnp.asarray(images)}), training=True,
        rngs={"dropout": jax.random.fold_in(jax.random.PRNGKey(0), 0)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _name: isinstance(mdl, nn.Dropout),
    )
    keep = torch.from_numpy(
        np.asarray(captured["intermediates"]["Dropout_0"]["__call__"][0]) != 0
    )
    monkeypatch.setattr(
        port_mnist, "dropout",
        lambda x, rate, gen: x if gen is None else torch.where(keep, x / (1 - rate), torch.zeros_like(x)),
    )
    state = JaxState.create(model.apply, params, optax.sgd(0.1), stats)
    jax_train = jax_step.build_train_step(
        jax_mnist.loss, device_parse=jax_mnist.device_parse, donate=False, remat=True
    )
    new_state, _ = jax_train(
        state, {"image": jnp.asarray(images)}, jnp.asarray(labels), jnp.asarray(weights)
    )
    port = port_mnist.custom_model()
    port.load_state_dict(flax_weights.torch_state_from_flax(
        tree_utils.tree_to_dict(params), port, tree_utils.tree_to_dict(stats)
    ))
    port_state = TrainState.create(port, port_mnist.optimizer())
    port_train = port_step.build_train_step(
        port_mnist.loss, device_parse=port_mnist.device_parse, remat=True
    )
    port_train(port_state, {"image": torch.from_numpy(images)}, torch.from_numpy(labels),
               torch.from_numpy(weights))
    got = flax_weights.flax_flat_from_torch(port)
    want = {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.params).items()}
    for name in want:
        rel = np.linalg.norm(got[name] - want[name]) / max(np.linalg.norm(want[name]), 1e-30)
        assert rel < STEP_REL_TOL, name
    got_stats = flax_weights.flax_state_from_torch(port)
    want_stats = {
        k: np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.model_state).items()
    }
    for name in want_stats:
        np.testing.assert_allclose(got_stats[name], want_stats[name], atol=STATS_TOL, rtol=0)


def test_lm_remat_run_matches_jax_remat_run(data):
    port, port_tasks = _local_run("port", _lm_argv(data, "--remat", "true"))
    jax_run, jax_tasks = _local_run("jax", _lm_argv(data, "--remat", "true"))
    assert port_tasks == jax_tasks and port.trainer.step == int(jax_run.trainer.step)
    got, want = flax_weights.flax_flat_from_torch(port.state.model), _jax_flat(jax_run)
    for name in want:
        off = np.abs(got[name] - want[name]) > LM_TOL + LM_TOL * np.abs(want[name])
        if off.any():
            assert name.endswith("attn/key/bias"), name
            assert np.abs(got[name] - want[name]).max() <= 2 * LM_LR * 12, name


# ---- an optimizer a graph can replay -------------------------------------------


def test_lr_schedule_feeds_a_capture_and_counts_updates():
    schedule = LRSchedule(lambda count: 0.1 / (1 + count))
    param = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([param], lr=1.0)
    opt.register_step_pre_hook(schedule)
    param.grad = torch.ones(1)
    opt.step()
    assert opt.param_groups[0]["lr"] == 0.1 and schedule.updates == 1
    assert schedule.values(3) == [0.1 / 2, 0.1 / 3, 0.1 / 4]
    # a tensor lr is filled in place, and a capture's updates read the feed
    opt.param_groups[0]["lr"] = lr = torch.tensor(0.0)
    opt.step()
    assert float(lr) == pytest.approx(0.05) and opt.param_groups[0]["lr"] is lr
    feed = torch.tensor([7.0, 8.0])
    with schedule.feeding(feed):
        opt.step()
        assert float(lr) == 7.0
        opt.step()
        assert float(lr) == 8.0
    assert schedule.updates == 2  # a capture runs no update


def test_make_capturable_keeps_a_scheduled_lr_on_the_device():
    param = torch.nn.Parameter(torch.zeros(1))
    adam = torch.optim.Adam([param], lr=3e-3)
    adam.lr_schedule = LRSchedule(lambda count: 1e-3)
    assert make_capturable(adam, "cpu") is True
    group = adam.param_groups[0]
    assert group["capturable"] is True and isinstance(group["lr"], torch.Tensor)
    sgd = torch.optim.SGD([param], lr=0.1)
    assert make_capturable(sgd, "cpu") is True  # a constant lr is fine
    sgd.lr_schedule = LRSchedule(lambda count: 0.1)
    assert make_capturable(sgd, "cpu") is False  # SGD reads it on the host
