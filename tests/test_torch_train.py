"""The port's training path (``elasticdl_tpu_torch``: the LM's training
forward, ``trainer/state.py``, ``trainer/step.py``,
``parallel/distributed.py``) against the JAX package's, on the CPU.

The weights are drawn from a numpy seed and carried to both sides by
``utils.flax_weights``; the batches are numpy too.  The LM is small: 2
layers, width 32, 2 heads, sequence 64, f32.  Its attention runs the
JAX package's Pallas kernels in interpret mode on one side and the
plain versions of the port's kernels (forward and backward) on the
other.  Loss and gradients are held to 1e-4, the JAX package's own
gradient tolerance (``tests/test_attention.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.models import long_seq_transformer as jax_lm
from elasticdl_tpu.parallel.distributed import SPMDTrainer as JaxTrainer
from elasticdl_tpu.parallel.distributed import trim_pad as jax_trim_pad
from elasticdl_tpu.parallel.mesh import MeshConfig
from elasticdl_tpu.trainer import metrics as jax_metrics
from elasticdl_tpu.trainer import state as jax_state
from elasticdl_tpu.trainer import step as jax_step
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu_torch.layers import attention as port_layers
from elasticdl_tpu_torch.models import long_seq_transformer as port_lm
from elasticdl_tpu_torch.ops import attention as port_attn
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer, trim_pad
from elasticdl_tpu_torch.trainer import metrics as port_metrics
from elasticdl_tpu_torch.trainer import state as port_state
from elasticdl_tpu_torch.trainer import step as port_step
from elasticdl_tpu_torch.utils import flax_weights

TOL = 1e-4
SEQ = 64
LM_KW = dict(vocab_size=97, embed_dim=32, num_heads=2, num_layers=2)
LR = 1e-3
WEIGHTS = np.array([1.0, 1.0, 0.0], np.float32)


@pytest.fixture(autouse=True)
def _full_f32_products():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _batch(rows=3, seed=1, vocab=LM_KW["vocab_size"]):
    tokens = np.random.RandomState(seed).randint(0, vocab, (rows, SEQ + 1))
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens[:, :-1]}, tokens[:, 1:]


def _random_flat(fm, seed=7):
    """Flat flax parameters of ``fm``, every leaf from a numpy seed."""
    sample = {"tokens": jnp.asarray(_batch(rows=1)[0]["tokens"])}
    like = fm.init(jax.random.PRNGKey(0), sample)["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for name, leaf in tree_utils.tree_to_dict(like).items():
        value = rng.randn(*leaf.shape).astype(np.float32)
        if name.endswith("/scale"):
            value = 1.0 + 0.1 * value
        elif name.endswith("/bias"):
            value = 0.1 * value
        elif name.endswith("/embedding"):
            value = 0.5 * value
        else:  # kernels: N(0, 1/fan_in)
            value = value / np.sqrt(leaf.shape[0])
        flat[name] = value.astype(np.float32)
    return flat, like


def _pair(seed=7, **overrides):
    """(flax module, flax params, port model) with the same weights."""
    kw = dict(LM_KW, **overrides)
    fm = jax_lm.custom_model(**kw)
    flat, like = _random_flat(fm, seed)
    pm = port_lm.custom_model(**kw)
    pm.load_state_dict(flax_weights.torch_state_from_flax(flat, pm))
    return fm, tree_utils.dict_to_tree(flat, like), pm


def _port_trainer(pm, lr=LR):
    return SPMDTrainer(pm, port_lm.loss, port_lm.optimizer(lr), device="cpu")


def _jax_grads(fm, params, feats, labels, weights):
    def loss(p):
        logits = fm.apply({"params": p}, feats, training=True)
        return jax_step.weighted_mean_loss(jax_lm.loss, labels, logits, weights)

    value, grads = jax.value_and_grad(loss)(params)
    return float(value), tree_utils.tree_to_dict(grads)


def _port_grads(pm):
    """The gradients the last step applied, in flax names and layouts."""
    grads = {n: p.grad for n, p in pm.named_parameters()}
    clone = port_lm.custom_model(**LM_KW)
    clone.load_state_dict(grads)
    return flax_weights.flax_flat_from_torch(clone)


def _assert_flat_close(got, want, atol, rtol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(
            got[name], np.asarray(want[name]), atol=atol, rtol=rtol, err_msg=name
        )


def test_one_train_step_matches_jax_loss_and_gradients():
    fm, params, pm = _pair()
    feats, labels = _batch()
    want_loss, want_grads = _jax_grads(fm, params, feats, labels, WEIGHTS)

    step_fn = jax_step.build_train_step(jax_lm.loss, donate=False)
    jstate = jax_state.TrainState.create(fm.apply, params, optax.adam(LR))
    jstate, jmetrics = step_fn(jstate, feats, labels, WEIGHTS)

    trainer = _port_trainer(pm)
    port_attn.reset_launch_counts()
    metrics = trainer.train_step(
        trainer.place_batch(feats), trainer.place_batch(labels),
        trainer.place_batch(WEIGHTS),
    )
    assert set(port_attn.launch_counts.values()) == {0}  # CPU: plain path
    assert trainer.step == 1 and int(jstate.step) == 1
    assert abs(float(metrics["loss"]) - want_loss) < TOL
    assert abs(float(jmetrics["loss"]) - want_loss) < TOL
    _assert_flat_close(_port_grads(pm), want_grads, TOL, TOL)


def test_three_adam_steps_match_jax():
    """Losses and parameters at 1e-4 over 3 Adam steps, except where the
    gradient is rounding noise.  Adam moves an element by about lr
    wherever |g| >> eps (1e-8), whatever |g| is, so a gradient that is
    zero in exact arithmetic but ~1e-9 in floats (the key biases: a key
    bias adds the same q.b to every score of a row, which softmax
    ignores) moves its element by up to lr per step in either direction,
    differently in the two frameworks.  Those elements (|g| < 1e-7 at
    the first step, far below the 1e-4 gradient tolerance) are held to
    2 * lr * steps instead, and only key biases may need that."""
    fm, params, pm = _pair()
    feats, labels = _batch()
    _loss, first_grads = _jax_grads(fm, params, feats, labels, WEIGHTS)
    step_fn = jax_step.build_train_step(jax_lm.loss, donate=False)
    jstate = jax_state.TrainState.create(fm.apply, params, optax.adam(LR))
    trainer = _port_trainer(pm)
    steps = 3
    for i in range(steps):
        jstate, jm = step_fn(jstate, feats, labels, WEIGHTS)
        pm_loss = trainer.train_step(
            trainer.place_batch(feats), trainer.place_batch(labels),
            trainer.place_batch(WEIGHTS),
        )["loss"]
        assert abs(float(pm_loss) - float(jm["loss"])) < TOL, i
    want = tree_utils.tree_to_dict(jstate.params)
    got = flax_weights.flax_flat_from_torch(pm)
    for name in want:
        w = np.asarray(want[name])
        off = np.abs(got[name] - w) > TOL + TOL * np.abs(w)
        if off.any():
            assert name.endswith("attn/key/bias"), name
            assert (np.abs(first_grads[name][off]) < 1e-7).all(), name
            assert np.abs(got[name] - w).max() <= 2 * LR * steps, name


def test_zero_weight_row_gives_exactly_zero_gradient():
    _fm, _params, pm = _pair()
    feats, labels = _batch(rows=3)
    trainer = _port_trainer(pm)
    state = trainer.state

    def grads(tokens, labs, weights):
        outputs = pm({"tokens": torch.from_numpy(tokens)}, training=True)
        outputs.retain_grad()
        loss = port_step.weighted_mean_loss(
            port_lm.loss, torch.from_numpy(labs), outputs,
            torch.from_numpy(weights),
        )
        loss.backward()
        out = {n: p.grad.clone() for n, p in pm.named_parameters()}
        state.optimizer.zero_grad(set_to_none=True)
        return loss, out, outputs.grad

    loss, padded, out_grad = grads(feats["tokens"], labels, WEIGHTS)
    assert torch.count_nonzero(out_grad[2]) == 0
    # other contents in the padding row: bit-identical gradients
    other = feats["tokens"].copy()
    other[2] = (other[2] + 5) % LM_KW["vocab_size"]
    _loss2, padded2, _ = grads(other, labels, WEIGHTS)
    for name in padded:
        assert torch.equal(padded[name], padded2[name]), name
    # the real rows alone: the same gradients up to summation order
    real_loss, real, _ = grads(feats["tokens"][:2], labels[:2], WEIGHTS[:2])
    assert abs(loss.item() - real_loss.item()) < 1e-6
    for name in padded:
        torch.testing.assert_close(padded[name], real[name], atol=1e-6, rtol=1e-5)


def test_weighted_mean_loss_matches_jax_and_plain_mean():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, (4, 5)).astype(np.int32)
    weights = np.array([1, 0, 1, 1], np.float32)
    want = float(jax_step.weighted_mean_loss(jax_lm.loss, labels, logits, weights))
    got = float(port_step.weighted_mean_loss(
        port_lm.loss, torch.from_numpy(labels), torch.from_numpy(logits),
        torch.from_numpy(weights),
    ))
    assert abs(got - want) < 1e-6
    ones = port_step.weighted_mean_loss(
        port_lm.loss, torch.from_numpy(labels), torch.from_numpy(logits),
        torch.ones(4),
    )
    plain = port_lm.loss(torch.from_numpy(labels), torch.from_numpy(logits))
    assert abs(float(ones) - float(plain)) < 1e-6


def test_eval_and_predict_steps_match_jax():
    fm, params, pm = _pair()
    feats, labels = _batch()
    jstate = jax_state.TrainState.create(fm.apply, params, optax.adam(LR))
    j_out, j_loss = jax_step.build_eval_step(jax_lm.loss)(
        jstate, feats, labels, WEIGHTS
    )
    trainer = _port_trainer(pm)
    place = trainer.place_batch
    out, loss = trainer.eval_step(place(feats), place(labels), place(WEIGHTS))
    assert abs(float(loss) - float(j_loss)) < TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)
    pred = trainer.predict_step(place(feats))
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)


def test_batch_shaping_matches_spmd_trainer_on_one_device():
    fm, _params, pm = _pair()
    feats, labels = _batch(rows=3)
    mesh = MeshConfig.from_string("dp=1").create(devices=jax.devices()[:1])
    jtrainer = JaxTrainer(mesh, fm, jax_lm.loss, optax.adam(LR), feats)
    trainer = _port_trainer(pm)
    for tree in (feats, labels):
        want = jax.tree_util.tree_map(np.asarray, jtrainer.place_canonical(tree, 5))
        got = trainer.place_canonical(tree, 5)
        for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(
                {"x": got} if not isinstance(got, dict) else got)):
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(
            jax.tree_util.tree_leaves(trainer.pad_to(tree, 5))[0],
            jax.tree_util.tree_leaves(jtrainer.pad_to(tree, 5))[0],
        )
    np.testing.assert_array_equal(trainer.row_mask(3, 5), jtrainer.row_mask(3, 5))
    np.testing.assert_array_equal(
        trainer.place_mask(2, 4).numpy(), np.asarray(jtrainer.place_mask(2, 4))
    )
    with pytest.raises(ValueError):
        trainer.pad_to(feats, 2)
    outputs = {"logits": np.arange(10.0).reshape(5, 2)}
    np.testing.assert_array_equal(
        trim_pad({"logits": torch.from_numpy(outputs["logits"])}, 3)["logits"],
        jax_trim_pad(outputs, 3)["logits"],
    )


def test_checkpoints_load_across_packages():
    fm, params, pm = _pair()
    feats, _labels = _batch(rows=2)
    jstate = jax_state.TrainState.create(fm.apply, params, optax.adam(LR))
    want = np.asarray(fm.apply({"params": params}, feats))

    # the port's checkpoint, loaded by the JAX package
    port_ckpt = port_state.state_to_checkpoint(_port_trainer(pm).state)
    other = jax_state.TrainState.create(
        fm.apply, jax.tree_util.tree_map(jnp.zeros_like, params), optax.adam(LR)
    )
    loaded = jax_state.checkpoint_to_state(other, port_ckpt)
    got = np.asarray(fm.apply({"params": loaded.params}, feats))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    # the JAX package's checkpoint, loaded by the port
    fresh = _port_trainer(port_lm.custom_model(**LM_KW))
    port_state.checkpoint_to_state(fresh.state, jax_state.state_to_checkpoint(jstate))
    logits = fresh.predict_step(fresh.place_batch(feats)).numpy()
    np.testing.assert_allclose(logits, want, atol=TOL, rtol=TOL)
    assert set(port_ckpt) == set(jax_state.state_to_checkpoint(jstate))
    assert port_state.count_params(pm) == jax_state.count_params(params)
    with pytest.raises(KeyError):
        port_state.checkpoint_to_state(fresh.state, {"params/stray": np.zeros(1)})


def test_training_forward_without_dropout_matches_flax():
    fm, params, pm = _pair()
    feats, _labels = _batch()
    want = np.asarray(
        fm.apply({"params": params}, feats, training=True,
                 rngs={"dropout": jax.random.PRNGKey(0)})
    )
    gen = port_layers.dropout_generator(0, "cpu")
    with torch.no_grad():
        got = pm({"tokens": torch.from_numpy(feats["tokens"])}, training=True,
                 generator=gen)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_dropout_masks_follow_seed_and_step():
    _fm, _params, pm = _pair(dropout_rate=0.3)
    tokens = torch.from_numpy(_batch()[0]["tokens"])

    def run(step, seed=0):
        with torch.no_grad():
            return pm(tokens, training=True,
                      generator=port_layers.dropout_generator(step, "cpu", seed))

    assert torch.equal(run(4), run(4))
    assert not torch.equal(run(4), run(5))
    assert not torch.equal(run(4), run(4, seed=1))
    with torch.no_grad():
        assert torch.equal(pm(tokens), pm(tokens, training=False))
        assert not torch.equal(run(4), pm(tokens))
    with pytest.raises(ValueError, match="generator"):
        pm(tokens, training=True)
    # flax's rule: kept elements scaled by 1 / (1 - rate), the rest 0
    x = torch.ones(10_000)
    y = port_layers.dropout(x, 0.3, port_layers.dropout_generator(0, "cpu"))
    kept = y[y != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.7))
    assert abs(float((y == 0).float().mean()) - 0.3) < 0.02


def test_train_steps_with_dropout_are_replayable():
    def losses():
        _fm, _params, pm = _pair(dropout_rate=0.2)
        trainer = _port_trainer(pm)
        feats, labels = _batch()
        return [
            float(trainer.train_step(
                trainer.place_batch(feats), trainer.place_batch(labels)
            )["loss"])
            for _ in range(2)
        ]

    assert losses() == losses()


def test_modes_metrics_and_optimizer_resolution_match_jax():
    assert [m.value for m in port_state.Modes] == [m.value for m in jax_state.Modes]
    rng = np.random.RandomState(4)
    labels = rng.randint(0, 7, (3, 5))
    logits = rng.randn(3, 5, 7).astype(np.float32)
    j_acc, p_acc = jax_metrics.Accuracy(), port_lm.eval_metrics_fn()["accuracy"]
    j_acc.update(labels, logits)
    p_acc.update(torch.from_numpy(labels), torch.from_numpy(logits).bfloat16())
    assert isinstance(p_acc, port_metrics.Accuracy)
    assert p_acc.result() == j_acc.result()
    assert set(port_lm.eval_metrics_fn()) == set(jax_lm.eval_metrics_fn())

    factory = port_step.resolve_optimizer(port_lm.optimizer, 0.5)
    opt = factory([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["lr"] == 0.5
    assert port_step.resolve_optimizer(torch.optim.SGD) is torch.optim.SGD
    with pytest.raises(TypeError):
        port_step.resolve_optimizer(3)


def _loop_weighted_mean_loss(loss_fn, labels, outputs, weights):
    """The per-row loop ``weighted_mean_loss`` replaced: one ``loss_fn``
    call per singleton row."""
    def rows(tree, i):
        if isinstance(tree, dict):
            return {k: v[i : i + 1] for k, v in tree.items()}
        return tree[i : i + 1]

    per_row = torch.stack(
        [loss_fn(rows(labels, i), rows(outputs, i)) for i in range(weights.shape[0])]
    )
    weights = weights.to(per_row.dtype)
    return (weights * per_row).sum() / torch.clamp(weights.sum(), min=1.0)


def _loss_cases():
    from elasticdl_tpu_torch.models import deepfm_functional_api as deepfm
    from elasticdl_tpu_torch.models import mnist_functional_api as mnist

    gen = torch.Generator().manual_seed(0)
    return {
        "lm": (port_lm.loss, torch.randint(0, 11, (6, 5), generator=gen, dtype=torch.int32),
               torch.randn(6, 5, 11, generator=gen)),
        "mnist": (mnist.loss, torch.randint(0, 10, (6,), generator=gen, dtype=torch.int32),
                  torch.randn(6, 10, generator=gen)),
        "deepfm": (deepfm.loss, torch.randint(0, 2, (6,), generator=gen, dtype=torch.int32),
                   {"logits": torch.randn(6, generator=gen),
                    "probs": torch.rand(6, 1, generator=gen)}),
    }


@pytest.mark.parametrize("case", ["lm", "mnist", "deepfm"])
def test_vmapped_weighted_mean_loss_matches_the_row_loop(case):
    """``weighted_mean_loss`` vmaps ``loss_fn`` over singleton rows, as the
    JAX step does; it gives the per-row loop's loss and gradients (1e-6:
    the same f32 arithmetic, batched), and rows of weight 0 exactly zero
    gradient."""
    loss_fn, labels, outputs = _loss_cases()[case]
    weights = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    results = []
    for fn in (port_step.weighted_mean_loss, _loop_weighted_mean_loss):
        out = (
            {k: v.clone().requires_grad_() for k, v in outputs.items()}
            if isinstance(outputs, dict) else outputs.clone().requires_grad_()
        )
        loss = fn(loss_fn, labels, out, weights)
        grad_of = out["logits"] if isinstance(out, dict) else out
        (grad,) = torch.autograd.grad(loss, grad_of)
        results.append((loss.detach(), grad))
    (got, got_grad), (want, want_grad) = results
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got_grad, want_grad, atol=1e-6, rtol=1e-6)
    assert torch.count_nonzero(got_grad[weights == 0]) == 0
    assert torch.count_nonzero(got_grad[weights == 1]) > 0
