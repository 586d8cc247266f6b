"""The port's layers and ``TransformerLM`` (``elasticdl_tpu_torch``)
against the JAX package's flax modules, with the weights carried across
by ``utils.flax_weights``.

Every parameter is drawn from a numpy seed (biases and LayerNorm scales
too, so a mapping that mixed them up would show) and handed to both
sides.  f32 is held to 1e-4; the bf16 case to 6e-2 absolute on logits
of size ~1, which is several bf16 roundings (2**-8 relative each) of
the activations over two blocks, rounded at different places by the two
frameworks.  Both sides compute f32 products in full f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.layers import attention as jax_layers
from elasticdl_tpu.models import long_seq_transformer as jax_lm
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu_torch.layers import attention as port_layers
from elasticdl_tpu_torch.models import long_seq_transformer as port_lm
from elasticdl_tpu_torch.utils import export_utils, flax_weights, model_utils
from elasticdl_tpu_torch.utils.device import resolve_device

TOL = 1e-4
BF16_TOL = 6e-2
SEQ = 64
LM_KW = dict(vocab_size=97, embed_dim=32, num_heads=2, num_layers=2)


@pytest.fixture(autouse=True)
def _full_f32_products():
    # the reference runs state TF32 off (only matters on a card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _random_flat(flax_module, sample, seed):
    """Flat flax parameters of ``flax_module``'s structure, every leaf
    drawn from a numpy seed."""
    params = flax_module.init(jax.random.PRNGKey(0), sample)["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for name, leaf in tree_utils.tree_to_dict(params).items():
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
    return flat, params


def _flax_apply(flax_module, flat, like, inputs, **kw):
    params = tree_utils.dict_to_tree(flat, like)
    return np.asarray(
        flax_module.apply({"params": params}, inputs, **kw), dtype=np.float32
    )


def _port_module(port_module, flat):
    port_module.load_state_dict(
        flax_weights.torch_state_from_flax(flat, port_module)
    )
    return port_module.eval()


def _tokens(rows=2, seq=SEQ, vocab=LM_KW["vocab_size"], seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (rows, seq)).astype(
        np.int32
    )


def _run_port(module, inputs):
    with torch.inference_mode():
        return module(inputs).float().numpy()


# ---- layers -----------------------------------------------------------------


@pytest.mark.parametrize(
    "heads,kv_heads,causal",
    [(2, 0, False), (2, 0, True), (4, 2, True)],
    ids=["mha", "mha_causal", "gqa_causal"],
)
def test_self_attention_matches_flax(heads, kv_heads, causal):
    x = np.random.RandomState(3).randn(2, SEQ, 32).astype(np.float32)
    fm = jax_layers.MultiHeadSelfAttention(
        num_heads=heads, causal=causal, num_kv_heads=kv_heads
    )
    flat, like = _random_flat(fm, jnp.asarray(x), seed=4)
    want = _flax_apply(fm, flat, like, jnp.asarray(x))
    pm = _port_module(
        port_layers.MultiHeadSelfAttention(
            32, heads, causal=causal, num_kv_heads=kv_heads
        ),
        flat,
    )
    got = _run_port(pm, torch.from_numpy(x))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_heads", [0, 1], ids=["mha", "gqa"])
def test_transformer_block_matches_flax(kv_heads):
    x = np.random.RandomState(5).randn(2, SEQ, 32).astype(np.float32)
    fm = jax_layers.TransformerBlock(
        num_heads=2, causal=True, num_kv_heads=kv_heads
    )
    flat, like = _random_flat(fm, jnp.asarray(x), seed=6)
    want = _flax_apply(fm, flat, like, jnp.asarray(x))
    pm = _port_module(
        port_layers.TransformerBlock(32, 2, causal=True, num_kv_heads=kv_heads),
        flat,
    )
    got = _run_port(pm, torch.from_numpy(x))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_sinusoidal_positions_match_flax():
    want = np.asarray(jax_layers.sinusoidal_positions(SEQ, 32))
    got = port_layers.sinusoidal_positions(SEQ, 32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---- the LM -----------------------------------------------------------------


def _lm_pair(seed=7, **overrides):
    kw = dict(LM_KW, **overrides)
    fm = jax_lm.custom_model(**kw)
    sample = {"tokens": jnp.asarray(_tokens(rows=1))}
    flat, like = _random_flat(fm, sample, seed=seed)
    pm = _port_module(port_lm.custom_model(**kw), flat)
    return fm, pm, flat, like


@pytest.mark.parametrize(
    "overrides", [{}, {"num_kv_heads": 1}], ids=["mha", "gqa"]
)
def test_lm_forward_matches_flax_f32(overrides):
    fm, pm, flat, like = _lm_pair(**overrides)
    tokens = _tokens(rows=3)
    want = _flax_apply(fm, flat, like, {"tokens": jnp.asarray(tokens)})
    got = _run_port(pm, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (3, SEQ, LM_KW["vocab_size"])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_lm_forward_matches_flax_bf16():
    fm, pm, flat, like = _lm_pair(dtype="bfloat16")
    tokens = _tokens(rows=2)
    want = _flax_apply(fm, flat, like, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        out = pm({"tokens": torch.from_numpy(tokens)})
    assert out.dtype == torch.bfloat16  # logits in the compute dtype
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    np.testing.assert_allclose(out.float().numpy(), want, atol=BF16_TOL, rtol=0)
    f32 = _flax_apply(
        jax_lm.custom_model(**LM_KW), flat, like, {"tokens": jnp.asarray(tokens)}
    )
    # the bf16 model is nearer its own reference than to the f32 model's
    assert np.abs(out.float().numpy() - want).mean() < np.abs(f32 - want).mean()


def test_flax_weights_round_trip_is_exact():
    _fm, pm, flat, _like = _lm_pair(num_kv_heads=1)
    back = flax_weights.flax_flat_from_torch(pm)
    assert set(back) == set(flat)
    for name, value in flat.items():
        assert back[name].shape == value.shape, name
        np.testing.assert_array_equal(back[name], value, err_msg=name)


def test_flax_weights_reject_missing_extra_and_misshaped():
    _fm, pm, flat, _like = _lm_pair()
    missing = dict(flat)
    del missing["block_1/mlp_up/kernel"]
    with pytest.raises(KeyError):
        flax_weights.torch_state_from_flax(missing, pm)
    with pytest.raises(KeyError):
        flax_weights.torch_state_from_flax(dict(flat, stray=np.zeros(1)), pm)
    bad = dict(flat)
    bad["lm_head/kernel"] = bad["lm_head/kernel"].T
    with pytest.raises(ValueError):
        flax_weights.torch_state_from_flax(bad, pm)


def test_port_exported_weights_load_into_flax(tmp_path):
    """The port's ``export_model`` writes the JAX package's layout: the
    JAX loader rebuilds the same function from it."""
    from elasticdl_tpu.utils import export_utils as jax_export

    _fm, pm, _flat, _like = _lm_pair()
    model_def = "long_seq_transformer.long_seq_transformer.custom_model"
    export_utils.export_model(
        str(tmp_path), pm, model_def, model_params=LM_KW, model_version=5
    )
    model, flat_params, flat_state = jax_export.load_exported_model(str(tmp_path))
    assert jax_export.read_manifest(str(tmp_path))["model_version"] == 5
    tokens = _tokens(rows=2)
    params, _ = jax_export.rebuild_variables(
        model, {"tokens": tokens[:1]}, flat_params, flat_state
    )
    want = np.asarray(model.apply({"params": params}, {"tokens": tokens}))
    got = _run_port(pm, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_manifest_model_def_resolves_to_the_port():
    spec = model_utils.get_model_spec(
        "", "long_seq_transformer.long_seq_transformer.custom_model",
        model_params=LM_KW,
    )
    assert spec.module is port_lm
    model = spec.build_model()
    assert isinstance(model, port_lm.TransformerLM)
    assert len(model.blocks) == LM_KW["num_layers"]
    assert spec.loss is port_lm.loss and spec.optimizer is port_lm.optimizer


def test_loss_matches_optax():
    rng = np.random.RandomState(8)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, (2, 5)).astype(np.int32)
    want = float(jax_lm.loss(labels, jnp.asarray(logits)))
    got = float(port_lm.loss(labels, torch.from_numpy(logits)))
    assert abs(got - want) < 1e-5


# ---- the edges ------------------------------------------------------------------


def test_out_of_range_token_ids_nan_in_jax_and_raise_in_port():
    """The JAX model gathers with fill semantics: an id past the vocab
    gives NaN logits on its row.  The port refuses the request instead,
    before it reaches the device (on a card the gather would assert and
    kill the process's CUDA context)."""
    fm, pm, flat, like = _lm_pair()
    tokens = _tokens(rows=2)
    tokens[1, 3] = LM_KW["vocab_size"]
    want = _flax_apply(fm, flat, like, {"tokens": jnp.asarray(tokens)})
    assert np.isnan(want[1]).any() and np.isfinite(want[0]).all()
    with pytest.raises(ValueError, match="token ids"):
        _run_port(pm, {"tokens": torch.from_numpy(tokens)})
    tokens[1, 3] = -1
    with pytest.raises(ValueError, match="token ids"):
        pm.validate_features({"tokens": tokens})


def test_moe_block_is_refused_until_ported():
    with pytest.raises(NotImplementedError):
        port_layers.TransformerBlock(32, 2, num_experts=4)


def test_entry_points_raise_without_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.serving.engine import ServingEngine
    from elasticdl_tpu_torch.serving.replica import ServingReplica

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _fm, pm, _flat, _like = _lm_pair()
    export_utils.export_model(
        str(tmp_path), pm,
        "long_seq_transformer.long_seq_transformer.custom_model",
        model_params=LM_KW,
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        export_utils.load_exported_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(str(tmp_path), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingReplica(str(tmp_path), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        SPMDTrainer(pm, port_lm.loss, port_lm.optimizer())
    model, _, _ = export_utils.load_exported_model(str(tmp_path), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert ServingEngine(str(tmp_path), 4, device="cpu").device.type == "cpu"
    trainer = SPMDTrainer(pm, port_lm.loss, port_lm.optimizer(), device="cpu")
    assert next(trainer.state.model.parameters()).device.type == "cpu"
