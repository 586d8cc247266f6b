"""The port's KV-cached decode and ``generate``
(``elasticdl_tpu_torch/models/long_seq_transformer.py``) against the JAX
package's, on the same seeded flax weights: the cases of
``tests/test_generation.py`` plus the port's own parity checks.

Greedy tokens must equal JAX ``generate``'s exactly, and the cached
logits of every decode step stay within 1e-5 of JAX's in f32 (both sides
compute the decode attention in f32 with the same masking; the
projections differ only in summation order).  The sampled bits differ
from JAX's PRNG by design: the port samples with a ``torch.Generator``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import long_seq_transformer as jax_lm
from elasticdl_tpu.utils import tree_utils
from elasticdl_tpu_torch.layers import attention as port_layers
from elasticdl_tpu_torch.models import long_seq_transformer as port_lm
from elasticdl_tpu_torch.utils import flax_weights

LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _full_f32_products():
    torch.backends.cuda.matmul.allow_tf32 = False


def _init_params(model, batch=2, seq=8, seed=0):
    feats = {"tokens": jnp.zeros((batch, seq), jnp.int32)}
    return model.init(jax.random.PRNGKey(seed), feats)["params"]


def _port_model(params, **kwargs):
    model = port_lm.custom_model(**kwargs)
    model.load_state_dict(
        flax_weights.torch_state_from_flax(tree_utils.tree_to_dict(params), model)
    )
    return model.eval()


def _port_full_forward_greedy(model, prompt, num_steps):
    """Oracle: recompute the whole sequence every step (the port's full
    forward, the flash path's plain version on the CPU)."""
    tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
    with torch.no_grad():
        for _ in range(num_steps):
            nxt = model({"tokens": tokens})[:, -1].argmax(-1)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return tokens.numpy()


def _jax_cached_logits(params, tokens, **kwargs):
    """Each decode step's logits through the JAX decode model, fed
    ``tokens`` one at a time (as JAX ``generate`` does)."""
    max_len = tokens.shape[1]
    model = jax_lm.TransformerLM(**kwargs, decode=True, max_decode_len=max_len)
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0),
            {"tokens": jnp.zeros((tokens.shape[0], 1), jnp.int32)},
        )["cache"]
    )
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    out = []
    for i in range(max_len):
        logits, mutated = model.apply(
            {"params": params, "cache": cache},
            {"tokens": jnp.asarray(tokens[:, i:i + 1], jnp.int32)},
            mutable=["cache"],
        )
        cache = mutated["cache"]
        out.append(np.asarray(logits[:, -1], np.float32))
    return np.stack(out, 1)


def _port_cached_logits(model, tokens):
    decode = port_lm.TransformerLM(
        **model.config, decode=True, max_decode_len=tokens.shape[1]
    )
    decode.load_state_dict(model.state_dict())
    decode.eval()
    cache = decode.init_cache(tokens.shape[0])
    out = []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            step = torch.as_tensor(tokens[:, i:i + 1], dtype=torch.int64)
            out.append(decode({"tokens": step}, cache=cache)[:, -1].float().numpy())
    assert cache.pos == tokens.shape[1]
    return np.stack(out, 1)


CASES = {
    "mha": (dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4), 0,
            [[3, 7, 1], [10, 2, 5]], 6),
    "gqa": (dict(vocab_size=64, num_layers=1, embed_dim=32, num_heads=4, num_kv_heads=2), 1,
            [[9, 4], [0, 31]], 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_generation_matches_full_forward_and_jax(case):
    """The ported cases of ``tests/test_generation.py`` (with and without
    GQA): cached greedy decoding equals the full-forward oracle, and the
    port's tokens equal JAX ``generate``'s exactly."""
    kwargs, seed, prompt, steps = CASES[case]
    params = _init_params(jax_lm.custom_model(**kwargs), seed=seed)
    prompt = np.asarray(prompt, np.int32)
    want = np.asarray(jax_lm.generate(params, jnp.asarray(prompt), num_steps=steps, **kwargs))
    got = port_lm.generate(params, prompt, num_steps=steps, device="cpu", **kwargs)
    assert got.dtype == torch.int64 and got.shape == (2, prompt.shape[1] + steps)
    np.testing.assert_array_equal(got.numpy(), want)
    model = _port_model(params, **kwargs)
    np.testing.assert_array_equal(_port_full_forward_greedy(model, prompt, steps), want)
    # the model's own weights (params=None) decode the same
    np.testing.assert_array_equal(
        port_lm.generate(None, prompt, num_steps=steps, model=model).numpy(), want
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_logits_match_jax_and_the_full_forward(case):
    kwargs, seed, _prompt, _steps = CASES[case]
    params = _init_params(jax_lm.custom_model(**kwargs), seed=seed)
    tokens = np.random.RandomState(seed).randint(0, kwargs["vocab_size"], (2, 9))
    want = _jax_cached_logits(params, tokens, **kwargs)
    model = _port_model(params, **kwargs)
    got = _port_cached_logits(model, tokens)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    with torch.no_grad():
        full = model({"tokens": torch.as_tensor(tokens)}).numpy()
    np.testing.assert_allclose(got, full, atol=LOGIT_TOL, rtol=0)


def test_decode_attention_matches_jax_with_a_bf16_cache():
    """One layer in decode mode with bf16 compute: the cache holds K/V in
    the compute dtype, the scores and P.V run in f32, the output is cast
    to the query's dtype, as JAX's ``_decode_attend``."""
    from elasticdl_tpu.layers import attention as jax_layers

    fm = jax_layers.MultiHeadSelfAttention(
        num_heads=4, num_kv_heads=2, causal=True, decode=True, max_decode_len=6,
        dtype=jnp.bfloat16,
    )
    x = np.random.RandomState(3).randn(2, 6, 32).astype(np.float32)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :1]), decode_pos=0)
    params, cache = variables["params"], variables["cache"]
    assert cache["k"].dtype == jnp.bfloat16
    pm = port_layers.MultiHeadSelfAttention(
        32, 4, causal=True, num_kv_heads=2, dtype="bfloat16", decode=True, max_decode_len=6,
    )
    pm.load_state_dict(flax_weights.torch_state_from_flax(tree_utils.tree_to_dict(params), pm))
    port_cache = pm.empty_cache(2, torch.bfloat16)
    for pos in range(6):
        want, mutated = fm.apply(
            {"params": params, "cache": cache}, jnp.asarray(x[:, pos:pos + 1]),
            decode_pos=pos, mutable=["cache"],
        )
        cache = mutated["cache"]
        with torch.no_grad():
            got = pm(torch.from_numpy(x[:, pos:pos + 1]), decode_pos=pos, cache=port_cache)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=0
        )
        np.testing.assert_array_equal(
            port_cache.k[:, :pos + 1].float().numpy(),
            np.asarray(cache["k"][:, :pos + 1], np.float32),
        )


def test_bf16_generate_is_its_decode_models_argmax():
    """In bf16, ``generate`` casts its decode model's projections and
    table once; its greedy tokens are the argmax of each step of a decode
    model that casts them at every use, exactly."""
    kwargs = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=4, dtype="bfloat16")
    torch.manual_seed(3)
    model = port_lm.custom_model(**kwargs).eval()
    prompt = np.asarray([[3, 7, 1], [10, 2, 5]])
    tokens = port_lm.generate(None, prompt, num_steps=6, model=model)
    logits = _port_cached_logits(model, tokens.numpy())
    np.testing.assert_array_equal(logits[:, 2:-1].argmax(-1), tokens[:, 3:].numpy())
    assert model.lm_head.weight.dtype == torch.float32  # the caller's model is left as it was


def test_decode_errors_match_jax():
    pm = port_layers.MultiHeadSelfAttention(32, 4, decode=True, max_decode_len=4)
    cache = pm.empty_cache(1, torch.float32)
    x = torch.zeros(1, 1, 32)
    with pytest.raises(ValueError, match="decode mode needs decode_pos"):
        pm(x, cache=cache)
    with pytest.raises(ValueError, match="one token per call"):
        pm(torch.zeros(1, 2, 32), decode_pos=0, cache=cache)
    no_len = port_layers.MultiHeadSelfAttention(32, 4, decode=True)
    with pytest.raises(ValueError, match="decode=True needs max_decode_len"):
        no_len(x, decode_pos=0, cache=cache)
    with pytest.raises(ValueError, match="KVCache"):
        pm(x, decode_pos=0)
    lm = port_lm.TransformerLM(vocab_size=8, embed_dim=16, num_heads=2, num_layers=1,
                               decode=True, max_decode_len=2)
    lm_cache = lm.init_cache(1)
    with torch.no_grad():
        for _ in range(2):
            lm({"tokens": torch.zeros(1, 1, dtype=torch.int64)}, cache=lm_cache)
        with pytest.raises(ValueError, match="past max_decode_len"):
            lm({"tokens": torch.zeros(1, 1, dtype=torch.int64)}, cache=lm_cache)


def test_sampling_modes_and_errors():
    """temperature 0 is greedy; a near-zero temperature samples the
    argmax; one generator seed reproduces its tokens and another gives
    others; top-k keeps every sampled token among its step's k most
    likely; the JAX errors."""
    kwargs = dict(vocab_size=32, num_layers=1, embed_dim=32, num_heads=2)
    params = _init_params(jax_lm.custom_model(**kwargs))
    prompt = np.asarray([[1, 2]], np.int32)

    def gen(**kw):
        return port_lm.generate(params, prompt, num_steps=5, device="cpu", **kwargs, **kw)

    greedy = gen()
    np.testing.assert_array_equal(
        greedy.numpy(),
        np.asarray(jax_lm.generate(params, jnp.asarray(prompt), num_steps=5, **kwargs)),
    )
    cold = gen(temperature=1e-4, rng=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(greedy.numpy(), cold.numpy())

    def hot(seed):
        return gen(temperature=5.0, top_k=8, rng=torch.Generator().manual_seed(seed))

    np.testing.assert_array_equal(hot(1).numpy(), hot(1).numpy())
    draws = {tuple(hot(s)[0].tolist()) for s in range(6)}
    assert len(draws) > 1
    # every sampled token is among its step's top 8 (by the full forward)
    model = _port_model(params, **kwargs)
    tokens = hot(2)
    with torch.no_grad():
        logits = model({"tokens": tokens[:, :-1]})[0]
    for t in range(prompt.shape[1], tokens.shape[1]):
        top = set(torch.topk(logits[t - 1], 8).indices.tolist())
        assert int(tokens[0, t]) in top
    # a top_k past the vocabulary is clamped to it
    assert gen(temperature=1.0, top_k=1000, rng=torch.Generator().manual_seed(0)).shape == (1, 7)

    with pytest.raises(ValueError, match="rng"):
        gen(temperature=1.0)
    with pytest.raises(ValueError, match="top_k"):
        gen(top_k=-1)
    with pytest.raises(ValueError, match="either a model or model_kwargs"):
        port_lm.generate(params, prompt, 2, model=model, vocab_size=32)
    with pytest.raises(ValueError, match="token ids"):
        gen_bad = np.asarray([[1, 32]], np.int32)
        port_lm.generate(params, gen_bad, 2, device="cpu", **kwargs)


def test_sampled_bits_differ_from_jax_by_design():
    """The pinned divergence: the port samples with a ``torch.Generator``,
    JAX with its counter-based PRNG, so the same integer seed draws other
    tokens (greedy decoding is the same on both)."""
    kwargs = dict(vocab_size=32, num_layers=1, embed_dim=32, num_heads=2)
    params = _init_params(jax_lm.custom_model(**kwargs))
    prompt = np.asarray([[1, 2], [3, 4]], np.int32)
    jax_tokens = np.asarray(jax_lm.generate(
        params, jnp.asarray(prompt), num_steps=12, temperature=5.0,
        rng=jax.random.PRNGKey(1), **kwargs,
    ))
    port_tokens = port_lm.generate(
        params, prompt, num_steps=12, temperature=5.0,
        rng=torch.Generator().manual_seed(1), device="cpu", **kwargs,
    ).numpy()
    np.testing.assert_array_equal(port_tokens[:, :2], jax_tokens[:, :2])
    assert not np.array_equal(port_tokens, jax_tokens)


def test_generate_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = dict(vocab_size=16, num_layers=1, embed_dim=16, num_heads=2)
    params = _init_params(jax_lm.custom_model(**kwargs))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_lm.generate(params, np.asarray([[1]]), 2, **kwargs)


def test_trained_model_generates_the_markov_chain(tmp_path):
    """Train the port's LM briefly through its trainer on the permutation
    chain of ``gen_sequence``, then generate: most continuations follow
    next = perm[cur] (the data's noise rate is 5 %)."""
    from elasticdl_tpu_torch.data.dataset import Dataset
    from elasticdl_tpu_torch.data.recordio_gen import synthetic
    from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.state import Modes

    torch.set_num_threads(2)
    data_dir = synthetic.gen_sequence(
        str(tmp_path / "seq"), num_records=256, num_shards=1, seq_len=32, seed=0
    )
    reader = RecordIODataReader(data_dir=data_dir)
    name, (start, count) = next(iter(reader.create_shards().items()))
    task = type("T", (), {"shard_name": name, "start": start, "end": start + count})
    ds = port_lm.dataset_fn(
        Dataset.from_generator(lambda: reader.read_records(task)), Modes.TRAINING,
        reader.metadata,
    )
    batches = list(ds.batch(32))
    kwargs = dict(num_layers=1, embed_dim=64, num_heads=2)
    torch.manual_seed(0)
    model = port_lm.custom_model(**kwargs)
    trainer = SPMDTrainer(model, port_lm.loss, port_lm.optimizer(3e-3), device="cpu")
    for _ in range(8):
        for feats, labels in batches:
            trainer.train_step(trainer.place_batch(feats), trainer.place_batch(labels))

    perm = np.random.RandomState(1234).permutation(port_lm.VOCAB)
    prompt = np.array([[5, int(perm[5])], [40, int(perm[40])]])
    out = port_lm.generate(None, prompt, num_steps=10, model=trainer.state.model).numpy()
    correct = sum(
        int(out[b, t + 1] == perm[out[b, t]])
        for b in range(out.shape[0])
        for t in range(1, out.shape[1] - 1)
    )
    total = out.shape[0] * (out.shape[1] - 2)
    assert correct / total > 0.7, (correct, total, out)


def test_smoke_phase19a_rehearsal_on_the_cpu():
    """``chip_smoke.py``'s phase 19a at a small width on the CPU: every
    gate it holds on the card but the kernel's launches (none here)."""
    import chip_smoke

    cfg = dict(vocab_size=97, embed_dim=32, num_heads=2, num_layers=2)
    row = chip_smoke.generate_lm("cpu", cfg=cfg, batch=2, prompt_len=8, steps=12)
    assert row["tokens"] == 24 and row["margin_decided"] > 0
    assert row["max_abs_err"] < 1e-4 and row["sampled_in_top_k"]
