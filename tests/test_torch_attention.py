"""The port's attention (``elasticdl_tpu_torch.ops.attention``) against
the JAX package's (``elasticdl_tpu.ops.attention``) on the same inputs.

The JAX flash forward runs its Pallas kernel in interpret mode on the
CPU, as ``tests/test_attention.py`` runs it; the port's CPU path is the
plain version of its CUDA kernel.  Both ``out`` and the row logsumexp
``lse`` are compared, at 2e-5 in f32 (the JAX package's own forward
tolerance).  The backward (the plain versions of the dQ and dK/dV
kernels, and autograd through the port's ``flash_attention``) is held to
the JAX package's ``_flash_backward`` and ``jax.grad`` at 1e-4, its own
gradient tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import attention as jax_attn
from elasticdl_tpu_torch.ops import attention as port_attn

TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(b=2, s=64, h=2, kvh=None, d=16, seed=0):
    rng = np.random.RandomState(seed)
    kvh = kvh or h
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kvh, d).astype(np.float32)
    v = rng.randn(b, s, kvh, d).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# (seq, heads, kv_heads, block): S=72 is not a multiple of the 32-row
# block, so the JAX kernel's _pick_block shrinks its blocks to 8 rows
FLASH_CASES = [
    pytest.param(64, 2, 2, 32, id="mha"),
    pytest.param(64, 4, 2, 32, id="gqa"),
    pytest.param(72, 4, 1, 32, id="gqa_ragged"),
]
# lengths that straddle the card's 128-row bf16 tile, where the plain
# version the kernel is held to must still be _flash_forward: S=144 is
# not a multiple of 32, so the JAX kernel takes 16-row blocks (as many
# grid steps as S=72's 8-row ones); S=160 keeps 32-row blocks
TILE_EDGE_CASES = [
    pytest.param(144, 4, 2, 32, id="past_tile_gqa"),
    pytest.param(160, 6, 2, 32, id="tile_and_a_quarter_gqa"),
]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq,heads,kv_heads,block", FLASH_CASES + TILE_EDGE_CASES)
def test_flash_reference_matches_jax_kernel(seq, heads, kv_heads, block, causal):
    q, k, v = _qkv(s=seq, h=heads, kvh=kv_heads)
    j_out, j_lse = jax_attn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None,
        block, block, None,
    )
    p_out, p_lse = port_attn.flash_attention_reference(*_t(q, k, v), causal)
    assert p_out.shape == j_out.shape and p_lse.shape == j_lse.shape
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_matches_jax_public_entry(causal):
    q, k, v = _qkv(s=64, h=4, kvh=2)
    j_out = jax_attn.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    p_out = port_attn.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_mha_reference_matches_jax(kv_heads, causal):
    q, k, v = _qkv(s=40, h=4, kvh=kv_heads)
    j_out = jax_attn.mha_reference(q, k, v, causal=causal)
    p_out = port_attn.mha_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)


def test_explicit_scale_matches_jax():
    q, k, v = _qkv(s=32, h=2)
    j_out, j_lse = jax_attn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 0.3, 32, 32, None
    )
    p_out, p_lse = port_attn.flash_attention_reference(*_t(q, k, v), True, 0.3)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), atol=TOL, rtol=TOL)


def test_repeat_kv_heads_matches_jax_grouping():
    q, k, v = _qkv(s=8, h=6, kvh=2)
    jk, jv = jax_attn.repeat_kv_heads(q, k, v)
    pk, pv = port_attn.repeat_kv_heads(*_t(q, k, v))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize(
    "k_heads,v_heads", [(3, 3), (2, 1)], ids=["indivisible", "k_v_differ"]
)
def test_gqa_validation_raises_like_jax(k_heads, v_heads):
    q = np.zeros((1, 4, 4, 8), np.float32)
    k = np.zeros((1, 4, k_heads, 8), np.float32)
    v = np.zeros((1, 4, v_heads, 8), np.float32)
    with pytest.raises(ValueError):
        jax_attn.validate_gqa_heads(q, k, v)
    with pytest.raises(ValueError):
        port_attn.validate_gqa_heads(*_t(q, k, v))


def test_cpu_tensor_takes_the_plain_path_without_a_launch():
    q, k, v = _t(*_qkv(s=48, h=4, kvh=2))
    port_attn.reset_launch_counts()
    out, lse = port_attn.flash_forward(q, k, v, causal=True)
    ref_out, ref_lse = port_attn.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert torch.equal(port_attn.attention(q, k, v, causal=True), ref_out)
    grads = port_attn.flash_backward(q, k, v, out, lse, q, causal=True)
    ref = port_attn.flash_backward_reference(q, k, v, out, lse, q, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert port_attn.launch_counts == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    }


def test_bf16_cpu_path_keeps_dtype_and_tracks_f32():
    q, k, v = _t(*_qkv(s=32, h=2))
    out, lse = port_attn.flash_forward(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True
    )
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = port_attn.mha_reference(q, k, v, causal=True)
    # inputs rounded to bf16 (8 mantissa bits) and a bf16 output
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


# ---- the backward -------------------------------------------------------


def _backward_inputs(seq, heads, kv_heads, causal, seed=2):
    """(q, k, v, out, lse, g) with out and lse from the JAX forward."""
    q, k, v = _qkv(s=seq, h=heads, kvh=kv_heads, seed=seed)
    g = np.random.RandomState(seed + 1).randn(*q.shape).astype(np.float32)
    out, lse = jax_attn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, 32, 32,
        None,
    )
    return q, k, v, np.array(out), np.array(lse), g  # writable copies


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq,heads,kv_heads,block", FLASH_CASES)
def test_backward_references_match_jax_kernels(seq, heads, kv_heads, block, causal):
    inputs = _backward_inputs(seq, heads, kv_heads, causal)
    want = jax_attn._flash_backward(
        *(jnp.asarray(x) for x in inputs), causal, None, block, block, None
    )
    t = _t(*inputs)
    dq = port_attn.flash_dq_reference(*t, causal)
    dk, dv = port_attn.flash_dkv_reference(*t, causal)
    assert dk.shape == (2, seq, kv_heads, 16)  # at the kv-head shape
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL
        )
    both = port_attn.flash_backward_reference(*t, causal)
    assert all(torch.equal(a, b) for a, b in zip(both, (dq, dk, dv)))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq,heads,kv_heads,block", FLASH_CASES)
def test_autograd_matches_jax_grad(seq, heads, kv_heads, block, causal):
    q, k, v = _qkv(s=seq, h=heads, kvh=kv_heads, seed=4)
    g = np.random.RandomState(5).randn(*q.shape).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_attn.flash_attention(
            q, k, v, causal=causal, block_q=block, block_k=block
        )
        return (out * g).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = port_attn.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), atol=GRAD_TOL, rtol=GRAD_TOL
        )


def test_autograd_backward_is_the_plain_backward_not_autograd_of_forward():
    """On CPU tensors the Function's backward calls the plain versions of
    the backward kernels: the exact code the kernels are held to."""
    q, k, v = _t(*_qkv(s=40, h=4, kvh=2))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = port_attn.attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), g)
    out, lse = port_attn.flash_attention_reference(q, k, v, causal=True)
    want = port_attn.flash_backward_reference(q, k, v, out, lse, g, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
