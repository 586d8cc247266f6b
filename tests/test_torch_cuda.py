"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain versions, and the LM forward on the card against the same
model on the CPU.  Marked ``cuda``; each skips (with its reason) where
``torch.cuda.is_available()`` is false.  This file imports no JAX; on a
machine that has only PyTorch, skip ``tests/conftest.py`` (it sets JAX
up)::

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

from __future__ import annotations

import pytest
import torch

from elasticdl_tpu_torch.models import long_seq_transformer as lm
from elasticdl_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile only for the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, S, H, KVH, D, dtype, causal, atol, rtol): bf16 output and P
# rounded to bf16 before P.V -> about one bf16 ulp of each element
# (rtol 2e-2) plus 4e-3; f32 end to end -> 1e-4
KERNEL_CASES = [
    (2, 256, 4, 4, 64, torch.bfloat16, True, 4e-3, 2e-2),
    (2, 200, 8, 2, 64, torch.bfloat16, True, 4e-3, 2e-2),
    (1, 130, 2, 2, 128, torch.bfloat16, False, 4e-3, 2e-2),
    (1, 77, 2, 1, 32, torch.float32, True, 1e-4, 1e-4),
]


@pytest.mark.parametrize("b,s,h,kvh,d,dtype,causal,atol,rtol", KERNEL_CASES)
def test_flash_kernel_matches_plain_version(
    cuda, b, s, h, kvh, d, dtype, causal, atol, rtol
):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, s, kvh, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, s, kvh, d), generator=gen, device=cuda).to(dtype)
    attn.reset_launch_counts()
    out, lse = attn.flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert attn.launch_counts["flash_fwd"] == 1
    ref_out, ref_lse = attn.flash_attention_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head_dim 48 has no instance
        attn.flash_forward(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        attn.flash_forward(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):  # backward kernels: later
        attn.flash_forward(q, q, q)


# (dtype, tol): f32 runs the kernel's CUDA-core path and full-f32
# products (TF32 off) against the CPU's plain path -> 1e-4; bf16 rounds
# P before P.V and activations at other places -> 6e-2 on logits ~1
@pytest.mark.parametrize(
    "dtype,tol", [(None, 1e-4), ("bfloat16", 6e-2)], ids=["f32", "bf16"]
)
def test_lm_forward_on_the_card_matches_the_cpu(cuda, dtype, tol):
    kw = dict(vocab_size=101, embed_dim=128, num_heads=2, num_layers=2,
              dtype=dtype)
    model = lm.custom_model(**kw)
    lm.init_weights(model, torch.Generator().manual_seed(0))
    tokens = torch.randint(
        0, kw["vocab_size"], (2, 200), generator=torch.Generator().manual_seed(1)
    )
    with torch.inference_mode():
        want = model.eval()({"tokens": tokens}).float()
        attn.reset_launch_counts()
        got = model.to(cuda)({"tokens": tokens.to(cuda)}).float().cpu()
    assert attn.launch_counts["flash_fwd"] == kw["num_layers"]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
