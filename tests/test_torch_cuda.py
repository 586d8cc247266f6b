"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (the
flash forward, dQ and dK/dV) against their plain versions, the LM's
forward and train step, and mnist's and DeepFM's train steps, on the
card against the same model on the CPU, and the native EDLIO codec
built on the card's machine.  Marked ``cuda``; each skips (with its reason) where
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
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer

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
    # the edges of the bf16 kernel's 128-row q and k/v tiles
    (2, 64, 4, 4, 64, torch.bfloat16, True, 4e-3, 2e-2),
    (1, 2049, 4, 4, 64, torch.bfloat16, True, 4e-3, 2e-2),
    (2, 1024, 12, 4, 128, torch.bfloat16, True, 4e-3, 2e-2),
    (1, 512, 2, 2, 64, torch.bfloat16, False, 4e-3, 2e-2),
    # the backward's bf16 tiles differ per head dim: D 32 and D 128, ragged
    (2, 333, 4, 2, 32, torch.bfloat16, True, 4e-3, 2e-2),
    (1, 1000, 4, 2, 128, torch.bfloat16, True, 4e-3, 2e-2),
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


@pytest.mark.parametrize(
    "dtype,kernel",
    [(torch.bfloat16, "flash_fwd_sm90_kernel"),
     (torch.float32, "flash_fwd_f32_kernel")],
    ids=["bf16_wgmma", "f32_cuda_cores"],
)
def test_forward_launches_the_kernel_of_its_dtype(cuda, dtype, kernel):
    """bf16 goes through the wgmma/TMA kernel and f32 through the
    CUDA-core one (the device's own record of what ran), each counted
    once in launch_counts["flash_fwd"]."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (
        torch.randn((1, 200, 2, 64), generator=gen, device=cuda).to(dtype)
        for _ in range(3)
    )
    attn.flash_forward(q, k, v, True)  # built and loaded before the trace
    torch.cuda.synchronize()
    attn.reset_launch_counts()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        attn.flash_forward(q, k, v, True)
        torch.cuda.synchronize()
    assert attn.launch_counts["flash_fwd"] == 1
    ran = [e.key for e in prof.key_averages() if "flash_fwd" in e.key]
    assert len(ran) == 1 and kernel in ran[0], ran


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head_dim 48 has no instance
        attn.flash_forward(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        attn.flash_forward(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    lse = torch.zeros((2, 8, 1), device=cuda)
    with pytest.raises(TypeError):
        attn.flash_backward(q, q, q, q, lse, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError):  # lse of the wrong shape
        attn.flash_backward(q, q, q, q, lse[:1], q)
    with pytest.raises(ValueError):  # g of the wrong shape
        attn.flash_backward(q, q, q, q, lse, q[:, :4])


# the backward kernels, at the forward's cases.  Gradients are held
# relative to their own size: atol is a fraction of max|ref| (bf16: the
# kernels round P and dS to bf16, 2**-9 relative, before their products,
# so an element built from one large term moves by up to two bf16
# roundings of the largest element; f32: summation order only)
BWD_TOLS = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-5, 1e-4)}


@pytest.mark.parametrize("b,s,h,kvh,d,dtype,causal,_atol,_rtol", KERNEL_CASES)
def test_backward_kernels_match_plain_versions(
    cuda, b, s, h, kvh, d, dtype, causal, _atol, _rtol
):
    gen = torch.Generator(device=cuda).manual_seed(1)

    def mk(heads):
        return torch.randn((b, s, heads, d), generator=gen, device=cuda).to(dtype)

    q, k, v, g = mk(h), mk(kvh), mk(kvh), mk(h)
    out, lse = attn.flash_forward(q, k, v, causal)
    attn.reset_launch_counts()
    got = attn.flash_backward(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    assert attn.launch_counts == {
        "flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
    }
    want = attn.flash_backward_reference(q, k, v, out, lse, g, causal)
    atol, rtol = BWD_TOLS[dtype]
    for a, r in zip(got, want):
        assert a.shape == r.shape and a.dtype == r.dtype
        torch.testing.assert_close(
            a.float(), r.float(), atol=atol * r.float().abs().max().item(),
            rtol=rtol,
        )


def test_autograd_through_the_kernels_matches_the_plain_path(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (
        torch.randn((2, 130, heads, 64), generator=gen, device=cuda)
        for heads in (4, 2, 2)
    )
    g = torch.randn(q.shape, generator=gen, device=cuda)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.reset_launch_counts()
    got = torch.autograd.grad(attn.attention(*leaves, causal=True), leaves, g)
    assert attn.launch_counts == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
    }
    out, lse = attn.flash_attention_reference(q, k, v, True)
    want = attn.flash_backward_reference(q, k, v, out, lse, g, True)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)


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


def test_lm_train_step_on_the_card_matches_the_cpu(cuda):
    """One f32 train step (TF32 off) of the same model on the card and on
    the CPU: loss, every gradient and every updated parameter at 1e-4,
    with one launch of each kernel per layer.  The key biases' gradient
    is zero in exact arithmetic (softmax ignores a score shift shared by
    a row) and rounding noise in floats, which Adam turns into steps of
    up to lr either way: they are held to 2 lr."""
    kw = dict(vocab_size=101, embed_dim=128, num_heads=2, num_layers=2)
    lr = 1e-3
    rng = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, kw["vocab_size"], (3, 201), generator=rng)
    feats, labels = {"tokens": tokens[:, :-1]}, tokens[:, 1:]
    weights = torch.tensor([1.0, 1.0, 0.0])
    models, losses = [], []
    for device in ("cpu", cuda):
        model = lm.custom_model(**kw)
        lm.init_weights(model, torch.Generator().manual_seed(0))
        trainer = SPMDTrainer(model, lm.loss, lm.optimizer(lr), device=device)
        place = trainer.place_batch
        attn.reset_launch_counts()
        metrics = trainer.train_step(place(feats), place(labels), place(weights))
        losses.append(float(metrics["loss"]))
        models.append(trainer.state.model)
    assert attn.launch_counts == {
        "flash_fwd": kw["num_layers"], "flash_bwd_dq": kw["num_layers"],
        "flash_bwd_dkv": kw["num_layers"],
    }
    assert abs(losses[0] - losses[1]) < 1e-4
    for (name, p_cpu), p_card in zip(
        models[0].named_parameters(), models[1].parameters()
    ):
        got_grad, got = p_card.grad.cpu(), p_card.detach().cpu()
        torch.testing.assert_close(got_grad, p_cpu.grad, atol=1e-4, rtol=1e-4)
        if name.endswith("attn.key.bias"):
            assert (got - p_cpu.detach()).abs().max() <= 2 * lr, name
        else:
            torch.testing.assert_close(got, p_cpu.detach(), atol=1e-4, rtol=1e-4)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _zoo_step_on_both(module, model_kw, features, labels, weights):
    """One SGD train step of ``module``'s model, from the same seeded
    weights, on the CPU and on the card (TF32 off, f32): returns
    ``(losses, models)``."""
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer

    losses, models = [], []
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        model = module.custom_model(**model_kw)
        trainer = SPMDTrainer(
            model, module.loss, module.optimizer(), device=device,
            device_parse=getattr(module, "device_parse", None),
        )
        place = trainer.place_batch
        metrics = trainer.train_step(place(features), place(labels), place(weights))
        losses.append(float(metrics["loss"]))
        models.append(trainer.state.model)
    return losses, models


def _assert_steps_agree(losses, models, tol):
    assert abs(losses[0] - losses[1]) <= tol * abs(losses[0])
    (cpu, card) = (dict(m.named_parameters()) for m in models)
    for name, p_cpu in cpu.items():
        assert _rel(card[name].grad.cpu(), p_cpu.grad) < tol, name
        assert _rel(card[name].detach().cpu(), p_cpu.detach()) < tol, name
    for name, b_cpu in models[0].named_buffers():
        got = dict(models[1].named_buffers())[name].cpu()
        assert _rel(got, b_cpu) < tol, name


def test_mnist_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One SGD step of mnist, uint8 images parsed on the device, with one
    fixed dropout mask on both devices (their generators draw different
    bits): loss, every gradient, parameter and running statistic within
    1e-4 in relative norm (f32 convolutions on cuDNN against the CPU's,
    TF32 off)."""
    import numpy as np

    from elasticdl_tpu_torch.models import mnist_functional_api as mnist

    rng = np.random.RandomState(0)
    keep = torch.from_numpy(rng.rand(32, 12, 12, 64) >= mnist.DROPOUT_RATE)

    def fixed_dropout(x, rate, generator):
        if generator is None:
            return x
        mask = keep.to(x.device)
        return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))

    monkeypatch.setattr(mnist, "dropout", fixed_dropout)
    images = rng.randint(0, 256, (32, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 32).astype(np.int32)
    weights = np.array([1.0] * 28 + [0.0] * 4, np.float32)
    losses, models = _zoo_step_on_both(mnist, {}, {"image": images}, labels, weights)
    _assert_steps_agree(losses, models, 1e-4)


def test_deepfm_train_step_on_the_card_matches_the_cpu(cuda):
    """One SGD step of DeepFM at full width on 512 rows of int16 ids
    (padding ids and ids past the table among them): loss, every
    gradient and parameter within 1e-5 in relative norm."""
    import numpy as np

    from elasticdl_tpu_torch.models import deepfm_functional_api as deepfm

    rng = np.random.RandomState(1)
    ids = rng.randint(0, 5383, (512, 10))
    ids[:, -2:] = 0
    ids[0, 0], ids[1, 1] = 5504, -1  # masked: no row, no gradient
    labels = rng.randint(0, 2, 512).astype(np.int32)
    weights = np.ones(512, np.float32)
    losses, models = _zoo_step_on_both(
        deepfm, {}, {"feature": ids.astype(np.int16)}, labels, weights
    )
    _assert_steps_agree(losses, models, 1e-5)


def test_native_codec_builds_and_writes_the_python_codecs_bytes(cuda, tmp_path):
    """On the card's machine the codec builds from the checkout (g++ and
    zlib) and writes the files the pure-Python codec writes."""
    from elasticdl_tpu_torch.data import recordio
    from elasticdl_tpu_torch.data.recordio import _pyimpl

    path = recordio.ensure_native_codec()
    assert recordio.native_available() and path.endswith(".so")
    payloads = [b"", b"x" * 1000, bytes(range(256))]
    for name, writer in (("native", recordio.Writer), ("python", _pyimpl.Writer)):
        with writer(str(tmp_path / name)) as w:
            for p in payloads:
                w.write(p)
    assert (tmp_path / "native").read_bytes() == (tmp_path / "python").read_bytes()
    with recordio.Scanner(str(tmp_path / "native")) as scanner:
        assert list(scanner) == payloads
