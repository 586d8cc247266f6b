"""Attention: the flash-attention forward kernel for Hopper + dispatch.

The counterpart of ``elasticdl_tpu/ops/attention.py``.  Layout
convention everywhere: ``(batch, seq, heads, head_dim)``.

- :func:`flash_forward` launches the hand-written CUDA kernel
  (``csrc/flash_fwd.cu``, which replaces the TPU kernel ``_flash_kernel``)
  on CUDA tensors and returns ``(out, lse)``; on CPU tensors it runs
  :func:`flash_attention_reference`, the plain PyTorch version of the
  same function.  Nothing falls back: a CUDA tensor the kernel does not
  take raises.
- :func:`attention` is the layers' entry point.  This slice is
  single-device: sequence parallelism (ring attention, Ulysses) is not
  ported yet, so there is no ``sp`` mesh to read and it always runs the
  local kernel.

The backward kernels (dQ, dK/dV) come with the training slice; until
then a CUDA tensor that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_NEG_INF = -1e30

# launches of each kernel wrapper, counted where the kernel is launched
# and nowhere else (a run reads them to show its path went through the
# kernel); reset with reset_launch_counts()
launch_counts: dict[str, int] = {"flash_fwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---- reference (plain PyTorch) ---------------------------------------------


def validate_gqa_heads(q, k, v) -> int:
    """The grouped-query head constraint: K and V must agree, and q heads
    must be a multiple of kv heads.  Returns the group factor (1 = plain
    MHA)."""
    q_heads, kv_heads = q.shape[2], k.shape[2]
    if v.shape[2] != kv_heads:
        raise ValueError(
            f"k and v head counts differ: {kv_heads} vs {v.shape[2]}"
        )
    if kv_heads <= 0 or q_heads % kv_heads:
        raise ValueError(
            f"GQA needs q heads ({q_heads}) divisible by kv heads "
            f"({kv_heads})"
        )
    return q_heads // kv_heads


def repeat_kv_heads(q, k, v):
    """Repeat each KV head over its query group so the caller can treat
    heads uniformly (kv head ``j`` serves q heads ``j*group ..``)."""
    group = validate_gqa_heads(q, k, v)
    if group == 1:
        return k, v
    return (
        k.repeat_interleave(group, dim=2),
        v.repeat_interleave(group, dim=2),
    )


def _scaled_scores(q, k, causal, sm_scale):
    """f32 scores ``sm_scale * q . k`` (B, H, Sq, Sk), causal-masked with
    the TPU kernel's -1e30 in global positions (row >= col)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        row = torch.arange(s_q, device=q.device)[:, None]
        col = torch.arange(s_k, device=q.device)[None, :]
        scores = scores.masked_fill(row < col, _NEG_INF)
    return scores


def mha_reference(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Plain multi-head attention, (B, S, H, D) layout (K/V may carry
    fewer heads — GQA); the numerical oracle."""
    k, v = repeat_kv_heads(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    probs = torch.softmax(_scaled_scores(q, k, causal, sm_scale), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_reference(
    q, k, v, causal: bool = False, sm_scale: float | None = None
):
    """The plain PyTorch version of the flash kernel: ``(out, lse)`` with
    ``out`` (B, Sq, H, D) in q's dtype and ``lse`` (B*H, Sq, 1) f32, the
    row logsumexp of the SCALED scores, exactly as the TPU kernel writes
    it (the backward rebuilds probabilities from it)."""
    k, v = repeat_kv_heads(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _scaled_scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(scores, dim=-1)  # (B, H, Sq)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    batch, heads, seq_q = lse.shape
    return out, lse.reshape(batch * heads, seq_q, 1)


# ---- the CUDA kernel -------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


@functools.cache
def _flash_fwd_fn():
    """The kernel's C entry point and the error-string helper, built and
    bound at first launch."""
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.edl_flash_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,  # out, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # batch, heads, kv_heads
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # seq_q, seq_k, head_dim
        ctypes.c_int, ctypes.c_float, ctypes.c_int,  # causal, scale, dtype
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.edl_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.edl_cuda_error_string


def _check_kernel_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "the flash-attention backward kernels are not ported yet: "
                f"{name} requires grad on CUDA"
            )
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16, got {q.dtype}"
        )
    batch, seq_q, _heads, head_dim = q.shape
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash kernel takes head_dim in {_KERNEL_HEAD_DIMS}, got {head_dim}"
        )
    if k.shape[0] != batch or k.shape[3] != head_dim or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if seq_q == 0 or k.shape[1] == 0:
        raise ValueError("flash kernel needs non-empty sequences")


def _flash_forward_cuda(q, k, v, causal: bool, sm_scale: float):
    _check_kernel_inputs(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    batch, seq_q, heads, head_dim = q.shape
    seq_k, kv_heads = k.shape[1], k.shape[2]
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash kernel needs 16-byte aligned inputs")
    out = torch.empty_like(q)
    lse = torch.empty(
        (batch * heads, seq_q, 1), dtype=torch.float32, device=q.device
    )
    fn, error_string = _flash_fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            batch, heads, kv_heads, seq_q, seq_k, head_dim,
            int(bool(causal)), float(sm_scale), _KERNEL_DTYPES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {error_string(err).decode()} ({err})"
        )
    launch_counts["flash_fwd"] += 1
    return out, lse


def flash_forward(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Flash-attention forward, (B, S, H, D) layout: ``(out, lse)`` as
    :func:`flash_attention_reference` returns them.  CUDA tensors go
    through the Hopper kernel; CPU tensors through the plain version."""
    validate_gqa_heads(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale)
    raise ValueError(f"flash attention has no path for device {q.device}")


def flash_attention(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Blockwise flash attention, (B, S, H, D) layout: the output only."""
    return flash_forward(q, k, v, causal, sm_scale)[0]


# ---- dispatch --------------------------------------------------------------


def attention(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Self-attention entry point for layers: the local flash kernel
    (sequence parallelism is not in this slice of the port)."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
