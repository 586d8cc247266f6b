"""Attention: the flash-attention kernels for Hopper + dispatch.

The counterpart of ``elasticdl_tpu/ops/attention.py``.  Layout
convention everywhere: ``(batch, seq, heads, head_dim)``.

- :func:`flash_forward` launches the hand-written CUDA kernel
  (``csrc/flash_fwd.cu``, which replaces the TPU kernel ``_flash_kernel``:
  ``wgmma`` and TMA for bf16, CUDA cores for f32) on CUDA tensors and
  returns ``(out, lse)``; on CPU tensors it runs
  :func:`flash_attention_reference`, the plain PyTorch version of the
  same function.
- :func:`flash_backward` launches the two backward kernels
  (``csrc/flash_bwd.cu``, replacing ``_flash_dq_kernel`` and
  ``_flash_dkv_kernel``) on CUDA tensors and returns ``(dq, dk, dv)``;
  on CPU tensors it runs :func:`flash_backward_reference`.
- :func:`flash_attention` ties the two together as a
  ``torch.autograd.Function`` that saves ``(q, k, v, out, lse)``, the
  counterpart of the JAX package's ``custom_vjp``.
- :func:`attention` is the layers' entry point.  This slice is
  single-device: sequence parallelism (ring attention, Ulysses) is not
  ported yet, so there is no ``sp`` mesh to read and it always runs the
  local kernel.

Nothing falls back: a CUDA tensor the kernels do not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import threading

import torch

_NEG_INF = -1e30

# launches of each kernel wrapper, counted where the kernel is launched
# and nowhere else (a run reads them to show its path went through the
# kernel); reset with reset_launch_counts().  A CUDA graph's capture
# records the kernel without launching it, so it is not counted, and
# its replays run no Python: a graph's launches are read from the
# profiler's device trace
launch_counts: dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
}
# two serving replicas in one process launch from two dispatch threads
_launch_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# Debug hook: when set, a worker process writes its launch counts (from
# the process's start) to $ELASTICDL_TPU_DUMP_LAUNCHES/launches_<tag>.json
# as its run ends, since a job's workers are processes of their own
LAUNCH_DUMP_ENV = "ELASTICDL_TPU_DUMP_LAUNCHES"


def dump_launch_counts_if_requested(tag: str) -> None:
    out_dir = os.environ.get(LAUNCH_DUMP_ENV, "")
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"launches_{tag}.json"), "w") as f:
        json.dump(launch_counts, f)


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


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


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
    sm_scale = _default_scale(q, sm_scale)
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
    sm_scale = _default_scale(q, sm_scale)
    scores = _scaled_scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(scores, dim=-1)  # (B, H, Sq)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    batch, heads, seq_q = lse.shape
    return out, lse.reshape(batch * heads, seq_q, 1)


def _backward_terms(q, k, v, out, lse, g, causal, sm_scale):
    """The f32 pieces both backward kernels share, as ``_flash_backward``
    forms them: P rebuilt from the saved ``lse`` (masked entries are
    exactly 0), dS = P * (dO V^T - delta) with delta = rowsum(dO * O),
    and dO, all (B, H, Sq, Sk) or (B, Sq, H, D)."""
    sm_scale = _default_scale(q, sm_scale)
    k, v = repeat_kv_heads(q, k, v)
    batch, seq_q, heads, _ = q.shape
    scores = _scaled_scores(q, k, causal, sm_scale)
    probs = torch.exp(scores - lse.reshape(batch, heads, seq_q, 1))
    g = g.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    delta = (g * out.float()).sum(-1).transpose(1, 2)[..., None]  # (B,H,Sq,1)
    return probs, probs * (dp - delta), g, k, sm_scale


def _dq_from_terms(q, ds, k_rep, sm_scale):
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k_rep.float()) * sm_scale
    return dq.to(q.dtype)


def _dkv_from_terms(q, k, v, p, ds, g, sm_scale):
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    batch, seq_k, kv_heads, d = k.shape
    group = q.shape[2] // kv_heads
    # q head j * group + i belongs to kv head j (repeat_kv_heads' order)
    dk = dk.reshape(batch, seq_k, kv_heads, group, d).sum(3)
    dv = dv.reshape(batch, seq_k, kv_heads, group, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_reference(q, k, v, out, lse, g, causal=False, sm_scale=None):
    """The plain PyTorch version of the dQ kernel: ``dq`` (B, Sq, H, D)
    in q's dtype, from the forward's ``out`` and ``lse`` and the output
    gradient ``g``."""
    _p, ds, _g, k_rep, sm_scale = _backward_terms(
        q, k, v, out, lse, g, causal, sm_scale
    )
    return _dq_from_terms(q, ds, k_rep, sm_scale)


def flash_dkv_reference(q, k, v, out, lse, g, causal=False, sm_scale=None):
    """The plain PyTorch version of the dK/dV kernel: ``(dk, dv)`` at the
    kv-head shape (B, Sk, KVH, D), each GQA group's q heads summed."""
    p, ds, g, _k, sm_scale = _backward_terms(
        q, k, v, out, lse, g, causal, sm_scale
    )
    return _dkv_from_terms(q, k, v, p, ds, g, sm_scale)


def flash_backward_reference(q, k, v, out, lse, g, causal=False, sm_scale=None):
    """``(dq, dk, dv)`` as the two plain versions give them, from one set
    of shared terms."""
    p, ds, g, k_rep, sm_scale = _backward_terms(
        q, k, v, out, lse, g, causal, sm_scale
    )
    dq = _dq_from_terms(q, ds, k_rep, sm_scale)
    return (dq, *_dkv_from_terms(q, k, v, p, ds, g, sm_scale))


# ---- the CUDA kernels ------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the shape arguments every entry point takes after its pointers:
# batch, heads, kv_heads, seq_q, seq_k, head_dim, causal, scale, dtype,
# stream
_SHAPE_ARGS = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _P]


@functools.cache
def _kernel_fn(library: str, name: str, n_pointers: int):
    """The C entry point ``edl_<name>`` of ``csrc/<library>.cu`` and its
    error-string helper, built and bound at first launch."""
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load(library)
    fn = getattr(lib, f"edl_{name}")
    fn.argtypes = [_P] * n_pointers + _SHAPE_ARGS
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


def _launch(name, library, tensors, q, k, causal, sm_scale):
    """Launch kernel ``name`` of ``csrc/<library>.cu`` on the current
    stream with ``tensors`` as its pointer arguments; raise if the launch
    fails, else count it (unless a CUDA graph is being captured, which
    records the kernel and launches nothing)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    batch, seq_q, heads, head_dim = q.shape
    seq_k, kv_heads = k.shape[1], k.shape[2]
    fn, error_string = _kernel_fn(library, name, len(tensors))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in tensors),
            batch, heads, kv_heads, seq_q, seq_k, head_dim,
            int(bool(causal)), float(sm_scale), _KERNEL_DTYPES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {error_string(err).decode()} ({err})"
        )
    if not torch.cuda.is_current_stream_capturing():
        with _launch_count_lock:
            launch_counts[name] += 1


def _flash_forward_cuda(q, k, v, causal: bool, sm_scale: float):
    _check_kernel_inputs(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    batch, seq_q, heads, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(
        (batch * heads, seq_q, 1), dtype=torch.float32, device=q.device
    )
    _launch(
        "flash_fwd", "flash_fwd", (q, k, v, out, lse), q, k, causal, sm_scale,
    )
    return out, lse


def _backward_inputs(q, k, v, out, lse, g):
    """Check what the backward kernels take; return contiguous
    ``(q, k, v, g, lse, delta)`` with delta = rowsum(dO * O) in f32,
    (B*H, Sq), computed here as the JAX package computes it outside its
    kernels."""
    _check_kernel_inputs(q, k, v)
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(
                f"{name} is {tuple(t.shape)} on {t.device}; q is "
                f"{tuple(q.shape)} on {q.device}"
            )
    batch, seq_q, heads, _ = q.shape
    if lse.shape != (batch * heads, seq_q, 1) or lse.dtype != torch.float32:
        raise ValueError(
            f"lse must be f32 {(batch * heads, seq_q, 1)}, got "
            f"{lse.dtype} {tuple(lse.shape)}"
        )
    g = g.to(q.dtype).contiguous()
    q, k, v, lse = (t.contiguous() for t in (q, k, v, lse))
    return q, k, v, g, lse, _delta(g, out)


def _delta(g, out):
    """delta = rowsum(dO * O) in f32, (B*H, Sq) from (B, Sq, H, D)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd_dq(q, k, v, g, lse, delta, causal, sm_scale):
    dq = torch.empty_like(q)
    _launch(
        "flash_bwd_dq", "flash_bwd", (q, k, v, g, lse, delta, dq),
        q, k, causal, sm_scale,
    )
    return dq


def _launch_bwd_dkv(q, k, v, g, lse, delta, causal, sm_scale):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(
        "flash_bwd_dkv", "flash_bwd", (q, k, v, g, lse, delta, dk, dv),
        q, k, causal, sm_scale,
    )
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, out, lse, g, causal: bool, sm_scale: float):
    return _launch_bwd_dq(
        *_backward_inputs(q, k, v, out, lse, g), causal, sm_scale
    )


def _flash_bwd_dkv_cuda(q, k, v, out, lse, g, causal: bool, sm_scale: float):
    return _launch_bwd_dkv(
        *_backward_inputs(q, k, v, out, lse, g), causal, sm_scale
    )


def _flash_backward_cuda(q, k, v, out, lse, g, causal: bool, sm_scale: float):
    """Both backward kernels on one set of checked inputs and one delta."""
    inputs = _backward_inputs(q, k, v, out, lse, g)
    dq = _launch_bwd_dq(*inputs, causal, sm_scale)
    dk, dv = _launch_bwd_dkv(*inputs, causal, sm_scale)
    return dq, dk, dv


def _dispatch(kernel, plain, q, k, v, causal, sm_scale, *rest):
    """``kernel`` for CUDA tensors, ``plain`` for CPU ones; raise on any
    other device.  Both take ``(q, k, v, *rest, causal, sm_scale)``."""
    validate_gqa_heads(q, k, v)
    sm_scale = _default_scale(q, sm_scale)
    if q.device.type == "cuda":
        return kernel(q, k, v, *rest, causal, sm_scale)
    if q.device.type == "cpu":
        return plain(q, k, v, *rest, causal, sm_scale)
    raise ValueError(f"flash attention has no path for device {q.device}")


def flash_forward(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Flash-attention forward, (B, S, H, D) layout: ``(out, lse)`` as
    :func:`flash_attention_reference` returns them.  CUDA tensors go
    through the Hopper kernel; CPU tensors through the plain version."""
    return _dispatch(
        _flash_forward_cuda, flash_attention_reference, q, k, v, causal,
        sm_scale,
    )


def flash_bwd_dq(q, k, v, out, lse, g, causal: bool = False, sm_scale=None):
    """dQ of flash attention, as :func:`flash_dq_reference` returns it:
    the Hopper kernel for CUDA tensors, the plain version for CPU ones."""
    return _dispatch(
        _flash_bwd_dq_cuda, flash_dq_reference, q, k, v, causal, sm_scale,
        out, lse, g,
    )


def flash_bwd_dkv(q, k, v, out, lse, g, causal: bool = False, sm_scale=None):
    """``(dk, dv)`` of flash attention at the kv-head shape, as
    :func:`flash_dkv_reference` returns them: the Hopper kernel for CUDA
    tensors, the plain version for CPU ones."""
    return _dispatch(
        _flash_bwd_dkv_cuda, flash_dkv_reference, q, k, v, causal, sm_scale,
        out, lse, g,
    )


def flash_backward(
    q, k, v, out, lse, g, causal: bool = False, sm_scale: float | None = None
):
    """Flash-attention backward: ``(dq, dk, dv)`` from the forward's
    ``(q, k, v, out, lse)`` and the output gradient ``g``.  CUDA tensors
    go through both kernels, which share one delta; CPU tensors through
    :func:`flash_backward_reference`."""
    return _dispatch(
        _flash_backward_cuda, flash_backward_reference, q, k, v, causal,
        sm_scale, out, lse, g,
    )


class _FlashAttention(torch.autograd.Function):
    """The forward saves ``(q, k, v, out, lse)``; the backward rebuilds
    the probabilities from ``lse`` (FlashAttention-2), so neither
    direction keeps an (S, S) score matrix.  Both directions dispatch
    through :func:`flash_forward` / :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Blockwise flash attention, (B, S, H, D) layout: the output only,
    differentiable through the backward kernels."""
    validate_gqa_heads(q, k, v)
    return _FlashAttention.apply(q, k, v, causal, _default_scale(q, sm_scale))


# ---- dispatch --------------------------------------------------------------


def attention(q, k, v, causal: bool = False, sm_scale: float | None = None):
    """Self-attention entry point for layers: the local flash kernel
    (sequence parallelism is not in this slice of the port)."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
