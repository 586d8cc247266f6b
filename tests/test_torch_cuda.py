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


# ---- k steps as one CUDA graph replay ---------------------------------------


def _stacked_groups(make_features, rows, k, groups, seed=0):
    """``groups`` host groups ``(features, labels, weights)`` of ``k``
    canonical batches; the last step of the last group carries 3
    zero-weight padding rows."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(groups):
        features, labels = make_features(rng, k * rows)
        weights = np.ones((k, rows), np.float32)
        out.append((
            {n: v.reshape((k, rows) + v.shape[1:]) for n, v in features.items()},
            labels.reshape((k, rows) + labels.shape[1:]), weights,
        ))
    out[-1][2][-1, -3:] = 0.0
    return out


def _graph_against_eager(make_trainer, groups, k):
    """The groups through ``train_steps_stacked`` on one trainer (the
    first eager, the second captured, all replayed) and as single steps
    on another from the same start: their states after each group.  The
    eager trainer's optimizer is made capturable as the graph trainer's
    first group makes its own (capturable Adam computes its bias
    correction on the card, in other roundings than on the host)."""
    from elasticdl_tpu_torch.trainer.state import make_capturable
    from elasticdl_tpu_torch.utils.tree_utils import map_tree

    graph, eager = make_trainer(), make_trainer()
    make_capturable(eager.state.optimizer, eager.device)
    for group in groups:
        graph.train_steps_stacked(*graph.place_group(*group))
        for j in range(k):
            eager.train_step(*(eager.place_batch(map_tree(lambda x: x[j], t)) for t in group))
    torch.cuda.synchronize()
    assert graph.dispatch_counts == {
        "single_steps": 0, "eager_groups": 1, "graph_captures": 1,
        "graph_replays": len(groups) - 1,
    }
    assert graph.step == eager.step == k * len(groups)
    return graph, eager


def _assert_same_state(a, b):
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    for name, value in sb.items():
        torch.testing.assert_close(sa[name], value, atol=0, rtol=0, msg=name)


def test_mnist_graph_replays_equal_eager_steps_with_dropout(cuda, monkeypatch):
    """mnist's dropout (drawn per step from the step's generator, which
    the graph reseeds before each replay) and BatchNorm statistics: a
    replayed group of 3 is 3 eager steps, bit for bit (cuDNN held to its
    deterministic algorithms, on both sides)."""
    import numpy as np

    from elasticdl_tpu_torch.models import mnist_functional_api as mnist

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)

    def make_trainer():
        torch.manual_seed(0)
        return SPMDTrainer(
            mnist.custom_model(), mnist.loss, mnist.optimizer(),
            compute_dtype=torch.bfloat16, device="cuda", device_parse=mnist.device_parse,
        )

    def features(rng, n):
        return (
            {"image": rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)},
            rng.randint(0, 10, n).astype(np.int32),
        )

    groups = _stacked_groups(features, 32, 3, 4)
    graph, eager = _graph_against_eager(make_trainer, groups, 3)
    _assert_same_state(graph, eager)
    # the replays drew their masks: a graph with a frozen seed would give
    # the eager steps' first group's masks again, and other weights
    assert not torch.equal(graph.state.model.dense.weight, make_trainer().state.model.dense.weight)


def test_deepfm_graph_replays_equal_eager_steps(cuda):
    import numpy as np

    from elasticdl_tpu_torch.models import deepfm_functional_api as deepfm

    def make_trainer():
        torch.manual_seed(0)
        return SPMDTrainer(
            deepfm.custom_model(), deepfm.loss, deepfm.optimizer(), device="cuda",
        )

    def features(rng, n):
        ids = rng.randint(0, 5383, (n, 10))
        ids[:, -2:] = 0
        return {"feature": ids.astype(np.int16)}, rng.randint(0, 2, n).astype(np.int32)

    graph, eager = _graph_against_eager(make_trainer, _stacked_groups(features, 256, 4, 4), 4)
    _assert_same_state(graph, eager)


def _lm_trainer(schedule=None, remat=False):
    """A small bf16 LM through the flash kernels, Adam with
    ``schedule`` as its learning_rate_scheduler (``build_optimizer``'s
    hook, a tensor lr on the card)."""
    import types

    from elasticdl_tpu_torch.trainer.local_executor import build_optimizer

    model = lm.custom_model(vocab_size=101, embed_dim=128, num_heads=2, num_layers=2, dtype="bfloat16")
    lm.init_weights(model, torch.Generator().manual_seed(0))
    spec = types.SimpleNamespace(optimizer=lm.optimizer, learning_rate_scheduler=schedule)
    return SPMDTrainer(
        model, lm.loss, build_optimizer(spec), compute_dtype=torch.bfloat16,
        device="cuda", remat=remat,
    )


def _lm_features(rng, n):
    tokens = rng.randint(0, 101, (n, 129)).astype("int32")
    return {"tokens": tokens[:, :-1]}, tokens[:, 1:]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_lm_graph_replays_equal_eager_steps_with_a_scheduled_lr(cuda, remat):
    """Trap (c): every replayed step reads its own scheduled lr from the
    card (Adam, capturable), so a group of 4 is 4 eager steps, bit for
    bit, with the flash kernels in the graph (and their forward run
    twice per step with remat)."""
    def schedule(count):
        return 1e-3 * (1 + count % 3)

    groups = _stacked_groups(_lm_features, 4, 4, 3)
    graph, eager = _graph_against_eager(lambda: _lm_trainer(schedule, remat), groups, 4)
    _assert_same_state(graph, eager)
    lr = graph.state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and float(lr) == pytest.approx(schedule(11))
    assert graph.state.optimizer.lr_schedule.updates == 12


def test_single_steps_keep_the_optimizer_until_the_first_group(cuda):
    """A single step runs the optimizer as built (host lr, host step
    counts); the first stacked group makes it capturable, its step counts
    moved to the card, and the graph that follows equals eager steps.
    The wrappers count the launches of eager steps only: the capture
    launches nothing, and a replay runs no Python."""
    from elasticdl_tpu_torch.trainer.state import make_capturable
    from elasticdl_tpu_torch.utils.tree_utils import map_tree

    def schedule(count):
        return 1e-3 * (1 + count % 3)

    groups = _stacked_groups(_lm_features, 4, 4, 3, seed=2)
    graph, eager = _lm_trainer(schedule), _lm_trainer(schedule)
    first = tuple(map_tree(lambda x: x[0], t) for t in groups[0])
    for trainer in (graph, eager):
        trainer.train_step(*(trainer.place_batch(x) for x in first))
    group = graph.state.optimizer.param_groups[0]
    assert group["capturable"] is False and not isinstance(group["lr"], torch.Tensor)
    make_capturable(eager.state.optimizer, eager.device)
    attn.reset_launch_counts()
    for stacked in groups:
        graph.train_steps_stacked(*graph.place_group(*stacked))
    launches = dict(attn.launch_counts)
    for stacked in groups:
        for j in range(4):
            eager.train_step(*(eager.place_batch(map_tree(lambda x: x[j], t)) for t in stacked))
    torch.cuda.synchronize()
    assert group["capturable"] is True and isinstance(group["lr"], torch.Tensor)
    assert all(s["step"].is_cuda for s in graph.state.optimizer.state.values())
    assert graph.dispatch_counts == {
        "single_steps": 1, "eager_groups": 1, "graph_captures": 1, "graph_replays": 2,
    }
    _assert_same_state(graph, eager)
    # 2 layers, 4 eager steps (the first group)
    assert launches == {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}


def test_restore_after_capture_is_what_the_next_replay_trains(cuda):
    """Trap (e): a restore copies into the tensors the graph captured, so
    the next replay trains the restored weights."""
    from elasticdl_tpu_torch.trainer.state import checkpoint_to_state, state_to_checkpoint
    from elasticdl_tpu_torch.utils.tree_utils import map_tree

    groups = _stacked_groups(_lm_features, 4, 4, 4, seed=1)
    start = state_to_checkpoint(_lm_trainer().state)
    graph, eager = _graph_against_eager(_lm_trainer, groups[:3], 4)
    for trainer in (graph, eager):
        checkpoint_to_state(trainer.state, start)
    graph.train_steps_stacked(*graph.place_group(*groups[3]))
    for j in range(4):
        eager.train_step(*(eager.place_batch(map_tree(lambda x: x[j], t)) for t in groups[3]))
    assert graph.dispatch_counts["graph_replays"] == 3
    # against a trainer with the same history (Adam's moments carry on),
    # restored the same way: a graph still reading the tensors a restore
    # replaced would leave the model's weights where the restore put them
    _assert_same_state(graph, eager)


def test_sgd_with_a_scheduled_lr_is_refused_on_the_graph_path(cuda):
    """SGD reads its lr on the host, which a graph would freeze: the
    capture refuses it, loudly."""
    import types

    import numpy as np

    from elasticdl_tpu_torch.models import deepfm_functional_api as deepfm
    from elasticdl_tpu_torch.trainer.local_executor import build_optimizer

    spec = types.SimpleNamespace(
        optimizer=deepfm.optimizer, learning_rate_scheduler=lambda count: 0.1
    )
    trainer = SPMDTrainer(deepfm.custom_model(), deepfm.loss, build_optimizer(spec), device="cuda")
    rng = np.random.RandomState(0)
    group = (
        {"feature": rng.randint(0, 5383, (2, 64, 10)).astype(np.int16)},
        rng.randint(0, 2, (2, 64)).astype(np.int32), np.ones((2, 64), np.float32),
    )
    trainer.train_steps_stacked(*trainer.place_group(*group))
    with pytest.raises(NotImplementedError, match="scheduled lr"):
        trainer.train_steps_stacked(*trainer.place_group(*group))


def test_a_failed_capture_raises_and_never_falls_back(cuda):
    """A step that reads the card from the host cannot be captured: the
    second group raises, and no eager step stands in for the graph."""
    import numpy as np

    class Syncing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

        def forward(self, features, training=False, generator=None):
            x = features["x"]
            if float(x.sum()) > 1e30:  # a host read of a device value
                x = x * 0
            return x * self.w

    trainer = SPMDTrainer(
        Syncing(), lambda labels, out: ((out - labels) ** 2).mean(),
        lambda params: torch.optim.SGD(params, lr=0.1), device="cuda",
    )
    group = (
        {"x": np.ones((2, 8, 4), np.float32)}, np.zeros((2, 8, 4), np.float32),
        np.ones((2, 8), np.float32),
    )
    trainer.train_steps_stacked(*trainer.place_group(*group))
    with pytest.raises(RuntimeError):
        trainer.train_steps_stacked(*trainer.place_group(*group))
    assert trainer.dispatch_counts["graph_replays"] == 0
    assert trainer.step == 2  # the failed group took no step
