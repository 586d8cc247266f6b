"""What the PyTorch port's profile scripts share: the card's name line,
and a ``torch.profiler`` trace's device time split by kernel category.

Imported by ``scripts/torch_serving_profile.py`` and
``scripts/torch_train_profile.py``; not a script of its own.
"""

from __future__ import annotations

import subprocess

# (category, substrings of a kernel's name), first match wins
CATEGORIES = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("copy", ("memcpy", "memset")),
    # cuBLAS's kernels: nvjet_* (CUDA 12.8+), *gemm*, *xmma*, cutlass_*
    ("dense_products", ("nvjet", "gemm", "xmma", "cutlass")),
    ("optimizer", ("adam", "multi_tensor")),
    ("loss", ("softmax", "nll_loss", "cross_entropy")),
)


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def category(name: str, categories: tuple[str, ...]) -> str:
    """The first of ``categories`` (names from :data:`CATEGORIES`) whose
    substrings ``name`` holds, else ``"other"``."""
    low = name.lower()
    for cat, tags in CATEGORIES:
        if cat in categories and any(tag in low for tag in tags):
            return cat
    return "other"


def device_split(prof, repeats: int, categories: tuple[str, ...], unit: str,
                 top: int) -> tuple[float, dict[str, float]]:
    """Print the ``top`` kernels of a trace of ``repeats`` equal runs by
    device ms per ``unit`` (one run); return the device busy ms per run
    and its split by category."""
    import torch

    by_category: dict[str, float] = {}
    kernels = []
    for avg in prof.key_averages():
        # user annotations (Optimizer.step#...) are ranges over kernels
        # already counted, not device work of their own
        if avg.device_type != torch.autograd.DeviceType.CUDA or getattr(
            avg, "is_user_annotation", False
        ):
            continue
        us = getattr(avg, "device_time_total", None)
        if us is None:
            us = avg.cuda_time_total
        ms = us / 1e3 / repeats
        kernels.append((ms, avg.count // repeats, avg.key))
        cat = category(avg.key, categories)
        by_category[cat] = by_category.get(cat, 0.0) + ms
    kernels.sort(reverse=True)
    for ms, count, name in kernels[:top]:
        print(f"{ms:10.3f} ms/{unit}  x{count:<5d} {name[:110]}", flush=True)
    return sum(by_category.values()), by_category
