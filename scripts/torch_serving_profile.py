"""Where one served dispatch of the PyTorch port spends its time, on one
NVIDIA GPU.

::

    python3 scripts/torch_serving_profile.py

Builds the LM that ``chip_smoke.py`` serves (its ``GPT2S`` at ``SEQ``
tokens, seeded random weights, written by its ``build_export``), loads it
into a ``ServingEngine`` with ``SERVE_ROWS`` canonical rows on the card,
warms up, and traces three dispatches (``predict_rows``: pad, host to
device, forward, device to host) under ``torch.profiler``.  Then it
times the copy of one dispatch's logits to the host as the engine makes
it (into pageable memory) against the same copy into a pinned buffer, a
yardstick the engine does not use yet.  Prints the card's name and power
limit, the kernels with the most device time, and as its last line one
JSON object: host wall time per dispatch, device busy time per dispatch
split into the flash kernel, the dense products, copies and the rest,
the device's idle share, and the two copy times.  Fails without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import GPT2S, SEQ, SERVE_ROWS, build_export  # noqa: E402
from torch_profile_split import card, device_split  # noqa: E402

DISPATCHES = 3
# the forward's kernels; the rest falls under "other"
SERVE_CATEGORIES = ("flash_fwd", "copy", "dense_products")


def copy_ms(fn, reps: int = 3) -> float:
    """Median ms of the copy ``fn`` over ``reps`` calls after one
    warm-up, each call between a pair of CUDA events (a copy into
    pageable memory holds the host until it ends, so calls cannot be
    queued back to back)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("CUDA is not available; this profile runs on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from elasticdl_tpu_torch.serving.engine import ServingEngine

    print(card(), flush=True)
    rng = np.random.RandomState(0)
    feats = {
        "tokens": rng.randint(0, GPT2S["vocab_size"], (SERVE_ROWS, SEQ))
        .astype(np.int32)
    }
    with tempfile.TemporaryDirectory(prefix="serving_profile_") as model_dir:
        build_export(model_dir)
        engine = ServingEngine(model_dir, SERVE_ROWS, device="cuda")
        for _ in range(2):
            engine.predict_rows(feats)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(DISPATCHES):
                engine.predict_rows(feats)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3 / DISPATCHES

    logits = torch.empty(
        (SERVE_ROWS, SEQ, GPT2S["vocab_size"]), dtype=torch.bfloat16, device="cuda"
    )
    pinned = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
    pageable_ms = copy_ms(logits.cpu)
    pinned_ms = copy_ms(lambda: pinned.copy_(logits))

    busy_ms, by_category = device_split(
        prof, DISPATCHES, SERVE_CATEGORIES, "dispatch", 15
    )
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "rows": SERVE_ROWS, "seq": SEQ, "layers": GPT2S["num_layers"],
        "wall_ms_per_dispatch": wall_ms,
        "device_busy_ms_per_dispatch": busy_ms,
        "device_ms_by_category": by_category,
        "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "logits_to_pageable_ms": pageable_ms,
        "logits_to_pinned_ms": pinned_ms,
    }), flush=True)
    if not busy_ms:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
