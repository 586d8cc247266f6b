"""Where one training step of the PyTorch port spends its time, on one
NVIDIA GPU.

::

    python3 scripts/torch_train_profile.py

Builds the LM that ``chip_smoke.py`` trains (its ``GPT2S`` at ``SEQ``
tokens, ``TRAIN_ROWS`` canonical rows, seeded random weights) in an
``SPMDTrainer`` on the card, takes two warm-up steps, and traces three
steps under ``torch.profiler``.  Prints the card's name and power limit,
the kernels with the most device time, and as its last line one JSON
object: host wall time per step, device busy time per step split into
the three flash kernels, the dense products, the loss, the optimizer,
copies and the rest, and the device's idle share.  Fails without CUDA.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import GPT2S, SEQ, TRAIN_ROWS  # noqa: E402
from torch_profile_split import CATEGORIES, card, device_split  # noqa: E402

STEPS = 3


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("CUDA is not available; this profile runs on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
    from elasticdl_tpu_torch.trainer.step import resolve_optimizer

    print(card(), flush=True)
    model = lm.custom_model(**GPT2S)
    lm.init_weights(model, torch.Generator().manual_seed(0))
    trainer = SPMDTrainer(model, lm.loss, resolve_optimizer(lm.optimizer))
    tokens = np.random.RandomState(1).randint(
        0, GPT2S["vocab_size"], (TRAIN_ROWS, SEQ + 1)
    ).astype(np.int32)
    batch = (
        trainer.place_batch({"tokens": tokens[:, :-1]}),
        trainer.place_batch(tokens[:, 1:]),
        trainer.place_mask(TRAIN_ROWS, TRAIN_ROWS),
    )
    for _ in range(2):
        float(trainer.train_step(*batch)["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(STEPS):
            trainer.train_step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / STEPS

    busy_ms, by_category = device_split(
        prof, STEPS, tuple(cat for cat, _tags in CATEGORIES), "step", 20
    )
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "rows": TRAIN_ROWS, "seq": SEQ, "layers": GPT2S["num_layers"],
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_ms_by_category": by_category,
        "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
    }), flush=True)
    if not busy_ms:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
