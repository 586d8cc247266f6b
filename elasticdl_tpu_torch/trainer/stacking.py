"""Batch shaping and the per-batch training loop; the counterpart of
``elasticdl_tpu/trainer/stacking.py`` at one step per dispatch.

Every batch is padded to the canonical row count with a 0/1 row mask,
so a task's ragged tail batch is one more masked step of the same shape.
The JAX package's ``--steps_per_dispatch > 1`` (k batches stacked into
one scanned dispatch) and its device prefetch are not ported yet: the
executor refuses those flags when it is built
(``utils/args.py::check_ported_flags``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable

from elasticdl_tpu_torch.utils.tree_utils import batch_rows


def canonical_batch_rows(minibatch_size: int, divisor: int) -> int:
    """THE canonical per-step batch shape: ``minibatch_size`` rounded
    up to the batch divisor, so one padded-and-masked shape serves full
    batches, ragged tails and shard divisibility."""
    div = max(1, int(divisor))
    return max(div, -(-int(minibatch_size) // div) * div)


def run_stacked_steps(
    get_trainer: Callable,
    batches: Iterable,
    canonical_rows: int,
    pre_batch: Callable | None = None,
    post_group: Callable | None = None,
    dispatch_ctx: Callable | None = None,
) -> int:
    """Drive ``batches`` of host ``(features, labels)`` through the
    trainer, one optimizer step each; returns the real records trained.

    ``get_trainer``: called lazily (the runtimes build their trainer on
    the first batch, in ``pre_batch``).  ``pre_batch(features)``: per
    incoming batch.  ``post_group()``: after every step (milestone
    hooks).  ``dispatch_ctx()``: context manager around each step
    (timing buckets).  ``canonical_rows``: every batch is padded to it,
    with a row mask that gives the padding zero weight.
    """
    ctx = dispatch_ctx or contextlib.nullcontext
    processed = 0
    for features, labels in batches:
        if pre_batch is not None:
            pre_batch(features)
        trainer = get_trainer()
        n = batch_rows(labels)
        with ctx():
            trainer.train_step(
                trainer.place_canonical(features, canonical_rows),
                trainer.place_canonical(labels, canonical_rows),
                trainer.place_mask(n, canonical_rows),
            )
        processed += n
        if post_group is not None:
            post_group()
    return processed
