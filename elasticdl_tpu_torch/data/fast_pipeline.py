"""The vectorized task pipeline: scanner chunks -> native batch decode ->
windowed numpy shuffle -> sliced minibatches; the counterpart of
``elasticdl_tpu/data/fast_pipeline.py``.

The classic pipeline (``dataset.batched_model_pipeline``) moves every
record through a chain of Python generators (read -> shuffle buffer ->
batch grouping -> decode), a few microseconds of interpreter work per
record.  Here the per-record work makes no Python object:

- the EDLIO scanner fills one reusable buffer with a few thousand
  concatenated payloads per FFI call (``read_record_chunks``),
- ``decode_concat_batch`` decodes that buffer straight into ``(N, ...)``
  batch arrays, in C,
- shuffling is a numpy row permutation over a decode window (up to
  ``_WINDOW_BYTES`` of decoded rows, typically the whole task), and
  minibatches are array slices.

The model's ``batch_parse(example_batch, mode)`` then maps raw columns to
``(features, labels)`` as in the classic path.  Under
``--steps_per_dispatch k`` (``stack_k``) runs of k full batches leave as
one ``PreStacked`` group, parsed once over the k*B rows and viewed
``(k, B, ...)``.

Eligibility is probed, not assumed: the first chunk must decode natively
(one schema, wire-format dtypes).  If it does not, or the model has no
``batch_parse``, or the reader no ``read_record_chunks``,
:func:`build_task_batches` gives the classic pipeline.  The native codec
itself is no condition: ``read_record_chunks`` builds it, or raises.

Shuffle: the module's ``batch_shuffle = (buffer, seed)`` policy seeds a
numpy permutation over each window, a pure function of the seed and the
task's records, so the JAX package's vectorized path gives the same
batches.  The batch count is the classic path's (full batches and one
final partial).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from elasticdl_tpu_torch.data.dataset import (
    DEFAULT_SHUFFLE_POLICY,
    Dataset,
    batched_model_pipeline,
)
from elasticdl_tpu_torch.data.reader import decode_concat_batch, decode_example
from elasticdl_tpu_torch.utils.tree_utils import map_tree, tree_leaves

# decode window cap: decoded rows accumulate up to this many bytes before
# a shuffle-and-emit flush
_WINDOW_BYTES = 64 << 20

# the minibatches of batch_parse models, by the path that made them, in
# this process; reset with reset_path_counts()
path_counts: dict[str, int] = {"vectorized": 0, "classic": 0}


def reset_path_counts() -> None:
    for path in path_counts:
        path_counts[path] = 0


class FallbackNeeded(Exception):
    """The first chunk failed the native decode probe (schema drift,
    sparse frames): take the classic per-record path."""


def _vectorized_task_batches(
    reader,
    task,
    batch_parse,
    mode,
    batch_size: int,
    shuffle_seed: int | None,
    window_bytes: int = _WINDOW_BYTES,
    stack_k: int | str | None = None,
    stack_divisor: int = 1,
    dispatch_device="cuda",
) -> Iterator:
    """Yield parsed minibatches of ``task``'s records.  Raises
    :class:`FallbackNeeded` before the first yield if the first chunk
    does not decode natively.

    ``stack_k`` (training): emit runs of ``stack_k`` full batches as
    :class:`~elasticdl_tpu_torch.trainer.stacking.PreStacked` groups,
    ``batch_parse`` applied once over the k*B rows and the result
    reshaped ``(k, B, ...)`` (``batch_parse`` is row-wise, so the rows'
    grouping is free).  ``"auto"`` sizes k from one parsed batch's bytes
    and the measured dispatch overhead of ``dispatch_device``
    (``stacking.auto_steps_per_dispatch``).  Needs ``batch_size``
    divisible by ``stack_divisor``; leftover full batches and the final
    partial batch are emitted plain."""
    if stack_k is not None and stack_k != "auto" and stack_k < 2:
        stack_k = None
    if stack_k is not None and batch_size % max(1, stack_divisor):
        stack_k = None
    chunks = reader.read_record_chunks(task)
    first = next(iter(chunks), None)
    if first is None:
        return
    buf, lengths = first
    template = decode_example(bytes(memoryview(buf)[: int(lengths[0])]))
    decoded = decode_concat_batch(buf, lengths, template)
    if decoded is None:
        raise FallbackNeeded(task.shard_name)

    row_bytes = max(1, sum(v.nbytes for v in template.values()))
    window_rows = max(batch_size, window_bytes // row_bytes)
    rng = (
        np.random.RandomState(shuffle_seed)
        if shuffle_seed is not None
        else None
    )

    if stack_k is not None:
        # one parsed batch: a parse without labels (prediction) cannot
        # group, and its wire bytes size an auto k
        n0 = min(batch_size, int(len(lengths)))
        sample = batch_parse({k: v[:n0] for k, v in decoded.items()}, mode)
        if not isinstance(sample, tuple):
            stack_k = None
        elif stack_k == "auto":
            from elasticdl_tpu_torch.trainer.stacking import (
                auto_steps_per_dispatch,
                measured_dispatch_overhead,
            )

            sample_bytes = sum(np.asarray(x).nbytes for x in tree_leaves(sample))
            stack_k = auto_steps_per_dispatch(
                int(sample_bytes / max(1, n0) * batch_size),
                measured_dispatch_overhead(dispatch_device),
            )
            if stack_k < 2:
                stack_k = None

    window: list[dict] = [decoded]
    pending = int(len(lengths))
    carry: dict | None = None

    def _flush(final: bool):
        nonlocal window, pending, carry
        parts = ([carry] if carry else []) + window
        window, pending = [], 0
        if not parts:
            return
        if len(parts) == 1:
            merged = parts[0]
        else:
            merged = {
                k: np.concatenate([p[k] for p in parts]) for k in parts[0]
            }
        n = len(next(iter(merged.values())))
        if rng is not None:
            perm = rng.permutation(n)
            merged = {k: v[perm] for k, v in merged.items()}
        full = n // batch_size * batch_size
        lo = 0
        if stack_k is not None:
            from elasticdl_tpu_torch.trainer.stacking import PreStacked

            # a window of fewer than k full batches still groups: one
            # PreStacked of the full batches it holds
            k_eff = min(stack_k, full // batch_size)
            group_rows = k_eff * batch_size
            while k_eff >= 2 and full - lo >= group_rows:
                feats, labels = batch_parse(
                    {k: v[lo : lo + group_rows] for k, v in merged.items()}, mode
                )
                feats, labels = (
                    map_tree(lambda a: a.reshape((k_eff, batch_size) + a.shape[1:]), t)
                    for t in (feats, labels)
                )
                yield PreStacked(
                    feats, labels, group_rows, map_tree(lambda a: a[0], feats)
                )
                lo += group_rows
        for lo in range(lo, full, batch_size):
            yield batch_parse(
                {k: v[lo : lo + batch_size] for k, v in merged.items()},
                mode,
            )
        if full < n:
            tail = {k: v[full:] for k, v in merged.items()}
            if final:
                yield batch_parse(tail, mode)
                carry = None
            else:
                carry = tail
        else:
            carry = None

    for buf, lengths in chunks:
        # schema drift mid-task cannot fall back (batches were already
        # yielded; a restart would train records twice): surface it
        decoded = decode_concat_batch(buf, lengths, template)
        if decoded is None:
            raise RuntimeError(
                f"record schema changed mid-shard in {task.shard_name} "
                f"[{task.start}, {task.end}): the vectorized decoder "
                "requires a uniform schema per shard"
            )
        window.append(decoded)
        pending += int(len(lengths))
        if pending >= window_rows:
            yield from _flush(final=False)
    yield from _flush(final=True)


def _batches_in(item) -> int:
    """The minibatches an item of the stream holds: k for a PreStacked
    group, else 1."""
    return getattr(item, "num_steps", 1)


def _shuffle_policy(spec, shuffle_records: bool) -> int | None:
    """None = no shuffle; else the permutation seed (the module-owned
    ``batch_shuffle`` policy, the classic batched path's contract)."""
    if not shuffle_records:
        return None
    policy = getattr(
        getattr(spec, "module", None),
        "batch_shuffle",
        DEFAULT_SHUFFLE_POLICY,
    )
    if policy is None:
        return None
    _buffer, seed = policy
    return int(seed)


def build_task_batches(
    reader,
    task,
    spec,
    mode,
    metadata,
    batch_size: int,
    shuffle_records: bool = False,
    prefetch: int = 0,
    stack_k: int | str | None = None,
    stack_divisor: int = 1,
    dispatch_device="cuda",
) -> Dataset:
    """THE task -> minibatch-stream chooser of the per-task runtimes:
    the vectorized path when the model defines ``batch_parse`` and the
    reader exposes raw chunks, the classic ``batched_model_pipeline``
    otherwise (and, through the first-chunk probe, for data the native
    decoder cannot batch).  A :class:`Dataset` either way, so a task can
    be re-iterated.  ``stack_k``, ``stack_divisor`` and
    ``dispatch_device``: the vectorized path's ``PreStacked`` groups
    (:func:`_vectorized_task_batches`); the classic path emits plain
    batches, which ``run_stacked_steps`` groups."""
    batch_parse = getattr(spec, "batch_parse", None)
    chunk_reader = getattr(reader, "read_record_chunks", None)

    def classic(prefetch_n: int = prefetch) -> Dataset:
        return batched_model_pipeline(
            Dataset.from_generator(lambda: reader.read_records(task)),
            spec,
            mode,
            metadata,
            batch_size,
            shuffle_records=shuffle_records,
            prefetch=prefetch_n,
        )

    if batch_parse is None or chunk_reader is None:
        return classic()
    seed = _shuffle_policy(spec, shuffle_records)

    def gen():
        fast = _vectorized_task_batches(
            reader, task, batch_parse, mode, batch_size, seed,
            stack_k=stack_k, stack_divisor=stack_divisor,
            dispatch_device=dispatch_device,
        )
        try:
            first = next(fast)
        except (FallbackNeeded, StopIteration):
            # the probe failed (or the task is empty): the same records
            # through the classic path, nothing yielded yet.  The outer
            # prefetch below already buffers, so no inner one
            for batch in classic(prefetch_n=0):
                path_counts["classic"] += 1
                yield batch
            return
        path_counts["vectorized"] += _batches_in(first)
        yield first
        for batch in fast:
            path_counts["vectorized"] += _batches_in(batch)
            yield batch

    out = Dataset(gen)
    if prefetch:
        # the eval and predict loops consume on the main thread; training
        # overlaps one level up (TaskPrefetcher)
        out = out.prefetch(prefetch)
    return out
