"""Numpy dataset pipeline with threaded prefetch; a copy of
``elasticdl_tpu/data/dataset.py``.

A small composable pipeline (``dataset_fn(ds, mode, metadata)`` then
``.batch().prefetch()``) that produces host numpy batches, which the
trainer places on the device.  Transformations are lazy; each
``__iter__`` restarts from the source, so a dataset built over a task's
record range can be re-consumed on retry.

The model-zoo ``dataset_fn(dataset, mode, metadata)`` contract operates on
this class: readers produce raw records, ``map`` decodes them, the worker
applies ``batch``/``prefetch``.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np


def _stack(elements: list):
    """Stack a list of pipeline elements into one batched element.

    Handles dicts (by key), tuples/lists (by position), scalars and
    ndarrays (np.stack).
    """
    first = elements[0]
    if isinstance(first, dict):
        return {k: _stack([e[k] for e in elements]) for k in first}
    if isinstance(first, (tuple, list)):
        cols = [_stack([e[i] for e in elements]) for i in range(len(first))]
        return tuple(cols) if isinstance(first, tuple) else cols
    return np.stack([np.asarray(e) for e in elements])


class Dataset:
    def __init__(self, source: Callable[[], Iterator]):
        self._source = source

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def from_generator(gen_factory: Callable[[], Iterable]) -> "Dataset":
        return Dataset(lambda: iter(gen_factory()))

    # ---- transformations --------------------------------------------------

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        parent = self._source
        return Dataset(lambda: (fn(x) for x in parent()))

    def filter(self, predicate: Callable[[Any], bool]) -> "Dataset":
        parent = self._source
        return Dataset(lambda: (x for x in parent() if predicate(x)))

    def shuffle(self, buffer_size: int, seed: int | None = None) -> "Dataset":
        parent = self._source

        def gen():
            rng = random.Random(seed)
            buf: list = []
            for x in parent():
                buf.append(x)
                if len(buf) >= buffer_size:
                    idx = rng.randrange(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return Dataset(gen)

    def batch(
        self, batch_size: int, drop_remainder: bool = False
    ) -> "Dataset":
        # one grouping loop (batch_list) serves both the stacked and the
        # raw-list batch APIs, so remainder semantics cannot diverge
        ds = self.batch_list(batch_size)
        if drop_remainder:
            ds = ds.filter(lambda acc: len(acc) == batch_size)
        return ds.map(_stack)

    def batch_list(self, batch_size: int) -> "Dataset":
        """Group elements into plain lists WITHOUT stacking — the raw
        half of the fused decode+batch fast path (the list feeds one
        native ``decode_example_batch`` call)."""
        parent = self._source

        def gen():
            acc: list = []
            for x in parent():
                acc.append(x)
                if len(acc) == batch_size:
                    yield acc
                    acc = []
            if acc:
                yield acc

        return Dataset(gen)

    def prefetch(self, buffer_size: int = 2) -> "Dataset":
        parent = self._source

        def gen():
            q: queue.Queue = queue.Queue(maxsize=buffer_size)
            _END = object()
            error: list = []
            # consumers may abandon the iterator mid-stream (an eval
            # loop breaking on error, a `take`, a GC'd generator): the
            # producer must notice and exit, or it blocks in q.put
            # forever and leaks a thread + its buffered batches per
            # abandoned stream
            closed = threading.Event()

            def _put_while_open(item) -> bool:
                while not closed.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        return True
                    except queue.Full:
                        continue
                return False

            def producer():
                try:
                    for x in parent():
                        if not _put_while_open(x):
                            return
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    error.append(e)
                finally:
                    _put_while_open(_END)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    x = q.get()
                    if x is _END:
                        if error:
                            raise error[0]
                        return
                    yield x
            finally:
                closed.set()

        return Dataset(gen)

    # ---- consumption ------------------------------------------------------

    def __iter__(self) -> Iterator:
        return self._source()


# records shuffled ahead of the batched parse, matching the model zoo's
# per-record convention (e.g. mnist dataset_fn: shuffle(1024, seed=0)):
# the default of the module-owned ``batch_shuffle = (buffer, seed)``
# policy, as in the JAX package
_SHUFFLE_BUFFER = 1024
DEFAULT_SHUFFLE_POLICY = (_SHUFFLE_BUFFER, 0)


def batched_model_pipeline(
    ds: Dataset,
    spec,
    mode,
    metadata,
    batch_size: int,
    shuffle_records: bool = False,
    prefetch: int = 0,
) -> Dataset:
    """Raw-record dataset -> batched model-input dataset.

    The one pipeline builder shared by every runtime.  When the model
    module defines the ``batch_parse(example_batch, mode)`` hook, records
    are grouped raw and decoded per minibatch by ``decode_example_batch``
    (one call of the native codec when it is loaded); otherwise the
    per-record ``dataset_fn`` composes with ``batch``.

    ``shuffle_records`` applies only to the fast path — in the classic
    path shuffling belongs to ``dataset_fn`` (model-owned).  Fast-path
    models keep that ownership through an optional module attribute
    ``batch_shuffle = (buffer, seed)`` (or ``None`` to disable); the
    default matches the zoo convention.  The batch count is identical
    either way: shuffling never crosses the dataset boundary, so
    lockstep's steps-per-task invariant holds.  (``shuffle_records`` is a
    plain bool rather than derived from ``mode`` here to keep this module
    free of the trainer's ``Modes`` import.)
    """
    batch_parse = getattr(spec, "batch_parse", None)
    if batch_parse is not None:
        from elasticdl_tpu_torch.data.reader import decode_example_batch

        policy = getattr(
            getattr(spec, "module", None),
            "batch_shuffle",
            DEFAULT_SHUFFLE_POLICY,
        )
        if shuffle_records and policy is not None:
            buffer_size, seed = policy
            ds = ds.shuffle(buffer_size, seed=seed)
        out = ds.batch_list(batch_size).map(
            lambda recs: batch_parse(decode_example_batch(recs), mode)
        )
    else:
        if spec.dataset_fn is not None:
            ds = spec.dataset_fn(ds, mode, metadata)
        out = ds.batch(batch_size)
    if prefetch:
        out = out.prefetch(prefetch)
    return out
