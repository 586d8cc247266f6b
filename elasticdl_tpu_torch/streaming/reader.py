"""The data reader of a ``stream://`` origin; the counterpart of
``elasticdl_tpu/streaming/reader.py``, record for record.

``stream://mnist?seed=3&total=4096&rate=2000`` names a record stream
whose record ``i`` is a pure function of ``(seed, i)``: the synthetic
generators' class templates (a fixed ``RandomState(1234)``) plus noise
from a ``RandomState`` seeded by ``(seed, i)``.  So master and workers
share no queue state: any worker can serve any leased ``[offset,
offset + n)`` window, a requeued window reads the same bytes on another
worker, and every process of a lockstep world reads the same window
alike.  The bytes equal the JAX reader's for the same origin.

``create_shards()`` is empty: a stream has no finite shard map, the
dispatcher's watermark-lease mode mints windows instead.  The reader has
no ``read_record_chunks``, so its records take the classic per-record
``Dataset`` path (``data/fast_pipeline.py::build_task_batches``), read
ahead of the step by the task prefetcher as every classic task is.
"""

from __future__ import annotations

import threading
from typing import Iterator

import numpy as np

from elasticdl_tpu_torch.data.reader import AbstractDataReader, Metadata, encode_example
from elasticdl_tpu_torch.streaming.source import StreamSpec, parse_stream_origin

# dataset -> (image shape, number of classes), the schemas of
# data/recordio_gen/synthetic.py, so the zoo's image models train unchanged
_SCHEMAS = {
    "mnist": ((28, 28), 10),
    "cifar10": ((32, 32, 3), 10),
}

_TEMPLATE_CACHE: dict[str, np.ndarray] = {}

# one RandomState a thread, re-seeded for each record: re-seeding gives
# the bits of a new RandomState(seed) (the cached Gaussian is reset
# too) for a hundredth of the cost of building one
_RNG = threading.local()


def _templates(dataset: str) -> np.ndarray:
    if dataset not in _SCHEMAS:
        raise ValueError(f"unknown stream dataset {dataset!r}; known: {sorted(_SCHEMAS)}")
    if dataset not in _TEMPLATE_CACHE:
        shape, num_classes = _SCHEMAS[dataset]
        # the synthetic generators' template RNG: a stream run learns the
        # same distribution as a run over generated shards
        rng = np.random.RandomState(1234)
        _TEMPLATE_CACHE[dataset] = rng.uniform(0, 255, size=(num_classes, *shape))
    return _TEMPLATE_CACHE[dataset]


def stream_record(dataset: str, seed: int, index: int) -> dict[str, np.ndarray]:
    """Record ``index`` of the stream: the same on every host, whatever
    the read order."""
    shape, num_classes = _SCHEMAS[dataset]
    templates = _templates(dataset)
    rng = getattr(_RNG, "state", None)
    if rng is None:
        rng = _RNG.state = np.random.RandomState()
    rng.seed((seed * 1_000_003 + index) % (2**31 - 1))
    label = rng.randint(num_classes)
    img = templates[label] + rng.normal(0, 32.0, size=shape)
    return {
        "image": np.clip(img, 0, 255).astype(np.uint8),
        "label": np.int64(label),
    }


class StreamDataReader(AbstractDataReader):
    def __init__(self, data_origin: str = "", **kwargs):
        super().__init__(**kwargs)
        self._origin = data_origin
        self._spec: StreamSpec = parse_stream_origin(data_origin)
        _templates(self._spec.dataset)  # an unknown schema fails here

    @property
    def spec(self) -> StreamSpec:
        return self._spec

    def read_records(self, task) -> Iterator[bytes]:
        for i in range(task.start, task.end):
            yield encode_example(stream_record(self._spec.dataset, self._spec.seed, i))

    def create_shards(self) -> dict[str, tuple[int, int]]:
        return {}

    @property
    def metadata(self) -> Metadata:
        return Metadata(extra={"format": "stream", "dataset": self._spec.dataset})
