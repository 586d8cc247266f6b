"""EDLIO-backed data reader; the counterpart of
``elasticdl_tpu/data/recordio_reader.py`` without its chunked reads
(they feed the vectorized pipeline, which needs the native codec).

A scanner per task over the record range, and shard creation by walking
a directory and reading each file's record count from its index.
"""

from __future__ import annotations

import os
from typing import Iterator

from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data.reader import AbstractDataReader, Metadata


class RecordIODataReader(AbstractDataReader):
    def __init__(self, data_dir: str = "", **kwargs):
        super().__init__(**kwargs)
        self._data_dir = data_dir or kwargs.get("data_dir", "")

    def read_records(self, task) -> Iterator[bytes]:
        with recordio.Scanner(
            task.shard_name, task.start, task.end - task.start
        ) as scanner:
            yield from scanner

    def create_shards(self) -> dict[str, tuple[int, int]]:
        if not self._data_dir:
            return {}
        shards = {}
        for name in sorted(os.listdir(self._data_dir)):
            path = os.path.join(self._data_dir, name)
            if os.path.isfile(path):
                shards[path] = (0, recordio.num_records(path))
        return shards

    @property
    def metadata(self) -> Metadata:
        return Metadata(extra={"format": "edlio"})
