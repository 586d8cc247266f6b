"""EDLIO-backed data reader; the counterpart of
``elasticdl_tpu/data/recordio_reader.py``.

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

    def read_record_chunks(self, task) -> Iterator:
        """Yield ``(concat_buf, lengths)`` chunks of the task's range: the
        raw-batch form of the fused scan+decode path
        (``data/fast_pipeline.py``) through the native codec's scanner,
        built here at first use (a failed build raises).  The views
        alias the scanner's reusable buffer: consume each chunk before
        advancing."""
        recordio.ensure_native_codec()
        with recordio.Scanner(
            task.shard_name, task.start, task.end - task.start
        ) as scanner:
            while True:
                chunk = scanner.next_chunk()
                if chunk is None:
                    return
                yield chunk

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
