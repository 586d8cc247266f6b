"""The JSONL helpers of ``elasticdl_tpu/telemetry/events.py`` that the
master journal reads and rotates through: :func:`rotate_if_needed` and
the shard-aware :func:`read_jsonl`, with the constants they use.

Long logs must not fill the disk: once the active JSONL crosses the size
cap it is shifted to ``<path>.1`` (older shards move to ``.2``, ``.3``,
...; the oldest beyond ``ROTATE_KEEP_SHARDS`` is overwritten).  Rotation
is rename-based so concurrent O_APPEND writers stay correct: a writer
holding the pre-rotation fd keeps appending into the renamed shard, and
a racing second rotation just loses the rename.

The event log itself (``EventLog``, the event vocabulary) comes with
slice 10 (telemetry).
"""

from __future__ import annotations

import json
import os

ROTATE_MAX_BYTES = 64 * 1024 * 1024
ROTATE_KEEP_SHARDS = 3
ROTATE_MAX_MB_ENV = "ELASTICDL_TPU_TELEMETRY_LOG_MAX_MB"


def rotate_if_needed(
    path: str,
    max_bytes: int | None = None,
    keep_shards: int | None = None,
):
    """Shift ``path`` into numbered shards once it crosses the cap."""
    if not path:
        return
    if max_bytes is None:
        try:
            max_bytes = int(
                float(os.environ.get(ROTATE_MAX_MB_ENV, 0)) * 1024 * 1024
            ) or ROTATE_MAX_BYTES
        except ValueError:
            max_bytes = ROTATE_MAX_BYTES
    keep = keep_shards if keep_shards is not None else ROTATE_KEEP_SHARDS
    try:
        if os.path.getsize(path) < max_bytes:
            return
    except OSError:
        return
    try:
        for i in range(keep - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")
    except OSError:
        # a concurrent writer rotated first; its shift already applied
        pass


def _shard_paths(path: str) -> list[str]:
    """All shards of one log, oldest first (highest index), active last."""
    shards = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        shards.append(f"{path}.{i}")
        i += 1
    shards.reverse()
    if os.path.exists(path):
        shards.append(path)
    return shards


def read_jsonl(path: str) -> list[dict]:
    """Parse one JSONL log INCLUDING its rotated shards (oldest first);
    torn lines (a writer killed mid-write) are skipped."""
    records: list[dict] = []
    for shard in _shard_paths(path):
        try:
            with open(shard, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return records
