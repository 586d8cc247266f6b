"""Data reader factory; the counterpart of ``elasticdl_tpu/data/factory.py``.

A model module's ``custom_data_reader`` wins; otherwise the origin is a
directory of EDLIO shards.  The JAX package's other sources (streams,
ODPS tables, CSV files) raise here until the slice that ports them.
"""

from __future__ import annotations

from elasticdl_tpu_torch.data.reader import AbstractDataReader
from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader


def create_data_reader(
    data_origin: str,
    records_per_task: int | None = None,
    custom_reader=None,
    **kwargs,
) -> AbstractDataReader:
    if custom_reader is not None:
        return custom_reader(
            data_origin=data_origin,
            records_per_task=records_per_task,
            **kwargs,
        )
    if data_origin.startswith("stream://"):
        raise NotImplementedError(
            f"{data_origin!r}: stream sources come with the port's "
            "streaming slice (ROADMAP.md queue 1, slice 9)"
        )
    if data_origin.startswith("odps://"):
        raise NotImplementedError(
            f"{data_origin!r}: ODPS tables come with the port's slice 9 "
            "(ROADMAP.md queue 1)"
        )
    if data_origin.endswith(".csv") or kwargs.get("reader_type") == "CSV":
        raise NotImplementedError(
            f"{data_origin!r}: CSV sources come with the port's slice 9 "
            "(ROADMAP.md queue 1)"
        )
    return RecordIODataReader(data_dir=data_origin, **kwargs)
