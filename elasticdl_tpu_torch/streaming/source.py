"""Stream sources: who decides how many records exist; the counterpart
of ``elasticdl_tpu/streaming/source.py``.

A stream source publishes two facts: the **source watermark** (records
``[0, watermark)`` exist and may be leased) and whether the source has
**closed** (the watermark will never advance again).  The dispatcher's
watermark-lease mode reads nothing else, so any feed that answers those
two questions plugs in: the seeded in-process queue below, an ODPS table
tailer, or a test double that calls ``advance`` by hand.

Watermarks are monotone: once published, a watermark never goes back (a
restarted master re-floors its source at the journaled watermark with
``advance_to``), which is what makes ``lag = source_watermark -
trained_watermark`` a backlog and the freshness ledger's staleness
well defined.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from urllib.parse import parse_qs, urlparse

STREAM_SCHEME = "stream://"


@dataclass(frozen=True)
class StreamSpec:
    """A parsed ``stream://`` origin.

    ``stream://mnist?seed=3&total=4096&rate=2000``: the dataset schema,
    the generator seed, the bounded prefix's length (``total``; 0 is
    unbounded) and the watermark's advance in records a second (0: only
    explicit ``advance`` calls move it).  Other query keys land in
    ``params`` (``initial``: records published at the start).
    """

    dataset: str
    seed: int = 0
    total: int = 0
    rate: float = 0.0
    params: dict = field(default_factory=dict)


def is_stream_origin(data_origin: str) -> bool:
    return bool(data_origin) and data_origin.startswith(STREAM_SCHEME)


def parse_stream_origin(data_origin: str) -> StreamSpec:
    if not is_stream_origin(data_origin):
        raise ValueError(f"not a stream:// origin: {data_origin!r}")
    parsed = urlparse(data_origin)
    query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
    return StreamSpec(
        dataset=parsed.netloc or parsed.path.lstrip("/"),
        seed=int(query.pop("seed", 0)),
        total=int(query.pop("total", 0)),
        rate=float(query.pop("rate", 0.0)),
        params=query,
    )


class QueueStreamSource:
    """The seeded in-process stream.

    The watermark advances at ``rate`` records a second of wall clock
    (or by explicit ``advance``/``advance_to`` calls), floored at
    ``initial`` and capped at ``total`` when the stream is a bounded
    prefix.  A bounded prefix is what lets a job end: the source closes
    at ``total``, and the dispatcher's ``finished()`` fires once the
    backlog drains.
    """

    def __init__(
        self,
        total: int = 0,
        rate_per_sec: float = 0.0,
        initial: int = 0,
        clock=time.monotonic,
    ):
        self._total = int(total)
        self._rate = float(rate_per_sec)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._floor = int(initial)  # guarded-by: _lock

    @classmethod
    def from_spec(cls, spec: StreamSpec, clock=time.monotonic):
        return cls(
            total=spec.total,
            rate_per_sec=spec.rate,
            initial=int(spec.params.get("initial", 0)),
            clock=clock,
        )

    def watermark(self) -> int:
        with self._lock:
            w = self._floor
            if self._rate > 0:
                w = max(w, int(self._rate * (self._clock() - self._t0)))
            if self._total > 0:
                w = min(w, self._total)
            # monotone even if the clock misbehaves
            self._floor = max(self._floor, w)
            return self._floor

    def closed(self) -> bool:
        """True once the watermark can never advance again."""
        return self._total > 0 and self.watermark() >= self._total

    def advance(self, n: int) -> int:
        """Publish ``n`` more records (tests and chaos)."""
        with self._lock:
            target = self._floor + int(n)
        return self.advance_to(target)

    def advance_to(self, watermark: int) -> int:
        """Floor the watermark at ``watermark``: monotone, so a lower
        target changes nothing (a restarted master resumes at the
        journaled watermark)."""
        with self._lock:
            w = int(watermark)
            if self._total > 0:
                w = min(w, self._total)
            self._floor = max(self._floor, w)
            return self._floor


class OdpsTailingSource:
    """Tails an ODPS table: its row count is the watermark, and
    ``close()`` ends the stream.  The ``odps`` SDK is imported when the
    source is built, so a machine without it fails here and nowhere
    else; ``client`` replaces the SDK's client (tests pass a fake with
    ``get_table(name).open_reader(partition=...).count``)."""

    def __init__(self, table: str, partition: str | None = None, client=None, **kwargs):
        if client is None:
            try:
                from odps import ODPS  # type: ignore
            except ImportError as exc:
                raise ImportError("OdpsTailingSource requires the 'odps' SDK") from exc
            import os

            client = ODPS(
                kwargs.get("access_id") or os.environ.get("ODPS_ACCESS_ID", ""),
                kwargs.get("access_key") or os.environ.get("ODPS_ACCESS_KEY", ""),
                kwargs.get("project") or os.environ.get("ODPS_PROJECT_NAME", ""),
                endpoint=kwargs.get("endpoint") or os.environ.get("ODPS_ENDPOINT", ""),
            )
        self._client = client
        self._table = table
        self._partition = partition
        self._closed = False

    def watermark(self) -> int:
        table = self._client.get_table(self._table)
        with table.open_reader(partition=self._partition) as reader:
            return int(reader.count)

    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True


def build_stream_source(data_origin: str, clock=time.monotonic):
    """The master's source for a ``stream://`` origin."""
    spec = parse_stream_origin(data_origin)
    if spec.dataset.startswith("odps:"):
        return OdpsTailingSource(table=spec.dataset[len("odps:"):])
    return QueueStreamSource.from_spec(spec, clock=clock)
