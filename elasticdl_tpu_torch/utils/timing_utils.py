"""Wall-clock timing buckets for the training loop; a copy of
``elasticdl_tpu/utils/timing_utils.py``.

Named wall-clock buckets (task_process / batch_process / ...), reported
at DEBUG level.  A bucket is host time: a step that returns before the
device finishes is charged its enqueue, not its device time.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict


class Timing:
    def __init__(self, enabled: bool = False, logger: logging.Logger | None = None):
        self._enabled = enabled
        self._logger = logger
        self.reset()

    def reset(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._starts: dict[str, float] = {}
        self._reported_ms: dict[str, int] = defaultdict(int)

    def start_record_time(self, name: str):
        if self._enabled:
            self._starts[name] = time.monotonic()

    def end_record_time(self, name: str):
        if self._enabled and name in self._starts:
            self._totals[name] += time.monotonic() - self._starts.pop(name)
            self._counts[name] += 1

    @contextlib.contextmanager
    def record(self, name: str):
        self.start_record_time(name)
        try:
            yield
        finally:
            self.end_record_time(name)

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {"total_secs": total, "count": self._counts[name]}
            for name, total in sorted(self._totals.items())
        }

    def exec_counters(self) -> dict[str, int]:
        """Bucket time accrued SINCE THE LAST CALL, as task-report
        counters (``time_<bucket>_ms``) — delta semantics so a batch that
        completes several tasks attributes its time once, not once per
        report, and the master's per-job sum stays exact.  Zero deltas
        are omitted; the cumulative-ms bookkeeping keeps rounding from
        drifting across reports."""
        if not self._enabled:
            return {}
        out = {}
        for name, total in self._totals.items():
            cum_ms = round(total * 1000)
            delta = cum_ms - self._reported_ms[name]
            if delta:
                out[f"time_{name}_ms"] = delta
                self._reported_ms[name] = cum_ms
        return out

    def totals_ms(self) -> dict[str, int]:
        """Cumulative bucket totals as ``time_<bucket>_ms`` keys — the
        ABSOLUTE counterpart of :meth:`exec_counters` deltas, for
        telemetry consumers (event log, registry mirror) that want the
        run total in one read.  Does not advance the delta bookkeeping."""
        if not self._enabled:
            return {}
        return {
            f"time_{name}_ms": round(total * 1000)
            for name, total in self._totals.items()
            if round(total * 1000)
        }

    def report_timing(self, reset: bool = False):
        if self._enabled and self._logger is not None:
            for name, stats in self.summary().items():
                self._logger.debug(
                    "Timing %s: %.6fs over %d calls",
                    name,
                    stats["total_secs"],
                    stats["count"],
                )
        if reset:
            self.reset()
