"""The step-time percentile tracker; the part of
``elasticdl_tpu/telemetry/slo.py`` that the autoscaler
(``master/autoscaler.py``) reads.

The rest of the SLO engine (the declarative objectives, the burn-rate
detectors, the incidents) comes with slice 10b.
"""

from __future__ import annotations

import threading
import time

# p95 window: enough samples to be a percentile, few enough to follow a
# change of regime within a handful of tasks
_PERCENTILE_WINDOW = 128


class StepTimePercentileTracker:
    """Master-side step time from the version-report channel.

    The chief reports ``trainer.step`` after every task; consecutive
    reports ``(t1, v1) -> (t2, v2)`` give the mean wall time of the
    ``v2 - v1`` steps between them, ``(t2 - t1) / (v2 - v1)``.  Coarser
    than a worker's own step times, but local to the master, and it is
    the quantity a resize changes: wall time per optimizer step.  The
    clock is injectable (``time.monotonic`` by default)."""

    def __init__(self, window: int = _PERCENTILE_WINDOW, clock=time.monotonic):
        self._lock = threading.Lock()
        self._window = window
        self._clock = clock
        self._samples_ms: list[float] = []  # guarded-by: _lock
        self._last: tuple[float, int] | None = None  # guarded-by: _lock

    def note_version(self, worker_id: int, version: int):
        now = self._clock()
        with self._lock:
            last = self._last
            if last is not None and version > last[1]:
                per_step_ms = (now - last[0]) * 1000.0 / (version - last[1])
                self._samples_ms.append(per_step_ms)
                if len(self._samples_ms) > self._window:
                    del self._samples_ms[: -self._window]
            if last is None or version >= last[1]:
                self._last = (now, version)

    def reset(self):
        """A re-formation invalidates the baseline: the new world's first
        report would otherwise span the whole outage."""
        with self._lock:
            self._last = None
            self._samples_ms.clear()

    def percentile_ms(self, q: float) -> float | None:
        """Nearest-index percentile over the window (q in [0, 100]); None
        under 4 samples, too few to call a percentile."""
        with self._lock:
            samples = sorted(self._samples_ms)
        if len(samples) < 4:
            return None
        idx = min(len(samples) - 1, int(round(q / 100.0 * (len(samples) - 1))))
        return samples[idx]

    def p95_ms(self) -> float | None:
        return self.percentile_ms(95.0)

    @property
    def sample_count(self) -> int:
        with self._lock:
            return len(self._samples_ms)
