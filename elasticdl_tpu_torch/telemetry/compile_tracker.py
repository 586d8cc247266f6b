"""Process-wide compile counting; the counterpart of
``elasticdl_tpu/telemetry/compile_tracker.py``.

Canonical batch shapes exist so that the steady-state step stream runs
one program (and one stacked variant), so the count of compiles is the
regression signal worth watching.  The port compiles no XLA programs;
its compiles are what a new program costs on the card:

- every CUDA graph capture of a stacked group (``parallel/distributed.py``
  ``_StepsGraph``), and
- every distinct input shape dispatched to a train step (its first
  dispatch picks the kernels' configurations and allocator blocks for the
  shape, as ``serving_status.compile_count`` counts shapes for a served
  model).

:func:`compile_count` is this process's total.  The master mirrors it,
plus the ``compile_count`` exec counters that workers ship with their
task reports (:class:`ExecCounterReporter`), onto ``/metrics`` as
``elasticdl_compile_total``.  Nothing here sits on the step path beyond
one set lookup of the dispatched shape.
"""

from __future__ import annotations

import threading
import time

# the exec-counter key workers report compile deltas under (summed by
# the task dispatcher, mirrored by MasterTelemetry._collect)
COMPILE_COUNT_KEY = "compile_count"

_lock = threading.Lock()
_count = 0
_secs_total = 0.0
_shapes: set = set()


def note_compile(duration_secs: float = 0.0):
    """One compile (a graph capture) of ``duration_secs``, and its
    ``compile`` span when a tracer is installed (on whatever thread
    captured; lifecycle spans are never sampled away)."""
    global _count, _secs_total
    with _lock:
        _count += 1
        _secs_total += max(0.0, float(duration_secs))
    from elasticdl_tpu_torch.telemetry import tracing

    tracer = tracing.get_tracer()
    if tracer is not None:
        now = time.monotonic()
        tracer.record_span(tracing.SPAN_COMPILE, now - max(0.0, float(duration_secs)), now)


def note_shape(key) -> bool:
    """A dispatch of input shape ``key`` (hashable); the first of each
    shape counts as a compile.  Returns whether it was new."""
    global _count
    if key in _shapes:
        return False
    with _lock:
        if key in _shapes:
            return False
        _shapes.add(key)
        _count += 1
    return True


def compile_count() -> int:
    """Compiles of this process so far."""
    return _count


def compile_secs_total() -> float:
    """Seconds this process spent capturing graphs."""
    return _secs_total


class ExecCounterReporter:
    """Ships compile deltas with task reports: :meth:`attach` stages the
    unreported delta into a report's exec counters, and the watermark
    moves only in :meth:`commit`, after the report went through, so a
    failed report ships its delta with the next one."""

    def __init__(self):
        self._reported = compile_count()

    def attach(self, counters: dict) -> int:
        """Stage the pending delta under ``COMPILE_COUNT_KEY`` (when
        nonzero); returns the total to :meth:`commit` once the report
        went through."""
        total = compile_count()
        delta = total - self._reported
        if delta > 0:
            counters[COMPILE_COUNT_KEY] = delta
        return total

    def commit(self, total: int):
        self._reported = max(self._reported, total)


def _reset_for_tests():
    """Zero the totals (tests that stand for a fresh process)."""
    global _count, _secs_total
    with _lock:
        _count = 0
        _secs_total = 0.0
        _shapes.clear()
