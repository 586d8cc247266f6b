"""Bounded micro-batching queue: arbitrary request sizes -> the one
canonical batch shape.

A copy of ``elasticdl_tpu/serving/batcher.py`` (the port imports nothing
of the JAX package), without the memory-ledger accounting.

The serving analogue of shape-canonical batching
(``docs/designs/shape_canonicalization.md``): traffic arrives as
requests of ANY row count, and the engine serves one canonical batch
shape (in the JAX package, each shape served is a compile; in the port,
one shape keeps the device's buffers and launch shapes the same from
group to group).  The batcher therefore works in ROWS, not requests:

- a request's rows join a FIFO row cursor queue (a request larger than
  the canonical shape simply spans several dispatch groups);
- the dispatch thread drains up to ``canonical_rows`` rows per group,
  flushing EARLY when the oldest queued row has waited ``max_wait_secs``
  (the latency/efficiency knob: 0 = dispatch immediately, always);
- rows the group is short of are padding, carried as the group's
  ``n_real``/row-mask — exactly zero-cost to correctness because per-row
  outputs are sliced back to their requests by position.

Backpressure is explicit: ``submit`` refuses rows beyond
``max_queue_rows`` with :class:`ServingOverloadError` (the client-visible
overload signal), so a traffic spike degrades to fast rejections instead
of an unbounded queue hiding seconds of latency.

Thread model: any number of submitter threads (request handlers), ONE
dispatch thread calling :meth:`next_group`.  Tickets are the
completion-future seam: the submitter blocks in :meth:`Ticket.result`
until the dispatch thread delivered every row (or an error).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np


class ServingError(Exception):
    """Base class for request-fatal serving failures."""

    retryable = False


class ServingOverloadError(ServingError):
    """The queue is full — shed load now, retry against another replica
    (or later)."""

    retryable = True


class ServingShutdownError(ServingError):
    """This replica is draining — retryable by design: predict is
    read-only, so the router re-routes to a healthy replica and a
    rolling restart stays invisible to clients."""

    retryable = True


class ShapeMismatchError(ServingError):
    """Request feature shapes/keys disagree with the served model."""


def tree_rows(tree) -> int:
    """Leading-dim row count of a feature tree (dict of arrays or one
    array); every leaf must agree."""
    leaves = (
        list(tree.values()) if isinstance(tree, dict) else [tree]
    )
    if not leaves:
        raise ShapeMismatchError("empty feature tree")
    counts = {int(np.shape(leaf)[0]) for leaf in leaves}
    if len(counts) != 1:
        raise ShapeMismatchError(
            f"feature leaves disagree on row count: {sorted(counts)}"
        )
    return counts.pop()


def _slice_rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: np.asarray(v)[lo:hi] for k, v in tree.items()}
    return np.asarray(tree)[lo:hi]


def concat_rows(chunks: list):
    """Row-concatenate feature/output chunks (all the same tree kind)."""
    if not chunks:
        raise ValueError("nothing to concatenate")
    if isinstance(chunks[0], dict):
        return {
            k: np.concatenate([np.asarray(c[k]) for c in chunks], axis=0)
            for k in chunks[0]
        }
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


class Ticket:
    """One submitted request: rows in, per-row outputs (re-assembled in
    row order) out.  Phase accounting is per REQUEST: ``queue_wait`` is
    submit -> the first dispatch group containing any of its rows opens;
    batch-level phases accumulate over every group the request spans;
    the residual to its measured total is ``untracked`` (sum-exact by
    construction, the step-anatomy discipline applied per request)."""

    __slots__ = (
        "request_id",
        "features",
        "rows",
        "submitted_at",
        "first_dispatch_at",
        "finished_at",
        "phases_secs",
        "dispatches",
        "_chunks",
        "_delivered",
        "_error",
        "_done",
        "model_version",
        "trace",
    )

    def __init__(self, request_id: str, features, rows: int, trace=None):
        self.request_id = request_id
        self.features = features
        self.rows = rows
        # trace context of the SUBMITTING request ({"trace_id",
        # "span_id"} or {}): the engine parents this request's
        # queue/engine spans into it and links the shared dispatch
        # group's span to it
        self.trace: dict = dict(trace) if trace else {}
        self.submitted_at = time.monotonic()
        self.first_dispatch_at: float | None = None
        self.finished_at: float | None = None
        self.phases_secs: dict[str, float] = {}
        self.dispatches = 0
        self._chunks: list = []
        self._delivered = 0
        self._error: BaseException | None = None
        self._done = threading.Event()
        self.model_version = -1

    # ---- dispatch-thread side ----------------------------------------------

    def note_dispatch_open(self, now: float):
        if self.first_dispatch_at is None:
            self.first_dispatch_at = now

    def add_phases(self, phases_secs: dict[str, float]):
        for name, secs in phases_secs.items():
            self.phases_secs[name] = self.phases_secs.get(name, 0.0) + secs
        self.dispatches += 1

    def deliver(self, output_rows, n: int, model_version: int) -> bool:
        """Append ``n`` rows of outputs; returns True when the last row
        landed.  Completion is NOT signalled here: the engine closes the
        phase decomposition first and then calls :meth:`finish`, so a
        handler waking from :meth:`result` can never read a half-closed
        phase set (the sum-exact response contract)."""
        self._chunks.append(output_rows)
        self._delivered += n
        self.model_version = model_version
        if self._delivered >= self.rows:
            self.finished_at = time.monotonic()
            return True
        return False

    def finish(self):
        """Release the waiter (phases are closed; see :meth:`deliver`)."""
        self._done.set()

    def fail(self, error: BaseException):
        self._error = error
        self.finished_at = time.monotonic()
        self._done.set()

    # ---- submitter side ----------------------------------------------------

    def result(self, timeout: float | None = None):
        """Block until complete; returns the row-ordered output tree."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id!r} not complete after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        if len(self._chunks) == 1:
            return self._chunks[0]
        return concat_rows(self._chunks)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error(self) -> BaseException | None:
        return self._error

    def total_secs(self) -> float:
        if self.finished_at is None:
            return 0.0
        return self.finished_at - self.submitted_at


class Group:
    """One dispatch group: up to ``canonical_rows`` real rows drawn from
    the cursor queue, with the (ticket, lo, hi) segments to slice the
    outputs back out."""

    __slots__ = ("segments", "n_real", "opened_at")

    def __init__(self, segments, n_real: int, opened_at: float):
        self.segments = segments  # [(ticket, lo, hi)] in row order
        self.n_real = n_real
        self.opened_at = opened_at

    def features(self):
        """Row-concatenated features of the group's real rows (the
        engine pads to the canonical shape)."""
        return concat_rows(
            [_slice_rows(t.features, lo, hi) for t, lo, hi in self.segments]
        )

    def tickets(self):
        seen = []
        for ticket, _lo, _hi in self.segments:
            if not seen or seen[-1] is not ticket:
                seen.append(ticket)
        return seen


class MicroBatcher:
    """The bounded coalescing queue (see module docstring)."""

    def __init__(
        self,
        canonical_rows: int,
        max_wait_secs: float = 0.002,
        max_queue_rows: int | None = None,
    ):
        if canonical_rows <= 0:
            raise ValueError("canonical_rows must be positive")
        self.canonical_rows = int(canonical_rows)
        self.max_wait_secs = float(max_wait_secs)
        # default bound: ~32 full dispatch groups of backlog
        self.max_queue_rows = (
            int(max_queue_rows)
            if max_queue_rows is not None
            else 32 * self.canonical_rows
        )
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        # (ticket, next_row) cursors, FIFO  # guarded-by: _lock
        self._cursors: deque = deque()
        self._pending_rows = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    # ---- submitter threads -------------------------------------------------

    def submit(self, request_id: str, features, trace=None) -> Ticket:
        rows = tree_rows(features)
        if rows <= 0:
            raise ShapeMismatchError("request carries zero rows")
        ticket = Ticket(request_id, features, rows, trace=trace)
        with self._lock:
            if self._closed:
                raise ServingShutdownError("batcher is shut down")
            # a single request LARGER than the bound must still be
            # admittable (the whole point is "1 row or 10,000"): the
            # effective bound stretches to the request's own size, so
            # an oversized request is admitted against an empty queue
            # and sheds only when real backlog sits in front of it
            if self._pending_rows + rows > max(self.max_queue_rows, rows):
                raise ServingOverloadError(
                    f"queue full: {self._pending_rows} rows pending, "
                    f"request adds {rows} (bound {self.max_queue_rows})"
                )
            self._cursors.append([ticket, 0])
            self._pending_rows += rows
            self._nonempty.notify()
        return ticket

    def queue_rows(self) -> int:
        with self._lock:
            return self._pending_rows

    def close(self):
        """Refuse new submits and wake the dispatch thread; queued
        tickets fail with a shutdown error."""
        with self._lock:
            self._closed = True
            cursors, self._cursors = list(self._cursors), deque()
            self._pending_rows = 0
            self._nonempty.notify_all()
        for ticket, _pos in cursors:
            ticket.fail(ServingShutdownError("server shutting down"))

    # ---- the dispatch thread -----------------------------------------------

    def next_group(self, poll_secs: float = 0.05) -> Group | None:
        """Block up to ``poll_secs`` for traffic; once any row is
        queued, wait AT MOST ``max_wait_secs`` from the oldest queued
        ticket's submit time for more rows (a full group dispatches
        immediately), then drain up to ``canonical_rows`` rows.  Returns
        None on an idle poll or shutdown."""
        with self._lock:
            if not self._cursors and not self._closed:
                self._nonempty.wait(poll_secs)
            if self._closed or not self._cursors:
                return None
            deadline = self._cursors[0][0].submitted_at + self.max_wait_secs
            while self._pending_rows < self.canonical_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(remaining)
                if self._closed:
                    return None
                if not self._cursors:
                    return None
            now = time.monotonic()
            segments = []
            taken = 0
            while self._cursors and taken < self.canonical_rows:
                cursor = self._cursors[0]
                ticket, pos = cursor
                take = min(ticket.rows - pos, self.canonical_rows - taken)
                ticket.note_dispatch_open(now)
                segments.append((ticket, pos, pos + take))
                taken += take
                if pos + take >= ticket.rows:
                    self._cursors.popleft()
                else:
                    cursor[1] = pos + take
            self._pending_rows -= taken
            return Group(segments, taken, now)
