"""Device-path pipelining: staging the next dispatch group on the card
while the current one computes, and retiring dispatches behind; the
counterpart of ``elasticdl_tpu/trainer/device_pipeline.py``.

- **Staging** (:class:`DeviceStager`): a daemon thread pulls host
  batches from the upstream stream (the ``TaskPrefetcher``'s queue, so
  decode -> stage -> compute are three deep), assembles them to the
  canonical dispatch shape, and copies them to the card through pinned
  memory on a CUDA stream of its own, while the current group computes.
  The queue is bounded, so staged device memory is bounded.
- **Ownership**: a staged group's buffers are read by exactly one
  dispatch: :meth:`StagedGroup.take` hands them over once (the consumer's
  stream waits on the copy's event first) and raises
  :class:`RetiredBufferError` on a second take.  This is what the JAX
  package's batch donation guards; here a graph replay copies the staged
  group into its static input buffers, and nothing reads a staged buffer
  after its take.
- **Retire-behind** (:func:`run_pipelined_steps`): each dispatch records
  a CUDA event, and the consumer blocks on the oldest once more than
  ``--pipeline_depth`` (default 2) are in flight; the window drains
  before a task is reported, so a task is reported only after all its
  groups ran.
- **Cross-task staging** (:func:`run_pipelined_task_stream`,
  ``--boundary_fusion``): one persistent stager walks the whole task
  stream, with :class:`TaskMark` sentinels between tasks, so the next
  task's first group is staged while the previous task's window drains
  and its report runs.  The gap between the last retire of a task and
  the first dispatch of the next is the ``boundary_stall`` counter.

Enablement: ``--device_prefetch`` (or ``ELASTICDL_TPU_DEVICE_PREFETCH``),
``--boundary_fusion`` (``ELASTICDL_TPU_BOUNDARY_FUSION``) and
``--pipeline_depth`` (``ELASTICDL_TPU_PIPELINE_DEPTH``), resolved once
when the executor is built.  Staging changes when a group is copied to
the card, never what is dispatched: grouping, order and steps are those
of the serial path (``trainer/stacking.py``), bit for bit.

On the CPU the same threads and queues run, and placement is a
``torch.from_numpy`` view; there are no streams or events to wait on.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterable

import torch

from elasticdl_tpu_torch.telemetry.memory import pytree_bytes, read_device_memory
from elasticdl_tpu_torch.trainer.stacking import (
    PreStacked,
    assemble_canonical_group,
    prestacked_weights,
    resolve_steps_per_dispatch,
)
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.tree_utils import batch_rows, tree_leaves

DEVICE_PREFETCH_ENV = "ELASTICDL_TPU_DEVICE_PREFETCH"
BOUNDARY_FUSION_ENV = "ELASTICDL_TPU_BOUNDARY_FUSION"
PIPELINE_DEPTH_ENV = "ELASTICDL_TPU_PIPELINE_DEPTH"
# a byte budget for staged-but-untaken device buffers; unset: half the
# card's headroom (telemetry/memory.py), none on the CPU
STAGING_BUDGET_ENV = "ELASTICDL_TPU_STAGING_BUDGET_BYTES"

# dispatched groups that may be in flight before the consumer blocks on
# the oldest: 2 is the classic one-behind pipeline
RETIRE_WINDOW = 2
# staged groups waiting in the queue: 1 is double buffering
STAGE_DEPTH = 1

_STAGE_KIND_GROUP = "group"
_STAGE_KIND_ERROR = "error"
_STAGE_KIND_DONE = "done"
_STAGE_KIND_MARK = "mark"


# ---- flag resolution --------------------------------------------------------

# the spellings the environment takes, as the flags' parse_bool: an
# unknown spelling leaves the feature off, with an error logged
_FALSEY_ENV = frozenset({"", "0", "false", "no", "off"})
_TRUTHY_ENV = frozenset({"1", "true", "yes", "on"})


def _resolve_bool(flag, env: str, what: str) -> bool:
    if flag is not None:
        return bool(flag)
    raw = os.environ.get(env, "").strip().lower()
    if raw in _TRUTHY_ENV:
        return True
    if raw not in _FALSEY_ENV:
        logger.error(
            "Unrecognized %s=%r; %s stays OFF (use 1/true/yes/on or "
            "0/false/no/off)", env, raw, what,
        )
    return False


def resolve_device_prefetch(flag=None) -> bool:
    """``--device_prefetch`` when given, else
    ``ELASTICDL_TPU_DEVICE_PREFETCH`` (off when unset or unrecognized)."""
    return _resolve_bool(flag, DEVICE_PREFETCH_ENV, "device prefetch")


def resolve_boundary_fusion(flag=None) -> bool:
    """``--boundary_fusion`` when given, else
    ``ELASTICDL_TPU_BOUNDARY_FUSION``; the executor fuses only with
    device prefetch on as well."""
    return _resolve_bool(flag, BOUNDARY_FUSION_ENV, "boundary fusion")


def resolve_pipeline_depth(flag=None) -> int:
    """``--pipeline_depth`` when given (at least 1), else
    ``ELASTICDL_TPU_PIPELINE_DEPTH``, else :data:`RETIRE_WINDOW`; a
    malformed environment value logs an error and keeps the default."""
    if flag is not None:
        return max(1, int(flag))
    raw = os.environ.get(PIPELINE_DEPTH_ENV, "").strip()
    if not raw:
        return RETIRE_WINDOW
    try:
        depth = int(raw)
    except ValueError:
        depth = 0
    if depth < 1:
        logger.error(
            "Unrecognized %s=%r; pipeline depth stays %d (use a positive "
            "integer)", PIPELINE_DEPTH_ENV, raw, RETIRE_WINDOW,
        )
        return RETIRE_WINDOW
    return depth


def staging_budget_bytes(device=None) -> int | None:
    """Bytes that staged-but-untaken groups may hold on the card, or None
    for no bound: ``ELASTICDL_TPU_STAGING_BUDGET_BYTES`` when set, else
    half the card's headroom (``torch.cuda.mem_get_info``), else None
    (the CPU)."""
    raw = os.environ.get(STAGING_BUDGET_ENV, "").strip()
    if raw:
        try:
            budget = int(raw)
        except ValueError:
            logger.error(
                "Unrecognized %s=%r; the staging budget falls back to the "
                "device's headroom (use a byte count)", STAGING_BUDGET_ENV, raw,
            )
        else:
            return budget if budget > 0 else None
    stats = read_device_memory(device)
    limit = int(stats.get("bytes_limit", 0)) if stats else 0
    if limit <= 0:
        return None
    return max(0, limit - int(stats.get("bytes_in_use", 0))) // 2


def stage_depth(anatomy=None, depth=None) -> int:
    """The retire window of a dispatch loop: ``depth``
    (``--pipeline_depth``, default :data:`RETIRE_WINDOW`), or 1 under a
    step anatomy (``--step_anatomy``), whose per-group walls need a
    barrier per group."""
    if anatomy is None:
        return RETIRE_WINDOW if depth is None else depth
    return 1


# ---- staging totals and the boundary-stall counter ---------------------------

_TOTALS_LOCK = threading.Lock()
# monotone totals of this process; milliseconds accumulate as floats
_TOTALS = {
    "groups": 0,
    "stall_ms": 0.0,
    "stage_ms": 0.0,
    "boundaries": 0,
    "boundary_stall_ms": 0.0,
}
_active = False
# the clock at a task boundary (the previous task's window drained),
# closed by the first dispatch of the next task; the dispatch thread is
# its only writer
_boundary_mark = None


def _note_staged(stage_secs: float):
    global _active
    with _TOTALS_LOCK:
        _active = True
        _TOTALS["groups"] += 1
        _TOTALS["stage_ms"] += stage_secs * 1000.0


def _note_stall(stall_secs: float):
    global _active
    with _TOTALS_LOCK:
        _active = True
        _TOTALS["stall_ms"] += stall_secs * 1000.0


def note_task_boundary():
    """Arm the boundary-stall clock at a task boundary, once the previous
    task's window drained and before its report runs.  Unarmed (no
    stager ran in this process) this reads no clock."""
    global _boundary_mark
    if _active:
        _boundary_mark = time.monotonic()


def note_boundary_dispatch():
    """Close a pending boundary mark: the first dispatch after a task
    boundary adds the device-idle gap to ``boundary_stall_ms``.  Every
    other dispatch reads one global."""
    global _boundary_mark, _active
    mark = _boundary_mark
    if mark is None:
        return
    _boundary_mark = None
    gap = time.monotonic() - mark
    with _TOTALS_LOCK:
        _active = True
        _TOTALS["boundaries"] += 1
        _TOTALS["boundary_stall_ms"] += gap * 1000.0


def clear_boundary_mark():
    """Disarm a pending mark (end of a run), so that the last task's
    mark never charges the idle time between runs to a later run."""
    global _boundary_mark
    _boundary_mark = None


def heartbeat_snapshot() -> dict:
    """The staging totals as integers (what the JAX package ships on the
    heartbeat), or ``{}`` when no stager ran in this process."""
    if not _active:
        return {}
    with _TOTALS_LOCK:
        return {key: int(value) for key, value in _TOTALS.items()}


def _reset_totals_for_tests():
    global _active, _boundary_mark
    with _TOTALS_LOCK:
        _active = False
        _boundary_mark = None
        for key in _TOTALS:
            _TOTALS[key] = 0


# ---- staged groups ----------------------------------------------------------


class RetiredBufferError(RuntimeError):
    """A staged group's buffers were taken twice: the first take handed
    them to their one dispatch, and nothing may read them again."""


class StagedGroup:
    """One dispatch group, assembled and on the device.

    ``kind``: ``KIND_STACKED``, ``placed`` is the ``(features, labels,
    weights)`` stacked ``(k, rows, ...)`` tuple of one
    ``train_steps_stacked``; ``KIND_SINGLES``, ``placed`` is a list of
    ``(features, labels, mask)`` single steps (a trailing partial group).
    ``hook_features``: one host features ref per step, for ``pre_batch``.
    ``host``: what the group was assembled from (the plain batches'
    ``(features, labels, rows)`` list, or the :class:`PreStacked`), so
    that a retry can place it again.
    ``error``: staging itself failed (nothing placed); the consumer
    raises it at the group's position.
    ``ready``: the CUDA event after the group's copies (None on the
    CPU)."""

    KIND_STACKED = "stacked"
    KIND_SINGLES = "singles"

    __slots__ = (
        "kind", "steps", "records", "hook_features", "host", "error",
        "nbytes", "_placed", "_ready", "_release",
    )

    def __init__(
        self, kind, placed, steps, records, hook_features, error=None,
        nbytes=0, ready=None, release=None, host=None,
    ):
        self.kind = kind
        self.steps = int(steps)
        self.records = int(records)
        self.hook_features = hook_features
        self.host = host
        self.error = error
        self.nbytes = int(nbytes)
        self._placed = placed
        self._ready = ready
        self._release = release

    def wait_copied(self):
        """Wait for the group's copies on the staging stream (nothing on
        the CPU): under a step anatomy the consumer-visible
        ``h2d_transfer`` holds them."""
        if self._ready is not None:
            self._ready.synchronize()

    def take(self):
        """The placed buffers, exactly once: the current stream waits for
        their copies first, and the allocator keeps them until that
        stream's work on them is done.  A second take raises
        :class:`RetiredBufferError`."""
        if self._placed is None:
            raise RetiredBufferError(
                "staged dispatch group already taken: its buffers belong to "
                "the dispatch that took them"
            )
        placed, self._placed = self._placed, None
        if self._ready is not None:
            stream = torch.cuda.current_stream(self._ready.device)
            stream.wait_event(self._ready)
            for leaf in tree_leaves(placed):
                leaf.record_stream(stream)
        if self._release is not None:
            release, self._release = self._release, None
            release(self.nbytes)
        return placed


def _assemble_prestacked(item: PreStacked):
    return item.features, item.labels, prestacked_weights(item)


def _place_assembled(trainer, kind, assembled):
    if kind == StagedGroup.KIND_STACKED:
        return trainer.place_group(*assembled)
    return [trainer.place_step(*single) for single in assembled]


class TaskMark:
    """In-stream task delimiter of cross-task staging.  ``START``: the
    next groups belong to this task; ``END``: all of its groups were
    handed over (retire the window, report).  The stager flushes a
    pending partial group at a mark, so a task's trailing partial never
    merges with the next task's first batch: grouping stays per task, as
    on the drain-at-boundary path."""

    START = "start"
    END = "end"

    __slots__ = ("kind", "tid", "task")

    def __init__(self, kind, tid, task):
        self.kind = kind
        self.tid = tid
        self.task = task


# ---- the staging thread -----------------------------------------------------


class DeviceStager:
    """Background staging of a canonical-shape batch stream.

    A daemon thread walks ``batches`` (plain ``(features, labels)`` pairs,
    :class:`PreStacked` groups and :class:`TaskMark` s), forms dispatch
    groups of ``k`` under the serial path's grouping policy, assembles
    them, copies them to the device on a CUDA stream of its own, and
    hands :class:`StagedGroup` s to the consumer through a bounded queue,
    in stream order.  An upstream error is re-raised by
    :meth:`next_staged` at its position in the stream."""

    def __init__(
        self,
        get_trainer: Callable,
        batches: Iterable,
        k,
        canonical_rows: int,
        deterministic_auto: bool = False,
        depth: int = STAGE_DEPTH,
    ):
        self._get_trainer = get_trainer
        self._batches = batches
        self._k = k
        self._rows = int(canonical_rows)
        self._deterministic_auto = deterministic_auto
        self._depth = max(1, int(depth))
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        # how many staged groups may wait untaken: the depth, degraded
        # (once, loudly) to 1 when they would exceed the staging budget
        self._admitted = self._depth
        self._stop = threading.Event()
        self._done = False
        self._bytes_lock = threading.Lock()
        self._staged_bytes = 0  # guarded by _bytes_lock
        self._thread = threading.Thread(
            target=self._produce, name="device-stage", daemon=True
        )
        self._thread.start()

    # ---- producer ----------------------------------------------------------

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer closed the stager."""
        while not self._stop.is_set():
            if self._admitted < self._depth and self._q.qsize() >= self._admitted:
                self._stop.wait(0.02)
                continue
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _admit(self, nbytes: int, device):
        if self._admitted <= 1:
            return
        budget = staging_budget_bytes(device)
        if budget is None:
            return
        with self._bytes_lock:
            pending = self._staged_bytes
        if pending + nbytes <= budget:
            return
        self._admitted = 1
        logger.warning(
            "device_stager: staged bytes %d + next group %d exceed the "
            "staging budget %d; staging depth %d -> 1 (set %s to override "
            "the budget)", pending, nbytes, budget, self._depth,
            STAGING_BUDGET_ENV,
        )

    def _stage(self, trainer, stream, assemble, steps, records, hooks, host):
        """Assemble and place one group; a failure here (a bad batch, a
        failed copy) becomes a group that carries the error, which the
        consumer raises in stream position."""
        t0 = time.monotonic()
        try:
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                kind, assembled = assemble()
                placed = _place_assembled(trainer, kind, assembled)
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
        except Exception as e:  # noqa: BLE001 — raised by the consumer
            return self._put((_STAGE_KIND_GROUP, StagedGroup(
                StagedGroup.KIND_SINGLES, None, steps=steps, records=records,
                hook_features=hooks, error=e, host=host,
            )))
        nbytes = pytree_bytes(placed)
        self._admit(nbytes, trainer.device)
        with self._bytes_lock:
            self._staged_bytes += nbytes
        _note_staged(time.monotonic() - t0)
        return self._put((_STAGE_KIND_GROUP, StagedGroup(
            kind, placed, steps=steps, records=records, hook_features=hooks,
            nbytes=nbytes, ready=ready, release=self._release_bytes, host=host,
        )))

    def _release_bytes(self, nbytes: int):
        with self._bytes_lock:
            self._staged_bytes -= nbytes

    def _produce(self):
        group: list = []
        try:
            trainer = self._get_trainer()
            stream = (
                torch.cuda.Stream(trainer.device)
                if getattr(trainer, "device", torch.device("cpu")).type == "cuda"
                else None
            )

            def stage_plain():
                return self._stage(
                    trainer, stream,
                    lambda: assemble_canonical_group(trainer, group, self._k, self._rows),
                    steps=len(group), records=sum(n for _f, _l, n in group),
                    hooks=[f for f, _l, _n in group], host=list(group),
                )

            for item in self._batches:
                if self._stop.is_set():
                    return
                if isinstance(item, (TaskMark, PreStacked)):
                    # stream order: pending plain batches go first
                    if group:
                        if not stage_plain():
                            return
                        group = []
                    if isinstance(item, TaskMark):
                        ok = self._put((_STAGE_KIND_MARK, item))
                    else:
                        ok = self._stage(
                            trainer, stream,
                            lambda item=item: (
                                StagedGroup.KIND_STACKED, _assemble_prestacked(item)
                            ),
                            steps=item.num_steps, records=item.num_records,
                            hooks=[item.sample_features] * item.num_steps,
                            host=item,
                        )
                    if not ok:
                        return
                    continue
                features, labels = item
                if self._k == "auto":
                    self._k = resolve_steps_per_dispatch(
                        self._k, (features, labels),
                        deterministic=self._deterministic_auto,
                        device=trainer.device,
                    )
                group.append((features, labels, batch_rows(labels)))
                if len(group) == self._k:
                    if not stage_plain():
                        return
                    group = []
            if group and not stage_plain():
                return
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            self._put((_STAGE_KIND_ERROR, e))
            return
        self._put((_STAGE_KIND_DONE, None))

    # ---- consumer ----------------------------------------------------------

    def next_event(self, anatomy=None):
        """The next stream event as ``(kind, payload)``: a staged group, a
        :class:`TaskMark`, DONE, or a producer-side ERROR (returned, not
        raised: the cross-task consumer decides).  The wait is the
        consumer's share of the staging (the ``stall_ms`` total); under a
        step ``anatomy`` it is the ``h2d_transfer`` phase, with the wait
        for a staged group's copies to end."""
        if self._done:
            return _STAGE_KIND_DONE, None
        if anatomy is None:
            t0 = time.monotonic()
            kind, payload = self._q.get()
            _note_stall(time.monotonic() - t0)
        else:
            from elasticdl_tpu_torch.telemetry.anatomy import PHASE_H2D_TRANSFER

            with anatomy.phase(PHASE_H2D_TRANSFER):
                t0 = time.monotonic()
                kind, payload = self._q.get()
                if kind == _STAGE_KIND_GROUP:
                    payload.wait_copied()
                _note_stall(time.monotonic() - t0)
        if kind in (_STAGE_KIND_DONE, _STAGE_KIND_ERROR):
            self._done = True
        return kind, payload

    def next_staged(self, anatomy=None) -> StagedGroup | None:
        """The next :class:`StagedGroup` in stream order, or None at the
        end; an upstream error is raised here, in its position.  Marks are
        skipped."""
        while True:
            kind, payload = self.next_event(anatomy)
            if kind == _STAGE_KIND_DONE:
                return None
            if kind == _STAGE_KIND_ERROR:
                raise payload
            if kind == _STAGE_KIND_GROUP:
                return payload

    def __iter__(self):
        while True:
            staged = self.next_staged()
            if staged is None:
                return
            yield staged

    def close(self):
        """Stop the producer, releasing it if it is blocked on a full
        queue; staged groups never taken die with the queue."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


# ---- the pipelined dispatch loop --------------------------------------------


def _dispatch_event(trainer):
    """A CUDA event recorded after a dispatch on the trainer's current
    stream, or None on the CPU (the dispatch already ran)."""
    device = getattr(trainer, "device", None)
    if device is None or device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _wait(event):
    """Retire one dispatch: wait for its event."""
    if event is not None:
        event.synchronize()


class _DispatchEngine:
    """The dispatch half of both pipelined loops: one take per group,
    the hooks' cadence, the retire window (a deque of CUDA events), and
    under a step ``anatomy`` each group's timed dispatch and commit."""

    def __init__(self, get_trainer, depth, pre_batch, post_group, ctx, anatomy=None):
        self._get_trainer = get_trainer
        self._depth = depth
        self._pre = pre_batch
        self._post = post_group
        self._ctx = ctx
        self._anatomy = anatomy
        self._inflight: deque = deque()
        self.processed = 0

    def _retire_push(self, trainer):
        # keep at most `depth` dispatched groups in flight: blocking on
        # the oldest bounds the device's queue while the next group is
        # issued behind the current one
        self._inflight.append(_dispatch_event(trainer))
        if len(self._inflight) > self._depth:
            _wait(self._inflight.popleft())

    def dispatch(self, staged: StagedGroup, run_hooks: bool = True):
        if staged.error is not None:
            # the serial path would have raised the same error from the
            # same pad or placement on this thread
            raise staged.error
        if run_hooks and self._pre is not None:
            for features in staged.hook_features:
                self._pre(features)
        trainer = self._get_trainer()
        note_boundary_dispatch()
        anatomy = self._anatomy
        if anatomy is None:
            if staged.kind == StagedGroup.KIND_STACKED:
                with self._ctx():
                    trainer.train_steps_stacked(*staged.take())
            else:
                for placed in staged.take():
                    with self._ctx():
                        trainer.train_step(*placed)
            self._retire_push(trainer)
        else:
            # each dispatch waits for its stream: nothing is in flight
            from elasticdl_tpu_torch.telemetry.anatomy import timed_device_dispatch

            if staged.kind == StagedGroup.KIND_STACKED:
                placed = staged.take()
                with self._ctx():
                    timed_device_dispatch(
                        anatomy, lambda: trainer.train_steps_stacked(*placed), trainer.device
                    )
            else:
                for placed in staged.take():
                    with self._ctx():
                        timed_device_dispatch(
                            anatomy, lambda placed=placed: trainer.train_step(*placed),
                            trainer.device,
                        )
        self.processed += staged.records
        if self._post is not None:
            self._post()
        if anatomy is not None:
            anatomy.commit(steps=staged.steps, records=staged.records, step=trainer.step)

    def drain(self):
        # the boundary barrier: every dispatched group retires before the
        # caller may report its task
        while self._inflight:
            _wait(self._inflight.popleft())


def run_pipelined_steps(
    get_trainer: Callable,
    batches: Iterable,
    k,
    *,
    canonical_rows: int,
    pre_batch: Callable | None = None,
    post_group: Callable | None = None,
    dispatch_ctx: Callable | None = None,
    deterministic_auto: bool = False,
    pipeline_depth: int | None = None,
    anatomy=None,
) -> int:
    """The ``--device_prefetch`` body of ``run_stacked_steps``: the same
    grouping, hooks (``pre_batch`` once per step before its group,
    ``post_group`` after every dispatch) and accounting, with groups
    staged off-thread:

    - the FIRST group runs on this thread (its ``pre_batch`` builds the
      trainer the stager places for), and a :class:`DeviceStager`, started
      before it dispatches, stages every later group;
    - dispatches retire behind in a window of :func:`stage_depth`, which
      drains before this returns, so the caller's task report never
      covers a group still running.

    Under a step ``anatomy`` the window is 1, the first group's fetch,
    assembly and copies are timed on this thread, and a staged group's
    ``h2d_transfer`` is the consumer's wait for it and its copies."""
    ctx = dispatch_ctx or contextlib.nullcontext
    rows = int(canonical_rows)
    depth = stage_depth(anatomy, pipeline_depth)
    if anatomy is not None:
        from elasticdl_tpu_torch.telemetry.anatomy import (
            PHASE_ASSEMBLE,
            PHASE_H2D_TRANSFER,
            PHASE_HOST_FETCH,
            wait_for_device,
        )

        pre_batch = anatomy.wrapped_hook(pre_batch)
        post_group = anatomy.wrapped_hook(post_group)
    engine = _DispatchEngine(get_trainer, depth, pre_batch, post_group, ctx, anatomy)
    it = iter(batches)

    def pull():
        if anatomy is None:
            return next(it, None)
        with anatomy.phase(PHASE_HOST_FETCH):
            return next(it, None)

    def place(trainer, kind, assembled):
        if anatomy is None:
            return _place_assembled(trainer, kind, assembled)
        with anatomy.phase(PHASE_H2D_TRANSFER):
            placed = _place_assembled(trainer, kind, assembled)
            wait_for_device(trainer.device)
        return placed

    # ---- the first group, on this thread (it builds the trainer) -----------
    warm: list = []
    warm_prestacked = None
    ended = False
    while True:
        item = pull()
        if item is None:
            ended = True
            break
        if isinstance(item, PreStacked):
            warm_prestacked = item
            break
        features, labels = item
        if pre_batch is not None:
            pre_batch(features)
        if k == "auto":
            k = resolve_steps_per_dispatch(
                k, (features, labels), deterministic=deterministic_auto,
                device=get_trainer().device,
            )
        warm.append((features, labels, batch_rows(labels)))
        if len(warm) == k:
            break
    def start_stager():
        return DeviceStager(
            get_trainer, it, k, rows, deterministic_auto=deterministic_auto,
            depth=max(1, depth - 1),
        )

    stager = None
    try:
        if warm:
            trainer = get_trainer()
            if anatomy is None:
                kind, assembled = assemble_canonical_group(trainer, warm, k, rows)
            else:
                with anatomy.phase(PHASE_ASSEMBLE):
                    kind, assembled = assemble_canonical_group(trainer, warm, k, rows)
            placed = place(trainer, kind, assembled)
            if not ended:
                # the stager starts once the first group is on the device
                # and before it dispatches: the second group is staged
                # while the first computes (a task of two groups overlaps
                # too), and its copies do not contend with the first's
                stager = start_stager()
            engine.dispatch(
                StagedGroup(
                    kind, placed,
                    steps=len(warm), records=sum(n for _f, _l, n in warm),
                    hook_features=(),
                ),
                run_hooks=False,  # they ran as the batches arrived
            )
        if warm_prestacked is not None:
            if pre_batch is not None:
                for _ in range(warm_prestacked.num_steps):
                    pre_batch(warm_prestacked.sample_features)
            trainer = get_trainer()
            engine.dispatch(
                StagedGroup(
                    StagedGroup.KIND_STACKED,
                    place(trainer, StagedGroup.KIND_STACKED, _assemble_prestacked(warm_prestacked)),
                    steps=warm_prestacked.num_steps,
                    records=warm_prestacked.num_records, hook_features=(),
                ),
                run_hooks=False,
            )
        if ended:
            return engine.processed

        # ---- steady state: stage off-thread, retire behind -----------------
        if stager is None:
            # a ready-made first group built the trainer in hooks of its
            # own, so its stager starts after it
            stager = start_stager()
        while True:
            staged = stager.next_staged(anatomy)
            if staged is None:
                break
            engine.dispatch(staged)
    finally:
        if stager is not None:
            stager.close()
        engine.drain()
    return engine.processed


def run_pipelined_task_stream(
    get_trainer: Callable,
    tasks: Iterable,
    k,
    *,
    canonical_rows: int,
    pre_batch: Callable | None = None,
    post_group: Callable | None = None,
    dispatch_ctx: Callable | None = None,
    deterministic_auto: bool = False,
    task_start: Callable | None = None,
    task_done: Callable | None = None,
    pipeline_depth: int | None = None,
    anatomy=None,
) -> int:
    """The ``--boundary_fusion`` task loop: one persistent
    :class:`DeviceStager` walks the whole task stream, so the next
    task's first groups are staged while the current task's last ones
    compute.

    ``tasks`` yields ``(task_id, task, batches)`` (the
    ``TaskPrefetcher``'s triples), pulled from the stager's thread.
    ``task_start(task_id, task)`` runs at a task's START mark;
    ``task_done(task_id, task, records)`` (the report) runs only after
    that task's own dispatch window drained, so a task is reported when
    all its groups ran.  The FIRST task runs through
    :func:`run_pipelined_steps` (its first group builds the trainer the
    stager places for).  If ``task_done`` raises, the stager closes and
    its staged groups die untaken: never dispatched, never reported.
    Marks reset the grouping per task, so dispatch order, shapes and
    results are those of the drain-at-boundary path."""
    it = iter(tasks)
    first = next(it, None)
    if first is None:
        return 0
    tid, task, batches = first
    if task_start is not None:
        task_start(tid, task)
    total = run_pipelined_steps(
        get_trainer, batches, k, pre_batch=pre_batch, post_group=post_group,
        dispatch_ctx=dispatch_ctx, deterministic_auto=deterministic_auto,
        canonical_rows=canonical_rows, pipeline_depth=pipeline_depth,
        anatomy=anatomy,
    )
    note_task_boundary()
    if task_done is not None:
        task_done(tid, task, total)

    ctx = dispatch_ctx or contextlib.nullcontext
    depth = stage_depth(anatomy, pipeline_depth)
    if anatomy is not None:
        pre_batch = anatomy.wrapped_hook(pre_batch)
        post_group = anatomy.wrapped_hook(post_group)
    engine = _DispatchEngine(get_trainer, depth, pre_batch, post_group, ctx, anatomy)

    def flatten():
        # on the stager's thread: marks delimit the tasks in the stream
        for tid_, task_, batches_ in it:
            yield TaskMark(TaskMark.START, tid_, task_)
            yield from batches_
            yield TaskMark(TaskMark.END, tid_, task_)

    # one more queue slot than the per-task stager: a boundary's two
    # marks take slots while the next task's first group is staged
    stager = DeviceStager(
        get_trainer, flatten(), k, int(canonical_rows),
        deterministic_auto=deterministic_auto, depth=depth,
    )
    task_records = 0
    try:
        while True:
            kind, payload = stager.next_event(anatomy)
            if kind == _STAGE_KIND_DONE:
                break
            if kind == _STAGE_KIND_ERROR:
                raise payload
            if kind == _STAGE_KIND_MARK:
                if payload.kind == TaskMark.START:
                    task_records = 0
                    if task_start is not None:
                        task_start(payload.tid, payload.task)
                else:
                    # retire this task's window, then its report, while the
                    # stager goes on with the next task
                    engine.drain()
                    note_task_boundary()
                    if task_done is not None:
                        task_done(payload.tid, payload.task, task_records)
                continue
            engine.dispatch(payload)
            total += payload.records
            task_records += payload.records
    finally:
        stager.close()
        engine.drain()
        clear_boundary_mark()
    return total
