"""Causal span tracing across the master↔worker control plane; the
counterpart of ``elasticdl_tpu/telemetry/tracing.py``, with its span
names, record fields and ``spans.jsonl`` format, so each package's
``trace`` CLI reads the other's telemetry directory.

Dapper-style distributed tracing with zero dependencies: every span
carries ``trace_id`` / ``span_id`` / ``parent_span_id``, one TASK is one
trace across master and workers (the trace context rides the RPC
messages — :mod:`elasticdl_tpu_torch.rpc.messages`), and the reform state
machine gets its own trace so ``trace analyze`` can break re-formation
downtime into named phases.

Clocks: spans record ``start``/``end`` on the machine-wide
CLOCK_MONOTONIC (same discipline as the event log — single-host runs
subtract across processes) plus a wall-clock ``time`` at span start.

Storage: finished spans accumulate in a bounded in-memory ring buffer
and are spilled as JSONL batches into ``<telemetry_dir>/spans.jsonl``
(O_APPEND, shared by master and worker subprocesses like
``events.jsonl``; size-based rotation via :mod:`.events`).  A span lost
to a SIGKILL'd buffer is an accepted trade — lifecycle emitters call
:func:`flush` at phase boundaries, and the chaos preempt path kills
workers whose spans of record (dispatch, recovery, reform) live on the
master side.

Sampling: hot-path spans (``train_step``, ``heartbeat``) pass
``sampled=True`` and are kept deterministically 1-in-N per name
(``--trace_sample_rate``; the count-based rule is reproducible across
runs, unlike coin flips).  Lifecycle/reform spans are always recorded.

Overhead contract: with no tracer installed every module-level hook is
one global load and a ``None`` check — the same bar as
:mod:`.worker_hooks` (tests poison the clock to prove it).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from elasticdl_tpu_torch.telemetry.events import (
    read_jsonl,
    rotate_if_needed,
)
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

SPANS_FILENAME = "spans.jsonl"

TRACE_SAMPLE_RATE_ENV = "ELASTICDL_TPU_TRACE_SAMPLE_RATE"
TRACE_PARENT_ENV = "ELASTICDL_TPU_TRACE_PARENT"

DEFAULT_SAMPLE_RATE = 0.05

# ---- span-name vocabulary (one definition site per name; linted) ------------

SPAN_TASK_LIFECYCLE = "task_lifecycle"  # master: lease -> report
SPAN_TASK_EXECUTE = "task_execute"  # worker: fetch + steps of one task
SPAN_GET_TASK = "get_task"  # worker: the lease RPC
SPAN_DATA_FETCH = "data_fetch"  # worker: first-batch host decode
SPAN_TRAIN_STEP = "train_step"  # worker: inter-step interval (sampled)
SPAN_REPORT_TASK = "report_task"  # worker: the report RPC
SPAN_HEARTBEAT = "heartbeat"  # worker: liveness ping (sampled)
SPAN_REFORM = "reform"  # master: whole re-formation
SPAN_REFORM_FENCE = "reform_fence_recover"  # master: fence + task recovery
SPAN_REFORM_RELAUNCH = "reform_relaunch"  # master: kill + respawn world
SPAN_WORLD_JOIN = "world_join"  # worker: process start -> world joined
SPAN_WORLD_INITIALIZE = "world_initialize"  # worker: the process group init
SPAN_TRAINER_BUILD = "trainer_build"  # worker: SPMDTrainer construction
SPAN_CHECKPOINT_SAVE = "checkpoint_save_snapshot"  # device->host snapshot
SPAN_CHECKPOINT_RESTORE = "checkpoint_restore_state"  # restore + re-place
SPAN_PROFILE_WINDOW = "profile_window"  # torch.profiler capture window
SPAN_REPLICA_PUSH = "replica_push"  # worker: snapshot + ring-neighbor push
SPAN_REPLICA_HARVEST = "replica_harvest"  # master: fetch peer shards on reform
SPAN_REPLICA_RESTORE = "replica_restore"  # worker: restore from peer RAM
SPAN_COMPILE = "compile"  # any process: a graph capture or new dispatch shape
SPAN_MASTER_RESTART = "master_restart"  # master: restore start -> serving
SPAN_JOURNAL_REPLAY = "journal_replay"  # master: journal replay proper
SPAN_WORKER_REHOME = "worker_rehome"  # master: one re-home handshake
SPAN_SLICE_LOSS = "slice_loss"  # master: slice death detect -> re-plan
SPAN_MESH_RESIZE = "mesh_resize"  # master: hybrid mesh re-plan (resize)
SPAN_AUTOSCALE_DECISION = "autoscale_decision"  # master: one SLO decision
SPAN_RPC_DEGRADED = "rpc_degraded"  # netem window: link slow/blackholed
SPAN_STEP_ANATOMY = "step_anatomy"  # one dispatch phase (phase= attr)
SPAN_SERVING_REQUEST = "serving_request"  # serving: one request (sampled)
SPAN_MODEL_SWAP = "model_swap"  # serving: one hot model swap
SPAN_FLEET_FAULT = "fleet_fault"  # fleetsim: one mass-fault injection
SPAN_SLO_WATCH = "slo_watch"  # slo: burn window, first bad eval -> fire
# serving fleet request tracing: one predict request is ONE trace —
# the client's root, the router's (re)route children, the replica's
# queue-vs-engine split, and the shared dispatch group LINKED (not
# parented: one group serves many traces) to every member request
SPAN_PREDICT_REQUEST = "predict_request"  # client: root, send -> response
SPAN_SERVING_ROUTE = "route"  # router: first routing attempt
SPAN_SERVING_REROUTE = "reroute"  # router: retry/eviction re-attempt
SPAN_SERVING_QUEUE = "queue"  # replica: submit -> first dispatch
SPAN_SERVING_ENGINE = "engine"  # replica: first dispatch -> delivered
SPAN_SERVING_DISPATCH = "serving_dispatch"  # replica: one batch group
SPAN_LIVE_PUSH = "live_push"  # master: harvest -> serving swap accepted


def gen_trace_id() -> str:
    """128-bit trace id as 32 hex chars (W3C traceparent width)."""
    return os.urandom(16).hex()


def gen_span_id() -> str:
    """64-bit span id as 16 hex chars."""
    return os.urandom(8).hex()


class Span:
    """One in-flight span; ``end()`` hands it to the recorder.  Usable
    as a context manager (ends on exit, success/error annotated)."""

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_span_id",
        "start_time",
        "start",
        "attrs",
        "_recorder",
        "_ended",
    )

    def __init__(self, recorder, name, trace_id, parent_span_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = gen_span_id()
        self.parent_span_id = parent_span_id
        self.start_time = time.time()
        self.start = time.monotonic()
        self.attrs = attrs
        self._recorder = recorder
        self._ended = False

    def set(self, **attrs):
        self.attrs.update(attrs)

    @property
    def context(self) -> dict:
        """The propagatable trace context (what rides an RPC field)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def end(self, **attrs):
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self._recorder._finish(self, time.monotonic())

    def __enter__(self):
        return self

    def __exit__(self, exc_type, _exc, _tb):
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False


class SpanRecorder:
    """Thread-safe span sink for one process.

    ``path=''`` disables persistence (spans are dropped at ``_finish``)
    but the object stays fully usable, so call sites never branch.
    """

    def __init__(
        self,
        path: str = "",
        role: str = "worker",
        worker_id: int = 0,
        process_id: int = 0,
        generation: int = 0,
        sample_rate: float = DEFAULT_SAMPLE_RATE,
        buffer_spans: int = 64,
    ):
        self._path = path
        self._role = role
        self._worker_id = worker_id
        self._process_id = process_id
        self._generation = generation
        # 1-in-N deterministic sampling; rate >= 1 keeps everything,
        # rate <= 0 drops every sampled-class span
        self._sample_period = (
            1 if sample_rate >= 1.0 else (0 if sample_rate <= 0.0 else round(1.0 / sample_rate))
        )
        self._sample_counts: dict[str, int] = {}  # guarded-by: _lock
        self._buffer: list[dict] = []  # guarded-by: _lock
        self._buffer_spans = max(1, buffer_spans)
        self._lock = threading.Lock()
        self._last_step_at: float | None = None
        self._last_step: int | None = None
        # thread-local context stack: nested spans parent implicitly
        self._tls = threading.local()
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return bool(self._path)

    @property
    def generation(self) -> int:
        return self._generation

    # ---- context stack -----------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_context(self) -> dict | None:
        stack = self._stack()
        return stack[-1] if stack else None

    # ---- span creation -----------------------------------------------------

    def _resolve(self, trace_ctx: dict | None) -> tuple[str, str]:
        """(trace_id, parent_span_id) from an explicit context, the
        thread's implicit stack, or a fresh root trace."""
        ctx = trace_ctx if (trace_ctx and trace_ctx.get("trace_id")) else self.current_context()
        if ctx:
            return ctx["trace_id"], ctx.get("span_id", "")
        return gen_trace_id(), ""

    def start_span(self, name: str, trace_ctx: dict | None = None, **attrs) -> Span:
        trace_id, parent = self._resolve(trace_ctx)
        return Span(self, name, trace_id, parent, attrs)

    @contextlib.contextmanager
    def span(self, name: str, trace_ctx: dict | None = None, **attrs):
        """Context-managed span that also pushes itself as the implicit
        parent for spans opened inside the block."""
        sp = self.start_span(name, trace_ctx=trace_ctx, **attrs)
        stack = self._stack()
        stack.append(sp.context)
        try:
            yield sp
        except BaseException as ex:
            sp.attrs.setdefault("error", type(ex).__name__)
            raise
        finally:
            stack.pop()
            sp.end()

    def record_span(
        self,
        name: str,
        start_monotonic: float,
        end_monotonic: float,
        trace_ctx: dict | None = None,
        sampled: bool = False,
        **attrs,
    ) -> bool:
        """Record a RETROACTIVE span from explicit clock readings (the
        per-step and RPC hooks measure first, record after).  Returns
        False when the sampler dropped it."""
        if sampled and not self._sample(name):
            return False
        trace_id, parent = self._resolve(trace_ctx)
        record = self._base_record(name, trace_id, parent)
        record["time"] = time.time() - (time.monotonic() - start_monotonic)
        record["start"] = start_monotonic
        record["end"] = end_monotonic
        if attrs:
            record.update(attrs)
        self._push(record)
        return True

    def on_step(self, step: int):
        """The hot-path step hook: record a sampled ``train_step`` span
        covering the interval since the previous call (the same
        semantics as :func:`worker_hooks.record_step` durations).  A
        generation change resets the interval (new recorder per world,
        but the local executor reuses one)."""
        now = time.monotonic()
        last_at, last_step = self._last_step_at, self._last_step
        self._last_step_at, self._last_step = now, step
        if last_at is None:
            return
        self.record_span(
            SPAN_TRAIN_STEP,
            last_at,
            now,
            sampled=True,
            step=int(last_step) if last_step is not None else None,
        )

    def should_sample(self, name: str) -> bool:
        """Public face of the deterministic 1-in-N sampler for callers
        that make ONE keep/drop decision covering a group of related
        records (the step-anatomy phase spans of one dispatch)."""
        return self._sample(name)

    def _sample(self, name: str) -> bool:
        if self._sample_period == 1:
            return True
        if self._sample_period == 0:
            return False
        with self._lock:
            n = self._sample_counts.get(name, 0)
            self._sample_counts[name] = n + 1
        return n % self._sample_period == 0

    # ---- persistence -------------------------------------------------------

    def _base_record(self, name, trace_id, parent_span_id) -> dict:
        return {
            "span": name,
            "trace_id": trace_id,
            "span_id": gen_span_id(),
            "parent_span_id": parent_span_id,
            "role": self._role,
            "worker_id": self._worker_id,
            "process_id": self._process_id,
            "generation": self._generation,
        }

    def _finish(self, span: Span, end_monotonic: float):
        record = {
            "span": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_span_id": span.parent_span_id,
            "role": self._role,
            "worker_id": self._worker_id,
            "process_id": self._process_id,
            "generation": self._generation,
            "time": span.start_time,
            "start": span.start,
            "end": end_monotonic,
        }
        if span.attrs:
            record.update(span.attrs)
        self._push(record)

    def _push(self, record: dict):
        if not self._path:
            return
        with self._lock:
            self._buffer.append(record)
            if len(self._buffer) < self._buffer_spans:
                return
            batch, self._buffer = self._buffer, []
        self._write(batch)

    def flush(self):
        """Spill everything buffered so far to disk."""
        with self._lock:
            batch, self._buffer = self._buffer, []
        if batch:
            self._write(batch)

    def _write(self, batch: list[dict]):
        try:
            rotate_if_needed(self._path)
            payload = "".join(json.dumps(r) + "\n" for r in batch)
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(payload)
        except OSError:
            logger.exception("Telemetry span log write failed")


def read_spans(path: str) -> list[dict]:
    """Parse one spans.jsonl (plus rotated shards), skipping torn lines."""
    return read_jsonl(path)


# ---- module-level install + zero-cost-when-disabled accessors ---------------

_active: SpanRecorder | None = None


def install(
    telemetry_dir: str,
    role: str = "worker",
    worker_id: int = 0,
    process_id: int = 0,
    generation: int = 0,
    sample_rate: float | None = None,
) -> SpanRecorder | None:
    """Install the process-wide tracer writing to
    ``<telemetry_dir>/spans.jsonl``; returns it.  With no dir the
    process has no tracer from here on (None), as
    ``worker_hooks.install("")`` leaves no recorder: a run without
    telemetry must not write into an earlier run's directory."""
    global _active
    if not telemetry_dir:
        _active = None
        return None
    if sample_rate is None:
        sample_rate = sample_rate_from_env()
    _active = SpanRecorder(
        os.path.join(telemetry_dir, SPANS_FILENAME),
        role=role,
        worker_id=worker_id,
        process_id=process_id,
        generation=generation,
        sample_rate=sample_rate,
    )
    return _active


def install_from_env(
    worker_id: int = 0, process_id: int = 0, generation: int = 0
) -> SpanRecorder | None:
    """Install from ``ELASTICDL_TPU_TELEMETRY_DIR`` (worker subprocess
    entry); no-op when the master did not configure telemetry."""
    from elasticdl_tpu_torch.telemetry.worker_hooks import TELEMETRY_DIR_ENV

    return install(
        os.environ.get(TELEMETRY_DIR_ENV, ""),
        worker_id=worker_id,
        process_id=process_id,
        generation=generation,
    )


def sample_rate_from_env() -> float:
    try:
        return float(os.environ.get(TRACE_SAMPLE_RATE_ENV, DEFAULT_SAMPLE_RATE))
    except ValueError:
        return DEFAULT_SAMPLE_RATE


def parent_from_env() -> dict | None:
    """The trace context the spawner exported (the reform trace for a
    relaunched world), or None."""
    raw = os.environ.get(TRACE_PARENT_ENV, "")
    if not raw:
        return None
    try:
        ctx = json.loads(raw)
    except ValueError:
        return None
    return ctx if isinstance(ctx, dict) and ctx.get("trace_id") else None


def uninstall():
    global _active
    _active = None


def get_tracer() -> SpanRecorder | None:
    return _active


@contextlib.contextmanager
def trace_span(name: str, trace_ctx: dict | None = None, **attrs):
    """Context-managed span on the installed tracer; yields None (and
    costs one global load + None check) when tracing is disabled."""
    tracer = _active
    if tracer is None:
        yield None
        return
    with tracer.span(name, trace_ctx=trace_ctx, **attrs) as sp:
        yield sp


def record_step_span(step: int):
    """THE hot-path hook: one global load + None check when disabled."""
    tracer = _active
    if tracer is None:
        return
    tracer.on_step(step)


def trace_fetches(iterable, trace_ctx: dict | None = None, span=None):
    """Wrap a batch stream so the FIRST host-side fetch (shard open +
    decode — the serial cost a step actually waits on) becomes a
    ``data_fetch`` span, and the total fetch wall-clock is annotated on
    ``span`` (the task's execute span) when given.  Passthrough when
    tracing is disabled."""
    tracer = _active
    if tracer is None:
        yield from iterable
        return
    it = iter(iterable)
    first = True
    fetch_secs = 0.0
    while True:
        t0 = time.monotonic()
        try:
            item = next(it)
        except StopIteration:
            break
        t1 = time.monotonic()
        fetch_secs += t1 - t0
        if first:
            first = False
            tracer.record_span(
                SPAN_DATA_FETCH, t0, t1, trace_ctx=trace_ctx
            )
        yield item
    if span is not None:
        span.set(data_fetch_secs=round(fetch_secs, 6))


def flush():
    tracer = _active
    if tracer is not None:
        tracer.flush()
