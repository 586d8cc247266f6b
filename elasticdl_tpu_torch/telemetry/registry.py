"""The process-local metrics registry with Prometheus text exposition; the
counterpart of ``elasticdl_tpu/telemetry/registry.py``.

Plain Python, no ``prometheus_client``: the master exposes its metrics
from the same minimal install the workers run in.  Three kinds:

- :class:`Counter`: monotone totals (tasks, records, re-formations).
  ``set_total`` exists only to mirror an external monotone aggregate
  (the dispatcher's exec-counter sums, the heartbeat-shipped totals)
  into the exposition; normal code calls ``inc``.
- :class:`Gauge`: point-in-time values (live workers, model version,
  generation).
- :class:`Histogram`: cumulative buckets, by default the log-spaced
  step-latency buckets (1 ms .. 60 s); ``set_totals`` mirrors an
  external distribution monotonically, slot by slot.

Registering a name again with another label set returns another child
of the same family (the Prometheus data model); registering it as
another kind raises.  :meth:`MetricsRegistry.exposition` renders the
Prometheus text format 0.0.4, which ``/metrics`` serves
(``telemetry/httpd.py``); with the same operations it is byte-equal to
the JAX package's.

The serving engine files its request phases into
:data:`SERVING_LATENCY_BUCKETS` for the ``serving_status`` probe beat:
the step buckets floor at 1 ms, where a warm in-process predict
dispatch lives, so serving extends the same 1-2.5-5 ladder two decades
down (100 us resolution) and caps at 10 s.

Overhead: an update takes one small per-metric lock, and the hot step
path touches no registry at all (workers ship totals on the heartbeat,
``telemetry/worker_hooks.py``).
"""

from __future__ import annotations

import math
import re
import threading

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# log-spaced step-latency buckets (seconds): 1-2.5-5 per decade, 1ms-60s
STEP_LATENCY_BUCKETS = (
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
    30.0,
    60.0,
)

# log-spaced serving latency buckets (seconds): the step buckets two
# decades further down, capped at 10 s.  The step buckets stay as they
# are: a change there would desynchronize the monotone set_totals mirror
# between old and new processes mid-run.
SERVING_LATENCY_BUCKETS = (
    0.0001,
    0.00025,
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)


def _validate_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must be snake_case "
            "([a-z][a-z0-9_]*)"
        )
    return name


def _format_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    parts = []
    for key, value in labels:
        value = str(value).replace("\\", r"\\").replace('"', r"\"")
        parts.append(f'{key}="{value}"')
    return "{" + ",".join(parts) + "}"


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == int(value):
        return str(int(value))
    return repr(value)


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    def set_total(self, total: float):
        """Mirror an externally-accumulated monotone total (never lower
        the exposed value — scrapes must stay monotone)."""
        with self._lock:
            self._value = max(self._value, float(total))

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    def __init__(self):
        self._value = 0.0

    def set(self, value: float):
        self._value = float(value)

    def inc(self, amount: float = 1.0):
        self._value += amount

    def dec(self, amount: float = 1.0):
        self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    def __init__(self, buckets=STEP_LATENCY_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    @property
    def bounds(self) -> tuple[float, ...]:
        return self._bounds

    def observe(self, value: float):
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def set_totals(self, bucket_counts: dict, total_sum: float, total_count: int):
        """Mirror an externally-accumulated distribution (the
        histogram analogue of :meth:`Counter.set_total`): per-bucket
        NON-cumulative counts keyed by upper bound (floats, or the
        string forms a msgpack payload carries; ``inf``/``"inf"`` is
        the overflow slot).  Monotone per slot — a reordered or
        restarted source can never walk the exposed counts backward."""
        parsed: dict[float, int] = {}
        for bound, count in (bucket_counts or {}).items():
            try:
                parsed[float(bound)] = int(count)
            except (TypeError, ValueError):
                continue
        with self._lock:
            for i, bound in enumerate(self._bounds):
                if bound in parsed:
                    self._counts[i] = max(self._counts[i], parsed[bound])
            if math.inf in parsed:
                self._counts[-1] = max(self._counts[-1], parsed[math.inf])
            self._sum = max(self._sum, float(total_sum))
            self._count = max(self._count, int(total_count))

    def snapshot(self) -> dict:
        """Cumulative bucket counts keyed by upper bound, plus sum/count
        (the exposition shape, reusable by tests and the report CLI)."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        cumulative, acc = {}, 0
        for bound, count in zip(self._bounds, counts[:-1]):
            acc += count
            cumulative[bound] = acc
        cumulative[math.inf] = acc + counts[-1]
        return {"buckets": cumulative, "sum": total_sum, "count": total_count}

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum


_KINDS = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class _Family:
    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        # label tuple -> metric instance
        self.children: dict[tuple[tuple[str, str], ...], object] = {}


class MetricsRegistry:
    """Name -> family -> labeled children; renders Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        # run at exposition time so point-in-time gauges (queue depths,
        # mirrored totals) are fresh without any hot-path bookkeeping
        self._collect_callbacks: list = []

    # ---- registration (get-or-create) --------------------------------------

    def _child(self, name, kind, help_text, labels, factory):
        _validate_name(name)
        label_key = tuple(sorted((labels or {}).items()))
        for key, _ in label_key:
            _validate_name(key)
        with self._lock:
            family = self._families.get(name)
            if family is None:
                family = self._families[name] = _Family(name, kind, help_text)
            elif family.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {family.kind}, "
                    f"cannot re-register as {kind}"
                )
            child = family.children.get(label_key)
            if child is None:
                child = family.children[label_key] = factory()
            return child

    def counter(self, name: str, help_text: str = "", labels=None) -> Counter:
        return self._child(name, "counter", help_text, labels, Counter)

    def gauge(self, name: str, help_text: str = "", labels=None) -> Gauge:
        return self._child(name, "gauge", help_text, labels, Gauge)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labels=None,
        buckets=STEP_LATENCY_BUCKETS,
    ) -> Histogram:
        return self._child(
            name, "histogram", help_text, labels, lambda: Histogram(buckets)
        )

    def add_collect_callback(self, callback):
        """``callback(registry)`` runs before every exposition."""
        self._collect_callbacks.append(callback)

    def prune_children(self, name: str, keep_labels) -> int:
        """Drop every child of family ``name`` whose label set is not in
        ``keep_labels`` (an iterable of label dicts); returns how many
        were dropped.  This exists for CARDINALITY-BOUNDED families
        (per-worker series): when the fleet outgrows the series budget
        the per-worker children are replaced by aggregate ones, and the
        stale individual series must leave the exposition — Prometheus
        would otherwise keep scraping a thousand frozen gauges."""
        keep = {
            tuple(sorted((labels or {}).items())) for labels in keep_labels
        }
        with self._lock:
            family = self._families.get(name)
            if family is None:
                return 0
            drop = [key for key in family.children if key not in keep]
            for key in drop:
                del family.children[key]
            return len(drop)

    # ---- exposition --------------------------------------------------------

    def family_names(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def exposition(self) -> str:
        """Prometheus text format 0.0.4."""
        for callback in list(self._collect_callbacks):
            try:
                callback(self)
            except Exception:  # noqa: BLE001 — a scrape must never fail
                pass
        with self._lock:
            families = [
                (f.name, f.kind, f.help, dict(f.children))
                for f in self._families.values()
            ]
        lines = []
        for name, kind, help_text, children in sorted(families):
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for label_key in sorted(children):
                metric = children[label_key]
                if kind == "histogram":
                    snap = metric.snapshot()
                    for bound, cum in snap["buckets"].items():
                        le = label_key + (("le", _format_value(bound)),)
                        lines.append(
                            f"{name}_bucket{_format_labels(le)} {cum}"
                        )
                    labels = _format_labels(label_key)
                    lines.append(
                        f"{name}_sum{labels} {_format_value(snap['sum'])}"
                    )
                    lines.append(f"{name}_count{labels} {snap['count']}")
                else:
                    lines.append(
                        f"{name}{_format_labels(label_key)} "
                        f"{_format_value(metric.value)}"
                    )
        return "\n".join(lines) + "\n"
