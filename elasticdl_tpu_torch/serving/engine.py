"""The predict engine: one model on one device, one canonical batch shape.

The counterpart of ``elasticdl_tpu/serving/engine.py``.  The engine loads
an export (the JAX package's layout: ``manifest.json`` + name-keyed
npz), builds the model and loads its weights onto ``device`` once, on
the first request, and serves dispatch groups padded to the SAME
canonical row count (repeat-last fill; the padded rows' outputs are
never sliced back to a request).  Every request leaf is conformed to the
feature spec the first request fixed (per-row shape check + dtype cast),
and the model's own host-side check (``validate_features``, e.g. token
ids in range) runs before anything reaches the device.

Per-request anatomy, sum-exact as in the JAX package: ``queue_wait``
(submit -> first dispatch group opens) + the batch-level phases its rows
traversed (``assemble``/``h2d_transfer``/``device_compute``/
``d2h_transfer``, shared by every request in the group, accumulated
across groups for requests that span several) + ``untracked`` (the
exact residual to its measured total).  ``device_compute`` ends at an
explicit device synchronise, so the compute never lands in
``d2h_transfer``.

Outputs come back as numpy arrays in the model's output dtype, as the
JAX engine's ``device_get`` returns them: numpy has no bf16 of its own,
so a bf16 output is the same bits viewed as ``ml_dtypes.bfloat16``, the
numpy type JAX itself returns (a view, no widening on the host).

Hot swap: ``swap_from_export``, ``swap_state_dicts`` (flat name-keyed
arrays: an export's npz, a checkpoint's or a replication blob's
``params/`` entries) and :class:`ExportDirWatcher` build a second module
with the new weights on the engine's device, then replace the served
``(model, version)`` pair, one attribute, under the swap lock.  The
dispatch loop reads that pair once per group, so an in-flight group
finishes on the weights and the version it started with, and the old
module's device memory is freed once no group holds it (the JAX engine
too holds both sets of leaves during a swap).  A swap that would not
advance the served version is refused as stale
(:data:`STALE_SWAP_PREFIX`), which makes ``swap_model`` a versioned put
under re-delivery.  The JAX engine counts XLA compiles to show that a
swap compiles nothing; the port has no compiler, and counts instead the
distinct input shapes it has dispatched (:attr:`ServingEngine.
shapes_dispatched`), which stays 1.

Every completed request also lands in monotone per-phase totals
(``phase_totals_snapshot``: ms, count and the ``SERVING_LATENCY_BUCKETS``
histogram), which ride the ``serving_status`` reply the router probes
with.  Not in this slice: trace spans, the event log, the Prometheus
registry and the memory ledger (slice 10b).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.serving.batcher import (
    Group,
    ShapeMismatchError,
    tree_rows,
)
from elasticdl_tpu_torch.telemetry.anatomy import (
    PHASE_ASSEMBLE,
    PHASE_D2H_TRANSFER,
    PHASE_DEVICE_COMPUTE,
    PHASE_H2D_TRANSFER,
    PHASE_QUEUE_WAIT,
    PHASE_UNTRACKED,
)
from elasticdl_tpu_torch.telemetry.registry import SERVING_LATENCY_BUCKETS
from elasticdl_tpu_torch.trainer.step import build_predict_step
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.export_utils import (
    build_with_weights,
    load_flats,
    read_manifest,
)
from elasticdl_tpu_torch.utils.flax_weights import flax_state_from_torch
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec
from elasticdl_tpu_torch.utils.tree_utils import map_tree, to_host

_PHASE_TOTAL = "total"

# the one composition site of the stale-refusal reason; the servicer
# classifies against this constant to set SwapModelResponse.stale
STALE_SWAP_PREFIX = "stale swap"


def _pad_rows(tree, rows: int):
    """Pad a feature tree's leading dim to exactly ``rows`` (repeat-last
    fill; the padded rows' outputs are never sliced back to a
    request)."""

    def _pad(x):
        x = np.asarray(x)
        n = x.shape[0]
        if n == rows:
            return x
        if n > rows:
            raise ShapeMismatchError(
                f"group of {n} rows exceeds the canonical shape ({rows})"
            )
        return np.concatenate(
            [x, np.repeat(x[-1:], rows - n, axis=0)], axis=0
        )

    if isinstance(tree, dict):
        return {k: _pad(v) for k, v in tree.items()}
    return _pad(tree)


def _shape_signature(tree) -> tuple:
    """A placed feature tree's shapes and dtypes, hashable."""
    if isinstance(tree, dict):
        return tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in sorted(tree.items())
        )
    return (tuple(tree.shape), str(tree.dtype))


class ServingEngine:
    """Loads an export, builds the model on the first request (the
    export carries no feature spec; the first request does), serves
    padded canonical-shape dispatch groups on ``device``, and swaps in
    newer weights under traffic."""

    def __init__(
        self,
        model_dir: str,
        canonical_rows: int,
        device: str | torch.device = "cuda",
        replica_id: int = 0,
    ):
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.canonical_rows = int(canonical_rows)
        self.replica_id = int(replica_id)
        manifest = read_manifest(model_dir)
        self._manifest = manifest
        self._spec = get_model_spec(
            manifest.get("model_zoo", ""),
            manifest["model_def"],
            model_params=manifest.get("model_params", {}),
        )
        self._predict_fn = build_predict_step(
            device_parse=self._spec.device_parse
        )
        # the served (model, version) pair, replaced whole: a reader
        # takes one attribute load, so it never pairs one version's
        # weights with another's number.  The model is None until the
        # lazy build
        self._swap_lock = threading.Lock()
        self._served: tuple = (  # guarded-by: _swap_lock (writes)
            None, int(manifest.get("model_version", 0))
        )
        # flat param/state dicts pending the lazy build (replaced by a
        # pre-build swap; None once built)
        self._pending_flats = load_flats(model_dir)
        self._feature_spec = None  # {key: (row_shape, dtype)} or (shape, dtype)
        self.requests_served = 0
        self.rows_served = 0
        self.dispatches = 0
        self.errors = 0
        # requests the batcher shed (the servicer counts them here)
        self.rejected = 0
        self.swaps_applied = 0
        self.last_swap_ms = 0.0
        # the input shapes dispatched to the model: the JAX engine's
        # compile count has no compiler to count here, and this is what
        # it shows there, one canonical shape whatever the traffic
        self._shapes: set = set()
        # probe-beat phase totals (monotone, {phase: {"ms", "count",
        # "buckets"}}, bucket keys stringified for the wire), shipped
        # on every serving_status reply
        self._beat_lock = threading.Lock()
        self._phase_totals: dict[str, dict] = {}  # guarded-by: _beat_lock

    # ---- build -------------------------------------------------------------

    @property
    def built(self) -> bool:
        return self._served[0] is not None

    @property
    def version(self) -> int:
        return self._served[1]

    @property
    def model(self) -> torch.nn.Module | None:
        return self._served[0]

    @property
    def shapes_dispatched(self) -> int:
        """Distinct input shapes dispatched to the model (the port's
        ``compile_count``): 1 in steady state."""
        return len(self._shapes)

    def ensure_built(self, sample_features):
        """Build the model with the export's (or a pre-build swap's)
        weights on ``device`` and record the feature spec from the first
        request's features."""
        if self._served[0] is not None:
            return
        with self._swap_lock:
            if self._served[0] is not None:
                return
            flat_params, flat_state = self._pending_flats
            model = build_with_weights(
                self._spec, flat_params, flat_state, self.device
            )
            self._feature_spec = self._spec_of(sample_features)
            self._pending_flats = None
            self._served = (model, self._served[1])
        logger.info(
            "Serving engine built: %s version %d on %s, canonical rows %d",
            self._manifest.get("model_def", "?"),
            self.version,
            self.device,
            self.canonical_rows,
        )

    @staticmethod
    def _spec_of(features):
        def leaf_spec(x):
            x = np.asarray(x)
            return tuple(x.shape[1:]), x.dtype

        if isinstance(features, dict):
            return {k: leaf_spec(v) for k, v in features.items()}
        return leaf_spec(features)

    def conform(self, features):
        """Validate a request's feature tree against the served model's
        spec, cast leaves to the built dtypes, and run the model's own
        host-side check (``validate_features``) when it has one."""
        if self._feature_spec is None:
            return features  # first request defines the spec
        spec = self._feature_spec

        def conform_leaf(x, row_shape, dtype, name=""):
            x = np.asarray(x)
            if tuple(x.shape[1:]) != row_shape:
                raise ShapeMismatchError(
                    f"feature {name or '<array>'} row shape "
                    f"{tuple(x.shape[1:])} != served {row_shape}"
                )
            return x.astype(dtype, copy=False)

        if isinstance(spec, dict):
            if not isinstance(features, dict) or set(features) != set(spec):
                got = sorted(features) if isinstance(features, dict) else type(features).__name__
                raise ShapeMismatchError(
                    f"feature keys {got} != served {sorted(spec)}"
                )
            conformed = {
                k: conform_leaf(features[k], *spec[k], name=k) for k in spec
            }
        elif isinstance(features, dict):
            raise ShapeMismatchError(
                "served model takes a bare feature array, got a dict"
            )
        else:
            conformed = conform_leaf(features, *spec)
        validate = getattr(self.model, "validate_features", None)
        if validate is not None:
            validate(conformed)
        return conformed

    # ---- the dispatch body -------------------------------------------------

    def _place(self, tree):
        return map_tree(
            lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(self.device),
            tree,
        )

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_group(self, group: Group):
        """Execute one dispatch group end to end: assemble (concat + pad
        to canonical), h2d, compute, d2h, slice per-row outputs back to
        their tickets.  Every phase is timed; tickets completed here are
        finalized."""
        tickets = group.tickets()
        try:
            t_c0 = time.monotonic()
            conformed = self.conform(group.features())
            t_c1 = time.monotonic()
            # one-time lazy build (weights to the device) sits OUTSIDE the
            # phase windows: it is startup cost, not request anatomy
            self.ensure_built(conformed)
            t0 = time.monotonic()
            features = _pad_rows(conformed, self.canonical_rows)
            # one read: this group's weights and version, whatever swap
            # lands while it runs
            model, version = self._served
            t1 = time.monotonic()
            placed = self._place(features)
            self._shapes.add(_shape_signature(placed))
            self._sync()
            t2 = time.monotonic()
            outputs = self._predict_fn(model, placed)
            self._sync()
            t3 = time.monotonic()
            host = map_tree(to_host, outputs)
            t4 = time.monotonic()
        except Exception as ex:  # noqa: BLE001 — a poisoned group must
            # fail ITS tickets, not the dispatch thread
            for ticket in tickets:
                ticket.fail(ex)
                self.errors += 1
            logger.exception("Serving dispatch group failed")
            return
        phases = {
            PHASE_ASSEMBLE: (t_c1 - t_c0) + (t1 - t0),
            PHASE_H2D_TRANSFER: t2 - t1,
            PHASE_DEVICE_COMPUTE: t3 - t2,
            PHASE_D2H_TRANSFER: t4 - t3,
        }
        self.dispatches += 1
        offset = 0
        for ticket, lo, hi in group.segments:
            n = hi - lo
            rows = map_tree(lambda x: x[offset : offset + n], host)
            offset += n
            ticket.add_phases(phases)
            if ticket.deliver(rows, n, version):
                # close the anatomy BEFORE releasing the waiter: the
                # handler returns ticket.phases_secs the moment it
                # wakes, and it must see the sum-exact set
                try:
                    self._finalize(ticket)
                finally:
                    ticket.finish()

    def _finalize(self, ticket):
        """Close a completed request's anatomy (sum-exact residual)."""
        total = ticket.total_secs()
        queue_wait = max(
            0.0, (ticket.first_dispatch_at or ticket.submitted_at) - ticket.submitted_at
        )
        phases = dict(ticket.phases_secs)
        phases[PHASE_QUEUE_WAIT] = queue_wait
        tracked = sum(phases.values())
        phases[PHASE_UNTRACKED] = max(0.0, total - tracked)
        ticket.phases_secs = phases
        self.requests_served += 1
        self.rows_served += ticket.rows
        self._note_phase_totals(phases, total)

    def _note_phase_totals(self, phases: dict, total: float):
        """Accumulate one completed request into the monotone probe-beat
        totals."""
        items = list(phases.items())
        items.append((_PHASE_TOTAL, total))
        with self._beat_lock:
            for name, secs in items:
                stats = self._phase_totals.get(name)
                if stats is None:
                    stats = self._phase_totals[name] = {
                        "ms": 0.0,
                        "count": 0,
                        "buckets": {},
                    }
                stats["ms"] += secs * 1000.0
                stats["count"] += 1
                key = "inf"
                for bound in SERVING_LATENCY_BUCKETS:
                    if secs <= bound:
                        key = str(bound)
                        break
                buckets = stats["buckets"]
                buckets[key] = buckets.get(key, 0) + 1

    def phase_totals_snapshot(self) -> dict:
        """Deep copy of the monotone per-phase totals — the
        ``serving_status`` probe-beat payload."""
        with self._beat_lock:
            return {
                name: {
                    "ms": stats["ms"],
                    "count": stats["count"],
                    "buckets": dict(stats["buckets"]),
                }
                for name, stats in self._phase_totals.items()
            }

    def counters_snapshot(self) -> dict:
        """Monotone counters since the engine was made (probe-beat
        payload); the router max-merges these so replays are absorbed."""
        return {
            "requests": int(self.requests_served),
            "rows": int(self.rows_served),
            "rejected": int(self.rejected),
            "errors": int(self.errors),
            "swaps": int(self.swaps_applied),
            "dispatches": int(self.dispatches),
        }

    # ---- hot swap ----------------------------------------------------------

    def swap_from_export(self, model_dir: str, min_version: int = -1):
        """Swap to the model exported at ``model_dir``.  Refuses another
        model, an export older than ``min_version``, and a version that
        would not ADVANCE the served one (the staleness guard that makes
        ``swap_model`` a safe versioned put under RPC re-delivery).
        Returns ``(accepted, version, reason)``."""
        manifest = read_manifest(model_dir)
        version = int(manifest.get("model_version", 0))
        if manifest.get("model_def") != self._manifest.get("model_def"):
            return False, self.version, (
                f"model_def mismatch: serving "
                f"{self._manifest.get('model_def')!r}, export has "
                f"{manifest.get('model_def')!r}"
            )
        if min_version >= 0 and version < min_version:
            return False, self.version, (
                f"export version {version} < required {min_version}"
            )
        flat_params, flat_state = load_flats(model_dir)
        return self._swap_flats(flat_params, flat_state, version, model_dir)

    def swap_state_dicts(
        self, flat_params: dict, flat_state: dict, version: int,
        source: str = "in-memory",
    ):
        """Swap from flat name-keyed arrays in the JAX package's layout
        (flax names, ``params/`` stripped; the state under its
        collection's name) — the form an export's npz, a checkpoint and
        a replication blob all carry, so a training job's state can feed
        a serving replica without touching disk.  An empty
        ``flat_state`` keeps the served model's state."""
        return self._swap_flats(flat_params, flat_state, int(version), source)

    def _swap_flats(self, flat_params, flat_state, version, source):
        t0 = time.monotonic()
        with self._swap_lock:
            model, old = self._served
            if version <= old:
                return False, old, (
                    f"{STALE_SWAP_PREFIX}: version {version} <= served {old}"
                )
            if model is None:
                # not built yet: the pending flats ARE the model
                self._pending_flats = (dict(flat_params), dict(flat_state))
                self._served = (None, version)
            else:
                try:
                    new = build_with_weights(
                        self._spec,
                        flat_params,
                        flat_state or flax_state_from_torch(model),
                        self.device,
                    )
                except (KeyError, ValueError) as ex:
                    return False, old, f"incompatible state: {ex}"
                # groups already running keep the pair they read; the
                # next group reads this one
                self._served = (new, version)
        secs = time.monotonic() - t0
        self.swaps_applied += 1
        self.last_swap_ms = secs * 1000.0
        logger.info(
            "Hot model swap: version %d -> %d (%s, %.1fms)",
            old,
            version,
            source,
            secs * 1000.0,
        )
        return True, version, ""

    # ---- direct (in-process) convenience ------------------------------------

    def predict_rows(self, features):
        """One-shot synchronous predict of a feature tree, bypassing the
        batcher: pads to canonical, returns the real rows' outputs."""
        self.ensure_built(features)
        features = self.conform(features)
        n = tree_rows(features)
        placed = self._place(_pad_rows(features, self.canonical_rows))
        self._shapes.add(_shape_signature(placed))
        outputs = self._predict_fn(self.model, placed)
        return map_tree(lambda x: to_host(x)[:n], outputs)


class ExportDirWatcher:
    """Poll an export directory's manifest for a newer ``model_version``
    and hot-swap the engine when one lands — the train->serve seam: a
    training job re-exporting into the watched directory updates live
    serving with no restart."""

    def __init__(self, engine: ServingEngine, watch_dir: str,
                 poll_secs: float = 2.0):
        self._engine = engine
        self._dir = watch_dir
        self._poll_secs = max(0.1, float(poll_secs))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="serving-export-watch", daemon=True
        )
        self._thread.start()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def poll_once(self) -> bool:
        """One check; True when a swap was applied (tests drive this
        directly, the thread loops it)."""
        try:
            manifest = read_manifest(self._dir)
        except (OSError, ValueError):
            return False
        if int(manifest.get("model_version", 0)) <= self._engine.version:
            return False
        accepted, _version, reason = self._engine.swap_from_export(self._dir)
        if not accepted and reason:
            logger.warning("Export watcher swap refused: %s", reason)
        return accepted

    def _loop(self):
        while not self._stop.wait(self._poll_secs):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must outlive
                # a torn mid-write export; the next poll sees it whole
                logger.exception("Export watcher poll failed")
