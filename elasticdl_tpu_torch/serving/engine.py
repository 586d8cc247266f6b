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

Not in this slice: hot swap (``swap_state_dicts``, ``swap_from_export``,
the export-directory watcher), trace spans, the event log, the
Prometheus registry and the memory ledger.
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
from elasticdl_tpu_torch.trainer.step import build_predict_step
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.export_utils import (
    build_with_weights,
    load_flats,
    read_manifest,
)
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec
from elasticdl_tpu_torch.utils.tree_utils import map_tree, to_host


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


class ServingEngine:
    """Loads an export, builds the model on the first request (the
    export carries no feature spec; the first request does), and serves
    padded canonical-shape dispatch groups on ``device``."""

    def __init__(
        self,
        model_dir: str,
        canonical_rows: int,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.canonical_rows = int(canonical_rows)
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
        self._build_lock = threading.Lock()
        self._model: torch.nn.Module | None = None  # guarded-by: _build_lock (writes)
        self._version = int(manifest.get("model_version", 0))
        # flat param/state dicts pending the lazy build (None once built)
        self._pending_flats = load_flats(model_dir)
        self._feature_spec = None  # {key: (row_shape, dtype)} or (shape, dtype)
        self.requests_served = 0
        self.rows_served = 0
        self.dispatches = 0
        self.errors = 0

    # ---- build -------------------------------------------------------------

    @property
    def built(self) -> bool:
        return self._model is not None

    @property
    def version(self) -> int:
        return self._version

    @property
    def model(self) -> torch.nn.Module | None:
        return self._model

    def ensure_built(self, sample_features):
        """Build the model with the export's weights on ``device`` and
        record the feature spec from the first request's features."""
        if self._model is not None:
            return
        with self._build_lock:
            if self._model is not None:
                return
            flat_params, flat_state = self._pending_flats
            model = build_with_weights(
                self._spec, flat_params, flat_state, self.device
            )
            self._feature_spec = self._spec_of(sample_features)
            self._pending_flats = None
            self._model = model
        logger.info(
            "Serving engine built: %s version %d on %s, canonical rows %d",
            self._manifest.get("model_def", "?"),
            self._version,
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
        validate = getattr(self._model, "validate_features", None)
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
            model, version = self._model, self._version
            t1 = time.monotonic()
            placed = self._place(features)
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

    # ---- direct (in-process) convenience ------------------------------------

    def predict_rows(self, features):
        """One-shot synchronous predict of a feature tree, bypassing the
        batcher: pads to canonical, returns the real rows' outputs."""
        self.ensure_built(features)
        features = self.conform(features)
        n = tree_rows(features)
        placed = self._place(_pad_rows(features, self.canonical_rows))
        outputs = self._predict_fn(self._model, placed)
        return map_tree(lambda x: to_host(x)[:n], outputs)
