"""THE retry-safety registry: every RPC method, classified once; a copy
of ``elasticdl_tpu/rpc/idempotency.py`` (the port imports nothing of
the JAX package).

The retry contract (``rpc/retry.py``) is only as safe as the claim that
a re-delivered request cannot double its effect.  This module is where
that claim is written down, method by method.  In the JAX package the
``rpc-contract`` checker (``python -m elasticdl_tpu.analysis``) fails
the build when a method named in a server method table or a retryable
set is missing here; until the port's ``analysis/`` comes (slice 11),
``tests/test_torch_rpc.py`` enforces the same two rules on the port's
tables: every method is classified, and no ``not-retryable`` method is
in a retryable set.

Classification vocabulary:

- ``read-only``          — no server-side effect at all;
- ``fenced-read``        — read gated on a generation fence;
- ``memoized``           — first call computes, re-delivery replays the
  memo (the lockstep step stream);
- ``monotone-merge``     — the server max-merges, so replays are
  absorbed (heartbeat counters, version reports);
- ``deduped``            — the server drops duplicates by a stable id
  (task_id / lease id report dedup);
- ``duplicate-work-bounded`` — a lost reply can orphan work the lease
  timeout reclaims: duplicate WORK, never duplicate ACCOUNTING;
- ``reconciling``        — the request presents state and the server
  converges on it (the re-home handshake);
- ``versioned-put``      — a keyed put deduplicated by (source,
  version); replays are refused as stale;
- ``not-retryable``      — a duplicate WOULD double its effect: the
  method must never appear in a retryable set.
"""

from __future__ import annotations

# method name -> (classification, one-line why).  Keep alphabetical.
IDEMPOTENCY: dict[str, tuple[str, str]] = {
    "fetch_replica": (
        "read-only",
        "pure read of the replica store; probe and fetch mutate nothing",
    ),
    "get_restore_state": (
        "fenced-read",
        "serves the staged payload only to its generation; re-delivery "
        "re-serves the same bytes (the served-set release is per process "
        "id, so a replay cannot over-release)",
    ),
    "get_step_task": (
        "memoized",
        "memoized by seq under the stream lock; every process and every "
        "replay sees the first resolution",
    ),
    "get_task": (
        "duplicate-work-bounded",
        "a lost reply orphans a lease the timeout/re-home reconciliation "
        "reclaims — duplicate work, never duplicate accounting",
    ),
    "get_world_assignment": (
        "duplicate-work-bounded",
        "pops the standby mailbox; a lost reply loses one assignment the "
        "instance manager's replenish loop re-posts",
    ),
    "heartbeat": (
        "monotone-merge",
        "liveness timestamp overwrite + max-merged rpc/phase counters; "
        "replays are absorbed",
    ),
    "predict": (
        "read-only",
        "pure forward pass over replicated state; no server-side effect, "
        "so the router may re-send it to another replica after a "
        "deadline/UNAVAILABLE without double-counting anything (the "
        "request counters it bumps are observability, not accounting)",
    ),
    "push_replica": (
        "versioned-put",
        "keyed by (source, version, generation) with checksum; a replay "
        "is refused as a duplicate version",
    ),
    "rehome_worker": (
        "reconciling",
        "presents the worker's live leases; reconcile_leases re-accepts "
        "what is presented and requeues the rest — converges under "
        "re-delivery",
    ),
    "report_evaluation_metrics": (
        "deduped",
        "lease-id dedup in the servicer (against double accumulation): a re-delivered "
        "still-active report is dropped before accumulation",
    ),
    "report_task_result": (
        "deduped",
        "task_id dedup in the dispatcher (a re-send of a processed "
        "report is an unknown/inactive lease; exec counters bank once)",
    ),
    "report_version": (
        "monotone-merge",
        "server takes max(version); replays are absorbed",
    ),
    "request_profile": (
        "deduped",
        "arming while a window is still being distributed returns the "
        "existing window id (absorbed), and workers dedupe the "
        "heartbeat-borne command by window_id — so neither a "
        "re-delivered arm nor a duplicated response can open a second "
        "capture",
    ),
    "serving_status": (
        "read-only",
        "pure snapshot of replica counters/version; doubles as the "
        "serving plane's liveness probe AND the probe-beat telemetry "
        "ride-along (monotone counters + phase totals + memory ledger "
        "in the response, max/last-merged router-side), so it MUST be "
        "retry-safe — the payload is read-only on the replica and the "
        "router merge absorbs replays",
    ),
    "swap_model": (
        "versioned-put",
        "a swap to a version <= the replica's current one is refused as "
        "stale (engine guard), so a re-delivered swap is absorbed — the "
        "router fans it to every replica with retries on; the streaming "
        "live push rides the same method with an inline snapshot "
        "payload and the same guard, so a replayed push converges as "
        "stale instead of double-applying",
    ),
}


def classification(method: str) -> str | None:
    entry = IDEMPOTENCY.get(method)
    return entry[0] if entry else None
