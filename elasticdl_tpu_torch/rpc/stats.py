"""Process-local RPC outcome counters (client side); a copy of
``elasticdl_tpu/rpc/stats.py``, with an observer of the failures
(:func:`set_observer`).

The worker is where retries, deadline expiries and injected
UNAVAILABLEs actually happen, but the ``/metrics`` endpoint lives on
the master — so each worker accumulates monotone totals here and ships
a snapshot with every heartbeat (``HeartbeatRequest.rpc``).  The
heartbeat is deliberately the carrier: it is the one RPC that keeps
flowing when task reports stall, which is exactly when these counters
spike.  The master max-merges per worker and sums across workers onto
its totals (``MasterServicer.rpc_stats_totals``).

Counted here (all services riding :class:`~elasticdl_tpu_torch.rpc.service.
RpcClient`, the replication clients included):

- ``deadline_exceeded`` / ``unavailable`` — outage-class failures per
  attempt (retried or not);
- ``retries`` — backoff re-sends of the retry loop.

Zero-dependency and lock-tiny: the happy path never touches this
module; only failures do.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counts: dict[str, int] = {}
# observer(totals) after each noted failure (set_observer)
_observer = None

# the status-code names worth tracking (``StatusCode.name.lower()``);
# anything else is a bug-class failure the caller will surface loudly
_TRACKED_CODES = frozenset({"deadline_exceeded", "unavailable"})


def note_failure(code_name: str):
    """Record one failed attempt by lowercase status-code name."""
    if code_name not in _TRACKED_CODES:
        return
    with _lock:
        _counts[code_name] = _counts.get(code_name, 0) + 1
        totals = dict(_counts)
    observer = _observer
    if observer is not None:
        observer(totals)


def set_observer(observer):
    """``observer(totals)`` runs after each noted failure, for counters
    that must outlive their process: a worker that a network fault gets
    evicted never ships them on a heartbeat, so the chaos layer
    (``chaos/netem.py``) records them in its event log.  None removes it."""
    global _observer
    _observer = observer


def note_retry():
    """Record one backoff re-send (retry loop's ``on_retry``)."""
    with _lock:
        _counts["retries"] = _counts.get("retries", 0) + 1


def snapshot() -> dict[str, int]:
    """Monotone totals since process start (empty when clean)."""
    with _lock:
        return dict(_counts)


def reset_for_tests():
    global _observer
    with _lock:
        _counts.clear()
    _observer = None
