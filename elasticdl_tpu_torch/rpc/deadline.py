"""Per-method RPC deadline policy, the gray-failure floor of the RPC
plane; a copy of ``elasticdl_tpu/rpc/deadline.py``.

A blackholed link does not say UNAVAILABLE; it says nothing, forever.
Before this policy existed no master-facing RPC carried a deadline
(``RpcClient._call`` defaulted ``timeout=None``), so a one-way partition
hung the calling worker thread without ever reaching the retry loop.
With a policy installed every call degrades to DEADLINE_EXCEEDED — an
outage-class, retryable failure — and flows into the
:mod:`elasticdl_tpu_torch.rpc.retry` full-jitter loop instead of hanging.

Two tiers, not one number: control RPCs (task leases, reports,
heartbeats) move a few KB and should fail fast; state transfer
(``get_restore_state`` — a full model-state payload — and the
replication subsystem's ``push_replica``/``fetch_replica``) legitimately
takes long on big models, and a control-sized deadline there would turn
every reform restore into a spurious timeout.  The replication clients
adopt the SAME policy object, replacing their historical fixed
``PUSH_TIMEOUT_SECS``/``FETCH_TIMEOUT_SECS`` constants when a policy is
configured (and keeping them byte-for-byte when not).

The master owns the knob (``--rpc_deadline_secs``) and forwards it to
workers by env, like the retry budget — never argv, so worker command
lines and golden manifests stay byte-identical with the policy off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

DEADLINE_SECS_ENV = "ELASTICDL_TPU_RPC_DEADLINE_SECS"

# state transfer gets this multiple of the control deadline, floored so
# a tight control deadline (chaos runs use ~1 s) can never squeeze a
# model-state payload below the historical 30 s transfer timeouts
TRANSFER_MULTIPLIER = 10.0
TRANSFER_FLOOR_SECS = 30.0

# methods that move model-state payloads rather than control frames
STATE_TRANSFER_METHODS = frozenset(
    {"get_restore_state", "push_replica", "fetch_replica"}
)


@dataclass(frozen=True)
class DeadlinePolicy:
    """Deadlines by method class; ``deadline_for`` is the one lookup
    :class:`~elasticdl_tpu_torch.rpc.service.RpcClient` makes per call."""

    control_secs: float
    transfer_secs: float

    def deadline_for(self, method: str) -> float:
        if method in STATE_TRANSFER_METHODS:
            return self.transfer_secs
        return self.control_secs

    @classmethod
    def from_secs(cls, control_secs: float) -> "DeadlinePolicy":
        control = max(0.1, float(control_secs))
        return cls(
            control_secs=control,
            transfer_secs=max(
                TRANSFER_FLOOR_SECS, control * TRANSFER_MULTIPLIER
            ),
        )

    @classmethod
    def from_env(cls) -> "DeadlinePolicy | None":
        """The worker-side constructor: None (no deadlines — behavior
        byte-identical to a policy-less build) unless the master
        exported ``--rpc_deadline_secs``."""
        raw = os.environ.get(DEADLINE_SECS_ENV, "")
        if not raw:
            return None
        try:
            return cls.from_secs(float(raw))
        except ValueError:
            # loud, not silent: dropping the policy here restores the
            # infinite-hang failure mode it exists to prevent, so the
            # operator must be able to see WHY deadlines are off
            from elasticdl_tpu_torch.utils.log_utils import (
                default_logger as logger,
            )

            logger.error(
                "Unparseable %s=%r; RPC DEADLINES ARE OFF — a "
                "blackholed link can hang calls again",
                DEADLINE_SECS_ENV,
                raw,
            )
            return None


# ---- the heartbeat's cadence under a timeout and a deadline ------------------

# the beat interval a lockstep worker takes from its master, by env (the
# master knows its liveness timeout and the deadline it exports)
HEARTBEAT_INTERVAL_ENV = "ELASTICDL_TPU_HEARTBEAT_INTERVAL_SECS"
# the fastest cadence the rule below asks for
MIN_HEARTBEAT_INTERVAL_SECS = 0.25
# the beats a liveness timeout spans at least: a beat may then run two
# intervals late before a live worker is taken for dead
BEATS_PER_TIMEOUT = 3.0


def heartbeat_interval_secs(
    default_secs: float, timeout_secs: float | None, deadline_secs: float | None
) -> float:
    """The beat interval that keeps a live worker from being evicted and
    lets a worker see its link die before the master declares it dead.

    Between task pulls the heartbeat is the worker's only liveness
    signal, and the master evicts ``timeout_secs`` after the last beat it
    got.  A beat that runs later than ``timeout_secs`` minus the interval
    (a stalled process, a starved thread, a master that did not serve it
    in time) evicts a live worker: at the default 2 s cadence and a 3 s
    timeout that is 1 s, which a host loaded by a job's start (every
    process importing torch) can exceed.  So the interval is at most a
    third of the timeout, and a beat may run two intervals late.

    If the link goes silent just after a beat, the next beat leaves an
    interval later and its deadline expires one deadline after that.  At
    the default 2 s cadence with a 1 s deadline and a 3 s timeout that
    instant and the eviction coincide, and the eviction's SIGKILL can
    land before the worker has counted its first expired deadline.  So
    under a deadline shorter than the timeout the interval is also at
    most half of what the deadline leaves of the timeout: a swallowed
    beat then expires at least that half before the eviction.  With no
    timeout, the default."""
    if not timeout_secs:
        return default_secs
    cap = timeout_secs / BEATS_PER_TIMEOUT
    if deadline_secs is not None and deadline_secs < timeout_secs:
        cap = min(cap, (timeout_secs - deadline_secs) / 2.0)
    return max(MIN_HEARTBEAT_INTERVAL_SECS, min(default_secs, cap))
