"""RPC retry/backoff; a copy of ``elasticdl_tpu/rpc/retry.py``.

A small, self-contained unit: a :class:`RetryPolicy` (bounded attempts,
full-jitter exponential backoff, optional wall-clock budget) and
:func:`call_with_retry`, the loop :class:`~elasticdl_tpu_torch.rpc.service.
RpcClient` drives.  Kept free of sockets so the backoff math is
unit-testable without a server.

Retry safety contract: only calls the SERVER deduplicates or that are
naturally idempotent may retry — a retried non-idempotent call whose
first attempt actually landed would double its effect.  The generic
default (:data:`DEFAULT_IDEMPOTENT`) is the read-only subset;
``MasterClient`` opts the whole master control plane in because every
master RPC the port serves is dedup-safe by construction:

- ``get_step_task`` is memoized by seq; ``heartbeat`` / ``report_version``
  are monotone merges;
- ``report_task_result`` is deduplicated by task_id (a re-send of an
  already-processed report is dropped as an unknown/inactive lease);
- ``get_task`` may orphan a lease when the first attempt's reply is
  lost, which the lease timeout reclaims — bounded duplicate WORK, never
  duplicate ACCOUNTING.

Workers enable retries only when the master exports
``ELASTICDL_TPU_RPC_RETRY_SECS`` (``--rpc_retry_secs``), so a job without
it keeps the fail-fast behavior.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger

RETRY_SECS_ENV = "ELASTICDL_TPU_RPC_RETRY_SECS"

# outage budget when --rpc_retry_secs is unset: the master exports it,
# the worker falls back to it on a missing/malformed env — ONE constant
# so the two sides can never disagree
DEFAULT_RETRY_SECS = 60.0

# heartbeat-timeout fallback when the parsed args carry no
# --heartbeat_timeout_secs (0 disables timeout-based failure detection).
# Kept next to DEFAULT_RETRY_SECS because operators size the two
# against each other — a silence tolerance shorter than the worker's
# retry budget turns every surviving blip into a re-formation.  The
# master resolves the value ONCE (Master._heartbeat_timeout_secs); its
# run-loop failure detector and rehome-grace computation both reuse it.
DEFAULT_HEARTBEAT_TIMEOUT_SECS = 0.0

# naturally idempotent / read-only master methods: safe to retry on ANY
# service without knowing its dedup story
DEFAULT_IDEMPOTENT = frozenset(
    {"heartbeat", "get_step_task", "get_world_assignment", "get_restore_state"}
)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with full-jitter exponential backoff.

    ``max_attempts`` counts the FIRST try; ``total_timeout_secs`` is a
    wall budget — whichever limit trips first ends the loop.  Full
    jitter (delay uniform in [0, cap]) is deliberate: a master restart
    makes every worker retry at once, and synchronized backoff would
    thundering-herd the fresh server.
    """

    max_attempts: int = 5
    base_delay_secs: float = 0.1
    max_delay_secs: float = 2.0
    total_timeout_secs: float | None = None

    def delay_cap(self, attempt: int) -> float:
        """Backoff ceiling after ``attempt`` failures (1-based)."""
        return min(
            self.max_delay_secs,
            self.base_delay_secs * (2.0 ** max(0, attempt - 1)),
        )

    @classmethod
    def from_budget(cls, budget_secs: float) -> "RetryPolicy":
        """The HA-worker policy: attempts effectively unbounded, the
        wall budget is the limit (sized to cover a master relaunch)."""
        return cls(
            max_attempts=10_000,
            base_delay_secs=0.1,
            max_delay_secs=2.0,
            total_timeout_secs=max(0.1, budget_secs),
        )


def call_with_retry(
    fn,
    policy: RetryPolicy,
    is_retryable=lambda ex: True,
    on_retry=None,
    rng: random.Random | None = None,
    sleep=time.sleep,
    clock=time.monotonic,
):
    """Run ``fn()`` under ``policy``.

    ``is_retryable(exc) -> bool`` gates which failures back off (a
    non-retryable exception re-raises immediately); ``on_retry(attempt,
    exc)`` fires before each sleep — the RPC client uses it for its
    re-resolve hook.  ``rng``/``sleep``/``clock`` are injectable for
    deterministic tests."""
    rng = rng if rng is not None else random.Random()
    deadline = (
        clock() + policy.total_timeout_secs
        if policy.total_timeout_secs is not None
        else None
    )
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as ex:  # noqa: BLE001 — gated by is_retryable
            if not is_retryable(ex):
                raise
            out_of_attempts = attempt >= policy.max_attempts
            out_of_time = deadline is not None and clock() >= deadline
            if out_of_attempts or out_of_time:
                raise
            if on_retry is not None:
                try:
                    on_retry(attempt, ex)
                except Exception:  # noqa: BLE001 — a broken hook (e.g.
                    # a re-resolve probe dying) must not end the retry
                    # loop: the loop IS the outage survival path
                    logger.exception("Retry hook failed; continuing")
            delay = rng.uniform(0.0, policy.delay_cap(attempt))
            if deadline is not None:
                # the wall budget clamps the FINAL backoff sleep too: a
                # full jitter draw near max_delay must not overshoot the
                # deadline and bill the caller for time the budget
                # already spent
                delay = min(delay, max(0.0, deadline - clock()))
            sleep(delay)
