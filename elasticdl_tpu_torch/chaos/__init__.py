"""Deterministic fault injection and elastic-invariant checking; a copy
of the JAX-free part of ``elasticdl_tpu/chaos/``.

- :mod:`.plan` — a pure-data fault plan ("preempt process 1 at step
  6"), seeded and replayable, serialized as JSON;
- :mod:`.hooks` — the worker-side injector the lockstep worker arms
  from ``ELASTICDL_TPU_CHAOS_PLAN``/``_EVENTS``;
- :mod:`.invariants` — the checker fed by the master's dispatcher,
  servicer and re-formations: every training task once, records
  accounted, versions monotonic within a generation, progress past
  every re-formation; and, over the event log, the JAX harness's
  ``replication_no_lost_steps``;
- :mod:`.harness` — the harness's master lives: a job run through master
  kills, one checker spanning every life, and the ``master_recovery``
  invariant.

The rest of the harness, the runner CLI and the network shim come with
slice 6b-2d.
"""

from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind, FaultPlan  # noqa: F401
from elasticdl_tpu_torch.chaos.invariants import (  # noqa: F401
    InvariantChecker,
    Violation,
)
