"""Deterministic fault injection and elastic-invariant checking; a copy
of the JAX-free part of ``elasticdl_tpu/chaos/``.

- :mod:`.plan` — a pure-data fault plan ("preempt process 1 at step
  6"), seeded and replayable, serialized as JSON;
- :mod:`.hooks` — the worker-side injector the lockstep worker arms
  from ``ELASTICDL_TPU_CHAOS_PLAN``/``_EVENTS``;
- :mod:`.invariants` — the checker fed by the master's dispatcher,
  servicer and re-formations: every training task once, records
  accounted, versions monotonic within a generation, progress past
  every re-formation.

The harness, the runner CLI and the network shim come with the next
part of the slice.
"""

from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind, FaultPlan  # noqa: F401
from elasticdl_tpu_torch.chaos.invariants import (  # noqa: F401
    InvariantChecker,
    Violation,
)
