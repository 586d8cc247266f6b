"""Deterministic fault injection and elastic-invariant checking; the
counterpart of ``elasticdl_tpu/chaos/``.

- :mod:`.plan` — a pure-data fault plan ("preempt process 1 at step
  6"), seeded and replayable, serialized as JSON;
- :mod:`.hooks` — the worker-side injector the lockstep worker arms
  from ``ELASTICDL_TPU_CHAOS_PLAN``/``_EVENTS``;
- :mod:`.invariants` — the checker fed by the master's dispatcher,
  servicer and re-formations: every training task once, records
  accounted, versions monotonic within a generation, progress past
  every re-formation; and, over the event log, the JAX harness's
  ``replication_no_lost_steps``;
- :mod:`.netem` — the transport-level shim for gray failures (the
  process lives, its link degrades): per-method latency with seeded
  jitter, drop-with-hang blackholes, one-way partitions, injected
  UNAVAILABLE, and duplicate delivery run twice in the master, at the
  socket transport's client and server seams;
- :mod:`.harness` — runs a real multi-process model-zoo job under a plan
  with the checker attached (through master kills and capacity faults,
  one checker spanning every life of the master) and returns a JSON-able
  report;
- :mod:`.runner` — the CLI: ``python -m elasticdl_tpu_torch.chaos.runner
  --plan preempt_one_worker``.
"""

from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind, FaultPlan  # noqa: F401
from elasticdl_tpu_torch.chaos.invariants import (  # noqa: F401
    InvariantChecker,
    Violation,
)
