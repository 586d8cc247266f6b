"""The autoscaler: grow or shrink a world's slice count on its SLOs; a
copy of ``elasticdl_tpu/master/autoscaler.py``.

The master's run loop ticks :meth:`Autoscaler.evaluate` once a poll.
Its inputs are ones the control plane has already: the p95 step time
from the chief's version reports (``telemetry/slo.py``'s tracker, fed
through the servicer's version observers) and the backlog of pending
tasks from the dispatcher.  A decision is a request, not an action: the
master resizes the next world (``set_world_slices``) and asks its own
run loop to re-form (``request_reform``), the path a capacity grant
takes, so an autoscale resize is fenced, harvested, restored and
accounted like any other elective re-formation.

Every threshold defaults to off: with no ``--autoscale_*`` flag the
master builds no autoscaler.  The streaming backlog (the lag behind a
stream's watermark) comes with slice 9.
"""

from __future__ import annotations

import time

from elasticdl_tpu_torch.telemetry.slo import StepTimePercentileTracker

DEFAULT_COOLDOWN_SECS = 30.0
# shrink only when every configured SLO sits under this fraction of its
# threshold (and the backlog is empty): hysteresis against flapping
SHRINK_HEADROOM = 0.25


class Autoscaler:
    def __init__(
        self,
        p95_step_ms: float | None = None,
        backlog_tasks: int | None = None,
        cooldown_secs: float | None = None,
        shrink: bool = False,
        min_slices: int = 1,
        max_slices: int = 1,
        tracker: StepTimePercentileTracker | None = None,
    ):
        self.p95_step_ms = p95_step_ms
        self.backlog_tasks = backlog_tasks
        self.cooldown_secs = (
            cooldown_secs if cooldown_secs is not None else DEFAULT_COOLDOWN_SECS
        )
        self.shrink_enabled = bool(shrink)
        self.min_slices = max(1, int(min_slices or 1))
        self.max_slices = max(self.min_slices, int(max_slices or 1))
        self.tracker = tracker if tracker is not None else StepTimePercentileTracker()
        self._last_decision_at: float | None = None
        self.decisions: list[dict] = []

    def note_version(self, worker_id: int, version: int):
        """The servicer's version observer (wired by ``Master``)."""
        self.tracker.note_version(worker_id, version)

    def note_reform(self):
        """Any re-formation restarts the cooldown and the step-time
        baseline: the new world must bring fresh evidence first."""
        self._last_decision_at = time.monotonic()
        self.tracker.reset()

    def evaluate(
        self, backlog: int, current_slices: int, now: float | None = None
    ) -> dict | None:
        """One tick: a decision ``{"action", "from_slices", "to_slices",
        "reason", "p95_step_ms", "backlog"}`` or None.  The caller acts
        on it (resize and ``request_reform``)."""
        now = now if now is not None else time.monotonic()
        if (
            self._last_decision_at is not None
            and now - self._last_decision_at < self.cooldown_secs
        ):
            return None
        p95 = self.tracker.p95_ms()
        decision = None
        if (
            self.backlog_tasks is not None
            and backlog >= self.backlog_tasks
            and current_slices < self.max_slices
        ):
            decision = self._decide(
                "grow", current_slices, current_slices + 1,
                f"backlog {backlog} >= {self.backlog_tasks}", p95, backlog,
            )
        elif (
            self.p95_step_ms is not None
            and p95 is not None
            and p95 >= self.p95_step_ms
            and current_slices < self.max_slices
        ):
            decision = self._decide(
                "grow", current_slices, current_slices + 1,
                f"p95 step {p95:.1f}ms >= {self.p95_step_ms:.1f}ms", p95, backlog,
            )
        elif self.shrink_enabled and current_slices > self.min_slices:
            # a shrink needs positive evidence of over-provisioning: a
            # measured p95 under the headroom share of its SLO.  An empty
            # backlog alone is not: pending counts unleased tasks only,
            # and reads 0 while every worker is busy with a lease
            under_p95 = (
                self.p95_step_ms is not None
                and p95 is not None
                and p95 <= SHRINK_HEADROOM * self.p95_step_ms
            )
            if under_p95 and backlog == 0:
                decision = self._decide(
                    "shrink", current_slices, current_slices - 1,
                    "all SLOs under headroom with empty backlog", p95, backlog,
                )
        if decision is not None:
            self._last_decision_at = now
        return decision

    def _decide(self, action, from_slices, to_slices, reason, p95, backlog):
        decision = {
            "action": action,
            "from_slices": from_slices,
            "to_slices": to_slices,
            "reason": reason,
            "p95_step_ms": round(p95, 3) if p95 is not None else None,
            "backlog": backlog,
        }
        self.decisions.append(decision)
        return decision


def build_autoscaler(args, fleet_slices: int) -> Autoscaler | None:
    """An Autoscaler when an ``--autoscale_*`` SLO is set, else None (no
    observer, no tick, no state)."""
    p95 = getattr(args, "autoscale_p95_step_ms", None)
    backlog = getattr(args, "autoscale_backlog_tasks", None)
    if p95 is None and backlog is None:
        return None
    return Autoscaler(
        p95_step_ms=p95,
        backlog_tasks=backlog,
        cooldown_secs=getattr(args, "autoscale_cooldown_secs", None),
        shrink=bool(getattr(args, "autoscale_shrink", None)),
        min_slices=getattr(args, "min_slices", None) or 1,
        max_slices=fleet_slices,
    )
