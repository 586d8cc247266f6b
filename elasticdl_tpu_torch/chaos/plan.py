"""Fault plans: pure data, seeded, replayable.

A copy of ``elasticdl_tpu/chaos/plan.py``.

A plan is a named list of :class:`Fault`s.  Worker-side faults fire at a
deterministic point in the training schedule — when the process's model
version (``trainer.step``) reaches ``at_step`` — and are fenced by
``cluster_version`` so a re-formed world (generation 1, 2, …) does not
re-fire a generation-0 fault after restart.  Master-side faults
(capacity changes) trigger on the master-observed model version.

Plans serialize to/from JSON (``to_json``/``from_json``), so a chaos run
is reproducible from its report; :func:`random_plan` derives a plan from
a seed alone, so fuzzing sweeps are replayable by seed.
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field


class FaultKind:
    """Fault vocabulary.  Worker-side kinds fire inside a worker process
    (hooks.py); master-side kinds fire in the master's control loop
    (driven by harness.py)."""

    # worker-side
    PREEMPT = "preempt_worker"  # SIGKILL self at step (the preemption)
    KILL_COORDINATOR = "kill_coordinator"  # PREEMPT pinned to process 0
    DROP_HEARTBEAT = "drop_heartbeat"  # suppress heartbeats for a window
    DELAY_BATCHES = "delay_batches"  # sleep per host-pipeline batch
    KILL_IN_CHECKPOINT = "kill_in_checkpoint"  # die entering a save
    # die mid-replication: after the local snapshot, before the ring
    # neighbor holds the new version — the torn/incomplete replica set
    # must be detected and skipped at harvest time
    KILL_DURING_REPLICATION = "kill_during_replication"
    # whole-slice preemption: EVERY process whose slice_id matches the
    # fault's dies at the armed step (atomically — lockstep worlds reach
    # the step together).  The master must shrink the next world to the
    # surviving slices (slice-granular reform), not crash the job
    SLICE_LOSS = "slice_loss"
    # master-side
    REDUCE_CAPACITY = "reduce_capacity"  # shrink the world by `count`
    RESTORE_CAPACITY = "restore_capacity"  # back to full size
    # kill the master process itself (SIGKILL semantics: no cleanup, no
    # journal flush) and relaunch it from --master_journal_dir after
    # `duration_secs` of downtime — the master-HA closure fault
    MASTER_KILL = "master_kill"

    # network-side (chaos/netem.py): gray failures of the RPC plane,
    # injected at the RpcClient._call / create_server handler seam — the
    # link degrades, the processes live.  Unlike worker kinds these arm
    # by MATCHED-CALL INDEX (``at_step`` = matched calls to skip before
    # arming), because the transport shim has no trainer step; they are
    # still generation-fenced and plan-driven like everything else.
    NET_DELAY = "net_delay"  # +delay_ms (seeded jitter) per matched call
    NET_BLACKHOLE = "net_blackhole"  # drop-with-hang: silence, not error
    NET_DUPLICATE = "net_duplicate"  # request re-executed server-side
    NET_UNAVAILABLE = "net_unavailable"  # injected UNAVAILABLE, `count`x
    # one-way partition of a worker<->master pair: direction="request"
    # drops requests (server never executes), direction="response"
    # executes server-side but drops the reply — the nastiest gray
    # failure, because every client retry re-delivers a landed request
    NET_PARTITION = "net_partition"

    WORKER_SIDE = frozenset(
        {
            PREEMPT,
            KILL_COORDINATOR,
            DROP_HEARTBEAT,
            DELAY_BATCHES,
            KILL_IN_CHECKPOINT,
            KILL_DURING_REPLICATION,
            SLICE_LOSS,
        }
    )
    MASTER_SIDE = frozenset({REDUCE_CAPACITY, RESTORE_CAPACITY, MASTER_KILL})
    # client-seam kinds fire in the targeted worker's RpcClient; the
    # server-seam kind (duplicate delivery) fires in the master's
    # generic handler, where "re-executed server-side" is literal
    NETWORK_CLIENT_SIDE = frozenset(
        {NET_DELAY, NET_BLACKHOLE, NET_UNAVAILABLE, NET_PARTITION}
    )
    NETWORK_SERVER_SIDE = frozenset({NET_DUPLICATE})
    NETWORK_SIDE = NETWORK_CLIENT_SIDE | NETWORK_SERVER_SIDE
    ALL = WORKER_SIDE | MASTER_SIDE | NETWORK_SIDE


@dataclass(frozen=True)
class Fault:
    """One injected fault.

    ``process_id`` targets one process of the lockstep world (``None``
    on master-side faults); ``cluster_version`` is the world generation
    the fault belongs to; ``at_step`` is the model version that arms it.
    ``duration_secs`` bounds window faults (heartbeat drop, batch
    delay) and is the master-down window of MASTER_KILL; ``delay_ms``
    is the per-batch sleep of DELAY_BATCHES; ``count`` is the shrink
    amount of REDUCE_CAPACITY.

    ``trigger`` arms MASTER_KILL: ``"step"`` fires when the
    master-observed model version reaches ``at_step``; ``"reform"``
    fires inside the NEXT re-formation, after the generation fence and
    task recovery but before the relaunch — the nastiest window (the
    fence is journaled, no new world exists).

    Network kinds re-read two fields: ``method`` filters which RPC
    method the fault matches ("" = every method of every service riding
    the shim'd transport), and ``at_step`` is the number of MATCHED
    calls to skip before arming (the transport shim sees calls, not
    trainer steps).  ``direction`` selects the dropped half of a
    NET_PARTITION; ``duration_secs`` bounds window kinds
    (delay/blackhole/partition) and ``count`` bounds per-call kinds
    (duplicate/unavailable).
    """

    kind: str
    fault_id: str
    at_step: int = 0
    process_id: int | None = None
    cluster_version: int = 0
    duration_secs: float = 0.0
    delay_ms: float = 0.0
    count: int = 1
    trigger: str = "step"
    # SLICE_LOSS target: every process of this slice dies at at_step
    # (None on every other kind)
    slice_id: int | None = None
    # network-kind fields (defaults keep old plan JSONs loading)
    method: str = ""
    direction: str = "request"
    # fleet-scale mass-fault target (elasticdl_tpu.fleetsim): the
    # fraction of the live fleet a PREEMPT kills in ONE tick when no
    # single process_id is named.  0.0 (the default) keeps every
    # process-targeted plan and old plan JSON byte-identical.
    fraction: float = 0.0

    def __post_init__(self):
        if self.kind not in FaultKind.ALL:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: "
                f"{sorted(FaultKind.ALL)}"
            )
        if self.trigger not in ("step", "reform"):
            raise ValueError(
                f"unknown fault trigger {self.trigger!r}; valid: "
                "('step', 'reform')"
            )
        if self.direction not in ("request", "response"):
            raise ValueError(
                f"unknown partition direction {self.direction!r}; "
                "valid: ('request', 'response')"
            )


@dataclass
class FaultPlan:
    name: str
    faults: list[Fault] = field(default_factory=list)
    seed: int | None = None
    notes: str = ""

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "seed": self.seed,
                "notes": self.notes,
                "faults": [asdict(f) for f in self.faults],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        raw = json.loads(text)
        return cls(
            name=raw["name"],
            seed=raw.get("seed"),
            notes=raw.get("notes", ""),
            faults=[Fault(**f) for f in raw.get("faults", [])],
        )

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())

    def worker_faults(self) -> list[Fault]:
        return [f for f in self.faults if f.kind in FaultKind.WORKER_SIDE]

    def master_faults(self) -> list[Fault]:
        return [
            f
            for f in self.faults
            if f.kind in FaultKind.MASTER_SIDE
            and f.kind != FaultKind.MASTER_KILL
        ]

    def master_kill_faults(self) -> list[Fault]:
        return [f for f in self.faults if f.kind == FaultKind.MASTER_KILL]

    def network_client_faults(self) -> list[Fault]:
        """Faults the targeted worker's RPC-client shim arms."""
        return [
            f
            for f in self.faults
            if f.kind in FaultKind.NETWORK_CLIENT_SIDE
        ]

    def network_server_faults(self) -> list[Fault]:
        """Faults the master's server-handler shim arms (duplicate
        delivery: the request literally re-executes server-side)."""
        return [
            f
            for f in self.faults
            if f.kind in FaultKind.NETWORK_SERVER_SIDE
        ]


# ---- built-in plans ---------------------------------------------------------

# Default arming step for kill faults: checkpoint_steps in the harness
# is 2, and one 64-record task at batch 32 is 2 steps, so by step 6 a
# periodic checkpoint has long since been written — the re-formed world
# has state to resume from, which is the scenario under test.
_KILL_STEP = 6


def builtin_plans(num_workers: int = 2) -> dict[str, FaultPlan]:
    """The named plans the runner/benchmarks use.  ``num_workers`` sizes
    process targets (the victim of a plain preemption is the LAST
    process — never the coordinator, which has its own plan)."""
    last = max(0, num_workers - 1)
    plans = {
        "none": FaultPlan(
            name="none", notes="no faults — the baseline trajectory"
        ),
        "preempt_one_worker": FaultPlan(
            name="preempt_one_worker",
            faults=[
                Fault(
                    kind=FaultKind.PREEMPT,
                    fault_id="preempt-p%d" % last,
                    at_step=_KILL_STEP,
                    process_id=last,
                )
            ],
            notes="SIGKILL one non-coordinator process mid-epoch",
        ),
        "preempt_coordinator": FaultPlan(
            name="preempt_coordinator",
            faults=[
                Fault(
                    kind=FaultKind.KILL_COORDINATOR,
                    fault_id="kill-coordinator",
                    at_step=_KILL_STEP,
                    process_id=0,
                )
            ],
            notes=(
                "kill process 0 — the jax.distributed coordination "
                "service dies with it (worst-case lockstep failure)"
            ),
        ),
        "heartbeat_drop": FaultPlan(
            name="heartbeat_drop",
            faults=[
                Fault(
                    kind=FaultKind.DROP_HEARTBEAT,
                    fault_id="hb-drop-p%d" % last,
                    at_step=4,
                    process_id=last,
                    # must exceed the harness heartbeat timeout (3 s) so
                    # the master declares the silent worker dead and
                    # re-forms around a process that never crashed
                    duration_secs=8.0,
                )
            ],
            notes="a live-but-silent worker: heartbeats stop, process "
            "survives; the stale world must be fenced out",
        ),
        "slow_host_pipeline": FaultPlan(
            name="slow_host_pipeline",
            faults=[
                Fault(
                    kind=FaultKind.DELAY_BATCHES,
                    fault_id="slow-batches",
                    at_step=2,
                    process_id=None,  # every process
                    delay_ms=40.0,
                    duration_secs=6.0,
                )
            ],
            notes="host-pipeline stall: batches arrive late on every "
            "process; no correctness impact allowed",
        ),
        "checkpoint_kill": FaultPlan(
            name="checkpoint_kill",
            faults=[
                Fault(
                    kind=FaultKind.KILL_IN_CHECKPOINT,
                    fault_id="ckpt-kill-p%d" % last,
                    at_step=4,
                    process_id=last,
                )
            ],
            notes="die on entering a checkpoint save: resume must fall "
            "back to the last complete checkpoint",
        ),
        "preempt_twice": FaultPlan(
            name="preempt_twice",
            faults=[
                Fault(
                    kind=FaultKind.PREEMPT,
                    fault_id="preempt-gen0",
                    at_step=_KILL_STEP,
                    process_id=last,
                ),
                Fault(
                    kind=FaultKind.PREEMPT,
                    fault_id="preempt-gen1",
                    at_step=_KILL_STEP + 6,
                    process_id=last,
                    cluster_version=1,
                ),
            ],
            notes="a second preemption after the first re-formation "
            "(generation-fenced: gen-1 fault arms only in gen 1)",
        ),
        "preempt_after_replication": FaultPlan(
            name="preempt_after_replication",
            faults=[
                Fault(
                    kind=FaultKind.PREEMPT,
                    fault_id="preempt-post-replica-p%d" % last,
                    # one step after a task-boundary replica push (tasks
                    # are 2 steps in the harness, so pushes land on even
                    # versions; _KILL_STEP is even): the resumed
                    # generation must restore from peer RAM at EXACTLY
                    # the pushed version — zero steps lost to the
                    # preemption beyond the one in flight
                    at_step=_KILL_STEP + 1,
                    process_id=last,
                )
            ],
            notes="SIGKILL a non-chief one step after a replica push; "
            "with replication on, restore must come from peer RAM at "
            "the pushed version (no disk read, no lost steps)",
        ),
        "kill_during_replication": FaultPlan(
            name="kill_during_replication",
            faults=[
                Fault(
                    kind=FaultKind.KILL_DURING_REPLICATION,
                    fault_id="replica-kill-p%d" % last,
                    at_step=4,
                    process_id=last,
                )
            ],
            notes="die mid-replication (snapshot committed locally, "
            "neighbor never receives it): the incomplete replica set "
            "must be skipped — restore from an older complete set or "
            "fall back to disk",
        ),
        "master_kill_mid_epoch": FaultPlan(
            name="master_kill_mid_epoch",
            faults=[
                Fault(
                    kind=FaultKind.MASTER_KILL,
                    fault_id="master-kill-mid-epoch",
                    at_step=_KILL_STEP,
                    duration_secs=2.0,
                )
            ],
            notes="SIGKILL the master mid-epoch (workers healthy): the "
            "relaunched master must replay its journal, the workers "
            "must re-home, and the job must complete with exactly-once "
            "accounting spanning the outage",
        ),
        "master_kill_during_reform": FaultPlan(
            name="master_kill_during_reform",
            faults=[
                Fault(
                    kind=FaultKind.PREEMPT,
                    fault_id="preempt-before-master-kill",
                    at_step=_KILL_STEP,
                    process_id=last,
                ),
                Fault(
                    kind=FaultKind.MASTER_KILL,
                    fault_id="master-kill-in-reform",
                    trigger="reform",
                    duration_secs=2.0,
                ),
            ],
            notes="kill the master INSIDE the re-formation the "
            "preemption caused (after the fence, before the relaunch): "
            "the relaunched master owns a fenced, half-recovered world "
            "— the journaled fence must hold and the job must still "
            "complete",
        ),
        "slice_loss_mid_epoch": FaultPlan(
            name="slice_loss_mid_epoch",
            faults=[
                Fault(
                    kind=FaultKind.SLICE_LOSS,
                    fault_id="slice-loss-s1",
                    at_step=_KILL_STEP,
                    # the LAST slice (keeps slice 0's chief alive so the
                    # surviving ring holds a full replica set); requires
                    # a >=2-slice world (the runner configures one)
                    slice_id=1,
                )
            ],
            notes="whole-slice preemption mid-epoch: every process of "
            "slice 1 dies atomically; reform must shrink the dp axis to "
            "the surviving slices and (with replication) hot-restore "
            "from the cross-slice replica ring",
        ),
        "grow_under_load": FaultPlan(
            name="grow_under_load",
            faults=[
                Fault(
                    kind=FaultKind.RESTORE_CAPACITY,
                    fault_id="capacity-grant",
                    at_step=_KILL_STEP,
                )
            ],
            notes="capacity grant mid-training: the job starts on one "
            "slice, a grant arrives under load, and reform grows the "
            "dp axis across slices without losing or double-training "
            "a record",
        ),
        "slow_network_mid_epoch": FaultPlan(
            name="slow_network_mid_epoch",
            faults=[
                Fault(
                    kind=FaultKind.NET_DELAY,
                    fault_id="net-delay-all",
                    # skip the first few calls so the world is up and
                    # training before the link degrades
                    at_step=4,
                    process_id=None,  # every process's master link
                    delay_ms=150.0,
                    duration_secs=6.0,
                )
            ],
            notes="gray, not dead: +150ms (seeded jitter) on every "
            "master-plane RPC for 6s — well inside the heartbeat "
            "tolerance, so the job must complete with ZERO "
            "re-formations (no false-dead from latency)",
        ),
        "blackhole_master_link": FaultPlan(
            name="blackhole_master_link",
            faults=[
                Fault(
                    kind=FaultKind.NET_BLACKHOLE,
                    fault_id="blackhole-p%d" % last,
                    at_step=12,
                    process_id=last,
                    # outlasts the worker's retry budget (the runner
                    # configures ~4s): deadlines turn the silence into
                    # DEADLINE_EXCEEDED, retries exhaust, the worker
                    # dies, reform evicts it — convergence, not a hang
                    duration_secs=60.0,
                )
            ],
            notes="one worker's master link blackholes (silence, not "
            "an error): every RPC must degrade to DEADLINE_EXCEEDED, "
            "flow through the retry loop, exhaust the budget, and the "
            "reform must evict the unreachable worker with exactly-once "
            "accounting intact",
        ),
        "oneway_partition_worker": FaultPlan(
            name="oneway_partition_worker",
            faults=[
                Fault(
                    kind=FaultKind.NET_PARTITION,
                    fault_id="oneway-p0",
                    at_step=12,
                    process_id=0,
                    direction="response",
                    duration_secs=60.0,
                )
            ],
            notes="one-way partition of the chief's master link: "
            "requests LAND server-side but every reply is dropped, so "
            "each retry re-delivers an already-executed request — the "
            "server-side dedup must hold while the lease timeout and "
            "reform converge the job",
        ),
        "dup_report_storm": FaultPlan(
            name="dup_report_storm",
            faults=[
                Fault(
                    kind=FaultKind.NET_DUPLICATE,
                    fault_id="dup-report-task",
                    at_step=2,
                    method="report_task_result",
                    count=4,
                ),
                Fault(
                    kind=FaultKind.NET_DUPLICATE,
                    fault_id="dup-report-version",
                    at_step=2,
                    method="report_version",
                    count=4,
                ),
            ],
            notes="duplicate delivery: report RPCs re-execute "
            "server-side (the response of the first execution is "
            "discarded, as after a lost reply + retry); task accounting "
            "must stay exactly-once and version reports monotone — the "
            "MASTER_RETRYABLE_METHODS dedup contract, proven under "
            "actual duplication",
        ),
        "streaming_preempt_under_load": FaultPlan(
            name="streaming_preempt_under_load",
            faults=[
                Fault(
                    kind=FaultKind.PREEMPT,
                    fault_id="stream-preempt-p%d" % last,
                    # streaming smokes run a short bounded prefix (each
                    # worker sees ~4 steps, not the epoch-mode budget
                    # _KILL_STEP assumes), so arm early enough that the
                    # kill lands while windows are still in flight
                    at_step=3,
                    process_id=last,
                )
            ],
            notes="SIGKILL one worker mid-STREAM (watermark-lease mode, "
            "no epochs, no checkpoints): the leased windows must "
            "requeue, the replica ring must restore at the replicated "
            "watermark, and lag behind the source watermark must stay "
            "bounded — the epoch-parity invariant is replaced by "
            "bounded_lag + freshness_monotone",
        ),
        "shrink_then_restore": FaultPlan(
            name="shrink_then_restore",
            faults=[
                Fault(
                    kind=FaultKind.REDUCE_CAPACITY,
                    fault_id="shrink",
                    at_step=4,
                    count=max(1, num_workers - 1),
                ),
                Fault(
                    kind=FaultKind.RESTORE_CAPACITY,
                    fault_id="restore",
                    at_step=10,
                ),
            ],
            notes="capacity loss then recovery: the world re-forms "
            "smaller, trains on, then re-forms back to full size",
        ),
    }
    return plans


def named_plan(name: str, num_workers: int = 2) -> FaultPlan:
    plans = builtin_plans(num_workers)
    if name not in plans:
        raise KeyError(
            f"unknown plan {name!r}; available: {sorted(plans)} "
            f"(or 'random:<seed>')"
        )
    return plans[name]


def random_plan(seed: int, num_workers: int = 2, max_faults: int = 3) -> FaultPlan:
    """A replayable random plan: the same seed always yields the same
    plan (the RNG is the only entropy source)."""
    rng = random.Random(seed)
    kinds = [
        FaultKind.PREEMPT,
        FaultKind.KILL_COORDINATOR,
        FaultKind.DROP_HEARTBEAT,
        FaultKind.DELAY_BATCHES,
    ]
    # faults that cost their world a re-formation: kills directly, and a
    # heartbeat drop indirectly (its window outlasts the harness timeout,
    # so the frozen worker is declared dead) — later faults must target
    # the generation that exists by then or they silently never fire
    reforming = (
        FaultKind.PREEMPT,
        FaultKind.KILL_COORDINATOR,
        FaultKind.DROP_HEARTBEAT,
    )
    faults = []
    for i in range(rng.randint(1, max_faults)):
        kind = rng.choice(kinds)
        proc = 0 if kind == FaultKind.KILL_COORDINATOR else rng.randrange(
            num_workers
        )
        faults.append(
            Fault(
                kind=kind,
                fault_id=f"random-{i}-{kind}",
                at_step=rng.randint(2, 12),
                process_id=proc,
                cluster_version=sum(
                    1 for f in faults if f.kind in reforming
                ),
                duration_secs=rng.choice([4.0, 6.0, 8.0])
                if kind == FaultKind.DROP_HEARTBEAT
                else 0.0,
                delay_ms=float(rng.randint(10, 80))
                if kind == FaultKind.DELAY_BATCHES
                else 0.0,
            )
        )
    return FaultPlan(
        name=f"random:{seed}", seed=seed, faults=faults,
        notes="seed-derived plan (replayable by seed alone)",
    )


def resolve_plan(name: str, num_workers: int = 2) -> FaultPlan:
    """``named_plan`` plus the ``random:<seed>`` spelling."""
    if name.startswith("random:"):
        return random_plan(int(name.split(":", 1)[1]), num_workers)
    return named_plan(name, num_workers)
