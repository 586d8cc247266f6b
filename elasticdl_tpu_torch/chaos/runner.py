"""The chaos runner CLI; the counterpart of ``elasticdl_tpu/chaos/runner.py``.

Run a model-zoo job (mnist_functional_api, two lockstep workers) under a
named fault plan, check the elastic contract, print one JSON report,
write ``chaos_result.json`` beside the run's artifacts, and exit 1 if
any invariant failed::

    python -m elasticdl_tpu_torch.chaos.runner --plan preempt_one_worker
    python -m elasticdl_tpu_torch.chaos.runner --plan random:1234 --no-baseline
    python -m elasticdl_tpu_torch.chaos.runner --plan preempt_one_worker --device cpu
    python -m elasticdl_tpu_torch.chaos.runner --list

The job runs on the card (``--device cuda``, the default: the workers
share it, and a card that is missing is an error) or on the CPU when
asked (``--device cpu``); the JAX runner pins the CPU.  By default the
faulted run is paired with a fault-free baseline of the same job (same
data and shuffle seeds), and the ``trajectory_parity`` invariant bounds
their accuracy delta: a preempted and re-formed job must reproduce the
fault-free trajectory.  ``--corrupt double_report`` (and the other
:data:`~elasticdl_tpu_torch.chaos.harness.CORRUPTIONS`) breaks the run on
purpose: a corrupted run must exit 1.  ``--corrupt drop_shard_parts``
needs row-sharded state, so it runs ``deepfm_sharded_embedding`` on
``gen_frappe`` records with replication on (:data:`SHARDED_JOB`); the
JAX runner, which always runs mnist, refuses it for want of replication.

``streaming_preempt_under_load`` runs as the JAX runner runs it: the
runner has no streaming job, so the plan's preemption hits the default
epoch job (a streaming run is ``chaos/harness.py``'s ``streaming=True``,
as ``chip_smoke.py``'s phase 20 and the JAX streaming smoke run it), and
``--corrupt drop_stream_window`` is refused for want of a streaming run.

Left for its slice: the fleet plans of ``--list`` (the tooling slice).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

# the default |accuracy(chaos) - accuracy(baseline)| bound: both runs
# train the same records to the end, so the gap is resume noise, not
# lost learning
TRAJECTORY_TOLERANCE = 0.15

# plans that exercise peer state replication: --replication auto turns
# it on for these (a slice loss is what the slice-aware ring is for)
REPLICATION_PLANS = frozenset(
    {
        "preempt_after_replication",
        "kill_during_replication",
        "slice_loss_mid_epoch",
    }
)

# slice-granular plans need a multi-slice fleet; grow_under_load starts
# the job on one slice so that the capacity grant has room to grow
MULTISLICE_PLANS = {
    "slice_loss_mid_epoch": {"num_slices": 2},
    "grow_under_load": {"num_slices": 2, "initial_slices": 1},
}

# the network plans and the RPC posture each needs.  The delay plan gets
# deadlines generous enough that latency is no error (the job must end
# with no re-formation); the blackhole and partition plans a tight
# deadline and a retry budget the fault window outlasts, so that the
# unreachable worker fails fast, dies and is evicted, and a lease timeout
# so that its tasks are reclaimed even without a re-formation; the
# duplicate plan keeps retries on, with room to spare
NETWORK_PLANS = {
    "slow_network_mid_epoch": {"rpc_deadline_secs": 5.0},
    "blackhole_master_link": {
        "rpc_deadline_secs": 1.0,
        "rpc_retry_secs": 4.0,
        "task_timeout_secs": 30.0,
    },
    "oneway_partition_worker": {
        "rpc_deadline_secs": 1.0,
        "rpc_retry_secs": 4.0,
        "task_timeout_secs": 30.0,
    },
    "dup_report_storm": {
        "rpc_deadline_secs": 5.0,
        "rpc_retry_secs": 8.0,
    },
}

# one line for each invariant the harness can report (--list)
INVARIANT_DESCRIPTIONS = {
    "exactly_once": "every training task completes successfully exactly "
    "once (0 = lost shard, >1 = double-trained)",
    "records_accounted": "successful task record sums match num_epochs x "
    "dataset size and the dispatcher's own counters",
    "version_monotonic": "no worker's reported model version decreases "
    "within one world generation",
    "reform_progress": "training advances PAST the highest pre-reform "
    "version (no completing by looping restored state)",
    "trajectory_parity": "|accuracy - fault-free baseline| within "
    "tolerance (exactly-once data + resume correctness)",
    "faults_injected": "the plan actually executed (a fault-free run "
    "must not pass a fault-injection gate)",
    "replication_no_lost_steps": "the re-formed world restored from peer "
    "RAM at exactly the last replicated step before the kill",
    "cross_slice_replica_coverage": "on a multi-slice world every "
    "replica push lands on a DIFFERENT slice than its source",
    "master_recovery": "a relaunched master restored from its journal "
    "and the generation fence never rolled back",
    "no_false_dead": "a latency-only network plan (delay within the "
    "heartbeat tolerance) completed with ZERO re-formations — gray is "
    "not dead",
    "duplicate_delivery_exactly_once": "duplicated report RPCs "
    "re-executed server-side were visibly deduplicated and no task "
    "counted twice (falsified by --corrupt drop_dedup)",
}

# plans that kill the master: they need the journaled control plane
# (--master_journal_dir), which the harness turns on for these alone
MASTER_HA_PLANS = frozenset(
    {"master_kill_mid_epoch", "master_kill_during_reform"}
)


def build_arg_parser() -> argparse.ArgumentParser:
    from elasticdl_tpu_torch.chaos.harness import CORRUPTIONS

    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.chaos.runner",
        description="Deterministic fault injection for elastic training",
    )
    parser.add_argument(
        "--plan",
        default="preempt_one_worker",
        help="Named plan (see --list-plans) or 'random:<seed>'",
    )
    parser.add_argument("--list-plans", action="store_true", help="List plans and exit")
    parser.add_argument(
        "--list",
        action="store_true",
        help="List every registered plan AND invariant with one-line "
        "descriptions, then exit 0",
    )
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument(
        "--num-slices",
        type=int,
        default=None,
        help="Force a multi-slice fleet for the chaos'd job; default: "
        "what the plan needs (2 for the slice plans, else 1)",
    )
    parser.add_argument("--num-records", type=int, default=1024)
    parser.add_argument("--num-epochs", type=int, default=2)
    parser.add_argument(
        "--baseline",
        dest="baseline",
        action="store_true",
        default=True,
        help="Also run the fault-free baseline and report the accuracy "
        "delta (default)",
    )
    parser.add_argument("--no-baseline", dest="baseline", action="store_false")
    parser.add_argument(
        "--trajectory-tolerance",
        type=float,
        default=TRAJECTORY_TOLERANCE,
        help="Max |accuracy delta| vs the baseline trajectory",
    )
    parser.add_argument(
        "--corrupt",
        default="",
        choices=list(CORRUPTIONS),
        help="Deliberately corrupt the run to prove the checker fails "
        "when it should",
    )
    parser.add_argument(
        "--replication",
        choices=["auto", "on", "off"],
        default="auto",
        help="Peer state replication for the chaos'd job; 'auto' enables "
        "it for the replication plans and leaves every other plan as a "
        "replication-less run",
    )
    parser.add_argument(
        "--workdir",
        default="",
        help="Keep artifacts (plan, event log, checkpoints) here; "
        "default: a temp dir, deleted on exit",
    )
    parser.add_argument("--output", default="", help="Also write the report JSON here")
    parser.add_argument("--run-timeout-secs", type=float, default=600.0)
    parser.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="Where the workers train and the final checkpoint is "
        "evaluated (the master uses none)",
    )
    return parser


# the job --corrupt drop_shard_parts runs: a model whose tables a world
# row-shards, on the dataset that feeds it, replicated
SHARDED_JOB = dict(
    model_def="deepfm_sharded_embedding.deepfm_sharded_embedding.custom_model",
    dataset="frappe",
)


def job_config(args, workdir: str):
    """The faulted job's configuration: the plan's replication, slices,
    master HA and RPC posture, as the JAX runner's ``_run`` sets them."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig
    from elasticdl_tpu_torch.chaos.plan import resolve_plan

    plan = resolve_plan(args.plan, num_workers=args.num_workers)
    replication = args.replication == "on" or (
        args.replication == "auto" and plan.name in REPLICATION_PLANS
    )
    slice_config = MULTISLICE_PLANS.get(plan.name, {})
    num_slices = (
        args.num_slices if args.num_slices is not None else slice_config.get("num_slices", 1)
    )
    network_config = NETWORK_PLANS.get(plan.name, {})
    sharded = args.corrupt == "drop_shard_parts"
    if sharded:
        replication = True
    return ChaosJobConfig(
        plan=plan,
        workdir=os.path.join(workdir, "chaos"),
        num_records=args.num_records,
        num_epochs=args.num_epochs,
        num_workers=args.num_workers,
        evaluate=True,
        corrupt=args.corrupt,
        run_timeout_secs=args.run_timeout_secs,
        replication=replication,
        master_ha=plan.name in MASTER_HA_PLANS or bool(plan.master_kill_faults()),
        num_slices=num_slices,
        initial_slices=slice_config.get("initial_slices"),
        rpc_deadline_secs=network_config.get("rpc_deadline_secs"),
        rpc_retry_secs=network_config.get("rpc_retry_secs"),
        task_timeout_secs=network_config.get("task_timeout_secs"),
        device=args.device,
        **(SHARDED_JOB if sharded else {}),
    )


def baseline_config(args, workdir: str):
    """The fault-free baseline: the same job under the ``none`` plan."""
    from elasticdl_tpu_torch.chaos.harness import ChaosJobConfig
    from elasticdl_tpu_torch.chaos.plan import named_plan

    return ChaosJobConfig(
        plan=named_plan("none", args.num_workers),
        workdir=os.path.join(workdir, "baseline"),
        num_records=args.num_records,
        num_epochs=args.num_epochs,
        num_workers=args.num_workers,
        evaluate=True,
        run_timeout_secs=args.run_timeout_secs,
        device=args.device,
    )


def _run(args, workdir: str) -> dict:
    from elasticdl_tpu_torch.chaos.harness import run_chaos_job

    report = run_chaos_job(job_config(args, workdir))
    if args.baseline and not args.corrupt:
        # a corrupted run exits 1 whatever its trajectory: a baseline
        # would double its time for nothing
        baseline = run_chaos_job(baseline_config(args, workdir))
        report["baseline_accuracy"] = baseline.get("accuracy")
        report["baseline_ok"] = baseline["invariants_ok"]
        delta = None
        if report.get("accuracy") is not None and baseline.get("accuracy") is not None:
            delta = round(report["accuracy"] - baseline["accuracy"], 4)
        report["accuracy_delta"] = delta
        parity_ok = delta is not None and abs(delta) <= args.trajectory_tolerance
        report["invariants"].append(
            {
                "name": "trajectory_parity",
                "status": "PASS" if parity_ok else "FAIL",
                "violations": []
                if parity_ok
                else [
                    f"|accuracy delta| {delta} exceeds {args.trajectory_tolerance} "
                    "vs the non-faulted trajectory"
                    if delta is not None
                    else "no accuracy available to compare"
                ],
            }
        )
        report["invariants_ok"] = bool(
            report["invariants_ok"] and parity_ok and baseline["invariants_ok"]
        )
    return report


def write_result_json(report: dict, workdir: str) -> str:
    """The machine-readable verdict beside the run's artifacts
    (``chaos_result.json``): per-invariant PASS/FAIL, the latencies, and
    the replication, slice, master-HA and RPC sections the run has, and
    the causal trace's summary (``trace``: each run's re-formation phase
    breakdown, recovered task spans and master outages, from
    ``telemetry/trace.py``)."""
    result = {
        "plan": report["plan"],
        "seed": report["seed"],
        "corrupt": report.get("corrupt", ""),
        "invariants": [{"name": i["name"], "status": i["status"]} for i in report["invariants"]],
        "invariants_ok": report["invariants_ok"],
        "rc": report.get("rc"),
        "accuracy": report.get("accuracy"),
        "accuracy_delta": report.get("accuracy_delta"),
        "reform_latency_secs": report.get("reform_latency_secs"),
        "detect_secs": report.get("detect_secs"),
        "kill_to_step_secs": report.get("kill_to_step_secs"),
    }
    for key in ("replication", "multislice", "rpc"):
        if report.get(key) is not None:
            result[key] = report[key]
    if report.get("master_ha") is not None:
        result["master_ha"] = report["master_ha"]
        result["master_lives"] = report.get("master_lives")
    try:
        from elasticdl_tpu_torch.telemetry.trace import analyze_run_dir

        result["trace"] = {
            rel: {
                "reform_downtime": run["reform_downtime"],
                "recovered_task_spans": run["recovered_task_spans"],
                # a master outage's phases, only when the run had one
                **({"master_outage": run["master_outage"]} if run.get("master_outage") else {}),
            }
            for rel, run in analyze_run_dir(workdir)["runs"].items()
        }
    except Exception:  # noqa: BLE001 — tracing never blocks the verdict
        result["trace"] = {}
    path = os.path.join(workdir, "chaos_result.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    return path


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.list or args.list_plans:
        from elasticdl_tpu_torch.chaos.plan import builtin_plans

        print("Plans:")
        for name, plan in sorted(builtin_plans(args.num_workers).items()):
            note = " ".join(plan.notes.split())
            print(f"  {name:26s} {note}")
        if args.list:
            print("Invariants:")
            for name, desc in sorted(INVARIANT_DESCRIPTIONS.items()):
                print(f"  {name:26s} {desc}")
        return 0

    from elasticdl_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no card where one is asked for: raise
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        report = _run(args, args.workdir)
        write_result_json(report, args.workdir)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            report = _run(args, workdir)
            write_result_json(report, workdir)

    text = json.dumps(report, indent=2)
    print(text)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0 if report["invariants_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
