"""Stall a live worker of a chaos job and report whether its master
evicted it.

Runs the port's chaos runner (``preempt_one_worker``, on the CPU, no
baseline) from a checkout, and once the world's process 0 has joined
stops that worker with SIGSTOP for ``--stall-secs`` seconds, then lets
it go on with SIGCONT.  A stop stands for a host too loaded to run the
worker's heartbeat thread.  A master that takes the stopped, live worker
for dead re-forms the world before the plan's kill of process 1 at step
6: the run's report then has ``dead_workers`` [[0]], no fired fault and
``faults_injected`` FAIL.  Prints one JSON line per run, then a summary.

    python scripts/torch_liveness_stall.py --stall-secs 1.8 --runs 4
    python scripts/torch_liveness_stall.py --tree OTHER_CHECKOUT ...

``--tree`` runs another checkout's runner (a parent commit unpacked with
``git archive``), so two liveness rules can be compared on one host.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from elasticdl_tpu_torch.utils.proc import HeldProcess  # noqa: E402

JOINED = "Process 0 joined generation 0"
STARTED = re.compile(r"Started worker 0 \(pid (\d+)\)")


def _wait_for(log_path: str, proc, pattern) -> re.Match | None:
    """The first match of ``pattern`` in the log, or None once the
    runner has ended without one."""
    while proc.poll() is None:
        with open(log_path, errors="replace") as f:
            found = re.search(pattern, f.read())
        if found:
            return found
        time.sleep(0.05)
    return None


def stall_run(tree: str, work_dir: str, stall_secs: float, after_secs: float) -> dict:
    """One runner job with process 0 stopped once; its report's verdict."""
    log_path = os.path.join(work_dir, "log.txt")
    out = os.path.join(work_dir, "report.json")
    env = dict(os.environ, PYTHONPATH=tree, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.chaos.runner",
             "--plan", "preempt_one_worker", "--device", "cpu", "--no-baseline",
             "--workdir", os.path.join(work_dir, "job"), "--output", out],
            cwd=tree, env=env, stdout=log_file, stderr=subprocess.STDOUT,
        )
    row: dict = {"stall_secs": stall_secs}
    started = _wait_for(log_path, proc, STARTED)
    # held before the world forms: the stop and the resume reach this
    # process or nothing
    worker = HeldProcess(int(started.group(1))) if started else None
    if worker is not None and _wait_for(log_path, proc, re.escape(JOINED)):
        time.sleep(after_secs)
        row["stopped"] = worker.signal(signal.SIGSTOP)
        time.sleep(stall_secs)
        worker.signal(signal.SIGCONT)
    row["rc"] = proc.wait()
    if os.path.exists(out):
        with open(out) as f:
            report = json.load(f)
        row.update(
            dead_workers=[e.get("dead_workers") for e in report["reforms"]],
            fired=[f.get("step") for f in report["faults_injected"]],
            failed=sorted(i["name"] for i in report["invariants"] if i["status"] != "PASS"),
        )
        row["evicted_live_worker"] = [0] in row["dead_workers"]
    result_path = os.path.join(work_dir, "job", "chaos_result.json")
    if os.path.exists(result_path):
        with open(result_path) as f:
            trace = json.load(f).get("trace") or {}
        # the re-formations the trace section found (the first world's
        # step samples die with its SIGKILLed processes)
        row["trace_reformations"] = sum(len(r.get("reform_downtime", [])) for r in trace.values())
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stall-secs", type=float, default=1.8)
    parser.add_argument("--after-secs", type=float, nargs="+", default=[0.0, 1.0, 2.0])
    parser.add_argument("--runs", type=int, default=4)
    parser.add_argument("--parallel", type=int, default=4)
    parser.add_argument("--tree", default=REPO)
    args = parser.parse_args(argv)
    rows: list = [None] * args.runs
    gate = threading.Semaphore(args.parallel)

    def one(i):
        with gate, tempfile.TemporaryDirectory(prefix="liveness_stall_") as work_dir:
            after = args.after_secs[i % len(args.after_secs)]
            rows[i] = {"run": i, "after_secs": after,
                       **stall_run(args.tree, work_dir, args.stall_secs, after)}
            print(json.dumps(rows[i]), flush=True)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(args.runs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps({
        "tree": args.tree, "stall_secs": args.stall_secs, "runs": args.runs,
        "evicted": sum(1 for r in rows if r.get("evicted_live_worker")),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
