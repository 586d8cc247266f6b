"""One plan through both packages' chaos runners, end to end on the CPU:
``preempt_one_worker --no-baseline`` through ``python -m
elasticdl_tpu.chaos.runner`` and ``python -m
elasticdl_tpu_torch.chaos.runner --device cpu``, side by side (one
intra-op thread in each of their processes), must give equal exit
codes, invariant names and statuses, tasks tracked, records and
re-formation counts; exact equality, no tolerance.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_SECS = 420


def start_runner(work_dir: str, *argv, package: str):
    """A chaos runner CLI as a subprocess, its report written to
    ``<work_dir>/report.json``, its output to ``<work_dir>/log.txt``."""
    os.makedirs(work_dir, exist_ok=True)
    device = ["--device", "cpu"] if package == "elasticdl_tpu_torch" else []
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    log = open(os.path.join(work_dir, "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.chaos.runner", *argv, *device,
         "--workdir", work_dir, "--output", os.path.join(work_dir, "report.json")],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    return SimpleNamespace(proc=proc, log=log, work_dir=work_dir)


def finish_runner(run) -> SimpleNamespace:
    """Wait for a runner; its exit code, report and ``chaos_result.json``."""
    try:
        rc = run.proc.wait(timeout=RUN_TIMEOUT_SECS)
    finally:
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.wait()
        run.log.close()

    def load(name):
        path = os.path.join(run.work_dir, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    with open(os.path.join(run.work_dir, "log.txt")) as f:
        tail = f.read()[-4000:]
    return SimpleNamespace(
        rc=rc, report=load("report.json"), result=load("chaos_result.json"), log_tail=tail
    )


def statuses(report: dict) -> dict:
    return {i["name"]: i["status"] for i in report["invariants"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos_parity")
    started = {
        pkg: start_runner(
            str(root / pkg), "--plan", "preempt_one_worker", "--no-baseline", package=package,
        )
        for pkg, package in (("jax", "elasticdl_tpu"), ("port", "elasticdl_tpu_torch"))
    }
    return {name: finish_runner(run) for name, run in started.items()}


def test_preempt_one_worker_through_both_runners(runs):
    ref, port = runs["jax"], runs["port"]
    assert port.rc == ref.rc == 0, (ref.log_tail, port.log_tail)
    assert statuses(port.report) == statuses(ref.report)
    for key in ("tasks_tracked", "records_ok", "num_records", "num_epochs"):
        assert port.report[key] == ref.report[key], key
    assert len(port.report["reforms"]) == len(ref.report["reforms"]) == 1
    assert [e["kind"] for e in port.report["faults_injected"]] == [
        e["kind"] for e in ref.report["faults_injected"]
    ]
    assert statuses(port.result) == statuses(ref.result)
