"""The port's profiler windows (``elasticdl_tpu_torch/utils/profiling.py``,
on ``torch.profiler``) held to ``tests/test_profiling.py``'s cases on the
CPU: ``--profile_dir`` captures a step window's Chrome trace during Local
training, a profiler without a directory does nothing, and a window opens
and closes on the steps it names.  Then the on-demand path: the master's
``request_profile`` and the heartbeat command, which the workers dedupe
by window id, as in the JAX package.
"""

from __future__ import annotations

import glob
import json
import os

import pytest
import torch

from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
from elasticdl_tpu.rpc import messages as jax_msg
from elasticdl_tpu.utils import profiling as jax_profiling
from elasticdl_tpu_torch.data.recordio_gen import synthetic
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.trainer.local_executor import LocalExecutor
from elasticdl_tpu_torch.utils import profiling
from elasticdl_tpu_torch.utils.args import parse_master_args
from elasticdl_tpu_torch.utils.profiling import StepProfiler, apply_profile_command


def test_local_training_writes_profile(tmp_path):
    train = synthetic.gen_mnist(str(tmp_path / "t"), num_records=192, num_shards=1, seed=0)
    profile_dir = str(tmp_path / "prof")
    args = parse_master_args([
        "--model_def", "mnist_functional_api.mnist_functional_api.custom_model",
        "--training_data", train, "--minibatch_size", "32", "--records_per_task", "96",
        "--profile_dir", profile_dir, "--profile_steps", "2", "--device", "cpu",
    ])
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        LocalExecutor(args).run()
    finally:
        torch.set_num_threads(threads)
    traces = glob.glob(os.path.join(profile_dir, "**", "*.trace.json*"), recursive=True)
    assert traces, f"no trace artifacts under {profile_dir}"
    with open(traces[0], encoding="utf-8") as f:
        chrome = json.load(f)
    # the window's host operators: the step's forward and backward ran in it
    names = {e.get("name", "") for e in chrome["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)


def test_step_profiler_inactive_without_dir():
    prof = StepProfiler("", num_steps=3)
    for step in range(10):
        prof.on_step(step)  # a no-op, not a crash
    prof.stop()


def test_step_profiler_window_bounds(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(profiling, "start_trace", lambda d, device=None: calls.append(("start", d)))
    monkeypatch.setattr(profiling, "stop_trace", lambda: calls.append(("stop",)))
    out = str(tmp_path / "p")
    prof = StepProfiler(out, start_step=2, num_steps=3)
    for step in range(10):
        prof.on_step(step)
    prof.stop()  # idempotent after the window closed
    assert calls == [("start", out), ("stop",)]


@pytest.mark.parametrize("mod", [profiling, jax_profiling], ids=["port", "jax"])
def test_an_armed_window_opens_at_the_next_step_and_replays_are_absorbed(monkeypatch, tmp_path, mod):
    """The worker side of ``request_profile``: the same commands give the
    same windows in both packages."""
    import jax

    calls = []
    if mod is profiling:
        monkeypatch.setattr(profiling, "start_trace", lambda d, device=None: calls.append(("start", d)))
        monkeypatch.setattr(profiling, "stop_trace", lambda: calls.append(("stop",)))
    else:
        monkeypatch.setattr(jax.profiler, "start_trace", lambda d: calls.append(("start", d)))
        monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls.append(("stop",)))
    prof = mod.StepProfiler("")
    tel = str(tmp_path)
    assert mod.apply_profile_command(prof, {"window_id": 1, "num_steps": 2}, tel, tag="w0")
    # a replay of the same window, and a second window while one is armed
    assert not mod.apply_profile_command(prof, {"window_id": 1, "num_steps": 2}, tel, tag="w0")
    assert not mod.apply_profile_command(prof, {"window_id": 2, "num_steps": 2}, tel, tag="w0")
    for _ in range(4):
        prof.on_step()
    assert mod.apply_profile_command(prof, {"window_id": 3, "num_steps": 1, "out_dir": "/o"}, tel)
    prof.on_step()
    prof.stop()
    assert not mod.apply_profile_command(prof, {}, tel)
    assert not mod.apply_profile_command(prof, {"window_id": 0}, tel)
    assert calls == [
        ("start", os.path.join(tel, "profile", "window_1_w0")), ("stop",),
        ("start", os.path.join("/o", "window_3")), ("stop",),
    ]


def test_request_profile_rides_the_heartbeat_as_the_jax_servicer_sends_it():
    """The master's side: ``request_profile`` arms a window whose command
    every heartbeat response carries until its TTL lapses; a second
    request meanwhile is absorbed with the same window id."""
    clock = [100.0]
    out = []
    for servicer, m in (
        (MasterServicer(8, TaskDispatcher({"s": (0, 16)}, records_per_task=8),
                        clock=lambda: clock[0]), msg),
        (JaxServicer(8, JaxDispatcher({"s": (0, 16)}, records_per_task=8),
                     clock=lambda: clock[0]), jax_msg),
    ):
        clock[0] = 100.0
        seen = [servicer.heartbeat(m.HeartbeatRequest(worker_id=0)).profile]
        first = servicer.request_profile(m.RequestProfileRequest(num_steps=3, out_dir="/p"))
        again = servicer.request_profile(m.RequestProfileRequest(num_steps=9))
        seen.append(servicer.heartbeat(m.HeartbeatRequest(worker_id=0)).profile)
        clock[0] += servicer.PROFILE_COMMAND_TTL_SECS
        seen.append(servicer.heartbeat(m.HeartbeatRequest(worker_id=0)).profile)
        late = servicer.request_profile(m.RequestProfileRequest(num_steps=0))
        seen.append(servicer.heartbeat(m.HeartbeatRequest(worker_id=0)).profile)
        out.append((seen, [(r.accepted, r.window_id, r.reason) for r in (first, again, late)]))
    assert out[0] == out[1]
    seen, responses = out[0]
    assert seen == [{}, {"window_id": 1, "num_steps": 3, "out_dir": "/p"}, {},
                    {"window_id": 2, "num_steps": 1, "out_dir": ""}]
    assert [r[1] for r in responses] == [1, 1, 2]


def test_request_profile_is_a_master_rpc():
    from elasticdl_tpu_torch.rpc.idempotency import IDEMPOTENCY
    from elasticdl_tpu_torch.rpc.service import MASTER_RETRYABLE_METHODS, MasterClient

    assert "request_profile" in MASTER_RETRYABLE_METHODS
    assert IDEMPOTENCY["request_profile"][0] == "deduped"
    assert callable(MasterClient.request_profile)
    decoded = msg.decode(msg.encode(msg.RequestProfileResponse(accepted=True, window_id=4)))
    assert decoded.window_id == 4 and decoded.accepted
