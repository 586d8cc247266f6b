"""A process this code no longer holds is never signalled.

Phase 20's CPU rehearsal (``tests/test_torch_streaming_smoke.py``) lost
its xdist worker after the module fixture had ended.  The smoke's
serving phases SIGKILLed the replica ids they had read from ``/proc``
after the frontend had reaped those replicas, and phase 14d did the same
for the workers of the master it killed once init had reaped them.  A
freed id goes to the next process or thread the host makes, and
``kill()`` on a thread's id ends that thread's whole process: under six
xdist workers that can be a test worker.  The cleanup now signals only
what it still holds: a ``Popen`` not yet reaped, the session of a
leader not yet reaped, or a process named by its pid and its start time,
checked again before each signal (``elasticdl_tpu_torch/utils/proc.py``).
These tests pin that rule.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from elasticdl_tpu_torch.master.master import LocalInstanceManager, _AdoptedProcess  # noqa: E402
from elasticdl_tpu_torch.utils.proc import HeldProcess  # noqa: E402

SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]

# a stand-in serving frontend: it starts one "replica" (its argv carries
# the replica marker the smoke looks for), and on SIGTERM stops and
# reaps it, as serving.main does, then exits
FRONTEND = r"""
import signal, subprocess, sys, time
kid = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)", "--role", "replica"])
open(sys.argv[1], "w").write(str(kid.pid))
def stop(*_a):
    kid.terminate()
    kid.wait()
    sys.exit(0)
signal.signal(signal.SIGTERM, stop)
while True:
    time.sleep(0.05)
"""


@pytest.fixture
def signals(monkeypatch):
    """Every pid-addressed signal this process sends, recorded (and sent)."""
    sent = []
    real_kill, real_killpg = os.kill, os.killpg

    def kill(pid, sig):
        sent.append(("kill", pid, sig))
        return real_kill(pid, sig)

    def killpg(pgid, sig):
        sent.append(("killpg", pgid, sig))
        return real_killpg(pgid, sig)

    monkeypatch.setattr(os, "kill", kill)
    monkeypatch.setattr(os, "killpg", killpg)
    return sent


def _wait_exists(path, secs=30.0):
    deadline = time.monotonic() + secs
    while not os.path.exists(path) or not open(path).read():
        assert time.monotonic() < deadline, path
        time.sleep(0.02)
    return int(open(path).read())


def test_a_reaped_child_is_never_signalled(signals):
    child = subprocess.Popen(SLEEPER)
    held = HeldProcess(child.pid)
    assert held.held and not held.exited()
    child.kill()
    assert child.wait() == -signal.SIGKILL
    signals.clear()  # the Popen's own kill, sent while it held the child
    # reaped: its pid is free for anyone; the handle sends nothing
    assert held.exited()
    assert held.signal(signal.SIGKILL) is False
    assert signals == []


def test_a_held_running_process_is_signalled_once_its_start_time_matches(signals):
    child = subprocess.Popen(SLEEPER)
    try:
        held = HeldProcess(child.pid)
        assert held.signal(signal.SIGKILL) is True
        assert child.wait(timeout=30) == -signal.SIGKILL
    finally:
        child.kill()
        child.wait()
    assert signals == [("kill", child.pid, signal.SIGKILL)]


def test_an_adopted_worker_once_reaped_is_never_signalled(signals):
    """``_AdoptedProcess`` (a re-homed worker) kills through its handle,
    and not at all once it knows the process is gone."""
    child = subprocess.Popen(SLEEPER)
    adopted = _AdoptedProcess(child.pid)
    child.kill()
    child.wait()  # reaped here, by its Popen: the adopted pid is free
    signals.clear()
    adopted.kill()
    adopted.terminate()
    assert adopted.poll() == -1 and adopted.exit_unknown
    assert signals == []


def test_signal_worker_goes_through_the_managers_handle(signals):
    child = subprocess.Popen(SLEEPER)
    im = LocalInstanceManager(None, 2, lambda *a, **k: [])
    im._procs[3] = child
    assert im.signal_worker(3, signal.SIGKILL) is True
    assert child.wait(timeout=30) == -signal.SIGKILL
    # reaped: Popen sends nothing to a pid it has waited on
    assert im.signal_worker(3, signal.SIGKILL) is True
    assert im.signal_worker(4, signal.SIGKILL) is False
    assert [s for s in signals if s[1] == child.pid] == [("kill", child.pid, signal.SIGKILL)]


def test_the_smoke_stops_serving_signalling_only_what_it_holds(tmp_path, signals):
    """Phases 16b and 20c: after SIGTERM the frontend has reaped its
    replica, and the cleanup sends no signal to the replica's freed pid,
    nor to the frontend's session once its leader is reaped."""
    pid_file = str(tmp_path / "kid")
    with open(os.devnull, "w") as devnull:
        frontend, held_frontend = chip_smoke._start_frontend(
            [sys.executable, "-c", FRONTEND, pid_file], devnull, dict(os.environ)
        )
    try:
        kid_pid = _wait_exists(pid_file)
        kids = chip_smoke._serving_children(frontend.pid)
        assert [k.pid for k in kids] == [kid_pid]
        # its own session: no signal to this process's group reaches it
        assert os.getsid(frontend.pid) == frontend.pid != os.getsid(0)
        frontend.send_signal(signal.SIGTERM)  # while it is held: unreaped
        signals.clear()
        assert chip_smoke._gone_within([held_frontend, *kids], 30.0)
        assert frontend.wait(timeout=30) == 0
    finally:
        chip_smoke._stop_serving(frontend, held_frontend, kids)
    assert signals == []


def test_the_smoke_stops_a_live_frontend_and_its_replica(tmp_path, signals):
    """A failed phase: the frontend and its replica still run when the
    cleanup comes, and both stop (the session, its leader unreaped)."""
    pid_file = str(tmp_path / "kid")
    with open(os.devnull, "w") as devnull:
        frontend, held_frontend = chip_smoke._start_frontend(
            [sys.executable, "-c", FRONTEND, pid_file], devnull, dict(os.environ)
        )
    kids = []
    try:
        kid = HeldProcess(_wait_exists(pid_file))
        kids = chip_smoke._serving_children(frontend.pid)
        assert len(kids) == 1
    finally:
        chip_smoke._stop_serving(frontend, held_frontend, kids)
    assert frontend.returncode == -signal.SIGKILL
    assert chip_smoke._gone_within([kid], 30.0)
    # the session first; then the replica by its pid, unless the
    # session's SIGKILL had already ended it (a zombie is not signalled)
    assert signals[0] == ("killpg", frontend.pid, signal.SIGKILL)
    assert signals[1:] in ([], [("kill", kid.pid, signal.SIGKILL)])


def test_a_zombie_is_exited_and_never_signalled(signals):
    """Exited, not yet reaped: nothing is left to signal, and a reap by
    its parent (init, for an orphan) may free the pid at any moment."""
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    held = HeldProcess(child.pid)
    deadline = time.monotonic() + 30
    while not held.exited() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert held.exited() and child.returncode is None
    assert held.signal(signal.SIGKILL) is False
    assert child.wait(timeout=30) == 0
    assert held.signal(signal.SIGKILL) is False
    assert signals == []


def test_a_later_holder_of_the_pid_is_never_signalled(signals, monkeypatch):
    from elasticdl_tpu_torch.utils import proc

    child = subprocess.Popen(SLEEPER)
    try:
        held = HeldProcess(child.pid)
        # the same pid, another start time: another process took the number
        real = proc._start_and_state
        monkeypatch.setattr(proc, "_start_and_state", lambda pid: (real(pid)[0] + 1, "S"))
        assert held.exited() and held.signal(signal.SIGKILL) is False
        assert signals == [] and child.poll() is None
        monkeypatch.setattr(proc, "_start_and_state", real)
        # the process it holds: signalled by pid, after the check
        assert held.signal(signal.SIGKILL) is True
        assert child.wait(timeout=30) == -signal.SIGKILL
        assert signals == [("kill", child.pid, signal.SIGKILL)]
    finally:
        child.kill()
        child.wait()


def test_a_process_gone_before_the_hold_is_never_signalled(signals):
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    held = HeldProcess(child.pid)
    assert not held.held and held.exited()
    assert held.signal(signal.SIGKILL) is False
    assert signals == []


SESSION_LEADER = r"""
import subprocess, sys, time
kid = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
open(sys.argv[1], "w").write(str(kid.pid))
time.sleep(float(sys.argv[2]))
"""


@pytest.mark.parametrize("leader_secs, timeout, want_rc", [(0.5, 30.0, 0), (60.0, 1.0, None)],
                         ids=["exits", "times_out"])
def test_a_session_is_stopped_before_its_leader_is_reaped(tmp_path, monkeypatch, leader_secs,
                                                            timeout, want_rc):
    """Phases 17 and 20 run each job in a session of its own: the session's
    group is signalled while its leader is not yet reaped (exited or not),
    so the group id is still this process's; a process the leader started
    goes with it."""
    sent = []
    real_killpg = os.killpg

    def killpg(pgid, sig):
        with open(f"/proc/{pgid}/stat") as f:  # the leader, unreaped
            sent.append((pgid, sig, f.read().rpartition(")")[2].split()[0]))
        return real_killpg(pgid, sig)

    monkeypatch.setattr(os, "killpg", killpg)
    pid_file = str(tmp_path / "kid")
    rc, _secs = chip_smoke._session_run(
        [sys.executable, "-c", SESSION_LEADER, pid_file, str(leader_secs)],
        str(tmp_path / "log"), timeout,
    )
    assert rc == want_rc
    kid = HeldProcess(_wait_exists(pid_file))
    assert chip_smoke._gone_within([kid], 30.0)
    assert len(sent) == 1 and sent[0][1] == signal.SIGKILL
    assert sent[0][2] == ("Z" if want_rc == 0 else "S")
