"""Hot standbys in the port (slice 6b-2c) against the JAX package's, on
the CPU.

- **The pool's size.** ``--standby_workers -1`` is one standby per
  process of a lockstep world and none for the task-stream worker; an
  explicit count is kept for a lockstep world and refused (with a
  warning) otherwise.
- **Activation** (``tests/test_failure_paths.py``'s case): a standby
  that died while waiting, or whose stdin is broken, is skipped (the
  broken one killed), and an empty pool reports False so that the caller
  cold-starts.
- **The standby's wait**: the assignment line on stdin sets the world's
  coordinates on the arguments, and EOF ends the process cleanly; a real
  ``python -m elasticdl_tpu_torch.worker.main --standby 1`` exits 0 at
  EOF; a pool spawned and drained by the instance manager.
- **The RPC mailbox** (``post_world_assignment``, ``get_world_assignment``,
  ``drain_standbys``) against the JAX servicer's, and over the socket
  transport to a polling standby (``_poll_world_assignment``); the
  heartbeat's ``should_quiesce`` from the quiesce flag.
- **The refill** waits for the new world's first step-task pull.
- **End to end** (gloo, tiny mnist through the train CLI):
  ``chip_smoke.py``'s phase 15a at a small size: a two-rank world
  preempted at step 6 and re-formed from the pool
  (``standby_activations == 2``, the pool's pids).
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import pytest

PKGS = ("jax", "torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"


def _master_mod(pkg):
    return importlib.import_module(
        ("elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch") + ".master.master"
    )


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


@pytest.mark.parametrize("standby", [-1, 0, 3])
@pytest.mark.parametrize("num_workers, lockstep", [(1, False), (1, True), (2, True), (4, True),
                                                   (2, False)])
def test_the_pool_size_matches_jax(num_workers, lockstep, standby):
    sizes = []
    for pkg in PKGS:
        im = _master_mod(pkg).LocalInstanceManager(
            None, num_workers, lambda *a, **k: [], lockstep=lockstep, standby_workers=standby
        )
        sizes.append((im._standby_target, im.lockstep, im.standby_activations))
    assert sizes[0] == sizes[1]
    world = lockstep and num_workers > 1
    assert sizes[1][0] == ((num_workers if standby < 0 else standby) if world else 0)


class _FakeProc:
    """A standby's Popen handle: alive or not, its stdin writable or not."""

    def __init__(self, alive=True, broken_pipe=False, pid=999):
        self._alive = alive
        self._broken = broken_pipe
        self.killed = False
        self.closed = False
        self.stdin = self
        self.written = b""
        self.pid = pid

    def poll(self):
        return None if self._alive and not self.killed else 1

    def write(self, data):
        if self._broken:
            raise OSError("broken pipe")
        self.written += data

    def flush(self):
        pass

    def close(self):
        self.closed = True
        self._alive = False

    def kill(self):
        self.killed = True

    def wait(self, timeout=None):
        return 0


def _bare_im(pkg, standbys):
    im = _master_mod(pkg).LocalInstanceManager.__new__(_master_mod(pkg).LocalInstanceManager)
    im._lock = threading.Lock()
    im._procs = {}
    im.standby_activations = 0
    im.activations = []
    im._standbys = list(standbys)
    im._draining = False
    return im


def test_activation_skips_dead_and_broken_standbys_as_jax_does():
    world = dict(coordinator_addr="localhost:1", num_processes=2, process_id=0, cluster_version=1)
    seen = []
    for pkg in PKGS:
        dead, broken, good = _FakeProc(alive=False), _FakeProc(broken_pipe=True), _FakeProc(pid=7)
        im = _bare_im(pkg, [dead, broken, good])
        first = im._activate_standby(7, world)
        second = im._activate_standby(8, world)
        seen.append((first, second, list(im._procs), broken.killed, dead.killed,
                     im.standby_activations, json.loads(good.written)))
    assert seen[0] == seen[1]
    assert seen[1][:6] == (True, False, [7], True, False, 1)
    assert seen[1][6] == {"worker_id": 7, **world}


def test_drain_closes_every_live_standby_and_fences_the_refill():
    for pkg in PKGS:
        alive, dead = _FakeProc(), _FakeProc(alive=False)
        im = _bare_im(pkg, [alive, dead])
        im._drain_standbys()
        assert alive.closed and not dead.closed
        assert im._standbys == [] and im._draining
        im._standby_target = 2
        im._replenish_standbys()  # fenced: spawns nothing
        assert im._standbys == []


def _standby_args(pkg):
    args_mod = importlib.import_module(
        ("elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch") + ".utils.args"
    )
    return args_mod.parse_worker_args([
        "--model_def", MNIST_DEF, "--worker_id", "0", "--master_addr", "localhost:1",
        "--standby", "1",
    ])


@pytest.mark.parametrize("line", ["", json.dumps({
    "worker_id": 5, "coordinator_addr": "localhost:9", "num_processes": 4, "process_id": 3,
    "cluster_version": 2, "slice_id": 1, "num_slices": 2,
}) + "\n"])
def test_the_standby_waits_on_stdin_as_jax_does(line, monkeypatch):
    """The assignment line sets the world's coordinates and ends standby
    mode; EOF reports False (the process exits cleanly)."""
    seen = []
    for pkg in PKGS:
        main_mod = importlib.import_module(
            ("elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch") + ".worker.main"
        )
        monkeypatch.delenv("EDL_STANDBY_ID", raising=False)
        monkeypatch.setattr(sys, "stdin", io.StringIO(line))
        args = _standby_args(pkg)
        ok = main_mod._standby_wait(args)
        seen.append((ok, {k: getattr(args, k) for k in (
            "worker_id", "coordinator_addr", "num_processes", "process_id",
            "cluster_version", "slice_id", "num_slices", "standby")}))
    assert seen[0] == seen[1]
    assert seen[1][0] == bool(line)
    if line:
        assert seen[1][1]["process_id"] == 3 and seen[1][1]["standby"] == 0


def test_a_standby_process_exits_cleanly_at_eof():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.worker.main", "--model_def", MNIST_DEF,
         "--worker_id", "0", "--master_addr", "localhost:1", "--standby", "1", "--device", "cpu"],
        input=b"", env=env, capture_output=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"waiting for a world assignment" in proc.stderr


def test_a_waiting_standby_has_paid_the_first_optimizers_imports():
    """The first optimizer a process builds imports torch._dynamo (8 s on
    the card's machine): a standby pays it while it waits, with no CUDA
    context, so that its first step after the activation does not."""
    code = (
        "import io, sys; sys.stdin = io.StringIO('');"
        "from elasticdl_tpu_torch.worker import main as m;"
        "from elasticdl_tpu_torch.utils.args import parse_worker_args;"
        f"args = parse_worker_args(['--model_def', '{MNIST_DEF}', '--worker_id', '0',"
        " '--master_addr', 'localhost:1', '--standby', '1', '--device', 'cpu']);"
        "before = 'torch._dynamo' in sys.modules;"
        "ok = m._standby_wait(args);"
        "import torch;"
        "print(before, ok, 'torch._dynamo' in sys.modules, torch.cuda.is_initialized())"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.stdout.split() == ["False", "False", "True", "False"], proc.stderr[-2000:]


def _servicer(pkg):
    mod = importlib.import_module(
        ("elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch") + ".master.servicer"
    )
    disp = importlib.import_module(
        ("elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch") + ".master.task_dispatcher"
    )
    msg = importlib.import_module(
        ("elasticdl_tpu" if pkg == "jax" else "elasticdl_tpu_torch") + ".rpc.messages"
    )
    return mod.MasterServicer(8, disp.TaskDispatcher({}, {}, {}, 8, 1)), msg


def test_the_mailbox_and_quiesce_match_jax():
    assignment = dict(worker_id=3, coordinator_addr="h:1", num_processes=2, process_id=1,
                      cluster_version=4, slice_id=1, num_slices=2)
    seen = []
    for pkg in PKGS:
        svc, msg = _servicer(pkg)
        out = []

        def poll(sid):
            out.append(dataclasses.asdict(svc.get_world_assignment(
                msg.GetWorldAssignmentRequest(standby_id=sid))))

        poll("a")
        svc.post_world_assignment("a", assignment)
        poll("b")
        poll("a")
        poll("a")
        beat = lambda: svc.heartbeat(msg.HeartbeatRequest(worker_id=1))  # noqa: E731
        out.append((svc.is_quiescing, beat().should_quiesce))
        svc.begin_quiesce()
        out.append((svc.is_quiescing, beat().should_quiesce, svc.cluster_version))
        svc.clear_quiesce()
        out.append((svc.is_quiescing, svc.cluster_version))
        svc.begin_quiesce()
        svc.end_quiesce()
        out.append((svc.is_quiescing, svc.cluster_version))
        svc.post_world_assignment("c", assignment)
        svc.drain_standbys()
        poll("c")
        # a poll is no liveness signal
        out.append(svc.live_workers())
        seen.append(out)
    for entry in seen[0]:
        if isinstance(entry, dict):
            entry.pop("trace", None)
    for entry in seen[1]:
        if isinstance(entry, dict):
            entry.pop("trace", None)
    assert seen[0] == seen[1]
    got = seen[1]
    assert not got[0]["has"] and got[2]["has"] and got[2]["process_id"] == 1
    assert not got[3]["has"] and got[-2]["shutdown"] and not got[-2]["has"]


def test_a_polling_standby_gets_its_assignment_over_the_wire(monkeypatch):
    from elasticdl_tpu_torch.rpc.service import create_server
    from elasticdl_tpu_torch.worker import main as worker_main

    svc, _msg = _servicer("torch")
    server = create_server(svc, 0)
    server.start()
    try:
        args = _standby_args("torch")
        args.master_addr = f"localhost:{server.port}"
        threading.Timer(0.3, svc.post_world_assignment, args=("pod-1", dict(
            worker_id=9, coordinator_addr="h:2", num_processes=2, process_id=0,
            cluster_version=1))).start()
        got = worker_main._poll_world_assignment(args, "pod-1", poll_secs=0.05)
        assert got["worker_id"] == 9 and got["num_slices"] == 1
        threading.Timer(0.3, svc.drain_standbys).start()
        assert worker_main._poll_world_assignment(args, "pod-2", poll_secs=0.05) is None
        # the stdin path's counterpart: EDL_STANDBY_ID makes the wait poll
        monkeypatch.setenv("EDL_STANDBY_ID", "pod-3")
        assert worker_main._standby_wait(args) is False
    finally:
        server.stop()


def test_the_refill_waits_for_the_new_worlds_first_pull(monkeypatch):
    """After a re-formation the pool refills once the new world pulls its
    first step task (the standbys' imports would slow its start)."""
    from elasticdl_tpu_torch.master import master as port_master

    pulled = {"at": None}
    spawned = []

    class Master:
        port = 1
        servicer = type("S", (), {"first_stream_pull_at": lambda self: pulled["at"]})()

    im = port_master.LocalInstanceManager(Master(), 2, lambda *a, **k: [], standby_workers=2)

    def spawn(worker_id, stdin_pipe=False, **kw):
        spawned.append((time.monotonic(), kw))
        return _FakeProc(pid=100 + len(spawned))

    monkeypatch.setattr(im, "_spawn", spawn)
    im._refill_in_background(after_join=True)
    time.sleep(0.5)
    assert spawned == []
    pulled["at"] = time.monotonic()
    deadline = time.monotonic() + 5
    while len(spawned) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert [kw for _t, kw in spawned] == [{"standby": 1}, {"standby": 1}]
    assert all(t >= pulled["at"] for t, _kw in spawned)
    assert [p.pid for p in im._standbys] == [101, 102]
    im._drain_standbys()


def _reads_stdin(pid: int) -> bool:
    """Whether ``pid`` is blocked in ``read`` on its stdin (Linux's
    ``/proc/<pid>/syscall``: the call's number, 0, and its first
    argument, fd 0)."""
    try:
        with open(f"/proc/{pid}/syscall", encoding="ascii") as f:
            return f.read().split()[:2] == ["0", "0x0"]
    except OSError:
        return False


def test_a_spawned_pool_is_drained_at_stop(tmp_path):
    """Two real standbys of the instance manager pay their imports and
    exit 0 when ``stop_workers`` closes their stdin."""
    from elasticdl_tpu_torch.master import master as port_master
    from elasticdl_tpu_torch.utils.args import build_worker_arguments, parse_master_args

    args = parse_master_args(["--model_def", MNIST_DEF, "--training_data", str(tmp_path),
                              "--device", "cpu", "--num_workers", "2"])

    class Master:
        port = 1

    def build_argv(worker_id, master_addr, **kw):
        argv = ["elasticdl_tpu_torch.worker.main", *build_worker_arguments(args, worker_id, master_addr)]
        for k, v in kw.items():
            argv += [f"--{k}", str(v)]
        return argv

    im = port_master.LocalInstanceManager(Master(), 2, build_argv, standby_workers=2)
    im._replenish_standbys()
    procs = list(im._standbys)
    assert len(procs) == 2 and all(p.poll() is None for p in procs)
    # warm: each blocks in read(0, ...) on its stdin (a standby still
    # importing is killed by the drain's 5 s wait, as in JAX)
    deadline = time.monotonic() + 120
    while not all(_reads_stdin(p.pid) for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    im.stop_workers(grace_secs=0.0)
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    assert im._standbys == []


def _smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_smoke_phase15a_standby_rehearsal_on_the_cpu(tmp_path):
    """Phase 15a at a small size: two ranks preempted at step 6, the new
    world handed to the two warm standbys, with the smoke's own gates."""
    smoke = _smoke()
    cfg = dict(smoke.SLICE_MNIST, train_records=512, eval_records=256, shards=2,
               records_per_task=64, batch=16, epochs=2, min_accuracy=0.0)
    data = smoke._zoo_data(str(tmp_path / "data"), cfg)
    row = smoke.standby_run(str(tmp_path / "standby"), cfg, data, device="cpu")
    print(json.dumps(row, default=str))
    assert smoke.check_slices_case("standby", row, cfg) == []
    assert row["reformed_world_pids"] == row["activated_pids"]
