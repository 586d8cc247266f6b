"""The port's master servicer and data-parallel step against the JAX
package's, on the CPU (``torch.distributed`` over gloo).

- **Servicer against servicer.** One scripted sequence of step-task
  pulls, task reports, a failed task, a re-formation (cluster version
  bumped, tasks recovered, stream reset) and heartbeats goes to the JAX
  ``MasterServicer`` and to the port's, each over its own package's task
  dispatcher on the same shards and seed: every response is the same —
  the tasks, WAIT and end-of-stream at the same seq, stale-version
  requests fenced — and so are the dispatchers' counters and the
  failure detector's verdicts on an injected clock.
- **One dp step against JAX.** Two processes each take 4 of 8 global
  mnist rows (3 of them zero-weight padding) through ``SPMDTrainer``
  with a process group; process 0's state after the step is held to the
  JAX single-device step on the 8 rows, with the JAX step's own dropout
  mask (``tests/test_torch_mnist.py``'s, read from the Dropout) and
  that file's tolerances: parameters within ``STEP_REL_TOL`` in relative
  norm, running statistics within ``STATS_TOL``.  This pins the loss's
  global weight sum and BatchNorm's cross-process statistics.
- **One dp step against the port's one process.** The same two-process
  step, with the port's own dropout, against ``SPMDTrainer`` without a
  group on the whole batch, for mnist (SGD, BatchNorm, dropout) and the
  LM (Adam, attention through the flash wrappers' plain path): every
  parameter and statistic within ``DP_TOL`` absolute (f32 sums taken in
  another order), and the two processes' states bitwise equal; and a
  stacked group of two mnist steps, run eagerly under the group, within
  ``STACKED_TOL``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from elasticdl_tpu_torch.parallel import elastic

DP_TOL = 1e-6
# two steps: the first step's differences of about 1e-7 grow through
# mnist's BatchNorm in the second (tests/test_torch_lockstep.py)
STACKED_TOL = 1e-4
ROWS, REAL = 8, 5
LM_KW = dict(vocab_size=64, embed_dim=32, num_heads=2, num_layers=2)
LM_SEQ = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    """The worker processes this file starts inherit the environment: one
    intra-op thread each, so that they do not oversubscribe the CPU the
    test runner's other workers share (on an oversubscribed CPU, the JAX
    package's mnist step beside them was seen to abort)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


# ---- servicer against servicer --------------------------------------------

SHARDS = {"a": (0, 96), "b": (0, 64)}


def _scenario(servicer, task_d, m):
    """The scripted requests; returns every response (as a dict) in order."""
    out, leased = [], {}

    def step(seq, worker, cluster_version=None):
        if cluster_version is None:
            cluster_version = servicer.cluster_version
        resp = servicer.get_step_task(m.GetStepTaskRequest(
            seq=seq, worker_id=worker, cluster_version=cluster_version,
        ))
        out.append(("step", seq, worker, cluster_version, dataclasses.asdict(resp)))
        if resp.task_id >= 0:
            leased[seq] = resp.task_id
        return resp

    def report(seq, error=""):
        servicer.report_task_result(m.ReportTaskResultRequest(
            task_id=leased[seq], err_message=error,
            exec_counters={"fail_count": 32} if error else {},
        ))

    # world 0: two processes pull the same seqs, process 0 reports
    for seq in range(3):
        step(seq, 0)
        step(seq, 1)
    report(0)
    report(1)
    # lease every task left without reporting: the stream WAITs (not
    # memoized: a second pull of that seq asks the dispatcher again)
    seq = 3
    while not step(seq, 0).is_wait:
        seq += 1
    step(seq, 1)
    report(2, error="lost a peer")  # re-queued
    first_wait = seq
    step(first_wait, 0)  # the re-queued task now resolves this seq
    out.append(("version", servicer.bump_cluster_version()))
    # the old world is fenced: end-of-stream, whatever its seq
    step(first_wait + 1, 0, cluster_version=0)
    for worker in (0, 1):
        task_d.recover_tasks(worker)
        servicer.forget_worker(worker)
    servicer.reset_step_stream()
    # world 1 restarts at seq 0 and trains every task to the end
    seq = 0
    while True:
        resp = step(seq, 2)
        step(seq, 3)
        if resp.is_wait:
            continue
        if resp.task_id < 0:
            break
        report(seq)
        servicer.report_version(m.ReportVersionRequest(model_version=seq + 1, worker_id=2))
        seq += 1
    step(seq, 3)  # end-of-stream is memoized at the same seq
    out.append(("beat", dataclasses.asdict(servicer.heartbeat(
        m.HeartbeatRequest(worker_id=2, step=seq, rpc={"retries": 1})
    ))))
    out.append(("version", servicer.get_model_version()))
    from elasticdl_tpu_torch.utils.constants import TaskType

    counters = task_d.counters(TaskType.TRAINING)
    out.append(("counters", counters.total_records, counters.failed_records))
    out.append(("finished", task_d.finished()))
    return out


def test_step_streams_of_the_two_servicers_are_identical():
    from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
    from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
    from elasticdl_tpu.rpc import messages as jax_msg
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.rpc import messages as port_msg

    kw = dict(records_per_task=32, num_epochs=2, shuffle_seed=3)
    jax_d, port_d = JaxDispatcher(SHARDS, **kw), TaskDispatcher(SHARDS, **kw)
    want = _scenario(JaxServicer(16, jax_d), jax_d, jax_msg)
    got = _scenario(MasterServicer(16, port_d), port_d, port_msg)
    assert got == want
    kinds = [entry[4]["type"] for entry in got if entry[0] == "step"]
    assert 3 in kinds  # a WAIT was served
    fenced = [e for e in got if e[0] == "step" and e[3] == 0 and e[2] == 0 and e[4]["task_id"] == -1 and e[4]["type"] == -1]
    assert fenced  # the stale world got end-of-stream
    assert got[-2] == ("counters", 320, 32) and got[-1] == ("finished", True)


def test_failure_detection_of_the_two_servicers_agrees():
    from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
    from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
    from elasticdl_tpu.rpc import messages as jax_msg
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.rpc import messages as port_msg

    def run(servicer_cls, dispatcher_cls, m):
        now = [0.0]
        servicer = servicer_cls(16, dispatcher_cls(SHARDS, records_per_task=32), clock=lambda: now[0])
        verdicts = []
        for t, worker in ((0.0, 0), (0.0, 1), (1.0, 2), (2.5, 0)):
            now[0] = t
            servicer.heartbeat(m.HeartbeatRequest(worker_id=worker))
        for t in (2.5, 3.6, 5.0):
            now[0] = t
            verdicts.append(servicer.dead_workers(3.0))
        servicer.mark_worker_dead(0)
        verdicts.append(servicer.dead_workers(0.0))
        verdicts.append(servicer.dead_workers(3.0))
        servicer.forget_worker(0)
        servicer.forget_worker(1)
        verdicts.append(servicer.dead_workers(3.0))
        verdicts.append(servicer.live_workers())
        return verdicts

    want = run(JaxServicer, JaxDispatcher, jax_msg)
    assert run(MasterServicer, TaskDispatcher, port_msg) == want
    assert want == [[], [1], [1, 2], [0], [0, 1, 2], [2], [2]]


# ---- the data-parallel step ----------------------------------------------


def _mnist_inputs():
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (REAL, 28, 28)).astype(np.uint8)
    labels = np.random.RandomState(105).randint(0, 10, REAL).astype(np.int32)
    pad = ROWS - REAL
    images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)])
    labels = np.concatenate([labels, np.repeat(labels[-1:], pad)])
    weights = np.array([1] * REAL + [0] * pad, np.float32)
    return images, labels, weights


def _lm_inputs():
    tokens = np.random.RandomState(1).randint(0, LM_KW["vocab_size"], (ROWS, LM_SEQ + 1))
    tokens = tokens.astype(np.int32)
    weights = np.array([1] * REAL + [0] * (ROWS - REAL), np.float32)
    return tokens[:, :-1], tokens[:, 1:], weights


def _port_setup(model_name: str, inputs: dict, rank: int):
    """``(trainer kwargs, features, labels, weights)`` of one port step;
    the mnist weights come from ``inputs``' flax flats on process 0 only
    (the others start from other weights and take process 0's by
    broadcast), the LM's from a seeded init."""
    from elasticdl_tpu_torch.models import long_seq_transformer as lm
    from elasticdl_tpu_torch.models import mnist_functional_api as mnist
    from elasticdl_tpu_torch.utils import flax_weights

    if model_name.startswith("mnist"):
        model = mnist.custom_model()
        if rank == 0:
            params = {k[len("p/"):]: v for k, v in inputs.items() if k.startswith("p/")}
            stats = {k[len("s/"):]: v for k, v in inputs.items() if k.startswith("s/")}
            model.load_state_dict(flax_weights.torch_state_from_flax(params, model, stats))
        kw = dict(loss_fn=mnist.loss, tx=mnist.optimizer(), device_parse=mnist.device_parse)
        features = {"image": inputs["images"]}
        labels = inputs["labels"]
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(11 if rank == 0 else 12)
            model = lm.custom_model(**LM_KW)
        kw = dict(loss_fn=lm.loss, tx=lm.optimizer())
        features, labels = {"tokens": inputs["tokens"]}, inputs["labels"]
    return model, kw, features, labels, inputs["weights"]


def _flats(model) -> dict:
    from elasticdl_tpu_torch.utils import flax_weights

    out = {f"p/{k}": v for k, v in flax_weights.flax_flat_from_torch(model).items()}
    out.update({f"s/{k}": v for k, v in flax_weights.flax_state_from_torch(model).items()})
    return out


def _dp_child(rank, world_size, port, model_name, inputs_path, out_dir):
    """One process of the two-process step (run by ``torch.multiprocessing``)."""
    from elasticdl_tpu_torch.models import mnist_functional_api as mnist
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer

    torch.set_num_threads(1)
    with np.load(inputs_path) as z:
        inputs = {k: z[k] for k in z.files}
    if "keep" in inputs:
        keep = torch.from_numpy(inputs["keep"])

        def jax_mask_dropout(x, rate, generator):
            rows = elastic.current_rows()
            mask = keep[rows.start:rows.stop]
            return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))

        mnist.dropout = jax_mask_dropout
    world = elastic.initialize_world(f"localhost:{port}", world_size, rank, device="cpu")
    try:
        model, kw, features, labels, weights = _port_setup(model_name, inputs, rank)
        trainer = SPMDTrainer(model, device="cpu", process_group=world.group, **kw)
        assert trainer.broadcast_state() == 0
        metrics = _steps(trainer, model_name, features, labels, weights)
        out = _flats(trainer.state.model)
        out["loss"] = np.asarray(float(metrics["loss"]))
        np.savez(os.path.join(out_dir, f"p{rank}.npz"), **out)
    finally:
        elastic.shutdown_world()


def _steps(trainer, model_name, features, labels, weights) -> dict:
    """One step of the batch; for ``*_stacked``, a group of two steps
    (the batch, then its rows reversed) through ``train_steps_stacked``,
    which under a process group runs them eagerly."""
    if not model_name.endswith("_stacked"):
        return trainer.train_step(*trainer.place_step(features, labels, weights))
    group = tuple(
        {k: np.stack([v, v[::-1]]) for k, v in t.items()} if isinstance(t, dict)
        else np.stack([t, t[::-1]])
        for t in (features, labels, weights)
    )
    metrics = trainer.train_steps_stacked(*trainer.place_group(*group))
    assert trainer.dispatch_counts["eager_groups"] == 1 and trainer.step == 2
    return metrics


def _two_process_step(tmp_path, model_name: str, inputs: dict) -> list[dict]:
    """Both processes' flats (and their share of the loss) after the
    two-process step."""
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **inputs)
    tmp.spawn(
        _dp_child,
        args=(2, elastic.pick_coordinator_port(), model_name, path, str(tmp_path)),
        nprocs=2, join=True,
    )
    outs = []
    for rank in range(2):
        with np.load(str(tmp_path / f"p{rank}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def _rel_norm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_two_process_mnist_step_matches_the_jax_step(tmp_path):
    import jax.numpy as jnp
    import optax

    import test_torch_mnist as t
    from elasticdl_tpu.models import mnist_functional_api as jax_mnist
    from elasticdl_tpu.trainer import step as jax_step
    from elasticdl_tpu.trainer.state import TrainState as JaxState
    from elasticdl_tpu.utils import tree_utils

    images, labels, weights = _mnist_inputs()
    model, params, stats = t._jax_variables(0)
    keep = t._jax_dropout_keep(model, {"params": params, **stats}, images, 0)
    state = JaxState.create(model.apply, params, optax.sgd(0.1), stats)
    train = jax_step.build_train_step(
        jax_mnist.loss, device_parse=jax_mnist.device_parse, donate=False
    )
    new_state, jax_metrics = train(
        state, {"image": jnp.asarray(images)}, jnp.asarray(labels), jnp.asarray(weights)
    )
    inputs = {"images": images, "labels": labels, "weights": weights, "keep": keep}
    inputs.update({f"p/{k}": v for k, v in tree_utils.tree_to_dict(params).items()})
    inputs.update({f"s/{k}": v for k, v in tree_utils.tree_to_dict(stats).items()})
    p0, p1 = _two_process_step(tmp_path, "mnist", inputs)

    want = {f"p/{k}": np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.params).items()}
    want_stats = {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(new_state.model_state).items()}
    for name, value in want.items():
        assert _rel_norm(p0[name], value) < t.STEP_REL_TOL, name
        before = params
        for part in name[len("p/"):].split("/"):
            before = before[part]
        # the update itself, not only the weights it was added to
        assert _rel_norm(p0[name] - before, value - before) < 1e-3, name
    assert set(want_stats) == {"batch_stats/BatchNorm_0/mean", "batch_stats/BatchNorm_0/var"}
    for name, value in want_stats.items():
        np.testing.assert_allclose(p0[f"s/{name}"], value, atol=t.STATS_TOL, rtol=0)
    # the processes' shares of the loss add up to the global batch's
    assert abs(float(p0["loss"] + p1["loss"]) - float(jax_metrics["loss"])) < t.LOGIT_TOL
    for key in p0:
        if key != "loss":
            np.testing.assert_array_equal(p0[key], p1[key], err_msg=key)


@pytest.mark.parametrize("model_name", ["mnist", "lm", "mnist_stacked"])
def test_two_process_step_matches_the_ports_one_process_step(tmp_path, model_name):
    """``mnist_stacked``: a stacked group of two steps, each process
    placing its rows of both (``place_group``), run eagerly under the
    process group, against the same two steps in one process."""
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer

    if model_name.startswith("mnist"):
        import test_torch_mnist as t
        from elasticdl_tpu.utils import tree_utils

        images, labels, weights = _mnist_inputs()
        _model, params, stats = t._jax_variables(1)
        inputs = {"images": images, "labels": labels, "weights": weights}
        inputs.update({f"p/{k}": v for k, v in tree_utils.tree_to_dict(params).items()})
        inputs.update({f"s/{k}": v for k, v in tree_utils.tree_to_dict(stats).items()})
    else:
        tokens, labels, weights = _lm_inputs()
        inputs = {"tokens": tokens, "labels": labels, "weights": weights}
    p0, p1 = _two_process_step(tmp_path, model_name, inputs)

    model, kw, features, labels, weights = _port_setup(model_name, inputs, 0)
    trainer = SPMDTrainer(model, device="cpu", **kw)
    metrics = _steps(trainer, model_name, features, labels, weights)
    want = _flats(trainer.state.model)
    assert set(p0) == set(want) | {"loss"}
    tol = STACKED_TOL if model_name.endswith("_stacked") else DP_TOL
    for key, value in want.items():
        np.testing.assert_allclose(p0[key], value, atol=tol, rtol=0, err_msg=key)
        np.testing.assert_array_equal(p0[key], p1[key], err_msg=key)
    assert abs(float(p0["loss"] + p1["loss"]) - float(metrics["loss"])) < tol
    if model_name == "mnist":
        # dropout and the padding rows did act: the statistics moved and
        # process 1 (1 real row of 4) holds a loss share of its own
        assert 0 < float(p1["loss"]) < float(p0["loss"])


def test_local_batch_ranges_and_divisor():
    assert elastic.local_batch_ranges(8, 2, 0) == [(0, 4)]
    assert elastic.local_batch_ranges(8, 2, 1) == [(4, 8)]
    assert elastic.batch_divisor(2) == 2 and elastic.batch_divisor(0) == 1
    with pytest.raises(ValueError, match="does not split"):
        elastic.local_batch_ranges(7, 2, 0)


@pytest.mark.parametrize(
    "device, processes, cards, backend",
    [("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 2, 2, "nccl"),
     ("cuda", 4, 2, "gloo"), ("cuda", 1, 1, "nccl")],
)
def test_backend_rule(monkeypatch, device, processes, cards, backend):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert elastic.choose_backend(device, processes) == backend
    if device == "cuda":
        assert elastic.rank_device(device, processes - 1) == torch.device(
            "cuda", (processes - 1) % cards
        )
