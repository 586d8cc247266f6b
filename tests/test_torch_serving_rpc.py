"""Serving's RPC face and hot swap in the port (``elasticdl_tpu_torch.
serving``: engine swaps, the replica over the socket transport, the
router, ``serving.main`` and ``predict --serving_addr``) against the JAX
package's, on the CPU.

The models are a causal LM (2 layers, width 32, sequence 64, vocabulary
61) and the iris classifier, exported by the JAX package's
``export_model`` from numpy-seeded weights.  The JAX engine serves 8
canonical rows (one per device of the test conftest's 8-device CPU
mesh), the port's 4 (``device="cpu"``); outputs are held to the JAX
engine's within ``TOL`` (f32), as ``tests/test_torch_serving.py`` holds
them.  Swap decisions, reasons and routing outcomes must be the JAX
package's exactly.  The serving RPCs also ride the chaos netem seams as
``tests/test_serving.py:799`` and ``:838`` hold the JAX replica to: an
injected UNAVAILABLE is retried, and a duplicated ``predict`` answers
once.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from elasticdl_tpu.rpc import messages as jax_msg
from elasticdl_tpu.serving.engine import ExportDirWatcher as JaxWatcher
from elasticdl_tpu.serving.engine import ServingEngine as JaxEngine
from elasticdl_tpu.serving.replica import ServingReplica as JaxReplica
from elasticdl_tpu.trainer.state import TrainState
from elasticdl_tpu.utils.export_utils import export_model as jax_export_model
from elasticdl_tpu.utils.model_utils import get_model_spec as jax_get_model_spec
from elasticdl_tpu_torch.replication.blob import encode_snapshot
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import service as rpc_service
from elasticdl_tpu_torch.rpc.deadline import DeadlinePolicy
from elasticdl_tpu_torch.rpc.service import RpcError, StatusCode
from elasticdl_tpu_torch.serving import main as serving_main
from elasticdl_tpu_torch.serving.engine import (
    STALE_SWAP_PREFIX,
    ExportDirWatcher,
    ServingEngine,
)
from elasticdl_tpu_torch.serving.replica import ServingClient, ServingReplica
from elasticdl_tpu_torch.serving.router import ServingRouter

TOL = 1e-4
JAX_ROWS, PORT_ROWS = 8, 4
SEQ = 64
LM_DEF = "long_seq_transformer.long_seq_transformer.custom_model"
LM_KW = dict(vocab_size=61, embed_dim=32, num_heads=2, num_layers=2)
IRIS_DEF = "odps_iris_dnn_model.odps_iris_dnn_model.custom_model"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 command runs six test processes
    at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tokens(n: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, LM_KW["vocab_size"], (n, SEQ)).astype(np.int32)}


_INIT: dict = {}  # model_def -> (spec, model, param shapes, model state)


def _export(out: str, version: int, seed: int, model_def=LM_DEF, params_kw=None,
            sample=None) -> str:
    """A JAX-written export at ``version`` with weights from ``seed``."""
    params_kw = LM_KW if params_kw is None else params_kw
    if model_def not in _INIT:
        spec = jax_get_model_spec("", model_def, model_params=params_kw)
        model = spec.build_model()
        # the variables' shapes only: an eager init takes seconds
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), sample or _tokens(1, seed=0), training=False
        ))
        _INIT[model_def] = (spec, model, shapes.get("params", {}), {
            k: jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), v)
            for k, v in shapes.items() if k != "params"
        })
    spec, model, params, model_state = _INIT[model_def]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (0.3 * rng.randn(*x.shape)).astype(np.float32), params
    )
    state = TrainState.create(model.apply, params, optax.identity(), model_state)
    state = state.replace(step=np.int32(version))
    args = argparse.Namespace(model_zoo="", model_def=model_def, model_params_dict=params_kw)
    return jax_export_model(out, state, spec, args)


def _iris_export(out: str, version: int, seed: int) -> str:
    return _export(
        out, version, seed, IRIS_DEF, {}, {"features": np.zeros((1, 4), np.float32)}
    )


def _flats(export_dir: str, scale: float) -> dict:
    with np.load(os.path.join(export_dir, "params.npz")) as z:
        return {k: z[k] * scale for k in z.files}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving_rpc")
    out = {
        "v3": _export(str(root / "v3"), 3, seed=11),
        "v9": _export(str(root / "v9"), 9, seed=12),
        "v12": _export(str(root / "v12"), 12, seed=13),
        "other": _export(str(root / "other"), 20, seed=14),
    }
    manifest_path = os.path.join(out["other"], "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    manifest["model_def"] = "mnist_functional_api.mnist_functional_api.custom_model"
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    out["root"] = str(root)
    return out


def _outputs(engine, feats) -> np.ndarray:
    return np.asarray(engine.predict_rows(feats), np.float32)


def _swap_sequence(engine, watcher_cls, exports, watched: str, feats) -> list:
    """The sequence of ``tests/test_serving.py``'s engine swap cases,
    each step as ``(step, accepted, version, stale, reason prefix,
    outputs)``."""
    steps = [("built", True, engine.version, "")]
    outputs = [_outputs(engine, feats)]

    def record(name, result):
        accepted, version, reason = result
        steps.append((name, accepted, version, reason))
        outputs.append(_outputs(engine, feats))

    record("to_9", engine.swap_from_export(exports["v9"]))
    record("replay_9", engine.swap_from_export(exports["v9"]))
    record("back_to_3", engine.swap_from_export(exports["v3"]))
    record("model_def", engine.swap_from_export(exports["other"]))
    record("min_version", engine.swap_from_export(exports["v12"], min_version=50))
    record("incompatible", engine.swap_state_dicts(
        {"not_a_param": np.zeros(3, np.float32)}, {}, engine.version + 1
    ))
    record("in_memory", engine.swap_state_dicts(
        _flats(exports["v3"], 2.0), {}, engine.version + 4, source="replica-store"
    ))
    watcher = watcher_cls(engine, watched)
    record("watch_same", (watcher.poll_once(), engine.version, ""))
    _export(watched, 21, seed=15)  # re-export in place
    record("watch_new", (watcher.poll_once(), engine.version, ""))
    record("watch_again", (watcher.poll_once(), engine.version, ""))
    out = [
        (name, accepted, version, reason.startswith(STALE_SWAP_PREFIX), reason.split(":")[0])
        for name, accepted, version, reason in steps
    ]
    return out, outputs


def test_engine_swap_sequence_matches_the_jax_engine(exports, tmp_path):
    feats = _tokens(3, seed=40)
    runs = {}
    for pkg, engine, watcher_cls in (
        ("jax", JaxEngine(exports["v3"], JAX_ROWS), JaxWatcher),
        ("port", ServingEngine(exports["v3"], PORT_ROWS, device="cpu"), ExportDirWatcher),
    ):
        watched = str(tmp_path / f"watched_{pkg}")
        shutil.copytree(exports["v3"], watched)
        runs[pkg] = _swap_sequence(engine, watcher_cls, exports, watched, feats)
    (jax_steps, jax_out), (port_steps, port_out) = runs["jax"], runs["port"]
    assert port_steps == jax_steps
    assert [s[:4] for s in port_steps] == [
        ("built", True, 3, False), ("to_9", True, 9, False),
        ("replay_9", False, 9, True), ("back_to_3", False, 9, True),
        ("model_def", False, 9, False), ("min_version", False, 9, False),
        ("incompatible", False, 9, False), ("in_memory", True, 13, False),
        ("watch_same", False, 13, False), ("watch_new", True, 21, False),
        ("watch_again", False, 21, False),
    ]
    assert [s[4] for s in port_steps][2:7] == [
        "stale swap", "stale swap", "model_def mismatch",
        "export version 12 < required 50", "incompatible state",
    ]
    for step, got, want in zip(port_steps, port_out, jax_out):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=step[0])
    # each accepted swap served new weights
    assert not np.allclose(port_out[0], port_out[1])
    assert not np.allclose(port_out[6], port_out[7])


def test_swap_before_the_build_replaces_the_pending_weights(exports):
    feats = _tokens(2, seed=41)
    jax_engine = JaxEngine(exports["v3"], JAX_ROWS)
    port_engine = ServingEngine(exports["v3"], PORT_ROWS, device="cpu")
    for engine in (jax_engine, port_engine):
        assert engine.swap_from_export(exports["v9"]) == (True, 9, "")
        assert not engine.built and engine.version == 9
    np.testing.assert_allclose(
        _outputs(port_engine, feats), _outputs(jax_engine, feats), atol=TOL, rtol=TOL
    )
    # the pending weights were version 9's
    fresh = ServingEngine(exports["v9"], PORT_ROWS, device="cpu")
    np.testing.assert_array_equal(_outputs(port_engine, feats), _outputs(fresh, feats))
    assert port_engine.version == 9 and port_engine.swaps_applied == 1


def test_a_swap_with_a_name_the_model_lacks_is_refused_by_the_port(exports):
    """A divergence, pinned: the JAX engine rebuilds its tree from the
    names it knows and ignores the rest; the port's loader refuses a
    name the model does not have."""
    flats = dict(_flats(exports["v3"], 2.0), extra=np.zeros(3, np.float32))
    jax_engine = JaxEngine(exports["v3"], JAX_ROWS)
    port_engine = ServingEngine(exports["v3"], PORT_ROWS, device="cpu")
    for engine in (jax_engine, port_engine):
        engine.predict_rows(_tokens(1, seed=43))
    assert jax_engine.swap_state_dicts(flats, {}, 5) == (True, 5, "")
    accepted, version, reason = port_engine.swap_state_dicts(flats, {}, 5)
    assert (accepted, version) == (False, 3) and reason.startswith("incompatible state")
    assert "extra" in reason


def test_payload_swap_from_a_replication_blob(exports):
    """``swap_model`` with an inline blob of the port's ``encode_snapshot``
    (``params/`` names, as a checkpoint carries them) answers as the JAX
    replica answers its own blob, and serves the JAX engine's outputs for
    the same flats."""
    from elasticdl_tpu.replication.blob import encode_snapshot as jax_encode

    feats = _tokens(2, seed=42)
    flats = _flats(exports["v3"], 1.5)
    dense = {f"params/{k}": v for k, v in flats.items()}
    port = ServingReplica(exports["v3"], PORT_ROWS, device="cpu")
    jax_rep = JaxReplica(exports["v3"], JAX_ROWS)
    answers = {}
    for pkg, servicer, codec, blob in (
        ("port", port.servicer, msg, encode_snapshot(dense, {})),
        ("jax", jax_rep.servicer, jax_msg, jax_encode(dense, {})),
    ):
        answers[pkg] = [
            (r.accepted, r.model_version, r.stale)
            for r in (
                servicer.swap_model(codec.SwapModelRequest(payload=blob, version=7, source="push")),
                servicer.swap_model(codec.SwapModelRequest(payload=blob, version=7)),
                servicer.swap_model(codec.SwapModelRequest(payload=b"torn", version=8)),
            )
        ]
    assert answers["port"][:2] == answers["jax"][:2] == [(True, 7, False), (False, 7, True)]
    # a torn blob is answered, not fatal
    assert answers["port"][2] == (False, 7, False)
    np.testing.assert_allclose(
        _outputs(port.engine, feats), _outputs(jax_rep.engine, feats), atol=TOL, rtol=TOL
    )


def test_probe_beat_totals_are_the_jax_engines(exports):
    jax_engine = JaxEngine(exports["v3"], JAX_ROWS)
    port_engine = ServingEngine(exports["v3"], PORT_ROWS, device="cpu")
    rng = np.random.RandomState(5)
    for _ in range(20):
        phases = {
            name: float(rng.exponential(0.01))
            for name in ("queue_wait", "assemble", "device_compute", "untracked")
        }
        total = sum(phases.values())
        jax_engine._note_phase_totals(phases, total)
        port_engine._note_phase_totals(phases, total)
    assert port_engine.phase_totals_snapshot() == jax_engine.phase_totals_snapshot()
    assert set(port_engine.counters_snapshot()) == set(jax_engine.counters_snapshot())


# ---- the replica over the socket -------------------------------------------


@pytest.fixture()
def replica(exports):
    rep = ServingReplica(
        exports["v3"], PORT_ROWS, max_wait_secs=0.002, device="cpu", port=0
    ).start()
    yield rep
    rep.close()


def test_replica_socket_mixed_sizes_concurrent_match_the_jax_engine(replica, exports):
    client = ServingClient(f"localhost:{replica.port}", deadlines=DeadlinePolicy.from_secs(30))
    jax_engine = JaxEngine(exports["v3"], JAX_ROWS)
    sizes = [1, 3, PORT_ROWS, PORT_ROWS + 3]
    feats = [_tokens(n, seed=50 + i) for i, n in enumerate(sizes)]
    with ThreadPoolExecutor(len(sizes)) as pool:
        responses = list(pool.map(
            lambda iv: client.predict(msg.PredictRequest(
                request_id=f"q{iv[0]}", features=msg.pack_array_tree(iv[1]),
            )),
            enumerate(feats),
        ))
    for n, f, response in zip(sizes, feats, responses):
        assert not response.error, response.error
        out = msg.unpack_array_tree(response.outputs)
        assert out.shape == (n, SEQ, LM_KW["vocab_size"]) and response.model_version == 3
        assert response.phases["total_ms"] > 0
        np.testing.assert_allclose(out, _outputs(jax_engine, f), atol=TOL, rtol=TOL)
    status = client.serving_status()
    assert (status.requests, status.rows, status.canonical_rows) == (
        len(sizes), sum(sizes), PORT_ROWS
    )
    assert status.counters["requests"] == len(sizes)
    assert status.phases["total"]["count"] == len(sizes)


def test_compile_count_is_the_count_of_dispatched_shapes(replica, exports):
    """A divergence, pinned: the JAX replica reports its process's XLA
    compile count; the port, with no compiler, reports the input shapes
    its engine dispatched, 1 whatever the request sizes and across a
    swap."""
    client = ServingClient(f"localhost:{replica.port}", deadlines=DeadlinePolicy.from_secs(30))
    for i, n in enumerate((1, 6, 2)):
        assert not client.predict(msg.PredictRequest(
            request_id=f"c{i}", features=msg.pack_array_tree(_tokens(n, seed=i)),
        )).error
    assert client.swap_model(msg.SwapModelRequest(model_dir=exports["v9"])).accepted
    assert not client.predict(msg.PredictRequest(
        request_id="after", features=msg.pack_array_tree(_tokens(5, seed=9)),
    )).error
    status = client.serving_status()
    assert status.compile_count == 1 and status.model_version == 9 and status.swaps == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_overload_is_answered_retryably(exports, pkg):
    """No dispatch thread: the queue only fills; the next request is shed
    retryably and counted as rejected, not as an error."""
    if pkg == "jax":
        rep, codec = JaxReplica(exports["v3"], JAX_ROWS, max_queue_rows=8), jax_msg
    else:
        rep, codec = ServingReplica(exports["v3"], PORT_ROWS, device="cpu", max_queue_rows=8), msg
    filler = threading.Thread(
        target=rep.servicer.predict,
        args=(codec.PredictRequest(request_id="fill", features=codec.pack_array_tree(_tokens(8, 1))),),
        daemon=True,
    )
    filler.start()
    for _ in range(500):
        if rep.batcher.queue_rows() == 8:
            break
        time.sleep(0.01)
    response = rep.servicer.predict(codec.PredictRequest(
        request_id="shed", features=codec.pack_array_tree(_tokens(1, 2)),
    ))
    assert response.error and response.retryable
    counters = rep.engine.counters_snapshot()
    assert (counters["rejected"], counters["errors"]) == (1, 0)
    rep.batcher.close()  # releases the filler
    filler.join(timeout=5)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bad_payload_is_answered_not_fatal(exports, pkg):
    if pkg == "jax":
        rep, codec = JaxReplica(exports["v3"], JAX_ROWS), jax_msg
    else:
        rep, codec = ServingReplica(exports["v3"], PORT_ROWS, device="cpu", port=0), msg
    rep.start()
    try:
        response = rep.servicer.predict(codec.PredictRequest(request_id="bad", features=b"not tensors"))
        assert response.error and not response.retryable
        ok = rep.servicer.predict(codec.PredictRequest(
            request_id="ok", features=codec.pack_array_tree(_tokens(2, 3)),
        ))
        assert not ok.error
    finally:
        rep.close()
    if pkg == "port":
        # errors counts every failure but a load shed
        assert rep.engine.counters_snapshot()["errors"] == 1


# ---- the router, with fake clients (tests/test_serving.py's) ----------------


def _router_pkg(pkg: str):
    if pkg == "jax":
        import grpc

        from elasticdl_tpu.chaos.netem import InjectedRpcError
        from elasticdl_tpu.serving import router

        return SimpleNamespace(
            router=router, msg=jax_msg,
            down=lambda: InjectedRpcError(grpc.StatusCode.UNAVAILABLE, "down"),
        )
    from elasticdl_tpu_torch.serving import router

    return SimpleNamespace(
        router=router, msg=msg, down=lambda: RpcError(StatusCode.UNAVAILABLE, "down")
    )


class _FakeClient:
    def __init__(self, codec, outcome, swap=None):
        self.codec, self.outcome, self.swap = codec, outcome, swap
        self.calls = 0
        self.swaps = []

    def predict(self, request):
        self.calls += 1
        return self.outcome(request) if callable(self.outcome) else self.outcome

    def serving_status(self, request=None):
        return self.codec.ServingStatusResponse(replica_id=0, model_version=1)

    def swap_model(self, request):
        self.swaps.append(request)
        if self.swap is not None:
            return self.swap()
        return self.codec.SwapModelResponse(accepted=True, model_version=5)

    def close(self):
        pass


def _inject(p, router, replica_id, client, last_seen=None):
    handle = p.router._ReplicaHandle(replica_id, f"fake:{replica_id}", client)
    if last_seen is not None:
        handle.last_seen = last_seen
    router._replicas[replica_id] = handle
    return handle


def _routes_around_a_dead_replica(p):
    router = p.router.ServingRouter()
    ok = p.msg.PredictResponse(model_version=1, rows=1)

    def dead(_request):
        raise p.down()

    a, b = _FakeClient(p.msg, dead), _FakeClient(p.msg, ok)
    _inject(p, router, 0, a)
    _inject(p, router, 1, b)
    router._replicas[1].outstanding = 1  # the dead one is tried first
    response = router.predict(p.msg.PredictRequest(request_id="r"))
    return (response.error, a.calls, b.calls, router._replicas[0].outstanding,
            router._replicas[1].outstanding)


def _raises_on_a_non_retryable_error(p):
    router = p.router.ServingRouter()

    def boom(_request):
        raise ValueError("bug, not outage")

    _inject(p, router, 0, _FakeClient(p.msg, boom))
    try:
        router.predict(p.msg.PredictRequest(request_id="r"))
    except ValueError as ex:
        return ("raised", str(ex))
    return ("returned",)


def _skips_an_evicted_replica(p):
    router = p.router.ServingRouter(evict_after_secs=0.5)
    stale = _FakeClient(p.msg, p.msg.PredictResponse(model_version=1, rows=1))
    _inject(p, router, 0, stale, last_seen=time.monotonic() - 10)
    response = router.predict(p.msg.PredictRequest(request_id="r"))
    return (bool(response.error), response.retryable, stale.calls, router.live_replicas())


def _tries_the_next_replica_on_overload(p):
    router = p.router.ServingRouter()
    a = _FakeClient(p.msg, p.msg.PredictResponse(error="queue full", retryable=True))
    b = _FakeClient(p.msg, p.msg.PredictResponse(model_version=1, rows=1))
    _inject(p, router, 0, a)
    _inject(p, router, 1, b)
    router._replicas[1].outstanding = 1
    response = router.predict(p.msg.PredictRequest(request_id="r"))
    return (response.error, a.calls, b.calls)


def _merges_the_swap_fan_out(p):
    router = p.router.ServingRouter()
    a, b = _FakeClient(p.msg, None), _FakeClient(p.msg, None)
    _inject(p, router, 0, a)
    _inject(p, router, 1, b)
    response = router.swap_model(p.msg.SwapModelRequest(model_dir="/m"))
    return (response.accepted, response.model_version, len(a.swaps), len(b.swaps),
            response.replicas)


def _absorbs_a_redelivery_not_an_unreachable_replica(p):
    router = p.router.ServingRouter()

    def stale():
        return p.msg.SwapModelResponse(
            accepted=False, model_version=5, reason="stale swap: version 5 <= served 5",
            stale=True,
        )

    def down():
        raise p.down()

    _inject(p, router, 0, _FakeClient(p.msg, None, stale))
    _inject(p, router, 1, _FakeClient(p.msg, None, stale))
    replay = router.swap_model(p.msg.SwapModelRequest(model_dir="/m"))
    _inject(p, router, 2, _FakeClient(p.msg, None, down))
    missed = router.swap_model(p.msg.SwapModelRequest(model_dir="/m"))
    return (replay.accepted, [o["absorbed"] for o in replay.replicas], missed.accepted,
            "unreachable" in missed.reason, router.fleet_snapshot()["replicas"][2]["swap_unreachable"])


def _refreshes_and_forgets_on_probe(p):
    router = p.router.ServingRouter(evict_after_secs=0.5, forget_after_secs=1.0)
    handle = _inject(p, router, 0, _FakeClient(p.msg, None), last_seen=time.monotonic() - 0.9)

    class _DeadStatus:
        def serving_status(self, request=None):
            raise p.down()

        def close(self):
            pass

    _inject(p, router, 1, _DeadStatus(), last_seen=time.monotonic() - 5.0)
    router.probe_once()
    return (router.live_replicas(), handle.last_status is not None, sorted(router._replicas))


ROUTER_SCENARIOS = {
    "routes_around_a_dead_replica": (_routes_around_a_dead_replica, ("", 1, 1, 0, 1)),
    "raises_on_a_non_retryable_error": (
        _raises_on_a_non_retryable_error, ("raised", "bug, not outage")
    ),
    "skips_an_evicted_replica": (_skips_an_evicted_replica, (True, True, 0, [])),
    "tries_the_next_replica_on_overload": (_tries_the_next_replica_on_overload, ("", 1, 1)),
    "merges_the_swap_fan_out": (_merges_the_swap_fan_out, (True, 5, 1, 1, [
        {"replica_id": 0, "accepted": True, "absorbed": False, "reason": ""},
        {"replica_id": 1, "accepted": True, "absorbed": False, "reason": ""},
    ])),
    "absorbs_a_redelivery_not_an_unreachable_replica": (
        _absorbs_a_redelivery_not_an_unreachable_replica, (True, [True, True], False, True, True)
    ),
    "refreshes_and_forgets_on_probe": (_refreshes_and_forgets_on_probe, ([0], True, [0])),
}


@pytest.mark.parametrize("scenario", sorted(ROUTER_SCENARIOS))
def test_router_scenario_matches_the_jax_router(scenario):
    run, expected = ROUTER_SCENARIOS[scenario]
    assert run(_router_pkg("jax")) == expected
    assert run(_router_pkg("port")) == expected


def test_router_over_the_socket_merges_live_status(replica):
    router = ServingRouter(deadlines=DeadlinePolicy.from_secs(30))
    try:
        router.add_replica(f"localhost:{replica.port}")
        router.probe_once()
        response = router.predict(msg.PredictRequest(
            request_id="r", features=msg.pack_array_tree(_tokens(3, seed=4)),
        ))
        assert not response.error
        assert msg.unpack_array_tree(response.outputs).shape == (3, SEQ, LM_KW["vocab_size"])
        status = router.serving_status(msg.ServingStatusRequest(detail=True))
        assert status.model_version == 3 and status.requests == 1 and len(status.replicas) == 1
        snap = router.fleet_snapshot()
        assert snap["live"] == [0] and snap["counters"]["requests"] == 1
        assert snap["phases"]["total"]["count"] == 1
    finally:
        router.close()


# ---- serving.main, end to end on the CPU ------------------------------------


def _frontend(model_dir: str, addr_file: str, *extra) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.main", "--model_dir", model_dir,
         "--num_replicas", "2", "--device", "cpu", "--addr_file", addr_file,
         "--minibatch_size", "8", *extra],
        cwd=REPO, env=env,
    )


# ---- the netem seams on the serving RPCs (tests/test_serving.py:799, :838) --


def test_serving_predict_survives_injected_unavailable(replica):
    """A client-side injected UNAVAILABLE rides the retry loop of the
    control plane: ``predict`` is retry-safe."""
    from elasticdl_tpu_torch.chaos.netem import NetemShim
    from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind
    from elasticdl_tpu_torch.rpc.retry import RetryPolicy

    shim = NetemShim(
        [Fault(kind=FaultKind.NET_UNAVAILABLE, fault_id="u", method="predict", count=1)],
        plan_seed=1,
    )
    rpc_service.set_client_fault_shim(shim)
    try:
        client = ServingClient(
            f"localhost:{replica.port}", retry=RetryPolicy(max_attempts=5),
            deadlines=DeadlinePolicy.from_secs(10),
        )
        response = client.predict(
            msg.PredictRequest(request_id="r", features=msg.pack_array_tree(_tokens(2, seed=3)))
        )
        assert not response.error  # the injected failure was retried
        assert shim.armed_count == 0  # and it fired
    finally:
        rpc_service.set_client_fault_shim(None)


def test_serving_predict_duplicate_delivery_harmless(replica):
    """Server-side duplicate delivery runs ``predict`` twice; it reads
    only, so the caller gets one right answer."""
    from elasticdl_tpu_torch.chaos.netem import NetemShim
    from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind

    shim = NetemShim(
        [Fault(kind=FaultKind.NET_DUPLICATE, fault_id="d", method="predict", count=1)],
        plan_seed=1,
    )
    rpc_service.set_server_fault_shim(shim)
    try:
        client = ServingClient(f"localhost:{replica.port}", deadlines=DeadlinePolicy.from_secs(10))
        feats = _tokens(4, seed=9)
        response = client.predict(
            msg.PredictRequest(request_id="dup", features=msg.pack_array_tree(feats))
        )
        assert not response.error
        out = msg.unpack_array_tree(response.outputs)
        assert out.shape == (4, SEQ, LM_KW["vocab_size"]) and shim.armed_count == 0
        assert replica.engine.counters_snapshot()["requests"] == 2  # ran twice
    finally:
        rpc_service.set_server_fault_shim(None)


def _wait_for(path: str, proc, secs: float = 60.0) -> str:
    deadline = time.monotonic() + secs
    while not os.path.exists(path):
        assert proc.poll() is None, f"the frontend exited {proc.returncode}"
        assert time.monotonic() < deadline, "the frontend is not up"
        time.sleep(0.05)
    with open(path) as f:
        return f.read().strip()


def test_serving_main_swaps_by_rpc_under_load_on_the_cpu(tmp_path):
    """The frontend with two CPU replicas: predict through it, a
    ``swap_model`` by RPC while a client keeps sending (no failure, every
    request sent after the acknowledgement served by the new version),
    and after SIGTERM no replica left."""
    v3 = _iris_export(str(tmp_path / "v3"), 3, seed=1)
    v5 = _iris_export(str(tmp_path / "v5"), 5, seed=2)
    addr_file = str(tmp_path / "addr")
    proc = _frontend(v3, addr_file)
    kids = []
    try:
        client = ServingClient(_wait_for(addr_file, proc), deadlines=DeadlinePolicy.from_secs(30))
        kids = chip_smoke._serving_children(proc.pid)
        feats = {"features": np.random.RandomState(0).rand(5, 4).astype(np.float32)}
        first = client.predict(msg.PredictRequest(request_id="a", features=msg.pack_array_tree(feats)))
        assert not first.error and first.model_version == 3
        outcomes, stop = [], threading.Event()

        def keep_sending():
            while not stop.is_set():
                sent = time.monotonic()
                response = client.predict(msg.PredictRequest(
                    request_id="l", features=msg.pack_array_tree(feats),
                ))
                outcomes.append((sent, response.model_version, response.error))

        sender = threading.Thread(target=keep_sending)
        sender.start()
        time.sleep(0.3)
        swap = client.swap_model(msg.SwapModelRequest(model_dir=v5))
        acked = time.monotonic()
        time.sleep(0.3)
        stop.set()
        sender.join()
        assert swap.accepted and [o["accepted"] for o in swap.replicas] == [True, True]
        assert outcomes and not [o for o in outcomes if o[2]]
        assert {o[1] for o in outcomes if o[0] > acked} == {5}
        status = client.serving_status(msg.ServingStatusRequest(detail=True))
        assert [r["model_version"] for r in status.replicas] == [5, 5]
        # one input shape on each replica that served
        assert status.compile_count == sum(1 for r in status.replicas if r["requests"])
        assert len(kids) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 0
        assert chip_smoke._gone_within(kids, 10.0)
    finally:
        # the replicas through their handles: the frontend reaped them,
        # and a freed pid may be another process's by now
        for held in kids:
            held.signal(signal.SIGKILL)
        proc.kill()
        proc.wait()


# --telemetry_dir acts since slice 10b-1 (tests/test_torch_trace.py)
@pytest.mark.parametrize("flag, value", [
    ("metrics_port", "0"), ("metrics_addr_file", "/tmp/m"),
    ("slo_config", "default"),
])
def test_telemetry_flags_raise_naming_slice_10(flag, value):
    with pytest.raises(NotImplementedError, match=f"--{flag}=.*slice 10b"):
        serving_main.main(["--model_dir", "/nowhere", f"--{flag}", value])


def test_replica_argv_is_the_jax_frontends_with_the_device():
    """The JAX package's replica command line (byte-identical with or
    without observability flags), with the port's module and
    ``--device`` at the end."""
    from elasticdl_tpu.serving import main as jax_main

    base = ["--model_dir", "/m", "--num_replicas", "2", "--watch_model"]
    observed = base + ["--slo_config", "default", "--telemetry_dir", "/t", "--metrics_port", "0"]
    plain_args = serving_main.build_parser().parse_args(base)
    port_argv = serving_main._replica_argv(plain_args, 1, "/w")
    assert port_argv == serving_main._replica_argv(
        serving_main.build_parser().parse_args(observed), 1, "/w"
    )
    jax_argv = jax_main._replica_argv(jax_main.build_parser().parse_args(observed), 1, "/w")
    want = [
        "elasticdl_tpu_torch.serving.main" if a == "elasticdl_tpu.serving.main" else a
        for a in jax_argv
    ] + ["--device", "cuda"]
    assert port_argv == want
    cpu = serving_main.build_parser().parse_args(base + ["--device", "cpu"])
    assert serving_main._replica_argv(cpu, 1, "/w")[-2:] == ["--device", "cpu"]


# ---- predict --serving_addr ---------------------------------------------------

PREDICT_ZOO = '''import os

import numpy as np

from {package}.models.odps_iris_dnn_model import *  # noqa: F401,F403


class PredictionOutputsProcessor:
    def __init__(self):
        self.batches = 0

    def process(self, predictions, worker_id):
        np.save(os.path.join(os.environ["SERVING_RPC_PREDICTIONS"],
                             f"{{self.batches:06d}}.npy"), np.asarray(predictions))
        self.batches += 1
'''


def test_predict_serving_addr_on_iris_equals_the_jax_predict_cli(tmp_path, monkeypatch):
    from elasticdl_tpu import api as jax_api
    from elasticdl_tpu.data.recordio_gen import synthetic
    from elasticdl_tpu.utils.args import parse_master_args as jax_parse
    from elasticdl_tpu_torch import client

    export = _iris_export(str(tmp_path / "export"), 3, seed=7)
    data = synthetic.gen_iris(str(tmp_path / "iris"), num_records=24, num_shards=1, seed=3)
    outputs, results = {}, {}
    jax_rep = JaxReplica(export, JAX_ROWS, port=0).start()
    port_rep = ServingReplica(export, JAX_ROWS, device="cpu", port=0).start()
    try:
        for pkg, package, port in (
            ("jax", "elasticdl_tpu", jax_rep.port),
            ("port", "elasticdl_tpu_torch", port_rep.port),
        ):
            zoo = tmp_path / f"zoo_{pkg}"
            zoo.mkdir()
            (zoo / "iris_predict.py").write_text(PREDICT_ZOO.format(package=package))
            out = tmp_path / f"out_{pkg}"
            out.mkdir()
            monkeypatch.setenv("SERVING_RPC_PREDICTIONS", str(out))
            argv = [
                "--model_zoo", str(zoo), "--model_def", "iris_predict.custom_model",
                "--prediction_data", data, "--minibatch_size", "8",
                "--records_per_task", "24", "--serving_addr", f"localhost:{port}",
            ]
            if pkg == "jax":
                results[pkg] = jax_api.predict(jax_parse(argv))
            else:
                # the port's CLI: its predict command's backend returns
                # the same result dict
                from elasticdl_tpu_torch import api as port_api
                from elasticdl_tpu_torch.utils.args import parse_master_args

                assert client.main(["predict", *argv]) == 0
                shutil.rmtree(out)
                out.mkdir()
                results[pkg] = port_api.predict(parse_master_args(argv))
            outputs[pkg] = np.concatenate(
                [np.load(out / name) for name in sorted(os.listdir(out))]
            )
    finally:
        jax_rep.close()
        port_rep.close()
    strip = {k: v for k, v in results["port"].items() if k != "serving_addr"}
    assert strip == {k: v for k, v in results["jax"].items() if k != "serving_addr"}
    assert strip == {"requests": 3, "rows": 24, "failures": 0, "model_version": 3}
    assert outputs["port"].shape == (24, 3)
    np.testing.assert_allclose(outputs["port"], outputs["jax"], atol=1e-5, rtol=1e-5)


# ---- the shared pieces, against the JAX package's ----------------------------


def test_pack_array_tree_bytes_are_the_jax_packages():
    trees = [
        {"x": np.arange(12, dtype=np.float32).reshape(3, 4), "ids": np.arange(3, dtype=np.int64)},
        np.arange(6, dtype=np.int32).reshape(2, 3),
        np.linspace(-2, 2, 8, dtype=np.float32).astype(ml_dtypes.bfloat16).reshape(2, 4),
    ]
    for tree in trees:
        packed = msg.pack_array_tree(tree)
        assert packed == jax_msg.pack_array_tree(tree)
        for got in (msg.unpack_array_tree(packed), jax_msg.unpack_array_tree(packed)):
            if isinstance(tree, dict):
                assert set(got) == set(tree)
                for k in tree:
                    assert got[k].dtype == tree[k].dtype
                    np.testing.assert_array_equal(got[k], tree[k])
            else:
                assert got.dtype == tree.dtype
                np.testing.assert_array_equal(got, tree)
    # a bf16 tree keeps its type through a whole message
    response = msg.decode(msg.encode(msg.PredictResponse(outputs=msg.pack_array_tree(trees[2]))))
    assert msg.unpack_array_tree(response.outputs).dtype == ml_dtypes.bfloat16


def test_serving_latency_buckets_are_the_jax_packages():
    from elasticdl_tpu.telemetry.registry import SERVING_LATENCY_BUCKETS as jax_buckets
    from elasticdl_tpu_torch.telemetry.registry import SERVING_LATENCY_BUCKETS

    assert SERVING_LATENCY_BUCKETS == jax_buckets


def test_max_merge_phase_stats_is_the_jax_packages():
    from elasticdl_tpu.utils.merge import max_merge_phase_stats as jax_merge
    from elasticdl_tpu_torch.utils.merge import max_merge_phase_stats

    rng = np.random.RandomState(3)
    beats = []
    for _ in range(30):
        beats.append({
            phase: {"ms": float(rng.rand() * 100), "count": int(rng.randint(0, 50)),
                    "buckets": {str(b): int(rng.randint(0, 9)) for b in (0.001, 0.01, 0.1)}}
            for phase in ("total", "queue_wait")
        })
    beats.append({"bad": "not a dict", "total": {"ms": "x"}})
    merged, totals, jax_merged, jax_totals = {}, {}, {}, {}
    for beat in beats:
        max_merge_phase_stats(merged, beat, totals=totals)
        jax_merge(jax_merged, beat, totals=jax_totals)
    assert merged == jax_merged and totals == jax_totals


# ---- chip_smoke.py's phase 16, rehearsed ------------------------------------


def test_smoke_phase16_serving_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """Phase 16 at a small size on the CPU: 16a with the message cap
    lowered between one row's logits and two rows' (the launch gate reads
    0: the plain path), then 16b with a short mnist training, the real
    frontend, the predict CLI, the watcher and SIGTERM (sequential here:
    the lowered cap would refuse 16b's requests in this process)."""
    monkeypatch.setattr(chip_smoke, "GPT2S", dict(LM_KW, dtype="bfloat16"))
    monkeypatch.setattr(chip_smoke, "SEQ", SEQ)
    row_bytes = SEQ * LM_KW["vocab_size"] * 2
    with monkeypatch.context() as capped:
        capped.setattr(rpc_service, "MAX_MESSAGE_BYTES", int(row_bytes * 1.5))
        lm = chip_smoke.serve_rpc_lm(str(tmp_path / "lm"), device="cpu")
    assert lm["flash_fwd_launches"] == 0 and lm["dispatches"] >= chip_smoke.SERVE_RPC_WARM
    assert lm["cap"]["code"] == "RESOURCE_EXHAUSTED" and lm["failures"] == []
    # the replicas' processes predict with the threads this process has
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch.get_num_threads()))
    cfg = dict(
        chip_smoke.SERVE_MNIST, train_records=512, eval_records=256, shards=2,
        records_per_task=256, batch=64, checkpoint_steps=4,
    )
    cli = chip_smoke.serve_cli_mnist(str(tmp_path / "cli"), device="cpu", cfg=cfg)
    assert cli["predicted_rows"] == 256 and cli["max_abs_err_to_local"] == 0.0
    assert cli["watch"]["failures"] == 0 and cli["exit"]["gone"]
