"""The port's serving path (``elasticdl_tpu_torch.serving``) against the
JAX package's, on one export.

The JAX package's ``export_model`` writes the export of a small causal
LM; the JAX ``ServingEngine`` (8 canonical rows, one per device of the
test conftest's 8-device CPU mesh) and the port's ``ServingReplica``
(4 canonical rows, ``device="cpu"``) both serve the same mixed-size
requests, and every delivered row must agree (f32, 1e-4).  The
micro-batcher cases of ``tests/test_serving.py`` run against the port's
copy of the batcher.
"""

from __future__ import annotations

import argparse
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import ml_dtypes
import numpy as np
import optax
import pytest

from elasticdl_tpu.serving.batcher import MicroBatcher as JaxMicroBatcher
from elasticdl_tpu.serving.engine import ServingEngine as JaxServingEngine
from elasticdl_tpu.trainer.state import TrainState, init_model
from elasticdl_tpu.utils.export_utils import export_model as jax_export_model
from elasticdl_tpu.utils.model_utils import get_model_spec as jax_get_model_spec
from elasticdl_tpu_torch.ops import attention as port_attn
from elasticdl_tpu_torch.serving.batcher import (
    MicroBatcher,
    ServingError,
    ServingOverloadError,
    ShapeMismatchError,
    Ticket,
    tree_rows,
)
from elasticdl_tpu_torch.serving.replica import PredictRequest, ServingReplica
from elasticdl_tpu_torch.telemetry.anatomy import (
    PHASE_UNTRACKED,
    SERVING_REQUEST_PHASES,
)
from elasticdl_tpu_torch.trainer.stacking import canonical_batch_rows

TOL = 1e-4
BF16_TOL = 6e-2  # as tests/test_torch_transformer.py: a few bf16 roundings
ROWS = 8  # the batcher tests' canonical shape, as in tests/test_serving.py
SEQ = 32
LM_DEF = "long_seq_transformer.long_seq_transformer.custom_model"
LM_KW = dict(vocab_size=61, embed_dim=32, num_heads=2, num_layers=2)
REQUEST_ROWS = (1, 2, 3, 5)


def _feats(n: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"features": rng.rand(n, 4).astype(np.float32)}


def _tokens(n: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "tokens": rng.randint(0, LM_KW["vocab_size"], (n, SEQ)).astype(np.int32)
    }


def _jax_export(out: str, model_params: dict) -> str:
    """A JAX-written export of the LM, with numpy-seeded weights."""
    spec = jax_get_model_spec("", LM_DEF, model_params=model_params)
    model = spec.build_model()
    params, model_state = init_model(model, _tokens(1, seed=0))
    rng = np.random.RandomState(11)
    params = jax.tree_util.tree_map(
        lambda x: (0.3 * rng.randn(*x.shape)).astype(np.float32), params
    )
    state = TrainState.create(model.apply, params, optax.identity(), model_state)
    state = state.replace(step=np.int32(7))
    args = argparse.Namespace(
        model_zoo="", model_def=LM_DEF, model_params_dict=model_params
    )
    return jax_export_model(out, state, spec, args)


@pytest.fixture(scope="module")
def lm_export(tmp_path_factory):
    return _jax_export(str(tmp_path_factory.mktemp("lm_export")), LM_KW)


def _serve_jax(export_dir, requests):
    """Each request through the JAX engine, synchronously (the dispatch
    loop's body, as tests/test_serving.py drives it)."""
    engine = JaxServingEngine(export_dir, ROWS)
    batcher = JaxMicroBatcher(ROWS, max_wait_secs=0.0)
    tickets = [batcher.submit(f"r{i}", f) for i, f in enumerate(requests)]
    while not all(t.done for t in tickets):
        engine.run_group(batcher.next_group(0.1))
    return [np.asarray(t.result(1.0)) for t in tickets]


def test_port_replica_serves_a_jax_export_like_the_jax_engine(lm_export):
    requests = [_tokens(n, seed=20 + i) for i, n in enumerate(REQUEST_ROWS)]
    want = _serve_jax(lm_export, requests)
    port_attn.reset_launch_counts()
    with ServingReplica(
        lm_export, canonical_rows=4, max_wait_secs=0.01, device="cpu"
    ) as replica:
        with ThreadPoolExecutor(len(requests)) as pool:
            responses = list(pool.map(
                replica.predict,
                [PredictRequest(f"r{i}", f, tree_rows(f))
                 for i, f in enumerate(requests)],
            ))
        engine = replica.engine
    for n, response, expected in zip(REQUEST_ROWS, responses, want):
        assert not response.error, response.error
        assert response.rows == n and response.model_version == 7
        assert response.outputs.shape == (n, SEQ, LM_KW["vocab_size"])
        np.testing.assert_allclose(response.outputs, expected, atol=TOL, rtol=TOL)
    # 11 rows in groups of at most 4: at least 3 dispatches
    assert engine.dispatches >= 3 and engine.rows_served == sum(REQUEST_ROWS)
    assert port_attn.launch_counts["flash_fwd"] == 0  # CPU: the plain path


def test_port_serves_bf16_logits_in_the_jax_engines_dtype(tmp_path):
    """A bf16 LM's logits come back as bf16 numpy arrays
    (``ml_dtypes.bfloat16``), as the JAX engine returns them, not widened."""
    export = _jax_export(str(tmp_path), dict(LM_KW, dtype="bfloat16"))
    feats = _tokens(3, seed=30)
    (want,) = _serve_jax(export, [feats])
    with ServingReplica(export, canonical_rows=4, device="cpu") as replica:
        response = replica.predict(PredictRequest("a", feats, 3))
    assert not response.error, response.error
    assert response.outputs.dtype == want.dtype == ml_dtypes.bfloat16
    got, want = (np.asarray(x, np.float32) for x in (response.outputs, want))
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_port_phases_are_sum_exact(lm_export):
    with ServingReplica(lm_export, canonical_rows=4, device="cpu") as replica:
        response = replica.predict(PredictRequest("a", _tokens(6, seed=3), 6))
    assert not response.error, response.error
    phases = dict(response.phases)
    total = phases.pop("total_ms")
    assert set(phases) == set(SERVING_REQUEST_PHASES) | {PHASE_UNTRACKED}
    assert all(v >= 0.0 for v in phases.values())
    assert sum(phases.values()) == pytest.approx(total, rel=1e-6, abs=1e-6)
    assert phases["device_compute"] > 0.0


def test_port_replica_answers_bad_requests_without_dying(lm_export):
    with ServingReplica(lm_export, canonical_rows=4, device="cpu") as replica:
        assert not replica.predict(PredictRequest("ok", _tokens(2, 1), 2)).error
        wrong_len = {"tokens": np.zeros((2, SEQ + 1), np.int32)}
        assert "row shape" in replica.predict(
            PredictRequest("len", wrong_len, 2)
        ).error
        bad_ids = _tokens(2, 2)
        bad_ids["tokens"][0, 0] = LM_KW["vocab_size"]
        assert "token ids" in replica.predict(
            PredictRequest("ids", bad_ids, 2)
        ).error
        again = replica.predict(PredictRequest("after", _tokens(3, 4), 3))
        assert not again.error and again.outputs.shape[0] == 3


def test_port_engine_predict_rows_matches_the_served_rows(lm_export):
    with ServingReplica(lm_export, canonical_rows=4, device="cpu") as replica:
        feats = _tokens(3, seed=9)
        served = replica.predict(PredictRequest("a", feats, 3)).outputs
        direct = replica.engine.predict_rows(feats)
    np.testing.assert_array_equal(served, direct)


def test_canonical_batch_rows_rounds_up_to_the_divisor():
    assert canonical_batch_rows(5, 4) == 8
    assert canonical_batch_rows(8, 4) == 8
    assert canonical_batch_rows(1, 8) == 8
    assert canonical_batch_rows(3, 0) == 3


# ---- the micro-batcher (the port's copy), after tests/test_serving.py -------


def test_tree_rows_validates():
    assert tree_rows(np.zeros((5, 2))) == 5
    assert tree_rows({"a": np.zeros((3, 1)), "b": np.zeros(3)}) == 3
    with pytest.raises(ShapeMismatchError):
        tree_rows({"a": np.zeros((3, 1)), "b": np.zeros(4)})
    with pytest.raises(ShapeMismatchError):
        tree_rows({})


def test_batcher_coalesces_small_requests():
    batcher = MicroBatcher(ROWS, max_wait_secs=10.0)
    t1 = batcher.submit("a", _feats(3))
    t2 = batcher.submit("b", _feats(5))
    group = batcher.next_group(0.1)
    assert group.n_real == ROWS  # full: dispatched without waiting
    assert [(t.request_id, lo, hi) for t, lo, hi in group.segments] == [
        ("a", 0, 3),
        ("b", 0, 5),
    ]
    assert t1.rows == 3 and t2.rows == 5


def test_batcher_splits_large_request_across_groups():
    batcher = MicroBatcher(ROWS, max_wait_secs=0.0)
    ticket = batcher.submit("big", _feats(ROWS * 2 + 3))
    sizes = []
    for _ in range(3):
        group = batcher.next_group(0.1)
        sizes.append(group.n_real)
        assert group.segments[0][0] is ticket
    assert sizes == [ROWS, ROWS, 3]
    assert batcher.queue_rows() == 0


def test_batcher_max_wait_flushes_partial():
    batcher = MicroBatcher(ROWS, max_wait_secs=0.01)
    batcher.submit("a", _feats(2))
    t0 = time.monotonic()
    group = batcher.next_group(1.0)
    waited = time.monotonic() - t0
    assert group.n_real == 2
    assert waited < 0.5  # flushed by max-wait, not the poll timeout


def test_batcher_zero_wait_dispatches_immediately():
    batcher = MicroBatcher(ROWS, max_wait_secs=0.0)
    batcher.submit("a", _feats(1))
    group = batcher.next_group(0.1)
    assert group.n_real == 1


def test_batcher_overload_rejects_with_retryable_error():
    batcher = MicroBatcher(ROWS, max_wait_secs=10.0, max_queue_rows=10)
    batcher.submit("a", _feats(8))
    with pytest.raises(ServingOverloadError) as exc:
        batcher.submit("b", _feats(3))
    assert exc.value.retryable
    batcher.submit("c", _feats(2))  # still fits


def test_batcher_admits_single_request_larger_than_bound():
    batcher = MicroBatcher(ROWS, max_wait_secs=0.0, max_queue_rows=10)
    big = batcher.submit("big", _feats(25))  # > bound, empty queue: in
    assert big.rows == 25
    with pytest.raises(ServingOverloadError):
        batcher.submit("late", _feats(25))  # backlog in front: shed
    drained = 0
    while drained < 25:
        group = batcher.next_group(0.1)
        drained += group.n_real
    batcher.submit("again", _feats(25))  # drained: admitted again


def test_batcher_close_fails_pending_tickets_retryably():
    batcher = MicroBatcher(ROWS, max_wait_secs=10.0)
    ticket = batcher.submit("a", _feats(2))
    batcher.close()
    with pytest.raises(ServingError) as exc:
        ticket.result(1.0)
    assert exc.value.retryable
    with pytest.raises(ServingError) as exc:
        batcher.submit("b", _feats(1))
    assert exc.value.retryable
    assert batcher.next_group(0.01) is None


def test_ticket_completion_deferred_until_finish():
    ticket = Ticket("x", np.zeros((2, 1), np.float32), 2)
    assert ticket.deliver(np.zeros((2, 3), np.float32), 2, 1) is True
    assert not ticket.done
    ticket.finish()
    assert ticket.done


def test_group_features_concatenates_in_row_order():
    batcher = MicroBatcher(ROWS, max_wait_secs=10.0)
    a, b = _feats(3, seed=1), _feats(5, seed=2)
    batcher.submit("a", a)
    batcher.submit("b", b)
    group = batcher.next_group(0.1)
    feats = group.features()
    np.testing.assert_array_equal(feats["features"][:3], a["features"])
    np.testing.assert_array_equal(feats["features"][3:], b["features"])


def test_batcher_serves_concurrent_submitters_in_full():
    """Many submitter threads, one dispatch thread: every row of every
    request is delivered exactly once, in its request's order."""
    batcher = MicroBatcher(ROWS, max_wait_secs=0.001)
    stop = threading.Event()

    def dispatch():
        while not stop.is_set():
            group = batcher.next_group(0.01)
            if group is None:
                continue
            rows = group.features()["features"]
            offset = 0
            for ticket, lo, hi in group.segments:
                n = hi - lo
                if ticket.deliver(rows[offset:offset + n], n, 1):
                    ticket.finish()
                offset += n

    thread = threading.Thread(target=dispatch)
    thread.start()
    try:
        requests = [_feats(n, seed=n) for n in (1, 9, 4, 17, 2, 8)]
        with ThreadPoolExecutor(len(requests)) as pool:
            tickets = list(pool.map(
                lambda iv: batcher.submit(f"r{iv[0]}", iv[1]),
                enumerate(requests),
            ))
        for ticket, feats in zip(tickets, requests):
            np.testing.assert_array_equal(
                ticket.result(5.0), feats["features"]
            )
    finally:
        stop.set()
        thread.join()
