"""Peer state replication in the port (``elasticdl_tpu_torch/replication/``),
on the CPU: the counterpart of ``tests/test_replication.py``.

- The rules both packages share (the ring, the store's accept and refuse
  decisions, the harvest's complete version, the merge of shards, the
  directory's peers and coverage, the no-lost-steps check) run against
  BOTH packages' modules on the same inputs (the ``pkg`` cases).
- The port's own pieces: its blob codec (bf16 included), the store's
  two-version retention, the replica service over the socket transport,
  the directory's harvest, the servicer's heartbeat plumbing and its
  restore stage (fenced by generation, released once process 0 has it),
  the replicator's cadence, and ``restore_from_replica``'s outcomes on a
  real trainer.
- A survivor's replica server answers while its training thread waits
  in a gloo all-reduce on a frozen peer, and after the peer's death
  (the collective then raises at once).
- Two-process gloo worlds of mnist through the train CLI: a SIGKILL one
  step after an accepted push re-forms the world from peer RAM at that
  push's version, with the pushed shard's CRC and a fault-free world's
  weights at that version bit for bit (one intra-op thread); a death
  inside a push restores the older complete set, or the newer disk
  checkpoint when there is one; every record is counted once.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.chaos import harness as jax_harness
from elasticdl_tpu.chaos.plan import FaultPlan as JaxFaultPlan
from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JaxDispatcher
from elasticdl_tpu.replication import blob as jax_blob
from elasticdl_tpu.replication import directory as jax_directory
from elasticdl_tpu.replication import replicator as jax_replicator
from elasticdl_tpu.replication import store as jax_store
from elasticdl_tpu.rpc import messages as jax_msg
from elasticdl_tpu_torch import client
from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
from elasticdl_tpu_torch.chaos import invariants
from elasticdl_tpu_torch.chaos.plan import Fault, FaultKind, FaultPlan, builtin_plans
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.parallel import elastic
from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer
from elasticdl_tpu_torch.replication import blob
from elasticdl_tpu_torch.replication import directory as port_directory
from elasticdl_tpu_torch.replication import replicator as port_replicator
from elasticdl_tpu_torch.replication import store as port_store
from elasticdl_tpu_torch.replication.directory import ReplicaDirectory
from elasticdl_tpu_torch.replication.replicator import (
    PeerReplicator,
    restore_from_replica,
)
from elasticdl_tpu_torch.replication.service import (
    ReplicaClient,
    ReplicaServicer,
    start_replica_server,
)
from elasticdl_tpu_torch.replication.store import ReplicaStore
from elasticdl_tpu_torch.rpc import messages as msg
from elasticdl_tpu_torch.rpc import service as rpc_service
from elasticdl_tpu_torch.rpc.service import RpcError, StatusCode
from elasticdl_tpu_torch.trainer import checkpointing
from elasticdl_tpu_torch.trainer.local_executor import build_optimizer
from elasticdl_tpu_torch.trainer.state import state_to_checkpoint
from elasticdl_tpu_torch.utils import save_utils
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.model_utils import get_model_spec
from elasticdl_tpu_torch.worker.lockstep import DUMP_STATE_ENV

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"

# the two packages' modules, for the rules they share
PKG = {
    "jax": {
        "blob": jax_blob, "store": jax_store, "directory": jax_directory,
        "replicator": jax_replicator,
    },
    "port": {
        "blob": blob, "store": port_store, "directory": port_directory,
        "replicator": port_replicator,
    },
}
PACKAGES = ["jax", "port"]


def _shard(source, version, dense=None, parts=None, generation=0, codec=blob, store=port_store):
    payload = codec.encode_snapshot(dense or {}, parts or {})
    return store.ReplicaShard(
        source=source, version=version, generation=generation,
        checksum=codec.blob_checksum(payload), payload=payload,
    )


def _pkg_shard(pkg, *args, **kw):
    return _shard(*args, codec=PKG[pkg]["blob"], store=PKG[pkg]["store"], **kw)


# ---- the rules both packages share -----------------------------------------

RING_CASES = [
    (0, 1, None), (0, 2, None), (1, 2, None), (3, 4, None),
    (0, 4, [0, 0, 1, 1]), (1, 4, [0, 0, 1, 1]), (3, 4, [0, 0, 1, 1]),
    (2, 6, [0, 0, 0, 1, 1, 2]), (5, 6, [0, 0, 0, 1, 1, 2]),
    (1, 3, [0, 0, 0]), (2, 5, [0, 1, 0, 1, 0]),
]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ring_neighbor_is_the_jax_packages(pkg):
    """The classic ring on one slice; repinned off-slice on several (the
    port passes no slice map yet, but the rule is whole)."""
    got = [PKG[pkg]["replicator"].ring_neighbor(p, n, m) for p, n, m in RING_CASES]
    assert got == [0, 1, 0, 0, 2, 2, 0, 3, 0, 2, 3]


# a sequence of (source, version, generation, torn) puts into a store of
# generation 0, and what each must answer
STORE_SEQUENCE = [
    ((1, 6, 0, False), (True, "")),
    ((1, 8, 0, True), (False, "checksum_mismatch")),
    ((1, 6, 0, False), (False, "stale_version")),
    ((1, 8, 1, False), (False, "generation_mismatch")),
    ((1, 8, 0, False), (True, "")),
    ((1, 10, 0, False), (True, "")),
    ((1, 7, 0, False), (False, "stale_version")),
    ((0, 2, 0, False), (True, "")),
]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_store_accepts_and_refuses_as_the_jax_packages(pkg):
    store = PKG[pkg]["store"].ReplicaStore(generation=0)
    answers = []
    for (source, version, generation, torn), _want in STORE_SEQUENCE:
        shard = _pkg_shard(pkg, source, version, {"w": np.full(3, version, np.float32)},
                           generation=generation)
        if torn:
            shard = PKG[pkg]["store"].ReplicaShard(
                source, version, generation, shard.checksum, shard.payload[:-1]
            )
        answers.append(store.put(shard))
    assert answers == [want for _put, want in STORE_SEQUENCE]
    assert store.versions(1) == [8, 10] and store.versions(0) == [2]
    assert store.rejected == 4
    assert sorted((h["source"], h["version"]) for h in store.holdings()) == [(0, 2), (1, 10)]


COMPLETE_CASES = [
    ({0: [6, 4], 1: [4, 6]}, 2, 6),
    ({0: [6, 4], 1: [4]}, 2, 4),
    ({0: [6]}, 2, None),
    ({0: [6], 1: [4]}, 2, None),
    ({0: [2, 4], 1: [4, 2], 2: [2]}, 3, 2),
    ({}, 1, None),
]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_complete_version_is_the_jax_packages(pkg):
    rule = PKG[pkg]["directory"].ReplicaDirectory._complete_version
    for offered, sources, want in COMPLETE_CASES:
        offers = {s: [(v, None, "a") for v in vs] for s, vs in offered.items()}
        assert rule(offers, sources) == want, offered


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_snapshots_is_the_jax_packages(pkg):
    rng = np.random.default_rng(0)
    dense = {"params/w": rng.standard_normal((2, 3)).astype(np.float32)}
    parts_a = {"params/emb": (np.arange(0, 4), rng.standard_normal((4, 2)).astype(np.float32))}
    parts_b = {"params/emb": (np.arange(4, 8), rng.standard_normal((4, 2)).astype(np.float32))}
    merged_dense, merged_parts = PKG[pkg]["blob"].merge_snapshots(
        [(dense, parts_a), ({}, parts_b)]
    )
    assert list(merged_dense) == ["params/w"]
    np.testing.assert_array_equal(merged_dense["params/w"], dense["params/w"])
    ids, rows = merged_parts["params/emb"]
    np.testing.assert_array_equal(ids, np.arange(8))
    np.testing.assert_array_equal(rows, np.concatenate([parts_a["params/emb"][1],
                                                        parts_b["params/emb"][1]]))


def _ad(process_id, version, addr="h:1", generation=0, source=None):
    return {
        "addr": addr, "process_id": process_id, "generation": generation,
        "holdings": [{"source": process_id if source is None else source,
                      "version": version, "generation": generation, "checksum": "x"}],
    }


@pytest.mark.parametrize("pkg", PACKAGES)
def test_directory_peers_and_coverage_are_the_jax_packages(pkg):
    directory = PKG[pkg]["directory"].ReplicaDirectory()
    directory.update(0, _ad(0, 2, "h:0"))
    directory.update(0, _ad(0, 4, "h:0"))
    directory.update(1, _ad(1, 4, "h:1"))
    directory.update(7, _ad(0, 9, "h:7", generation=1))
    directory.update(8, {"process_id": 3})  # no address: ignored
    assert directory.peers(0) == {"0": "h:0", "1": "h:1"}
    assert directory.peers(1) == {"0": "h:7"}
    assert directory.coverage_stats() == {
        "generations": {
            0: {"hosts_covered": [0, 1], "shard_versions": {"0": 4, "1": 4}},
            1: {"hosts_covered": [0], "shard_versions": {"0": 9}},
        },
        "pushes_by_generation": {"0": 3, "1": 1},
        "harvests": 0,
        "harvest_failures": 0,
    }
    directory.forget_worker(1)
    assert directory.peers(0) == {"0": "h:0"}


# (events of the port's log, the verdict) for the no-lost-steps check
NO_LOST_CASES = [
    ([("push", 6, 99.0), ("kill", 0, 100.0), ("restore", 6, 105.0)], "PASS"),
    ([("push", 6, 99.0), ("kill", 0, 100.0), ("restore", 4, 105.0)], "FAIL"),
    ([("push", 6, 99.0), ("kill", 0, 100.0)], "FAIL"),
    ([("kill", 0, 100.0), ("restore", 4, 105.0)], "FAIL"),
    ([("push", 6, 99.0), ("push", 8, 101.0), ("kill", 0, 100.0), ("restore", 6, 105.0)], "PASS"),
    ([("push", 6, 99.0)], None),
]


def _port_events(case):
    out = []
    for what, step, at in case:
        if what == "kill":
            out.append({"fault_id": "f", "kind": FaultKind.PREEMPT, "monotonic": at})
        else:
            out.append({"observation": f"replica_{what}", "step": step, "monotonic": at})
    return out


@pytest.mark.parametrize("case, verdict", NO_LOST_CASES)
def test_no_lost_steps_check_is_the_jax_harnesses(tmp_path, case, verdict):
    """The port's check on its event log against the JAX harness's on the
    same events in the JAX log's form."""
    port = invariants.check_replication_no_lost_steps(_port_events(case))
    kills = [{"kind": "preempt_worker", "monotonic": at} for w, _s, at in case if w == "kill"]
    jax_events = [
        {"event": f"replica_{w}", "step": s, "monotonic": at} for w, s, at in case if w != "kill"
    ]
    config = jax_harness.ChaosJobConfig(
        plan=JaxFaultPlan(name="t"), workdir=str(tmp_path), replication=True
    )
    ref = jax_harness._check_no_lost_steps(config, jax_events, kills)
    assert (port or {}).get("status") == (ref or {}).get("status") == verdict
    if port is not None:
        assert port["name"] == ref["name"] and len(port["violations"]) == len(ref["violations"])
    assert invariants.check_replication_no_lost_steps(_port_events(case), replication=False) is None


def test_no_lost_steps_check_audits_sharded_rows():
    """The sharded-table branch (``tests/test_torch_embeddings_sharded.py``
    runs it on a sharded world's real pushes)."""
    events = [
        {"observation": "replica_push", "step": 6, "monotonic": 1.0, "has_sharded": True,
         "sharded_rows": 0},
        {"kind": FaultKind.PREEMPT, "monotonic": 2.0},
        {"observation": "replica_restore", "step": 6, "monotonic": 3.0, "sharded_rows": 0},
    ]
    verdict = invariants.check_replication_no_lost_steps(events)
    assert verdict["status"] == "FAIL" and len(verdict["violations"]) == 2
    events[0]["sharded_rows"] = events[2]["sharded_rows"] = 8
    assert invariants.check_replication_no_lost_steps(events)["status"] == "PASS"


# ---- the blob codec ----------------------------------------------------------


def test_blob_round_trips_every_dtype_and_shape():
    import ml_dtypes

    rng = np.random.default_rng(1)
    dense = {
        "params/Dense_0/kernel": rng.standard_normal((3, 2)).astype(np.float32),
        "params/bf16": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
        "batch_stats/BatchNorm_0/mean": rng.standard_normal(4).astype(np.float32),
        "scalar": np.asarray(3, np.int64),
        "empty": np.zeros((0, 3), np.float16),
        "transposed": np.arange(6, dtype=np.int32).reshape(2, 3).T,
    }
    parts = {"params/emb": (np.arange(2, 5, dtype=np.int64), np.ones((3, 2), np.float32))}
    got_dense, got_parts = blob.decode_snapshot(blob.encode_snapshot(dense, parts))
    assert list(got_dense) == list(dense)
    for key, want in dense.items():
        assert got_dense[key].dtype == want.dtype and got_dense[key].shape == want.shape
        np.testing.assert_array_equal(got_dense[key], want)
    np.testing.assert_array_equal(got_parts["params/emb"][0], parts["params/emb"][0])
    np.testing.assert_array_equal(got_parts["params/emb"][1], parts["params/emb"][1])


def test_blob_truncation_is_detected_and_refused():
    payload = blob.encode_snapshot({"w": np.ones((4, 4), np.float32)}, {})
    assert blob.blob_checksum(payload[:-1]) != blob.blob_checksum(payload)
    with pytest.raises(ValueError, match="shorter"):
        blob.decode_snapshot(payload[:-1])
    with pytest.raises(ValueError, match="header accounts"):
        blob.decode_snapshot(payload + b"\0")


def test_blob_encoding_is_deterministic_and_merge_keeps_the_chiefs_bytes():
    """A stage merged from the chief's dense shard and the others' empty
    ones encodes to the chief's pushed bytes: the CRC the smoke holds
    the restored state to."""
    dense = {"params/a": np.arange(4, dtype=np.float32), "params/b": np.ones(2, np.float32)}
    pushed = blob.encode_snapshot(dense, {})
    merged = blob.merge_snapshots([blob.decode_snapshot(pushed), ({}, {})])
    assert blob.encode_snapshot(*merged) == pushed


# ---- the store -----------------------------------------------------------------


def test_store_retains_two_versions_and_serves_exact_ones():
    store = ReplicaStore(generation=0)
    for version in (2, 4, 6):
        assert store.put(_shard(0, version))[0]
    assert store.versions(0) == [4, 6] and store.get(0).version == 6
    assert store.get(0, version=4).version == 4 and store.get(0, version=2) is None
    assert store.put(_shard(0, 1)) == (False, "stale_version")
    assert store.holdings() == [
        {"source": 0, "version": 6, "generation": 0, "checksum": store.get(0).checksum}
    ]


# ---- the replica service -------------------------------------------------------


def _serve(store):
    server, port = start_replica_server(store)
    return server, f"127.0.0.1:{port}"


def _push_request(shard):
    return msg.PushReplicaRequest(
        source=shard.source, version=shard.version, generation=shard.generation,
        checksum=shard.checksum, payload=shard.payload,
    )


def test_replica_service_push_fetch_probe_round_trip():
    store = ReplicaStore(generation=0)
    server, addr = _serve(store)
    client_ = ReplicaClient(addr)
    try:
        shard = _shard(0, 4, {"w": np.ones((2, 2), np.float32)})
        assert client_.push_replica(_push_request(shard)).accepted
        probe = client_.fetch_replica(msg.FetchReplicaRequest(source=0, probe=True))
        assert probe.has and probe.version == 4 and probe.payload == b""
        assert probe.versions == [4]
        full = client_.fetch_replica(msg.FetchReplicaRequest(source=0))
        assert full.payload == shard.payload and full.checksum == shard.checksum
        assert not client_.fetch_replica(msg.FetchReplicaRequest(source=3)).has
        # a duplicate push is refused with its reason over the wire
        again = client_.push_replica(_push_request(shard))
        assert (again.accepted, again.reason) == (False, "stale_version")
    finally:
        server.stop(grace=0)


def test_replica_servicer_refuses_a_torn_push_in_process():
    servicer = ReplicaServicer(ReplicaStore(generation=0))
    shard = _shard(0, 4)
    torn = _push_request(shard)
    torn.payload = shard.payload[:-1]
    resp = servicer.push_replica(torn)
    assert (resp.accepted, resp.reason) == (False, "checksum_mismatch")
    assert servicer.store.get(0) is None


def test_a_push_over_the_message_cap_is_refused_before_it_is_sent(monkeypatch):
    """The 256 MiB cap (shrunk here) bounds one shard: the sender's client
    refuses it with RESOURCE_EXHAUSTED, and the receiver holds nothing."""
    store = ReplicaStore(generation=0)
    server, addr = _serve(store)
    try:
        monkeypatch.setattr(rpc_service, "MAX_MESSAGE_BYTES", 1024)
        shard = _shard(0, 4, {"w": np.ones(1024, np.float32)})
        with pytest.raises(RpcError) as err:
            ReplicaClient(addr).push_replica(_push_request(shard))
        assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
        assert store.get(0) is None
    finally:
        server.stop(grace=0)


# ---- the directory's harvest -------------------------------------------------


def _directory_over(store, worker_id=0, process_id=0, generation=0):
    server, addr = _serve(store)
    directory = ReplicaDirectory()
    directory.update(worker_id, {
        "addr": addr, "process_id": process_id, "generation": generation,
        "holdings": store.holdings(),
    })
    return directory, server


def test_harvest_picks_the_freshest_complete_set():
    store = ReplicaStore(generation=0)
    store.put(_shard(0, 4, {"w": np.full((2, 2), 4.0, np.float32)}))
    store.put(_shard(0, 6, {"w": np.full((2, 2), 6.0, np.float32)}))
    store.put(_shard(1, 4))
    store.put(_shard(1, 6))
    directory, server = _directory_over(store)
    try:
        stage = directory.harvest(live_worker_ids=[0], num_sources=2, generation=0, staged_for=1)
        assert (stage["version"], stage["generation"], stage["sources"]) == (6, 1, 2)
        assert stage["checksum"] == blob.blob_checksum(stage["payload"])
        dense, _parts = blob.decode_snapshot(stage["payload"])
        np.testing.assert_array_equal(dense["w"], np.full((2, 2), 6.0, np.float32))
        assert directory.harvests == 1 and directory.harvest_failures == 0
    finally:
        server.stop(grace=0)


def test_harvest_takes_the_older_complete_set_after_a_torn_push():
    """kill_during_replication's window: the survivor's own shard advanced
    to 6, the victim's 6 never landed; the older complete set (4) is
    assembled from the retained versions instead of falling to disk."""
    store = ReplicaStore(generation=0)
    store.put(_shard(0, 4, {"w": np.full((2, 2), 4.0, np.float32)}))
    store.put(_shard(0, 6, {"w": np.full((2, 2), 6.0, np.float32)}))
    store.put(_shard(1, 4))
    directory, server = _directory_over(store)
    try:
        stage = directory.harvest([0], 2, 0, 1)
        assert stage["version"] == 4
        dense, _parts = blob.decode_snapshot(stage["payload"])
        np.testing.assert_array_equal(dense["w"], np.full((2, 2), 4.0, np.float32))
    finally:
        server.stop(grace=0)


def test_harvest_with_incomplete_coverage_falls_back_to_disk():
    store = ReplicaStore(generation=0)
    store.put(_shard(0, 6))  # the victim's shard was never received
    directory, server = _directory_over(store)
    try:
        assert directory.harvest([0], 2, 0, 1) is None
        assert directory.harvest_failures == 1
    finally:
        server.stop(grace=0)


def test_harvest_ignores_dead_servers_and_stale_generations():
    store = ReplicaStore(generation=0)
    store.put(_shard(0, 6))
    store.put(_shard(1, 6))
    directory, server = _directory_over(store, worker_id=5)
    try:
        assert directory.harvest([], 2, 0, 1) is None  # worker 5 is dead
        assert directory.harvest([5], 2, 3, 4) is None  # another generation
        # an advertised server that died: its probes fail, nothing offered
        directory.update(6, {"addr": "127.0.0.1:1", "process_id": 1, "generation": 0,
                             "holdings": []})
        stage = directory.harvest([5, 6], 2, 0, 1)
        assert stage is not None and stage["version"] == 6
        assert directory.harvest_failures == 2
    finally:
        server.stop(grace=0)


def test_peers_are_string_keyed_on_the_wire():
    directory = ReplicaDirectory()
    directory.update(0, {"addr": "127.0.0.1:9", "process_id": 1, "generation": 0,
                         "holdings": []})
    peers = directory.peers(0)
    assert peers == {"1": "127.0.0.1:9"}
    assert msg.decode(msg.encode(msg.HeartbeatResponse(replica_peers=peers))).replica_peers == peers


# ---- the master servicer ---------------------------------------------------------


def _servicer(pkg="port"):
    if pkg == "jax":
        return JaxServicer(32, JaxDispatcher({"s": (0, 64)}, records_per_task=64))
    return MasterServicer(32, TaskDispatcher({"s": (0, 64)}, {}, {}, records_per_task=64))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_heartbeat_carries_the_advertisement_up_and_peers_down(pkg):
    servicer = _servicer(pkg)
    directory = PKG[pkg]["directory"].ReplicaDirectory()
    servicer.set_replica_directory(directory)
    ad = {"addr": "127.0.0.1:7", "process_id": 0, "generation": 0, "holdings": []}
    messages = jax_msg if pkg == "jax" else msg
    resp = servicer.heartbeat(messages.HeartbeatRequest(worker_id=0, step=4, replica=ad))
    assert resp.replica_peers == {"0": "127.0.0.1:7"}
    servicer.forget_worker(0)
    assert directory.peers(0) == {}


def test_a_heartbeat_without_replication_carries_no_peers():
    servicer = _servicer()
    resp = servicer.heartbeat(msg.HeartbeatRequest(worker_id=1))
    assert resp == msg.HeartbeatResponse()


def test_the_restore_stage_is_fenced_by_generation_and_released_by_the_chief():
    """The port's rule (ROADMAP queue 3): process 0 restores and
    broadcasts, so the stage leaves master RAM once process 0 has it; the
    JAX package serves every process and releases after the last."""
    servicer = _servicer()
    ask = msg.GetRestoreStateRequest
    assert not servicer.get_restore_state(ask(cluster_version=1)).has
    servicer.set_restore_stage(
        {"generation": 2, "version": 6, "checksum": "c", "payload": b"x"}
    )
    assert not servicer.get_restore_state(ask(cluster_version=1)).has
    # another process of the generation does not release it
    assert servicer.get_restore_state(ask(cluster_version=2, process_id=1)).has
    staged = servicer.get_restore_state(ask(cluster_version=2, process_id=0))
    assert (staged.has, staged.version, staged.checksum, staged.payload) == (True, 6, "c", b"x")
    assert not servicer.get_restore_state(ask(cluster_version=2, process_id=0)).has
    servicer.set_restore_stage({"generation": 3, "version": 8, "checksum": "c", "payload": b"y"})
    servicer.set_restore_stage(None)
    assert not servicer.get_restore_state(ask(cluster_version=3)).has


# ---- the replicator -------------------------------------------------------------


class _StepTrainer:
    def __init__(self, step):
        self.step = step
        self.state = None


@pytest.fixture()
def _fake_snapshot(monkeypatch):
    monkeypatch.setattr(
        elastic, "state_checkpoint_parts",
        lambda state, mesh=None, materialize_dense=True: (
            {"w": np.ones((1,), np.float32)} if materialize_dense else {}, {},
        ),
    )


def _replicator(steps=0, process_id=0):
    return PeerReplicator(
        ReplicaStore(generation=0), process_id=process_id, num_processes=2,
        generation=0, addr="127.0.0.1:0", replication_steps=steps,
    )


def test_replicator_every_boundary_cadence(_fake_snapshot):
    rep = _replicator(steps=0)
    assert rep.maybe_replicate(_StepTrainer(2))
    assert not rep.maybe_replicate(_StepTrainer(2))  # no new step
    assert rep.maybe_replicate(_StepTrainer(4))
    # the local commit happened, though no peer is known yet
    assert rep._store.get(0).version == 4
    assert (rep.pushes, rep.push_failures) == (0, 2)
    assert rep.last_push["ok"] is False and rep.last_push["version"] == 4
    assert rep.last_push["reason"] == "no_address"


def test_replicator_milestone_cadence_and_restore_alignment(_fake_snapshot):
    rep = _replicator(steps=4)
    assert not rep.maybe_replicate(_StepTrainer(3))
    assert rep.maybe_replicate(_StepTrainer(6))  # crossed 4
    assert not rep.maybe_replicate(_StepTrainer(7))
    rep.note_restored_version(6)
    assert not rep.maybe_replicate(_StepTrainer(7))
    assert rep.maybe_replicate(_StepTrainer(12))
    every = _replicator(steps=0)
    every.note_restored_version(6)
    assert not every.maybe_replicate(_StepTrainer(6))
    assert every.maybe_replicate(_StepTrainer(8))


def test_replicator_ring_push_delivers_to_the_neighbor(_fake_snapshot):
    neighbor_store = ReplicaStore(generation=0)
    server, addr = _serve(neighbor_store)
    rep = _replicator(process_id=0)
    try:
        assert rep.neighbor == 1 and not rep.knows_neighbor()
        rep.set_peers({"1": addr, "0": "127.0.0.1:0"})
        assert rep.knows_neighbor()
        rep.replicate_now(_StepTrainer(6))
        assert rep.stats() == {"pushes": 1, "push_failures": 0, "rejected": 0}
        delivered = neighbor_store.get(0)
        assert delivered is not None and delivered.version == 6
        assert delivered.checksum == rep._store.get(0).checksum
        assert set(rep.last_push) == {"version", "bytes", "snapshot_ms", "encode_ms",
                                      "send_ms", "ok", "reason"}
        # a stale copy is refused by the neighbor and counted as a failure
        rep.replicate_now(_StepTrainer(6))
        assert rep.stats()["push_failures"] == 1 and neighbor_store.rejected == 1
        assert rep.last_push["reason"] == "stale_version"
    finally:
        rep.close()
        server.stop(grace=0)


def test_replicator_advertisement_shape(_fake_snapshot):
    rep = _replicator(process_id=1)
    rep.replicate_now(_StepTrainer(2))
    ad = rep.advertisement()
    assert {k: ad[k] for k in ("addr", "process_id", "slice_id", "generation")} == {
        "addr": "127.0.0.1:0", "process_id": 1, "slice_id": 0, "generation": 0,
    }
    assert [h["version"] for h in ad["holdings"]] == [2]
    # a non-chief's share is empty until sharded tables come
    assert blob.decode_snapshot(rep._store.get(1).payload) == ({}, {})


# ---- state_checkpoint_parts and the hot restore on a real trainer ---------------


def _mnist_trainer(seed=0):
    spec = get_model_spec("", MNIST_DEF)
    torch.manual_seed(seed)
    model = spec.build_model()
    trainer = SPMDTrainer(
        model, spec.loss, build_optimizer(spec), device="cpu",
        device_parse=spec.device_parse,
    )
    return trainer


def test_state_checkpoint_parts_is_the_checkpoint_layout():
    """The chief's dense share is the checkpoint's name-keyed layout, the
    JAX package's names included; no parts until sharded tables come."""
    from elasticdl_tpu.models import mnist_functional_api as jax_mnist
    from elasticdl_tpu.trainer.state import init_model
    from elasticdl_tpu.utils import tree_utils

    trainer = _mnist_trainer()
    dense, parts = elastic.state_checkpoint_parts(trainer.state, None)
    want = state_to_checkpoint(trainer.state)
    assert parts == {} and list(dense) == list(want)
    for key in want:
        np.testing.assert_array_equal(dense[key], want[key])
    params, stats = init_model(
        jax_mnist.custom_model(), {"image": np.zeros((1, 28, 28), np.float32)}, rng_seed=0
    )
    jax_names = {f"params/{k}" for k in tree_utils.tree_to_dict(params)}
    jax_names |= set(tree_utils.tree_to_dict(stats))
    assert set(dense) == jax_names
    assert elastic.state_checkpoint_parts(trainer.state, None, materialize_dense=False) == ({}, {})


class _StageMaster:
    """In-process master stub serving one staged restore payload."""

    def __init__(self, stage):
        self._stage = stage

    def get_restore_state(self, request):
        stage = self._stage
        if stage is None or stage["generation"] != request.cluster_version:
            return msg.RestoreStateResponse()
        return msg.RestoreStateResponse(
            has=True, version=stage["version"], checksum=stage["checksum"],
            payload=stage["payload"],
        )


def _stage_of(trainer, version, generation=1):
    payload = blob.encode_snapshot(*elastic.state_checkpoint_parts(trainer.state))
    return {"generation": generation, "version": version,
            "checksum": blob.blob_checksum(payload), "payload": payload}


def test_restore_from_replica_lands_at_the_replicated_step(tmp_path, monkeypatch):
    source = _mnist_trainer(seed=1)
    stage = _stage_of(source, 6)
    target = _mnist_trainer(seed=2)
    events = tmp_path / "events.jsonl"
    plan = tmp_path / "plan.json"
    FaultPlan(name="none").save(str(plan))
    monkeypatch.setenv(chaos_hooks.PLAN_ENV, str(plan))
    monkeypatch.setenv(chaos_hooks.EVENTS_ENV, str(events))
    chaos_hooks.install_from_env(0, 1, 4)
    try:
        assert restore_from_replica(target, _StageMaster(stage), cluster_version=1) == 6
    finally:
        monkeypatch.setattr(chaos_hooks, "_active", None)
    assert target.step == 6
    want = state_to_checkpoint(source.state)
    got = state_to_checkpoint(target.state)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    (restore,) = invariants.read_event_log(str(events))
    assert restore["observation"] == "replica_restore" and restore["step"] == 6
    assert restore["restored_checksum"] == restore["checksum"] == stage["checksum"]


def test_a_replica_restore_and_a_disk_restore_hold_the_same_bits(tmp_path):
    """One format through one function: a checkpoint of a state and a
    replica stage of it restore to the same bits."""
    source = _mnist_trainer(seed=1)
    save_utils.CheckpointSaver(str(tmp_path / "ckpt")).save(
        6, state_to_checkpoint(source.state), extra={"model_version": 6}
    )
    from_disk, from_replica = _mnist_trainer(seed=2), _mnist_trainer(seed=3)

    class _Args:
        checkpoint_dir = str(tmp_path / "ckpt")
        checkpoint_dir_for_init = ""

    assert checkpointing.restore_trainer_state(from_disk, _Args) == 6
    assert restore_from_replica(from_replica, _StageMaster(_stage_of(source, 6)), 1) == 6
    a, b = state_to_checkpoint(from_disk.state), state_to_checkpoint(from_replica.state)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_restore_from_replica_declines_a_stage_older_than_disk():
    trainer = _mnist_trainer()
    master = _StageMaster(_stage_of(trainer, 4))
    assert restore_from_replica(trainer, master, 1, min_version=8) is None
    assert restore_from_replica(trainer, master, 1, min_version=4) == 4


def test_restore_from_replica_falls_through_without_a_usable_stage():
    trainer = _mnist_trainer()
    assert restore_from_replica(trainer, _StageMaster(None), cluster_version=1) is None
    stage = _stage_of(trainer, 6, generation=2)
    assert restore_from_replica(trainer, _StageMaster(stage), cluster_version=1) is None
    torn = dict(stage, generation=1, payload=stage["payload"][:-1])
    assert restore_from_replica(trainer, _StageMaster(torn), cluster_version=1) is None

    class _Gone:
        def get_restore_state(self, request):
            raise RpcError(StatusCode.UNAVAILABLE, "down")

    assert restore_from_replica(trainer, _Gone(), cluster_version=1) is None
    assert trainer.step == 0


def test_a_push_refused_by_the_cap_ends_in_a_disk_restore(tmp_path, monkeypatch):
    """A shard over the message cap (shrunk here; the gpt2s LM's ~500 MB
    of f32 weights are over the real 256 MiB): the chief's push fails and
    is counted, so its share lives in its own RAM only; when the chief
    dies the harvest finds no complete set, and the re-formed world
    restores from disk."""
    trainer = _mnist_trainer(seed=1)
    trainer.state.step = 8
    stores = [ReplicaStore(generation=0), ReplicaStore(generation=0)]
    served = [_serve(s) for s in stores]
    reps = [
        PeerReplicator(stores[p], p, 2, generation=0, addr=served[p][1]) for p in (0, 1)
    ]
    try:
        monkeypatch.setattr(rpc_service, "MAX_MESSAGE_BYTES", 64 * 1024)
        peers = {str(p): served[p][1] for p in (0, 1)}
        for rep in reps:
            rep.set_peers(peers)
            rep.replicate_now(trainer)
        # the chief's ~1 MB share is over the cap; the other's empty one is not
        assert reps[0].stats()["push_failures"] == 1 and reps[0].stats()["pushes"] == 0
        assert reps[0].last_push["reason"] == "RESOURCE_EXHAUSTED"
        assert reps[1].stats()["pushes"] == 1
        assert stores[1].get(0) is None and stores[0].get(1) is not None
        # the chief dies: its share was in its RAM only
        directory = ReplicaDirectory()
        directory.update(1, reps[1].advertisement())
        servicer = _servicer()
        servicer.set_restore_stage(directory.harvest([1], 2, 0, 1))
        assert directory.harvest_failures == 1
        save_utils.CheckpointSaver(str(tmp_path / "ckpt")).save(
            4, state_to_checkpoint(trainer.state), extra={"model_version": 4}
        )
        fresh = _mnist_trainer(seed=2)
        assert restore_from_replica(fresh, servicer, cluster_version=1) is None

        class _Args:
            checkpoint_dir = str(tmp_path / "ckpt")
            checkpoint_dir_for_init = ""

        assert checkpointing.restore_trainer_state(fresh, _Args) == 4
    finally:
        for server, _addr in served:
            server.stop(grace=0)


# ---- chaos plans and hooks --------------------------------------------------------


def test_kill_during_replication_fires_from_the_push_hook(tmp_path, monkeypatch):
    from elasticdl_tpu_torch.chaos.hooks import ChaosInjector

    killed = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: killed.append(sig))
    fault = Fault(kind=FaultKind.KILL_DURING_REPLICATION, fault_id="rk", at_step=4, process_id=0)
    inj = ChaosInjector(
        FaultPlan(name="t", faults=[fault]), process_id=0, cluster_version=0,
        worker_id=0, events_path=str(tmp_path / "e.jsonl"),
    )
    inj.on_step(4)  # arms only; never fires at a step boundary
    inj.on_replica_push(2)  # below at_step
    assert not killed
    inj.on_replica_push(4)
    assert killed == [signal.SIGKILL]
    inj.on_replica_pushed(4, ok=False)
    events = invariants.read_event_log(str(tmp_path / "e.jsonl"))
    assert events[0]["phase"] == "replica_push" and events[0]["fault_id"] == "rk"
    assert events[1]["observation"] == "replica_push" and events[1]["step"] == 4


def test_the_replication_plans_are_the_jax_packages():
    from elasticdl_tpu.chaos.plan import builtin_plans as jax_plans

    for name in ("preempt_after_replication", "kill_during_replication"):
        assert builtin_plans(2)[name].to_json() == jax_plans(2)[name].to_json()


# ---- a survivor answers the harvest --------------------------------------------

_SURVIVOR = textwrap.dedent('''
    import datetime, os, sys, time
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    from elasticdl_tpu_torch.replication import blob
    from elasticdl_tpu_torch.replication.service import start_replica_server
    from elasticdl_tpu_torch.replication.store import ReplicaShard, ReplicaStore

    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    store = dist.TCPStore("localhost", port, 2, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    if rank == 1:
        open(out + ".p1", "w").write(str(os.getpid()))
        time.sleep(600)  # never joins the all-reduce: the test freezes, then kills it
    replicas = ReplicaStore(generation=0)
    payload = blob.encode_snapshot({{"w": np.arange(4, dtype=np.float32)}}, {{}})
    replicas.put(ReplicaShard(0, 6, 0, blob.blob_checksum(payload), payload))
    _server, replica_port = start_replica_server(replicas)
    open(out + ".tmp", "w").write(str(replica_port))
    os.rename(out + ".tmp", out)
    try:
        dist.all_reduce(torch.ones(1 << 16))  # waits on the frozen peer
    except Exception as ex:
        open(out + ".raised", "w").write(type(ex).__name__)
    time.sleep(600)  # lingers, as a lockstep worker whose world broke
''')


def _wait_for(path, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.05)
    with open(path) as f:
        return f.read()


def test_a_survivor_answers_the_harvest_while_its_collective_waits(tmp_path):
    """The survivor's training thread waits in a gloo all-reduce on a
    frozen peer (SIGSTOP): its replica server still answers, since the
    collective releases the GIL while it waits.  Then the peer dies: the
    collective raises at once (gloo sees the closed connection), and the
    lingering survivor still answers."""
    script = tmp_path / "survivor.py"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script.write_text(_SURVIVOR.format(repo=repo))
    out = str(tmp_path / "port")
    port = elastic.pick_coordinator_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(port), out], env=env)
        for r in (0, 1)
    ]
    try:
        addr = f"127.0.0.1:{int(_wait_for(out))}"
        peer_pid = int(_wait_for(out + ".p1"))
        os.kill(peer_pid, signal.SIGSTOP)
        time.sleep(0.5)
        assert procs[0].poll() is None and not os.path.exists(out + ".raised")
        replicas = ReplicaClient(addr)
        for _ in range(20):
            t0 = time.monotonic()
            probe = replicas.fetch_replica(msg.FetchReplicaRequest(source=0, probe=True), timeout=5)
            assert probe.has and probe.version == 6
            assert time.monotonic() - t0 < 1.0
        assert not os.path.exists(out + ".raised")  # still waiting
        os.kill(peer_pid, signal.SIGKILL)
        assert _wait_for(out + ".raised", timeout=60) == "RuntimeError"
        full = replicas.fetch_replica(msg.FetchReplicaRequest(source=0), timeout=5)
        np.testing.assert_array_equal(
            blob.decode_snapshot(full.payload)[0]["w"], np.arange(4, dtype=np.float32)
        )
    finally:
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.kill(proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                proc.kill()
            proc.wait()


# ---- two-process worlds through the train CLI --------------------------------------

RECORDS, BATCH, PER_TASK = 384, 32, 64  # tasks of 2 steps, 12 steps an epoch


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    """One intra-op thread in every worker process: bit for bit across
    worlds, and no oversubscribed CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def mnist_data(tmp_path_factory):
    from elasticdl_tpu_torch.data.recordio_gen.synthetic import gen_mnist

    root = tmp_path_factory.mktemp("replication_data")
    return gen_mnist(str(root / "t"), num_records=RECORDS, num_shards=2, seed=3)


def _world_job(work_dir, data, plan=None, checkpoint_steps=0, extra=()):
    """One two-worker mnist job with ``--replication`` under ``plan`` (a
    ``FaultPlan``); returns the master, the event log and the dumps'
    directory."""
    from unittest import mock

    from elasticdl_tpu_torch.chaos.invariants import InvariantChecker
    from elasticdl_tpu_torch.master import main as master_main

    os.makedirs(work_dir, exist_ok=True)
    dump_dir = os.path.join(work_dir, "dump")
    events = os.path.join(work_dir, "events.jsonl")
    envs = {DUMP_STATE_ENV: dump_dir}
    if plan is not None:
        plan_path = os.path.join(work_dir, "plan.json")
        plan.save(plan_path)
        envs.update({chaos_hooks.PLAN_ENV: plan_path, chaos_hooks.EVENTS_ENV: events})
    kept = {}
    original = master_main.build_master

    def build(args):
        master = kept["master"] = original(args)
        checker = kept["checker"] = InvariantChecker(expected_records=RECORDS)
        master.task_d.add_observer(checker)
        master.servicer.add_version_observer(checker.on_version_report)
        master.reform_callbacks.append(checker.on_reform)
        return master

    argv = [
        "train", "--model_def", MNIST_DEF, "--training_data", data,
        "--minibatch_size", str(BATCH), "--records_per_task", str(PER_TASK),
        "--shuffle_seed", "5", "--device", "cpu",
        "--distribution_strategy", "AllreduceStrategy", "--num_workers", "2", "--port", "0",
        "--checkpoint_dir", os.path.join(work_dir, "ckpt"),
        "--checkpoint_steps", str(checkpoint_steps), "--keep_checkpoint_max", "0",
        "--replication", "true", "--heartbeat_timeout_secs", "60",
        "--envs", ",".join(f"{k}={v}" for k, v in envs.items()), *extra,
    ]
    with mock.patch.object(master_main, "build_master", build):
        rc = client.main(argv)
    master = kept["master"]
    counters = master.task_d.counters(TaskType.TRAINING)
    assert rc == 0 and counters.total_records == RECORDS
    assert not kept["checker"].check(counters)
    log = invariants.read_event_log(events) if os.path.exists(events) else []
    return master, log, dump_dir


@pytest.fixture(scope="module")
def fault_free(tmp_path_factory, mnist_data):
    """The fault-free world, a checkpoint at every task boundary."""
    work = str(tmp_path_factory.mktemp("fault_free"))
    master, _log, _dump = _world_job(work, mnist_data, checkpoint_steps=2)
    assert not master.reform_events
    summary = master.job_summary()["replication"]
    assert summary["generations"][0]["hosts_covered"] == [0, 1]
    return os.path.join(work, "ckpt")


def _pushes(log, generation=0):
    return [e for e in log if e.get("observation") == "replica_push"
            and e["cluster_version"] == generation]


def test_a_preempted_world_resumes_from_peer_ram_at_the_pushed_version(
    tmp_path, mnist_data, fault_free
):
    """SIGKILL of process 1 one step after an accepted push (version 6;
    the disk holds 4): the re-formed world restores version 6 from the
    harvested stage, the restored state's CRC is the pushed shard's, its
    weights are the fault-free world's at version 6 bit for bit, and
    every record is counted once."""
    plan = builtin_plans(2)["preempt_after_replication"]
    master, log, dump_dir = _world_job(str(tmp_path), mnist_data, plan, checkpoint_steps=4)
    (reform,) = master.reform_events
    assert reform["harvest"]["complete"] and reform["harvest"]["version"] == 6
    kill = next(e for e in log if e.get("fault_id"))
    assert kill["step"] == 7
    pushed = {(e["process_id"], e["step"]): e for e in _pushes(log)}
    # the push was accepted before the kill, by both neighbors
    assert pushed[(0, 6)]["ok"] and pushed[(1, 6)]["ok"]
    assert pushed[(0, 6)]["monotonic"] < kill["monotonic"]
    (restore,) = [e for e in log if e.get("observation") == "replica_restore"]
    assert restore["cluster_version"] == 1 and restore["step"] == 6
    assert restore["restored_checksum"] == restore["checksum"] == pushed[(0, 6)]["checksum"]
    assert reform["harvest"]["checksum"] == pushed[(0, 6)]["checksum"]
    assert not [e for e in log if e.get("observation") == "checkpoint_restore"]
    assert invariants.check_replication_no_lost_steps(log)["status"] == "PASS"
    want, _extra = save_utils.restore_checkpoint(fault_free, version=6)
    for p in (0, 1):
        with np.load(os.path.join(dump_dir, f"start_state_p{p}_g1.npz")) as got:
            assert set(got.files) == set(want)
            for key in want:
                assert np.array_equal(got[key], want[key]), (p, key)
    stats = master.job_summary()["replication"]
    assert stats["harvests"] == 1 and stats["harvest_failures"] == 0


def test_a_death_inside_a_push_restores_the_older_complete_set(tmp_path, mnist_data):
    """kill_during_replication: process 1 commits version 4 and dies
    before its push; the survivor holds its own 2 and 4 and process 1's
    2, so the harvest skips the torn version and stages 2 (no disk
    checkpoint is newer)."""
    plan = builtin_plans(2)["kill_during_replication"]
    master, log, _dump = _world_job(str(tmp_path), mnist_data, plan)
    (reform,) = master.reform_events
    assert reform["harvest"]["complete"] and reform["harvest"]["version"] == 2
    kill = next(e for e in log if e.get("fault_id"))
    assert (kill["phase"], kill["step"]) == ("replica_push", 4)
    assert not [e for e in _pushes(log) if e["process_id"] == 1 and e["step"] == 4]
    (restore,) = [e for e in log if e.get("observation") == "replica_restore"]
    assert restore["step"] == 2


def test_a_death_inside_a_push_restores_a_newer_disk_checkpoint(tmp_path, mnist_data):
    """The same death with a checkpoint every 4 steps: the complete set
    (2) is older than the disk's 4, so the stage is declined and the
    world restores from disk, losing no step to the replica path."""
    plan = builtin_plans(2)["kill_during_replication"]
    master, log, _dump = _world_job(str(tmp_path), mnist_data, plan, checkpoint_steps=4)
    (reform,) = master.reform_events
    assert reform["harvest"]["version"] == 2
    assert not [e for e in log if e.get("observation") == "replica_restore"]
    (restore,) = [e for e in log if e.get("observation") == "checkpoint_restore"]
    assert restore["version"] == 4


def test_replication_steps_sets_the_push_cadence(tmp_path, mnist_data):
    """``--replication_steps 4`` with tasks of 2 steps: pushes at 4, 8
    and 12 only, on both processes, every one accepted."""
    master, log, _dump = _world_job(
        str(tmp_path), mnist_data, FaultPlan(name="none"), extra=("--replication_steps", "4")
    )
    assert not master.reform_events
    steps = sorted((e["process_id"], e["step"]) for e in _pushes(log))
    assert steps == [(0, 4), (0, 8), (0, 12), (1, 4), (1, 8), (1, 12)]
    assert all(e["ok"] for e in _pushes(log))


# ---- chip_smoke.py's phase 12, small ------------------------------------------


def test_smoke_phase12_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """Every check of phase 12 at a small size: (a) the hot restore at
    the push of version 20 (disk 16), (b) the torn push of 24 restoring
    20, (c) the fault-free job with and without replication beside (a)'s
    costs, (d) the LM in two ranks with replication (2 layers, width 32:
    its chief's shard is under the cap here, so its pushes are accepted;
    the CPU takes the kernels' plain path, so their launch counts read
    0)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "GPT2S", dict(
        vocab_size=64, embed_dim=32, num_heads=2, num_layers=2, dtype="float32",
    ))
    monkeypatch.setattr(chip_smoke, "SEQ", 16)
    cfg = dict(
        chip_smoke.REPLICA_MNIST, train_records=1024, eval_records=256, batch=32,
        records_per_task=128, min_accuracy=0.0,
    )
    hot = chip_smoke.replica_preempt_run(str(tmp_path / "hot"), cfg, device="cpu")
    row = hot["row"]
    assert row["restored_from"] == "replica@20" and row["harvest"]["version"] == 20
    assert row["no_lost_steps"]["status"] == "PASS" and row["total_records"] == 1024
    torn = chip_smoke.replica_torn_run(str(tmp_path / "torn"), cfg, hot["data"], device="cpu")
    assert torn["restored_from"] == "replica@20" and torn["torn_pushes_by"] == [0]
    costs = chip_smoke.replica_cost_run(
        str(tmp_path / "cost"), cfg, hot["data"], row, {"reform_latency_secs": 1.0}, device="cpu"
    )
    assert costs["fault_free"]["replicated"]["pushes"] == 2 * 8
    assert costs["push"]["pushes"] >= 5 and costs["restore_ms"] > 0
    assert 0 < costs["reform_latency_secs"] and 0 < costs["restored_secs_after_detection"]
    lm = chip_smoke.replica_lm_run(str(tmp_path / "lm"), device="cpu")
    assert lm["rc"] == 0 and [p["ok"] for p in lm["chief_pushes"]] == [True, True]
    assert set(lm["launches"].values()) == {0}
