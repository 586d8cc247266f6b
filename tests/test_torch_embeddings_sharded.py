"""Row-sharded embedding tables in the port (``elasticdl_tpu_torch/
embeddings/``, ``models/deepfm_sharded_embedding.py``) against the JAX
package's, on the CPU.

- **The planner**: ``tests/test_embeddings_sharded.py``'s cases, each
  against the JAX function: row ranges, owners, the axis and the rules
  (the port's worlds are dp-only), and tier admission.
- **A two-rank world** (gloo) of ``deepfm_sharded_embedding`` at
  DeepFM's vocabulary (5 383 padded to 5 504, so 2 752 rows a rank):
  every rank holds only its rows; two SGD steps equal the port's Local
  trainer within ``DP_TOL`` (f32 sums in another order) and the JAX
  package's step within ``TOL`` in relative norm, the tables included.
- **Parts checkpoints**: the world's two-part checkpoint restores whole
  in a Local trainer and in the JAX package; a Local (dense) checkpoint
  and a JAX-written three-part checkpoint restore in a two-rank world,
  each rank reading its rows by row id (2 -> 1 -> 2, across packages).
- **Replication and chaos**: the ``replica_push`` fields of a sharded
  state, ``drop_shard_parts`` stripping the rows, the sharded checks
  tripping on synthetic events (the JAX cases :312 and :337) and the
  runner's ``--corrupt drop_shard_parts`` job exiting 1 with the
  violation.
- **Serving**: a replica serves the sharded model whole and hot-swaps it
  with no new dispatched shape (the JAX case :407).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as tmp

from elasticdl_tpu import embeddings as jax_emb
from elasticdl_tpu.models import deepfm_sharded_embedding as jax_sharded_model
from elasticdl_tpu.parallel.mesh import MeshConfig
from elasticdl_tpu.utils.constants import MeshAxis as JaxMeshAxis
from elasticdl_tpu_torch import embeddings as emb
from elasticdl_tpu_torch.models import deepfm_sharded_embedding as sharded_model
from elasticdl_tpu_torch.parallel import elastic
from elasticdl_tpu_torch.parallel.mesh import MeshAxis, world_mesh

DEEPFM_DEF = "deepfm_sharded_embedding.deepfm_sharded_embedding.custom_model"
DP_TOL = 1e-6
TOL = 1e-5
ROWS = 16
PADDED = 5504
TABLES = ("embedding/embedding", "id_bias/embedding")


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_child():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


# ---- the planner --------------------------------------------------------------


@pytest.mark.parametrize("rows", [0, 1, 7, 10, 5383, 5504])
@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_shard_row_ranges_match_jax(rows, hosts):
    got = emb.shard_row_ranges(rows, hosts)
    assert got == jax_emb.shard_row_ranges(rows, hosts)
    assert got[0][0] == 0 and got[-1][1] == rows
    for (_, hi), (lo2, _) in zip(got, got[1:]):
        assert hi == lo2


def test_shard_row_ranges_pinned_and_owners():
    assert emb.shard_row_ranges(5383, 2) == [(0, 2692), (2692, 5383)]
    assert emb.shard_row_ranges(5504, 2) == [(0, 2752), (2752, 5504)]
    assert emb.shard_row_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    with pytest.raises(ValueError):
        emb.shard_row_ranges(10, 0)
    with pytest.raises(ValueError):
        emb.shard_row_ranges(-1, 2)
    ranges = emb.shard_row_ranges(10, 3)
    got = [emb.owning_shard(r, ranges) for r in (0, 3, 4, 6, 7, 9)]
    assert got == [jax_emb.owning_shard(r, ranges) for r in (0, 3, 4, 6, 7, 9)]
    assert got == [0, 0, 1, 1, 2, 2]
    with pytest.raises(ValueError):
        emb.owning_shard(10, ranges)


@pytest.mark.parametrize("processes", [1, 2, 8])
def test_embedding_axis_and_rules_on_worlds_match_jax(processes):
    """The port's world is the JAX mesh ``dp=N``: the same axis, the same
    rules (dp fallback, divisibility skip, none on one process)."""
    jax_mesh = MeshConfig.from_string(f"dp={processes}").create(jax.devices("cpu")[:processes])
    mesh = world_mesh(processes)
    for kw in (dict(), dict(rows=1000), dict(rows=1001), dict(allow_dp=False)):
        assert emb.embedding_axis(mesh, **kw) == jax_emb.embedding_axis(jax_mesh, **kw)
    tables = {"embedding/embedding": 5504, "id_bias/embedding": 5504, "t/embedding": 5383}
    got = emb.sharded_table_rules(mesh, tables)
    want = jax_emb.sharded_table_rules(jax_mesh, tables)
    assert [r.regex.pattern for r in got] == [r.regex.pattern for r in want]
    assert [r.spec for r in got] == [tuple(r.spec) for r in want]
    for rule, ref in zip(got, want):
        for path in ("embedding/embedding", "params/embedding/embedding", "big_embedding/embedding"):
            assert rule.matches(path) == ref.matches(path)
    # the models' hooks, as the JAX modules'
    got = sharded_model.sharding_rules(mesh)
    want = jax_sharded_model.sharding_rules(jax_mesh)
    assert [(r.regex.pattern, r.spec) for r in got] == [
        (r.regex.pattern, tuple(r.spec)) for r in want
    ]
    from elasticdl_tpu.models import deepfm_edl_embedding as jax_edl
    from elasticdl_tpu_torch.models import deepfm_edl_embedding as port_edl

    assert port_edl.sharding_rules(mesh) == [] == jax_edl.sharding_rules(jax_mesh)
    assert MeshAxis.DP == JaxMeshAxis.DP


def test_model_spec_reads_the_rules_and_tracks_the_padded_vocab():
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    spec = get_model_spec("", DEEPFM_DEF)
    assert spec.rules_for(1) == ()
    model = spec.build_model()
    assert model.embedding.embedding.shape == (PADDED, 64)
    rules = spec.rules_for(2)
    assert [r.spec for r in rules] == [("dp", None)] * 2
    # an input_dim override re-pads the rules' table height
    sharded_model.custom_model(input_dim=1000)
    assert emb.sharded_table_rules(world_mesh(8), {"t": 1024}) != []
    assert sharded_model.sharding_rules(world_mesh(3)) == []  # 1024 % 3
    sharded_model.custom_model()
    assert len(sharded_model.sharding_rules(world_mesh(2))) == 2


def test_plan_placement_tiers_and_admission_fault(monkeypatch):
    monkeypatch.setenv(emb.DEVICE_BUDGET_ENV, str(1 << 20))
    assert emb.device_budget_bytes() == 1 << 20
    small = emb.plan_placement(1 << 10, name="small")
    assert small.tier == "device" and small.reason == "fits device budget"
    big = emb.plan_placement(1 << 24, name="big")
    assert big.tier == "spill"
    assert big.host_available_bytes is not None
    events = []
    with pytest.raises(emb.EmbeddingAdmissionError):
        emb.plan_placement(
            1 << 62, name="monster", emit=lambda ev, **fields: events.append((ev, fields))
        )
    assert events and events[0][0] == "embedding_spill_fault"
    assert events[0][1]["table"] == "monster"
    # the CPU has no device budget: an unknowable budget admits
    monkeypatch.delenv(emb.DEVICE_BUDGET_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert emb.device_budget_bytes() is None
    assert emb.plan_placement(1 << 40).tier == "device"


def test_tables_build_where_asked_and_the_cpu_keeps_its_bits():
    from elasticdl_tpu_torch.layers import embedding
    from elasticdl_tpu_torch.utils.model_utils import get_model_spec

    spec = get_model_spec("", DEEPFM_DEF)

    def build(**kw):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return spec.build_model(**kw)

    plain, on_cpu = build(), build(device="cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        table = torch.empty(PADDED, 64)
        torch.nn.init.uniform_(table, 0.0, 0.05)
    np.testing.assert_array_equal(plain.embedding.embedding.detach().numpy(), table.numpy())
    for a, b in zip(plain.state_dict().values(), on_cpu.state_dict().values()):
        assert torch.equal(a, b)
    assert embedding._table_device is None


# ---- the two-rank world ----------------------------------------------------------


def _flax_start(seed=3):
    """The JAX model's flax weights, both tables spread (their U[0, 0.05)
    start is too uniform for every term to show)."""
    from elasticdl_tpu.trainer.state import init_model
    from elasticdl_tpu.utils import tree_utils

    model = jax_sharded_model.custom_model()
    params, _ = init_model(model, {"feature": np.zeros((1, 10), np.int32)}, rng_seed=seed)
    flat = {k: np.asarray(v) for k, v in tree_utils.tree_to_dict(params).items()}
    rng = np.random.RandomState(seed + 1)
    for name in TABLES:
        flat[name] = rng.normal(0, 0.3, flat[name].shape).astype(np.float32)
    return flat


def _batches():
    """Two global batches of 16 rows; ids across the whole vocabulary
    (both owners), the last three of each row the padding id 0, and
    rows 12-15 zero-weight padding."""
    out = []
    for step in range(2):
        rng = np.random.RandomState(10 + step)
        ids = rng.randint(1, 5383, (ROWS, 10))
        ids[:, -3:] = 0
        labels = rng.randint(0, 2, ROWS).astype(np.int32)
        weights = np.array([1.0] * 12 + [0.0] * 4, np.float32)
        out.append((ids.astype(np.int16), labels, weights))
    return out


def _port_model(flat):
    from elasticdl_tpu_torch.utils import flax_weights

    model = sharded_model.custom_model()
    model.load_state_dict(flax_weights.torch_state_from_flax(flat, model))
    return model


def _trainer(model, group=None, rules=()):
    from elasticdl_tpu_torch.parallel.distributed import SPMDTrainer

    return SPMDTrainer(
        model, sharded_model.loss, sharded_model.optimizer(), device="cpu",
        process_group=group, sharding_rules=rules,
    )


def _snapshot(trainer) -> dict:
    dense, parts = elastic.state_checkpoint_parts(trainer.state)
    out = {f"d/{k}": v for k, v in dense.items()}
    for name, (ids, rows) in parts.items():
        out[f"ids/{name}"], out[f"rows/{name}"] = ids, rows
    return out


def _world_child(rank, world_size, port, inputs_path, out_dir, mode):
    """One rank of the two-rank world (``torch.multiprocessing``):
    ``train`` takes the two steps from the flax start, writes its part of
    a checkpoint and exports through process 0; ``restore`` restores each
    checkpoint of ``inputs['dirs']`` into a fresh sharded trainer."""
    from elasticdl_tpu_torch.trainer.checkpointing import (
        PeriodicCheckpointer,
        restore_trainer_state,
    )
    from elasticdl_tpu_torch.utils.export_utils import export_model

    torch.set_num_threads(1)
    with np.load(inputs_path, allow_pickle=False) as z:
        inputs = {k: z[k] for k in z.files}
    world = elastic.initialize_world(f"localhost:{port}", world_size, rank, device="cpu")
    try:
        rules = sharded_model.sharding_rules(world_mesh(world_size))
        flat = {k[len("p/"):]: v for k, v in inputs.items() if k.startswith("p/")}
        out = {}
        if mode == "train":
            trainer = _trainer(_port_model(flat), world.group, rules)
            assert trainer.broadcast_state() == 0
            out["table_rows"] = np.asarray(
                [trainer.state.model.embedding.embedding.shape[0],
                 trainer.state.model.id_bias.embedding.shape[0]]
            )
            losses = []
            for ids, labels, weights in _batches():
                metrics = trainer.train_step(
                    *trainer.place_step({"feature": ids}, labels, weights)
                )
                losses.append(float(metrics["loss"]))
            out["loss"] = np.asarray(losses)
            out.update(_snapshot(trainer))
            ckpt = PeriodicCheckpointer(
                os.path.join(out_dir, "world_ckpt"), 0, process_id=rank, num_parts=world_size
            )
            ckpt.save_now(trainer)
            ckpt.flush()
            tables = elastic.gather_sharded_tables_to_chief(trainer.state.model, world.group)
            if rank == 0:
                export_model(
                    os.path.join(out_dir, "export"), trainer.state.model, DEEPFM_DEF,
                    model_version=trainer.step, tables=tables,
                )
            # the eval forward runs the exchange too (no gradient)
            with torch.no_grad():
                logits = trainer.predict_step(
                    trainer.place_local(trainer.pad_to({"feature": _batches()[0][0]}, ROWS))
                )["logits"]
            out["logits"] = logits.numpy()
        else:
            for i, ckpt_dir in enumerate(str(inputs["dirs"]).split(",")):
                torch.manual_seed(100 + i)  # a start the restore must replace
                trainer = _trainer(sharded_model.custom_model(), world.group, rules)
                args = argparse.Namespace(checkpoint_dir=ckpt_dir, checkpoint_dir_for_init="")
                assert restore_trainer_state(trainer, args) == int(inputs["versions"][i])
                out.update({f"{i}/{k}": v for k, v in _snapshot(trainer).items()})
        np.savez(os.path.join(out_dir, f"{mode}_p{rank}.npz"), **out)
    finally:
        elastic.shutdown_world()


def _spawn_world(tmp_path, mode, inputs) -> list[dict]:
    path = str(tmp_path / f"{mode}_inputs.npz")
    np.savez(path, **inputs)
    tmp.spawn(
        _world_child,
        args=(2, elastic.pick_coordinator_port(), path, str(tmp_path), mode),
        nprocs=2, join=True,
    )
    outs = []
    for rank in range(2):
        with np.load(str(tmp_path / f"{mode}_p{rank}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The trained two-rank world, and the same two steps in the port's
    one process and in the JAX package."""
    from elasticdl_tpu.trainer import step as jax_step
    from elasticdl_tpu.trainer.state import TrainState as JaxState
    from elasticdl_tpu.utils import tree_utils

    tmp_path = tmp_path_factory.mktemp("sharded_world")
    flat = _flax_start()
    ranks = _spawn_world(tmp_path, "train", {f"p/{k}": v for k, v in flat.items()})
    local = _trainer(_port_model(flat))
    local_losses = []
    for ids, labels, weights in _batches():
        metrics = local.train_step(*local.place_step({"feature": ids}, labels, weights))
        local_losses.append(float(metrics["loss"]))
    jax_model = jax_sharded_model.custom_model()
    state = JaxState.create(jax_model.apply, _tree(flat), optax.sgd(0.1))
    train = jax_step.build_train_step(jax_sharded_model.loss, donate=False)
    for ids, labels, weights in _batches():
        state, _m = train(
            state, {"feature": jnp.asarray(ids)}, jnp.asarray(labels), jnp.asarray(weights)
        )
    jax_flat = {f"params/{k}": np.asarray(v) for k, v in tree_utils.tree_to_dict(state.params).items()}
    return dict(dir=tmp_path, ranks=ranks, local=local, local_losses=local_losses,
                jax=jax_flat, start=flat)


def _tree(flat):
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _assembled(ranks) -> dict:
    """The world's state: process 0's dense values, the tables assembled
    from both ranks' parts by row id."""
    from elasticdl_tpu_torch.utils.save_utils import assemble_embedding_tables

    out = {k[2:]: v for k, v in ranks[0].items() if k.startswith("d/")}
    parts = {}
    for name in (f"params/{t}" for t in TABLES):
        ids = np.concatenate([r[f"ids/{name}"] for r in ranks])
        rows = np.concatenate([r[f"rows/{name}"] for r in ranks])
        parts[name] = (ids, rows)
    out.update(assemble_embedding_tables(parts))
    return out


def test_each_rank_holds_only_its_rows(world):
    for rank, out in enumerate(world["ranks"]):
        assert out["table_rows"].tolist() == [2752, 2752]
        for name in TABLES:
            ids = out[f"ids/params/{name}"]
            np.testing.assert_array_equal(ids, np.arange(2752 * rank, 2752 * (rank + 1)))
            assert f"d/params/{name}" not in out
    # the dense values are the world's, bitwise equal on both ranks
    r0, r1 = world["ranks"]
    dense = sorted(k for k in r0 if k.startswith("d/"))
    assert dense == sorted(k for k in r1 if k.startswith("d/")) and len(dense) == 4
    for key in dense:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


def test_two_rank_world_matches_local_and_jax(world):
    from elasticdl_tpu_torch.trainer.state import state_to_checkpoint

    got = _assembled(world["ranks"])
    local = state_to_checkpoint(world["local"].state)
    assert set(got) == set(local) == set(world["jax"])
    for name, value in local.items():
        np.testing.assert_allclose(got[name], value, atol=DP_TOL, rtol=0, err_msg=name)
        want = world["jax"][name]
        assert np.linalg.norm(got[name] - want) / np.linalg.norm(want) < TOL, name
        start = world["start"][name[len("params/"):]]
        assert not np.array_equal(got[name], start), name  # every tensor moved
    # the ranks' shares of each step's loss add up to the global batch's
    losses = world["ranks"][0]["loss"] + world["ranks"][1]["loss"]
    np.testing.assert_allclose(losses, world["local_losses"], atol=DP_TOL, rtol=0)
    # both owners were read: rows of both halves moved
    for name in (f"params/{t}" for t in TABLES):
        moved = np.any(got[name] != world["start"][name[len("params/"):]], axis=1)
        assert moved[:2752].any() and moved[2752:].any()
    # the eval forward through the exchange gives each rank its rows' logits
    with torch.no_grad():
        want = world["local"].predict_step(
            world["local"].place_batch({"feature": _batches()[0][0]})
        )["logits"].numpy()
    logits = np.concatenate([r["logits"] for r in world["ranks"]])
    np.testing.assert_allclose(logits, want, atol=DP_TOL, rtol=0)


def test_world_export_gathers_the_tables_whole(world):
    from elasticdl_tpu_torch.utils.export_utils import load_exported_model, read_manifest

    model, flat_params, _ = load_exported_model(str(world["dir"] / "export"), device="cpu")
    assert read_manifest(str(world["dir"] / "export"))["model_version"] == 2
    assert model.embedding.embedding.shape == (PADDED, 64) and model.embedding.shard is None
    got = _assembled(world["ranks"])
    for name, value in flat_params.items():
        np.testing.assert_array_equal(value, got[f"params/{name}"])


def test_parts_checkpoints_restore_in_local_and_in_jax(world):
    """2 -> 1, and the port's parts in the JAX package."""
    from elasticdl_tpu.utils import save_utils as jax_save
    from elasticdl_tpu_torch.trainer.checkpointing import restore_trainer_state
    from elasticdl_tpu_torch.trainer.state import state_to_checkpoint
    from elasticdl_tpu_torch.utils import save_utils

    ckpt = str(world["dir"] / "world_ckpt")
    with open(os.path.join(ckpt, "version-2", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["num_parts"] == 2
    assert sorted(manifest["names"]["embeddings"]) == [f"params/{t}" for t in TABLES]
    with np.load(os.path.join(ckpt, "version-2", "variables-1-of-2.npz")) as z:
        assert sorted(z.files) == sorted(
            f"{kind}/params/{t}" for kind in ("emb_ids", "emb_rows") for t in TABLES
        )
    want = _assembled(world["ranks"])
    torch.manual_seed(7)
    local = _trainer(sharded_model.custom_model())
    args = argparse.Namespace(checkpoint_dir=ckpt, checkpoint_dir_for_init="")
    assert restore_trainer_state(local, args) == 2
    got = state_to_checkpoint(local.state)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    dense, tables, extra = jax_save.restore_checkpoint(ckpt)
    dense.update(jax_save.assemble_embedding_tables(tables))
    assert extra["model_version"] == 2
    for name, value in want.items():
        np.testing.assert_array_equal(dense[name], value, err_msg=name)
    # the keep filter: a restore of one rank's rows reads no other row
    keep = {f"params/{t}": [(2752, 5504)] for t in TABLES}
    _dense, parts, _extra = save_utils.restore_checkpoint_parts(ckpt, table_row_ranges=keep)
    for name, (ids, rows) in parts.items():
        np.testing.assert_array_equal(ids, np.arange(2752, 5504))
        np.testing.assert_array_equal(rows, want[name][2752:])
    # the two-tuple restore assembles the tables
    whole, _extra = save_utils.restore_checkpoint(ckpt)
    assert set(whole) == set(want)


def test_local_and_jax_parts_checkpoints_restore_in_a_world(world, tmp_path):
    """1 -> 2 and the JAX package's parts (three of them) -> 2: each rank
    reads its rows by id."""
    from elasticdl_tpu.utils import save_utils as jax_save
    from elasticdl_tpu_torch.trainer.checkpointing import PeriodicCheckpointer
    from elasticdl_tpu_torch.trainer.state import state_to_checkpoint

    local_dir = str(tmp_path / "local_ckpt")
    saver = PeriodicCheckpointer(local_dir, 0)
    saver.save_now(world["local"])
    saver.flush()
    want_local = state_to_checkpoint(world["local"].state)

    jax_dir = str(tmp_path / "jax_ckpt")
    want_jax = {k: v * 1.5 for k, v in want_local.items()}
    saver = jax_save.CheckpointSaver(jax_dir)
    dense = {k: v for k, v in want_jax.items() if k[len("params/"):] not in TABLES}
    for part, (lo, hi) in enumerate(emb.shard_row_ranges(PADDED, 3)):
        parts = {
            f"params/{t}": (np.arange(lo, hi), want_jax[f"params/{t}"][lo:hi]) for t in TABLES
        }
        saver.save(5, dense if part == 0 else {}, parts, part=part, num_parts=3,
                   extra={"model_version": 5}, enforce_retention=part == 0)
    ranks = _spawn_world(tmp_path, "restore", {
        "dirs": np.asarray(f"{local_dir},{jax_dir}"), "versions": np.asarray([2, 5]),
    })
    for i, want in enumerate((want_local, want_jax)):
        got = _assembled([{k[len(f"{i}/"):]: v for k, v in r.items() if k.startswith(f"{i}/")}
                          for r in ranks])
        assert set(got) == set(want)
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=f"{i} {name}")
        for rank, r in enumerate(ranks):
            assert r[f"{i}/rows/params/embedding/embedding"].shape == (2752, 64)


# ---- replication and chaos ------------------------------------------------------


def _sharded_state(rank=1):
    """A DeepFM state holding rank ``rank``'s rows of both tables of a
    two-rank world (sharded by hand: no world needed for a snapshot)."""
    from elasticdl_tpu_torch.embeddings.sharded import TableShard
    from elasticdl_tpu_torch.trainer.state import TrainState

    torch.manual_seed(0)
    model = sharded_model.custom_model()
    ranges = tuple(emb.shard_row_ranges(PADDED, 2))
    for attr in ("embedding", "id_bias"):
        module = getattr(model, attr)
        lo, hi = ranges[rank]
        module.embedding = torch.nn.Parameter(module.embedding.detach()[lo:hi].clone())
        module.embedding.row_sharded = True
        module.shard = TableShard(f"params/{attr}/embedding", PADDED, ranges, rank)
    return TrainState.create(model, sharded_model.optimizer())


@pytest.mark.parametrize("drop", [False, True], ids=["pushed", "drop_shard_parts"])
def test_replica_push_reports_the_sharded_rows(monkeypatch, drop):
    from elasticdl_tpu_torch.chaos import hooks as chaos_hooks
    from elasticdl_tpu_torch.chaos.invariants import check_replication_no_lost_steps
    from elasticdl_tpu_torch.chaos.plan import FaultKind
    from elasticdl_tpu_torch.replication import replicator
    from elasticdl_tpu_torch.replication.blob import decode_snapshot
    from elasticdl_tpu_torch.replication.store import ReplicaStore

    if drop:
        monkeypatch.setenv(replicator.DROP_SHARD_PARTS_ENV, "1")
    pushes = []
    monkeypatch.setattr(
        chaos_hooks, "record_replica_push", lambda version, **kw: pushes.append((version, kw))
    )
    store = ReplicaStore(generation=0)
    rep = replicator.PeerReplicator(store, process_id=1, num_processes=2, generation=0,
                                    addr="127.0.0.1:0")
    trainer = argparse.Namespace(state=_sharded_state(), step=4)
    rep.replicate_now(trainer)
    (version, fields), = pushes
    assert version == 4 and fields["has_sharded"] is True and fields["sharded_tables"] == 2
    assert fields["sharded_rows"] == (0 if drop else 2 * 2752)
    dense, parts = decode_snapshot(store.get(1).payload)
    assert dense == {}
    if drop:
        assert parts == {}
    else:
        assert sorted(parts) == [f"params/{t}" for t in TABLES]
        np.testing.assert_array_equal(parts["params/embedding/embedding"][0], np.arange(2752, 5504))
    events = [
        {"observation": "replica_push", "step": 4, "monotonic": 1.0, **fields},
        {"kind": FaultKind.PREEMPT, "monotonic": 2.0},
        {"observation": "replica_restore", "step": 4, "monotonic": 3.0,
         "sharded_rows": fields["sharded_rows"]},
    ]
    faults = [e for e in events if "kind" in e]
    verdict = check_replication_no_lost_steps(
        [e for e in events if "observation" in e], True, faults
    )
    assert verdict["status"] == ("FAIL" if drop else "PASS")
    if drop:
        assert any("zero sharded table rows" in v for v in verdict["violations"])


def _push(step, src, dst, src_slice, dst_slice, num_slices=2, **extra):
    return {"event": "replica_push", "step": step, "source": src, "target": dst,
            "source_slice": src_slice, "target_slice": dst_slice,
            "num_slices": num_slices, "ok": True, "monotonic": float(step), **extra}


def test_cross_slice_coverage_sharded_extension_matches_jax():
    from elasticdl_tpu.chaos import harness as jax_harness
    from elasticdl_tpu_torch.chaos import harness

    healthy = [
        _push(2, 0, 1, 0, 1, has_sharded=True, sharded_tables=2, sharded_rows=2752),
        _push(2, 1, 0, 1, 0, has_sharded=True, sharded_tables=2, sharded_rows=2752),
    ]
    dropped = [
        _push(2, 0, 1, 0, 1, has_sharded=True, sharded_tables=2, sharded_rows=0),
        _push(2, 1, 0, 1, 0, has_sharded=True, sharded_tables=2, sharded_rows=2752),
    ]
    dense_only = [_push(2, 0, 1, 0, 1, has_sharded=False, sharded_rows=0)]
    for events in (healthy, dropped, dense_only):
        assert harness.check_cross_slice_coverage(events, 2) == \
            jax_harness.check_cross_slice_coverage(events, 2)
    violations = harness.check_cross_slice_coverage(dropped, 2)
    assert len(violations) == 1 and "zero rows" in violations[0]


def test_no_lost_steps_sharded_extension_matches_jax(tmp_path):
    from elasticdl_tpu.chaos import harness as jax_harness
    from elasticdl_tpu.chaos.plan import FaultKind
    from elasticdl_tpu.chaos.plan import named_plan as jax_named_plan
    from elasticdl_tpu_torch.chaos import harness
    from elasticdl_tpu_torch.chaos.plan import named_plan

    config = harness.ChaosJobConfig(
        plan=named_plan("preempt_one_worker", 2), workdir=str(tmp_path), replication=True
    )
    jax_config = jax_harness.ChaosJobConfig(
        plan=jax_named_plan("preempt_one_worker", 2), workdir=str(tmp_path), replication=True
    )
    faults = [{"kind": FaultKind.PREEMPT, "monotonic": 10.0}]

    def restore(step, rows):
        return {"event": "replica_restore", "step": step, "sharded_rows": rows, "monotonic": 11.0}

    cases = {
        "healthy": ([_push(4, 0, 1, 0, 0, num_slices=1, has_sharded=True, sharded_rows=2752),
                     restore(4, 5504)], "PASS", None),
        "lost_rows": ([_push(4, 0, 1, 0, 0, num_slices=1, has_sharded=True, sharded_rows=2752),
                       restore(4, 0)], "FAIL", "zero sharded table rows"),
        "never_pushed": ([_push(4, 0, 1, 0, 0, num_slices=1, has_sharded=True, sharded_rows=0),
                          restore(4, 0)], "FAIL", "no replica to survive"),
    }
    for events, status, text in cases.values():
        got = harness._check_no_lost_steps(config, events, faults)
        want = jax_harness._check_no_lost_steps(jax_config, events, faults)
        assert got["status"] == want["status"] == status
        assert got["violations"] == want["violations"]
        if text:
            assert any(text in v for v in got["violations"])


def test_runner_drop_shard_parts_exits_nonzero_with_the_violation(tmp_path):
    """``python -m elasticdl_tpu_torch.chaos.runner --corrupt
    drop_shard_parts``: a two-worker sharded DeepFM job, replicated and
    preempted at step 6, whose pushes carry no table rows: the re-formed
    world refuses the row-less replica set and restores from disk, and
    the run exits 1 naming the lost rows."""
    workdir = str(tmp_path / "run")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.chaos.runner",
         "--corrupt", "drop_shard_parts", "--device", "cpu", "--num-records", "384",
         "--num-epochs", "1", "--workdir", workdir],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 1, proc.stderr[-3000:]
    with open(os.path.join(workdir, "chaos_result.json")) as f:
        result = json.load(f)
    assert result["corrupt"] == "drop_shard_parts" and not result["invariants_ok"]
    status = {i["name"]: i["status"] for i in result["invariants"]}
    assert status["replication_no_lost_steps"] == "FAIL"
    report = json.loads(proc.stdout[proc.stdout.index("{"):])
    violations = [v for i in report["invariants"] for v in i["violations"]]
    assert any("carried zero sharded table rows" in v for v in violations), violations
    # the job itself ran to its end: the rows were lost, not the records
    assert status["exactly_once"] == "PASS"


# ---- serving -----------------------------------------------------------------


def test_serving_the_sharded_model_whole_and_hot_swapping_it(tmp_path):
    from elasticdl_tpu_torch.serving.engine import ServingEngine
    from elasticdl_tpu_torch.utils.export_utils import export_model

    def export(version, scale):
        torch.manual_seed(version)
        model = sharded_model.custom_model()
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(scale).add_(0.01)
        return export_model(str(tmp_path / f"v{version}"), model, DEEPFM_DEF,
                            model_version=version)

    v1, v2 = export(3, 1.0), export(9, 2.0)
    engine = ServingEngine(v1, canonical_rows=8, device="cpu")
    assert engine.sharding_rules == ()
    feats = {"feature": np.random.RandomState(0).randint(1, 5383, (5, 10)).astype(np.int32)}
    out1 = engine.predict_rows(feats)["logits"]
    assert out1.shape[0] == 5
    assert engine.model.embedding.embedding.shape == (PADDED, 64)
    assert engine.model.embedding.shard is None
    shapes = engine.shapes_dispatched
    accepted, version, reason = engine.swap_from_export(v2)
    assert accepted and version == 9, reason
    out2 = engine.predict_rows(feats)["logits"]
    assert engine.shapes_dispatched == shapes == 1
    assert not np.allclose(out1, out2)
    assert engine.model.embedding.embedding.shape == (PADDED, 64)


# ---- the smoke's phase 19b-c, rehearsed ------------------------------------------


def test_smoke_phase19b_rehearsal_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 19b at a small vocabulary on the CPU: the
    first step against its minitable (bitwise moves, untouched rows
    equal), then the Local CLI run with its gates."""
    import chip_smoke

    cfg = dict(chip_smoke.DEEPFM_100M, gen_kwargs={"vocab_size": 100000},
               model_params="input_dim=100000", train_records=2048, batch=256,
               records_per_task=512)
    row = chip_smoke.deepfm_100m_run(str(tmp_path), "cpu", cfg=cfg)
    assert row["steps"] == 8 and row["table_shape"] == [100096, 64]
    for table in ("embedding", "id_bias"):
        assert row["first_step"][table]["moved_by_minus_lr_grad"]


def test_smoke_phase19c_rehearsal_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 19c on the CPU: the preempted sharded
    world restored from peer RAM by row id and held to Local, beside the
    runner's drop_shard_parts job exiting 1."""
    import chip_smoke

    rows = chip_smoke.sharded_world_phase(str(tmp_path), "cpu")
    assert rows["preempt"]["restored_from"] == f"replica@{rows['preempt']['last_accepted_push']}"
    assert rows["preempt"]["max_abs_diff_to_local"] < chip_smoke.PARITY_ATOL
    assert rows["drop"]["rc"] == 1 and rows["drop"]["sharded_violations"]
