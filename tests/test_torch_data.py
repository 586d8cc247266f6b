"""The port's data layer against the JAX package's, on the same seeded
inputs: the EDLIO codec and the example codec both ways, ``Dataset``,
the task dispatcher, and the per-task minibatch stream of the LM.

Every comparison here is exact: both sides run the same numpy
arithmetic and the same ``random`` seeds."""

from __future__ import annotations

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest

from elasticdl_tpu.data import dataset as jax_dataset
from elasticdl_tpu.data import fast_pipeline as jax_fast
from elasticdl_tpu.data import reader as jax_reader
from elasticdl_tpu.data import recordio as jax_recordio
from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
from elasticdl_tpu.data.recordio_reader import RecordIODataReader as JaxReader
from elasticdl_tpu.master import task_dispatcher as jax_dispatch
from elasticdl_tpu.trainer.state import Modes as JaxModes
from elasticdl_tpu.utils.model_utils import get_model_spec as jax_get_spec
from elasticdl_tpu_torch.data import dataset as port_dataset
from elasticdl_tpu_torch.data import reader as port_reader
from elasticdl_tpu_torch.data import recordio as port_recordio
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.data.recordio_gen import synthetic as port_synthetic
from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader as PortReader
from elasticdl_tpu_torch.master import task_dispatcher as port_dispatch
from elasticdl_tpu_torch.trainer.local_executor import LocalExecutor
from elasticdl_tpu_torch.trainer.state import Modes as PortModes
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.model_utils import get_model_spec as port_get_spec

LM_DEF = "long_seq_transformer.long_seq_transformer.custom_model"
SEQ_KW = dict(num_records=40, num_shards=2, seed=3, seq_len=64, vocab=256)


def _records(recordio, path, start=0, length=-1):
    with recordio.Scanner(path, start, length) as scanner:
        return list(scanner)


def _port_task_batches(reader, task, spec, mode, batch_size):
    """The minibatch stream ``LocalExecutor`` makes of one task (it
    shuffles training tasks and prefetches two batches)."""
    executor = type("Executor", (), {})()
    executor._spec = spec
    executor._args = type("Args", (), {"minibatch_size": batch_size})()
    executor._steps_per_dispatch, executor._device = 1, "cpu"
    return LocalExecutor._task_dataset(executor, reader, task, mode)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def seq_dirs(tmp_path_factory):
    """The same ``gen_sequence`` call made by each package."""
    root = tmp_path_factory.mktemp("seq")
    return {
        "jax": jax_synthetic.gen_sequence(str(root / "jax"), **SEQ_KW),
        "port": port_synthetic.gen_sequence(str(root / "port"), **SEQ_KW),
    }


# ---- the EDLIO container ----------------------------------------------------


def test_gen_sequence_writes_the_same_files(seq_dirs):
    names = sorted(os.listdir(seq_dirs["jax"]))
    assert names == sorted(os.listdir(seq_dirs["port"])) and len(names) == 2
    for name in names:
        with open(os.path.join(seq_dirs["jax"], name), "rb") as a, open(
            os.path.join(seq_dirs["port"], name), "rb"
        ) as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("start, length", [(0, -1), (3, 9), (17, 100)])
def test_each_package_reads_the_others_shards(seq_dirs, writer, start, length):
    """Records, record counts and ranged scans of shards one package
    wrote, read by both."""
    for name in sorted(os.listdir(seq_dirs[writer])):
        path = os.path.join(seq_dirs[writer], name)
        assert port_recordio.num_records(path) == jax_recordio.num_records(path) == 20
        want = _records(jax_recordio, path, start, length)
        assert _records(port_recordio, path, start, length) == want
        assert len(want) == min(20 - start, 20 if length < 0 else length)


def test_port_writer_matches_jax_writer_record_for_record(tmp_path):
    """Records of several sizes (an empty one included) in one shard."""
    rng = np.random.RandomState(0)
    records = [rng.bytes(n) for n in (0, 1, 7, 4096, 70000, 3)]
    for recordio, name in ((jax_recordio, "jax"), (port_recordio, "port")):
        with recordio.Writer(str(tmp_path / name)) as w:
            for r in records:
                w.write(r)
    assert (tmp_path / "jax").read_bytes() == (tmp_path / "port").read_bytes()
    assert _records(jax_recordio, str(tmp_path / "port")) == records


# ---- the example codec ------------------------------------------------------


def _example(kind):
    rng = np.random.RandomState(1)
    return {
        "tokens": {"tokens": rng.randint(0, 256, 65).astype(np.int64)},
        "image": {
            "image": rng.randint(0, 255, (28, 28)).astype(np.uint8),
            "label": np.int64(7),
        },
        "mixed": {
            "f32": rng.randn(3, 4).astype(np.float32),
            "f16": rng.randn(5).astype(np.float16),
            "bf16": rng.randn(2, 3).astype(ml_dtypes.bfloat16),
            "flag": np.array([True, False]),
            "scalar": np.float64(2.5),
        },
    }[kind]


@pytest.mark.parametrize("kind", ["tokens", "image", "mixed"])
@pytest.mark.parametrize(
    "encode, decode",
    [
        (port_reader.encode_example, jax_reader.decode_example),
        (jax_reader.encode_example, port_reader.decode_example),
    ],
    ids=["port_to_jax", "jax_to_port"],
)
def test_example_codec_round_trips_across_packages(kind, encode, decode):
    ex = _example(kind)
    payload = encode(ex)
    other = jax_reader if encode is port_reader.encode_example else port_reader
    assert payload == other.encode_example(ex)
    _assert_tree_equal(decode(payload), {k: np.asarray(v) for k, v in ex.items()})


def test_decode_example_batch_matches_jax():
    rng = np.random.RandomState(2)
    payloads = [
        jax_reader.encode_example(
            {"x": rng.randn(4).astype(np.float32), "y": np.int64(i)}
        )
        for i in range(5)
    ]
    for n in (1, 5):
        _assert_tree_equal(
            port_reader.decode_example_batch(payloads[:n]),
            jax_reader.decode_example_batch(payloads[:n]),
        )
    assert port_reader.decode_example_batch([]) == {}


# ---- Dataset ----------------------------------------------------------------


def _pipelines():
    """(name, build(Dataset) -> Dataset) over 23 elements of the form
    ``({"x": (2,) f32, "i": int}, label)``."""
    return [
        ("batch", lambda ds: ds.batch(5)),
        ("batch_drop", lambda ds: ds.batch(5, drop_remainder=True)),
        ("shuffle_batch", lambda ds: ds.shuffle(7, seed=3).batch(4)),
        ("shuffle_big_buffer", lambda ds: ds.shuffle(100, seed=0).batch(6)),
        ("map_prefetch", lambda ds: ds.map(lambda e: (e[0], e[1] * 2)).batch(8).prefetch(2)),
        ("batch_list", lambda ds: ds.batch_list(6)),
        ("filter", lambda ds: ds.filter(lambda e: e[1] % 3).batch(4)),
    ]


@pytest.mark.parametrize("name, build", _pipelines(), ids=[p[0] for p in _pipelines()])
def test_dataset_gives_the_jax_datasets_batches(name, build):
    rng = np.random.RandomState(5)
    elems = [({"x": rng.randn(2).astype(np.float32), "i": i}, i) for i in range(23)]
    want = list(build(jax_dataset.Dataset.from_generator(lambda: elems)))
    port_ds = build(port_dataset.Dataset.from_generator(lambda: elems))
    got = list(port_ds)
    assert len(got) == len(want) > 0
    _assert_tree_equal(got, want)
    # a dataset restarts from its source on every iteration
    _assert_tree_equal(list(port_ds), got)


# ---- the task dispatcher ----------------------------------------------------

SHARDS = {"/data/a": (0, 40), "/data/b": (5, 13), "/data/c": (0, 3)}


def _walk_dispatcher(module, records_per_task, num_epochs, shuffle_seed):
    """Lease every task; fail the third lease once; report; return what
    was handed out and the dispatcher's state after each report."""
    d = module.TaskDispatcher(
        SHARDS,
        evaluation_shards={"/data/e": (0, 10)},
        records_per_task=records_per_task,
        num_epochs=num_epochs,
        shuffle_seed=shuffle_seed,
    )
    trail, leases = [], 0
    while True:
        tid, task = d.get(0)
        if task is None:
            break
        leases += 1
        ok = leases != 3
        d.report(tid, ok, {module.FAIL_COUNT: 0 if ok else 1, "time_x_ms": 2})
        counters = {
            int(t): dataclasses.asdict(d.counters(t))
            for t in (TaskType.TRAINING, TaskType.EVALUATION)
        }
        trail.append(
            ((task.shard_name, task.start, task.end, int(task.type)), ok,
             counters, d.snapshot(), d.finished())
        )
    d.create_evaluation_tasks(model_version=7)
    evals = []
    while True:
        tid, task = d.get_eval_task(0)
        if task is None:
            break
        d.report(tid, True)
        evals.append((task.shard_name, task.start, task.end, task.model_version))
    return trail, evals, d.state_snapshot()


@pytest.mark.parametrize(
    "records_per_task, num_epochs, shuffle_seed",
    [(16, 1, 0), (7, 2, 1), (100, 3, None), (4, 1, 12345)],
)
def test_dispatchers_hand_out_the_same_tasks(records_per_task, num_epochs, shuffle_seed):
    if shuffle_seed is None:
        # unseeded shuffles differ from run to run in either package (and
        # so does which task is the third lease, failed and handed out
        # again): the completed tasks are compared as a multiset
        jax_trail, _, _ = _walk_dispatcher(jax_dispatch, records_per_task, num_epochs, None)
        port_trail, _, _ = _walk_dispatcher(port_dispatch, records_per_task, num_epochs, None)
        assert sorted(t[0] for t in jax_trail if t[1]) == sorted(
            t[0] for t in port_trail if t[1]
        )
        assert jax_trail[-1][2] == port_trail[-1][2]
        return
    want = _walk_dispatcher(jax_dispatch, records_per_task, num_epochs, shuffle_seed)
    got = _walk_dispatcher(port_dispatch, records_per_task, num_epochs, shuffle_seed)
    assert got == want
    trail = got[0]
    records = sum(n for _s, (_start, n) in SHARDS.items())
    trained = sum(t[0][2] - t[0][1] for t in trail if t[1])
    assert trained == records * num_epochs
    assert trail[-1][2][int(TaskType.TRAINING)]["failed_records"] == 1


# ---- the per-task minibatch stream ------------------------------------------


@pytest.mark.parametrize("mode", ["training", "evaluation", "prediction"])
def test_build_task_batches_gives_the_same_lm_batches(seq_dirs, mode):
    jax_spec = jax_get_spec("", LM_DEF)
    port_spec = port_get_spec("", LM_DEF)
    assert port_spec.batch_parse is None  # the LM takes the classic path
    path = sorted(os.path.join(seq_dirs["jax"], n) for n in os.listdir(seq_dirs["jax"]))[0]
    task = jax_dispatch.Task(path, 2, 17, TaskType.TRAINING)
    reader = JaxReader(data_dir=seq_dirs["jax"])
    m = JaxModes(mode)
    out = {
        "jax": list(jax_fast.build_task_batches(
            reader, task, jax_spec, m, reader.metadata, 4,
            shuffle_records=m.value == "training", prefetch=2,
        )),
        "port": list(_port_task_batches(
            PortReader(data_dir=seq_dirs["jax"]), task, port_spec, PortModes(mode), 4,
        )),
    }
    assert [len(b[0]["tokens"]) if mode != "prediction" else len(b["tokens"])
            for b in out["port"]] == [4, 4, 4, 3]
    _assert_tree_equal(out["port"], out["jax"])
    first = out["port"][0] if mode == "prediction" else out["port"][0][0]
    assert first["tokens"].dtype == np.int32 and first["tokens"].shape == (4, 64)


class _BatchParseSpec:
    """A model that parses whole decoded minibatches (``batch_parse``)
    and owns its shuffle (``batch_shuffle``)."""

    dataset_fn = None

    def __init__(self, policy):
        self.module = type("module", (), {"batch_shuffle": policy})()

    @staticmethod
    def batch_parse(batch, mode):
        tokens = batch["tokens"].astype(np.int32)
        return {"tokens": tokens[:, :-1]}, tokens[:, 1:]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("policy", [(8, 1), None], ids=["policy", "no_policy"])
def test_batch_parse_models_get_the_jax_fallback_batches(seq_dirs, monkeypatch, shuffle, policy):
    """The port has no native codec: a ``batch_parse`` model takes what
    the JAX chooser falls back to when the native decode is absent."""
    monkeypatch.setattr(jax_fast, "decode_concat_batch", lambda *a: None)
    path = os.path.join(seq_dirs["jax"], sorted(os.listdir(seq_dirs["jax"]))[1])
    task = jax_dispatch.Task(path, 0, 20, TaskType.TRAINING)
    spec = _BatchParseSpec(policy)
    reader = PortReader(data_dir="")
    got = list(port_dataset.batched_model_pipeline(
        port_dataset.Dataset.from_generator(lambda: reader.read_records(task)),
        spec, PortModes.TRAINING, None, 6, shuffle_records=shuffle,
    ))
    want = list(jax_fast.build_task_batches(
        JaxReader(data_dir=""), task, spec, JaxModes.TRAINING, None, 6,
        shuffle_records=shuffle,
    ))
    assert len(got) == 4
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("max_buffered_batches, max_buffered_bytes", [(4, 64 << 20), (1, 1)])
def test_task_prefetcher_streams_the_jax_prefetchers_tasks_and_batches(
    seq_dirs, max_buffered_batches, max_buffered_bytes
):
    """The decode-ahead thread over the LM's task stream, with roomy and
    with one-batch budgets: the same tasks, in the same order, each with
    the same batches."""
    from elasticdl_tpu.trainer.host_pipeline import TaskPrefetcher as JaxPrefetcher
    from elasticdl_tpu_torch.trainer.host_pipeline import TaskPrefetcher as PortPrefetcher

    out = {}
    def jax_batches(task, reader, spec):
        return jax_fast.build_task_batches(
            reader, task, spec, JaxModes.TRAINING, reader.metadata, 3,
            shuffle_records=True,
        )

    def port_batches(task, reader, spec):
        return _port_task_batches(reader, task, spec, PortModes.TRAINING, 3)

    for name, prefetcher_cls, dispatch, reader_cls, get_spec, task_batches in (
        ("jax", JaxPrefetcher, jax_dispatch, JaxReader, jax_get_spec, jax_batches),
        ("port", PortPrefetcher, port_dispatch, PortReader, port_get_spec, port_batches),
    ):
        reader = reader_cls(data_dir=seq_dirs["jax"])
        spec = get_spec("", LM_DEF)
        d = dispatch.TaskDispatcher(
            reader.create_shards(), records_per_task=7, shuffle_seed=4,
        )
        prefetcher = prefetcher_cls(
            lambda d=d: d.get(0),
            lambda task, reader=reader, spec=spec, task_batches=task_batches:
                task_batches(task, reader, spec),
            max_buffered_batches=max_buffered_batches,
            max_buffered_bytes=max_buffered_bytes,
        )
        stream = []
        try:
            for tid, task, batches in prefetcher:
                stream.append(((os.path.basename(task.shard_name), task.start, task.end),
                               list(batches)))
                d.report(tid, True)
        finally:
            prefetcher.close()
        assert d.finished()
        out[name] = stream
    assert [s[0] for s in out["port"]] == [s[0] for s in out["jax"]]
    assert len(out["port"]) == 6
    _assert_tree_equal([s[1] for s in out["port"]], [s[1] for s in out["jax"]])


def test_task_prefetcher_raises_the_producers_error_on_the_consumer():
    from elasticdl_tpu_torch.trainer.host_pipeline import TaskPrefetcher

    tasks = iter([(1, "a"), (2, "b")])

    def batches(task):
        if task == "b":
            raise ValueError("bad record")
        return [np.zeros(2)]

    prefetcher = TaskPrefetcher(lambda: next(tasks, (0, None)), batches)
    seen = []
    with pytest.raises(ValueError, match="bad record"):
        for tid, _task, batch_iter in prefetcher:
            seen.append((tid, len(list(batch_iter))))
    prefetcher.close()
    assert seen == [(1, 1)]


def test_reader_factory_reads_recordio_dirs_and_refuses_other_sources(seq_dirs):
    reader = create_data_reader(seq_dirs["port"], records_per_task=16)
    want = JaxReader(data_dir=seq_dirs["port"]).create_shards()
    assert reader.create_shards() == want and len(want) == 2
    for origin, kwargs in (
        ("stream://topic", {}), ("odps://project/tables/t", {}),
        ("/data/train.csv", {}), ("/data/train", {"reader_type": "CSV"}),
    ):
        with pytest.raises(NotImplementedError, match="slice 9"):
            create_data_reader(origin, **kwargs)
    custom = create_data_reader("x", records_per_task=3, custom_reader=lambda **kw: kw)
    assert custom == {"data_origin": "x", "records_per_task": 3}
