"""The port's native EDLIO codec and its vectorized task pipeline against
the JAX package's, on the CPU.

Held equal, byte for byte or element for element: the shards the two
packages' generators write (``gen_mnist``, ``gen_frappe``); the files the
port's native writer, the JAX package's native writer and its Python
writer make of the same payloads; the port's native batch decode and its
per-record decode; and the minibatches the two packages'
``build_task_batches`` make of the same task with the same seed (each
package builds its own codec, ``ensure_native_codec``)."""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest

from elasticdl_tpu.data import fast_pipeline as jax_fast
from elasticdl_tpu.data import recordio as jax_recordio
from elasticdl_tpu.data.recordio import _pyimpl as jax_pyimpl
from elasticdl_tpu.data.recordio_gen import synthetic as jax_synthetic
from elasticdl_tpu.data.recordio_reader import RecordIODataReader as JaxReader
from elasticdl_tpu.trainer.state import Modes as JaxModes
from elasticdl_tpu.utils.model_utils import get_model_spec as jax_get_model_spec
from elasticdl_tpu_torch.data import fast_pipeline, recordio
from elasticdl_tpu_torch.data import reader as port_reader
from elasticdl_tpu_torch.data.recordio import _pyimpl
from elasticdl_tpu_torch.data.recordio import build as build_mod
from elasticdl_tpu_torch.data.recordio_gen import synthetic
from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader
from elasticdl_tpu_torch.master.task_dispatcher import Task
from elasticdl_tpu_torch.trainer.state import Modes
from elasticdl_tpu_torch.utils.constants import TaskType
from elasticdl_tpu_torch.utils.model_utils import get_model_spec

MNIST_DEF = "mnist_functional_api.mnist_functional_api.custom_model"
DEEPFM_DEF = "deepfm_edl_embedding.deepfm_edl_embedding.custom_model"


@pytest.fixture(scope="module", autouse=True)
def codecs():
    """Both packages' native codecs, built (or found) once."""
    jax_recordio.ensure_native_codec()
    return recordio.ensure_native_codec()


def _files(directory):
    return {
        name: open(os.path.join(directory, name), "rb").read()
        for name in sorted(os.listdir(directory))
    }


@pytest.mark.parametrize(
    "gen, kwargs",
    [
        ("gen_mnist", dict(num_records=37, num_shards=3, seed=5)),
        ("gen_frappe", dict(num_records=101, num_shards=4, seed=2, vocab_size=512)),
        ("gen_frappe", dict(num_records=64, num_shards=1, seed=0)),
    ],
    ids=["mnist", "frappe-512", "frappe-5383"],
)
def test_generated_shards_are_byte_identical_to_jax(tmp_path, gen, kwargs):
    port_dir = getattr(synthetic, gen)(str(tmp_path / "port"), **kwargs)
    jax_dir = getattr(jax_synthetic, gen)(str(tmp_path / "jax"), **kwargs)
    port, want = _files(port_dir), _files(jax_dir)
    assert sorted(port) == sorted(want) and len(port) == kwargs["num_shards"]
    for name in want:
        assert port[name] == want[name], name


PAYLOADS = [b"", b"a", b"hello world", bytes(range(256)) * 40, b"\x00" * 7]


def test_native_writer_files_are_byte_identical_to_jax_writers(tmp_path):
    assert recordio.native_available()
    paths = {k: str(tmp_path / f"{k}.edlio") for k in ("port", "jax", "jax_py", "port_py")}
    for key, writer in (
        ("port", recordio.Writer), ("jax", jax_recordio.Writer),
        ("jax_py", jax_pyimpl.Writer), ("port_py", _pyimpl.Writer),
    ):
        with writer(paths[key]) as w:
            for payload in PAYLOADS:
                w.write(payload)
    assert isinstance(recordio.Writer(str(tmp_path / "x")), recordio._NativeWriter)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["port"] == data["jax"] == data["jax_py"] == data["port_py"]
    # the port's native scanner reads every range of it back
    assert recordio.num_records(paths["port"]) == len(PAYLOADS)
    for start, length in ((0, -1), (1, 3), (4, 1), (5, 2)):
        with recordio.Scanner(paths["jax"], start, length) as scanner:
            got = list(scanner)
        stop = len(PAYLOADS) if length < 0 else start + length
        assert got == PAYLOADS[start:stop]


def _task(path, start, end):
    return Task(path, start, end, TaskType.TRAINING)


def test_native_batch_decode_equals_per_record_decode(tmp_path):
    data = synthetic.gen_frappe(str(tmp_path), num_records=300, num_shards=1, seed=3)
    path = os.path.join(data, sorted(os.listdir(data))[0])
    reader = RecordIODataReader(data_dir=data)
    records = list(reader.read_records(_task(path, 0, 300)))
    want = {
        k: np.stack([port_reader.decode_example(r)[k] for r in records])
        for k in ("feature", "label")
    }
    # one C call over a list of payloads
    got = port_reader.decode_example_batch(records)
    # and over the scanner's concatenated chunks, zero-copy
    chunks = []
    for buf, lengths in reader.read_record_chunks(_task(path, 10, 290)):
        template = port_reader.decode_example(bytes(buf[: int(lengths[0])]))
        chunks.append(port_reader.decode_concat_batch(buf, lengths, template))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(np.concatenate([c[k] for c in chunks]), v[10:290])


def test_native_decode_refuses_a_record_off_the_schema():
    a = port_reader.encode_example({"x": np.arange(3, dtype=np.int64)})
    b = port_reader.encode_example({"x": np.arange(4, dtype=np.int64)})
    template = port_reader.decode_example(a)
    buf = np.frombuffer(a + b, np.uint8)
    lengths = np.array([len(a), len(b)], np.uint64)
    assert port_reader.decode_concat_batch(buf, lengths, template) is None
    # the batch decoder then decodes record by record, and np.stack
    # refuses the ragged pair as it does in the JAX package
    with pytest.raises(ValueError):
        port_reader.decode_example_batch([a, b])


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "_native.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(build_mod, "SOURCE", broken)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        build_mod.build()
    assert not any((tmp_path / "build").iterdir())


def test_a_library_name_follows_its_source(tmp_path, monkeypatch):
    source = tmp_path / "_native.cc"
    source.write_text("// one\n")
    monkeypatch.setattr(build_mod, "SOURCE", source)
    first = build_mod.library_path()
    source.write_text("// two\n")
    assert build_mod.library_path() != first


def _both_specs(model_def, **params):
    port = get_model_spec("", model_def, model_params=params)
    jax = jax_get_model_spec("", model_def, model_params=params)
    # the DeepFM modules resolve their id wire dtype when the model is built
    port.build_model(), jax.build_model()
    return port, jax


def _batches(fast, reader, task, spec, mode, batch_size):
    out = []
    for batch in fast.build_task_batches(
        reader, task, spec, mode, reader.metadata, batch_size,
        shuffle_records=mode.value == "training",
    ):
        leaves = batch if isinstance(batch, tuple) else (batch,)
        out.append([
            np.asarray(leaf["image" if "image" in leaf else "feature"])
            if isinstance(leaf, dict) else np.asarray(leaf)
            for leaf in leaves
        ])
    return out


@pytest.mark.parametrize(
    "model_def, gen, params, task_range, batch_size",
    [
        (MNIST_DEF, "gen_mnist", {}, (3, 200), 16),
        (DEEPFM_DEF, "gen_frappe", {"input_dim": 5383}, (0, 5000), 512),
    ],
    ids=["mnist", "deepfm"],
)
@pytest.mark.parametrize("mode", ["training", "evaluation", "prediction"])
def test_task_batches_match_jax(
    tmp_path, model_def, gen, params, task_range, batch_size, mode
):
    """The same task, seed and batch size give the same minibatches from
    both packages' vectorized paths (a window of 5000 frappe records
    spans two scanner chunks)."""
    n = max(task_range[1], 256)
    data = getattr(synthetic, gen)(str(tmp_path), num_records=n, num_shards=1, seed=1)
    path = os.path.join(data, os.listdir(data)[0])
    port_spec, jax_spec = _both_specs(model_def, **params)
    task = _task(path, *task_range)
    fast_pipeline.reset_path_counts()
    got = _batches(
        fast_pipeline, RecordIODataReader(data_dir=data), task, port_spec,
        Modes(mode), batch_size,
    )
    want = _batches(
        jax_fast, JaxReader(data_dir=data), task, jax_spec, JaxModes(mode),
        batch_size,
    )
    rows = task_range[1] - task_range[0]
    assert len(got) == len(want) == -(-rows // batch_size)
    assert fast_pipeline.path_counts == {"vectorized": len(got), "classic": 0}
    for g, w in zip(got, want):
        assert len(g) == len(w) == (1 if mode == "prediction" else 2)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if mode == "training":
        # shuffled: the first batch is not the task's first records
        unshuffled = _batches(
            fast_pipeline, RecordIODataReader(data_dir=data), task, port_spec,
            Modes.EVALUATION, batch_size,
        )
        assert not np.array_equal(got[0][0], unshuffled[0][0])


def test_data_the_native_decoder_cannot_batch_takes_the_classic_path(tmp_path):
    """A shard whose first records differ in shape fails the first-chunk
    probe: the task's batches come from the classic path, counted as
    such, with every record once."""
    path = str(tmp_path / "ragged.edlio")
    with recordio.Writer(path) as w:
        for i in range(10):
            w.write(port_reader.encode_example({
                "feature": np.arange(1 + i % 2, dtype=np.int64),
                "label": np.int64(i),
            }))
    spec = SimpleNamespace(
        batch_parse=lambda batch, mode: (batch["feature"], batch["label"]),
        dataset_fn=None, module=None,
    )
    fast_pipeline.reset_path_counts()
    reader = RecordIODataReader(data_dir=str(tmp_path))
    batches = fast_pipeline.build_task_batches(
        reader, _task(path, 0, 2), spec, Modes.EVALUATION, reader.metadata, 1,
    )
    assert [int(labels[0]) for _f, labels in batches] == [0, 1]
    assert fast_pipeline.path_counts == {"vectorized": 0, "classic": 2}


def test_chunked_reads_build_the_codec_or_raise(tmp_path, monkeypatch):
    data = synthetic.gen_frappe(str(tmp_path / "d"), num_records=8, num_shards=1)
    path = os.path.join(data, os.listdir(data)[0])
    reader = RecordIODataReader(data_dir=data)
    calls = []
    monkeypatch.setattr(recordio, "ensure_native_codec", lambda: calls.append(1))
    assert sum(len(lengths) for _b, lengths in reader.read_record_chunks(_task(path, 0, 8))) == 8
    assert calls == [1]

    def no_compiler():
        raise RuntimeError("g++ failed to build the native EDLIO codec")

    monkeypatch.setattr(recordio, "ensure_native_codec", no_compiler)
    spec = get_model_spec("", DEEPFM_DEF, model_params={"input_dim": 5383})
    spec.build_model()
    batches = fast_pipeline.build_task_batches(
        reader, _task(path, 0, 8), spec, Modes.TRAINING, reader.metadata, 4,
    )
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        list(batches)
