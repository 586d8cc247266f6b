"""Learnable synthetic datasets; copies of the generators of
``elasticdl_tpu/data/recordio_gen/synthetic.py`` and their helpers, so
that data can be made where JAX is absent.  The same arguments and
``RandomState`` seeds give the same records, written in byte-identical
EDLIO shards.

Schemas:

- mnist:    image uint8 [28, 28], label int64
- cifar10:  image uint8 [32, 32, 3], label int64
- frappe:   feature int64 [10] ids, label int64
- census:   13 named columns + label
- heart:    13 named columns + target
- iris:     features float32 [4], label int64
- sequence: tokens int64 [seq_len + 1]

``python -m elasticdl_tpu_torch.data.recordio_gen.synthetic DATASET
OUT_DIR`` writes one of them.
"""

from __future__ import annotations

import os

import numpy as np

from elasticdl_tpu_torch.data import recordio
from elasticdl_tpu_torch.data.reader import encode_example


def _write_shards(out_dir, name, examples, num_shards):
    os.makedirs(out_dir, exist_ok=True)
    per = (len(examples) + num_shards - 1) // num_shards
    for s in range(num_shards):
        chunk = examples[s * per : (s + 1) * per]
        if not chunk:
            continue
        with recordio.Writer(
            os.path.join(out_dir, f"{name}-{s:03d}.edlio")
        ) as w:
            for ex in chunk:
                w.write(encode_example(ex))
    return out_dir


def _class_template_images(rng, num_classes, shape):
    """One smooth random template per class; samples = template + noise."""
    templates = rng.uniform(0, 255, size=(num_classes, *shape))
    return templates


def gen_mnist(
    out_dir: str,
    num_records: int = 2048,
    num_shards: int = 4,
    seed: int = 0,
    image_shape=(28, 28),
    num_classes: int = 10,
):
    # class templates come from a fixed RNG so train/eval/predict splits
    # (different `seed`s) share one underlying distribution
    templates = _class_template_images(
        np.random.RandomState(1234), num_classes, image_shape
    )
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(num_records):
        label = rng.randint(num_classes)
        img = templates[label] + rng.normal(0, 32.0, size=image_shape)
        examples.append(
            {
                "image": np.clip(img, 0, 255).astype(np.uint8),
                "label": np.int64(label),
            }
        )
    return _write_shards(out_dir, "mnist", examples, num_shards)


def gen_cifar10(
    out_dir: str, num_records: int = 1024, num_shards: int = 4, seed: int = 0
):
    templates = _class_template_images(
        np.random.RandomState(1234), 10, (32, 32, 3)
    )
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(num_records):
        label = rng.randint(10)
        img = templates[label] + rng.normal(0, 32.0, size=(32, 32, 3))
        examples.append(
            {
                "image": np.clip(img, 0, 255).astype(np.uint8),
                "label": np.int64(label),
            }
        )
    return _write_shards(out_dir, "cifar10", examples, num_shards)


def gen_frappe(
    out_dir: str,
    num_records: int = 4096,
    num_shards: int = 4,
    seed: int = 0,
    num_features: int = 10,
    vocab_size: int = 5383,
):
    """Sparse-id dataset for the DeepFM models: the label is a function of a
    hidden per-id weight vector so factorization models can learn it."""
    id_weights = np.random.RandomState(1234).normal(0, 1.0, size=vocab_size)
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(num_records):
        ids = rng.randint(0, vocab_size, size=num_features).astype(np.int64)
        score = id_weights[ids].sum()
        examples.append(
            {"feature": ids, "label": np.int64(score > 0)}
        )
    return _write_shards(out_dir, "frappe", examples, num_shards)


CENSUS_NUMERIC = ["age", "capital-gain", "capital-loss", "hours-per-week"]
CENSUS_CATEGORICAL = [
    "workclass",
    "education",
    "marital-status",
    "occupation",
    "relationship",
    "race",
    "sex",
    "native-country",
    "education-num",
]
CENSUS_VOCAB = 100


def gen_census(
    out_dir: str,
    num_records: int = 4096,
    num_shards: int = 4,
    seed: int = 0,
    vocab_size: int = CENSUS_VOCAB,
):
    rng_w = np.random.RandomState(1234)
    cat_weights = {
        c: rng_w.normal(0, 1.0, size=vocab_size) for c in CENSUS_CATEGORICAL
    }
    num_weights = rng_w.normal(0, 1.0, size=len(CENSUS_NUMERIC))
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(num_records):
        numeric = rng.normal(0, 1.0, size=len(CENSUS_NUMERIC))
        cats = {
            c: np.int64(rng.randint(vocab_size))
            for c in CENSUS_CATEGORICAL
        }
        score = float(numeric @ num_weights) + sum(
            cat_weights[c][int(v)] for c, v in cats.items()
        )
        ex = {
            name: np.float32(val)
            for name, val in zip(CENSUS_NUMERIC, numeric)
        }
        ex.update(cats)
        ex["label"] = np.int64(score > 0)
        examples.append(ex)
    return _write_shards(out_dir, "census", examples, num_shards)


HEART_COLUMNS = [
    "age",
    "sex",
    "cp",
    "trestbps",
    "chol",
    "fbs",
    "restecg",
    "thalach",
    "exang",
    "oldpeak",
    "slope",
    "ca",
    "thal",
]


def gen_heart(
    out_dir: str, num_records: int = 2048, num_shards: int = 2, seed: int = 0
):
    weights = np.random.RandomState(1234).normal(0, 1.0, size=len(HEART_COLUMNS))
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(num_records):
        feats = rng.normal(0, 1.0, size=len(HEART_COLUMNS))
        ex = {
            name: np.float32(v) for name, v in zip(HEART_COLUMNS, feats)
        }
        ex["target"] = np.int64(feats @ weights > 0)
        examples.append(ex)
    return _write_shards(out_dir, "heart", examples, num_shards)


def gen_iris(
    out_dir: str, num_records: int = 512, num_shards: int = 2, seed: int = 0
):
    centers = np.random.RandomState(1234).normal(0, 3.0, size=(3, 4))
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(num_records):
        label = rng.randint(3)
        feats = centers[label] + rng.normal(0, 0.5, size=4)
        examples.append(
            {
                "features": feats.astype(np.float32),
                "label": np.int64(label),
            }
        )
    return _write_shards(out_dir, "iris", examples, num_shards)


def gen_sequence(
    out_dir: str,
    num_records: int = 1024,
    num_shards: int = 2,
    seed: int = 0,
    seq_len: int = 128,
    vocab: int = 256,
    noise: float = 0.05,
):
    """Token sequences for the long-context transformer: a fixed random
    permutation Markov chain (next = perm[cur], flipped to a random token
    with prob ``noise``), so next-token prediction is learnable to
    ~(1 - noise) accuracy.  Records carry seq_len + 1 tokens; dataset_fn
    shifts them into (input, target) pairs."""
    perm = np.random.RandomState(1234).permutation(vocab)
    rng = np.random.RandomState(seed)
    examples = []
    for _ in range(num_records):
        tokens = np.empty(seq_len + 1, dtype=np.int64)
        tokens[0] = rng.randint(vocab)
        for t in range(1, seq_len + 1):
            if rng.rand() < noise:
                tokens[t] = rng.randint(vocab)
            else:
                tokens[t] = perm[tokens[t - 1]]
        examples.append({"tokens": tokens})
    return _write_shards(out_dir, "sequence", examples, num_shards)


GENERATORS = {
    "mnist": gen_mnist,
    "sequence": gen_sequence,
    "cifar10": gen_cifar10,
    "frappe": gen_frappe,
    "census": gen_census,
    "heart": gen_heart,
    "iris": gen_iris,
}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate synthetic EDLIO data")
    p.add_argument("dataset", choices=sorted(GENERATORS))
    p.add_argument("out_dir")
    p.add_argument("--num_records", type=int, default=None)
    p.add_argument("--num_shards", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    kwargs = dict(num_shards=a.num_shards, seed=a.seed)
    if a.num_records:
        kwargs["num_records"] = a.num_records
    out = GENERATORS[a.dataset](a.out_dir, **kwargs)
    print(out)


if __name__ == "__main__":
    main()
