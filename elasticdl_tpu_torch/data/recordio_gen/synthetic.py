"""Synthetic token sequences for the LM; a copy of ``gen_sequence`` and
``_write_shards`` from ``elasticdl_tpu/data/recordio_gen/synthetic.py``,
so that data can be made where JAX is absent.  The same ``RandomState``
seeds give the same records, written in the same EDLIO shards.
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
