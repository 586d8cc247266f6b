"""DeepFM over row-sharded embedding tables; the port of
``elasticdl_tpu/models/deepfm_sharded_embedding.py``.

The DeepFM of ``deepfm_functional_api``; what differs is where its two
tables may live.  :func:`sharding_rules` routes them through
``embeddings.sharded_table_rules``, which falls back to ``dp``: in a
world of two or more processes each process holds only its rows of both
tables (``embeddings/sharded.py``), and they re-shard by global row id
when the world re-forms.  Alone on one card, as ``bench.py``'s
``deepfm_100m`` (``input_dim=100000000``) runs, the tables are whole,
built on the card.
"""

from __future__ import annotations

from elasticdl_tpu_torch.layers.embedding import padded_rows
from elasticdl_tpu_torch.models import deepfm_functional_api as _base
from elasticdl_tpu_torch.models.deepfm_functional_api import (  # noqa: F401
    DEFAULT_INPUT_DIM,
    VOCAB_PAD_MULTIPLE,
    DeepFM,
    batch_parse,
    custom_data_reader,
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
)

# the padded table height of the latest custom_model() (an input_dim
# override, as bench's, keeps the rules true to what the layers allocate)
_padded_vocab = padded_rows(DEFAULT_INPUT_DIM, VOCAB_PAD_MULTIPLE)


def custom_model(**kwargs):
    global _padded_vocab
    model = _base.custom_model(**kwargs)
    _padded_vocab = padded_rows(model.input_dim, VOCAB_PAD_MULTIPLE)
    return model


def sharding_rules(mesh):
    """Row-shard both tables over the embedding axis (ep > tp > fsdp >
    dp); [] on a single-process world."""
    from elasticdl_tpu_torch.embeddings import sharded_table_rules

    return sharded_table_rules(
        mesh,
        {
            "embedding/embedding": _padded_vocab,
            "id_bias/embedding": _padded_vocab,
        },
    )
