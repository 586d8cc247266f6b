"""DeepFM with distribution-eligible embedding tables; the port of
``elasticdl_tpu/models/deepfm_edl_embedding.py``, whose model body is
the functional DeepFM's (re-exported here).

:func:`sharding_rules` forces the two tables onto the mesh's embedding
axis (ep > tp > fsdp; never dp), as the JAX module's does.  The port's
worlds have only ``dp`` until slice 8, so there it returns no rule and
the tables stay whole on every process, as JAX's do on a dp-only mesh;
``deepfm_sharded_embedding`` is the variant that falls back to dp.
"""

from __future__ import annotations

from elasticdl_tpu_torch.layers.embedding import padded_rows
from elasticdl_tpu_torch.models.deepfm_functional_api import (  # noqa: F401
    DEFAULT_INPUT_DIM,
    VOCAB_PAD_MULTIPLE,
    DeepFM,
    batch_parse,
    custom_data_reader,
    custom_model,
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
)

# the padded table height the layers allocate (5504)
PADDED_VOCAB = padded_rows(DEFAULT_INPUT_DIM, VOCAB_PAD_MULTIPLE)


def sharding_rules(mesh):
    """Row-shard both tables over the first of ep > tp > fsdp that
    divides the padded vocabulary; [] (whole tables) when none does."""
    from elasticdl_tpu_torch.embeddings import embedding_axis
    from elasticdl_tpu_torch.parallel.mesh import Rule

    axis = embedding_axis(mesh, rows=PADDED_VOCAB, allow_dp=False)
    if axis is None:
        return []
    return [
        Rule(r"(^|/)embedding/embedding$", (axis, None)),
        Rule(r"(^|/)id_bias/embedding$", (axis, None)),
    ]
