"""DeepFM with distribution-eligible embedding tables; the port of
``elasticdl_tpu/models/deepfm_edl_embedding.py``, whose model body is
the functional DeepFM's (re-exported here).

The JAX module also exports ``sharding_rules(mesh)``, which forces the
two tables onto the mesh's embedding axis.  On one device there is no
axis to shard over, so the port leaves it out; it comes with the port's
sharded embeddings (``ROADMAP.md`` queue 1), and a job of this model
runs meanwhile with both tables whole on its one device.
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
