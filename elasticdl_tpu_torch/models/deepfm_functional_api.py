"""DeepFM over sparse feature ids (frappe-style data); the port of
``elasticdl_tpu/models/deepfm_functional_api.py``.

Ids ``(batch, 10)`` with 0 as padding (``mask_zero``); an embedding
table (5383 x 64, rows padded to a multiple of 128) feeds a
second-order FM term ``0.5 * sum((sum e)^2 - sum e^2)``, a first-order
per-id bias table, and a flatten -> Dense(64) -> Dense(1) deep tower;
logits = FM + deep.  Outputs ``{"logits": (b,), "probs": (b, 1)}``;
sigmoid cross entropy on the logits; SGD(0.1); accuracy on the logits
and AUC on the probabilities; a ``custom_data_reader`` hook.

Ids cross to the device at the narrowest wire dtype the vocabulary
allows (int16 for 5383) and widen to int32 there, in the model.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.layers.initializers import flax_default_init_
from elasticdl_tpu_torch.trainer.metrics import AUC, BinaryAccuracy
from elasticdl_tpu_torch.trainer.state import Modes

# the tables' rows are padded to a multiple of this (the JAX package pads
# so that a table shards evenly over any mesh axis; the padded rows are
# never looked up)
VOCAB_PAD_MULTIPLE = 128
# frappe's vocabulary
DEFAULT_INPUT_DIM = 5383


class DeepFM(nn.Module):
    def __init__(
        self,
        input_dim: int = DEFAULT_INPUT_DIM,
        embedding_dim: int = 64,
        input_length: int = 10,
        fc_unit: int = 64,
    ):
        super().__init__()
        self.input_dim = input_dim
        self.embedding = Embedding(
            input_dim, embedding_dim, vocab_pad_multiple=VOCAB_PAD_MULTIPLE
        )
        self.id_bias = Embedding(
            input_dim, 1, vocab_pad_multiple=VOCAB_PAD_MULTIPLE
        )
        # flax names the deep tower's layers in the order it constructs
        # them: Dense_0 is the output layer, Dense_1 the hidden one
        self.dense_hidden = nn.Linear(input_length * embedding_dim, fc_unit)
        self.dense_out = nn.Linear(fc_unit, 1)
        for layer in (self.dense_hidden, self.dense_out):
            flax_default_init_(layer)

    def forward(self, features, training: bool = False, generator=None):
        """``{"logits": (b,), "probs": (b, 1)}``; the model has no
        dropout and no statistics, so ``training`` changes nothing."""
        ids = features["feature"] if isinstance(features, dict) else features
        ids = torch.as_tensor(ids, device=self.dense_out.weight.device)
        ids = ids.to(torch.int32)  # the wire dtype widens on the device
        mask = (ids != 0).to(torch.float32).unsqueeze(-1)  # mask_zero

        emb = self.embedding(ids) * mask
        emb_sum = emb.sum(1)
        second_order = 0.5 * (emb_sum.square() - emb.square().sum(1)).sum(1)
        first_order = (self.id_bias(ids) * mask).sum((1, 2))
        fm_output = first_order + second_order

        nn_input = emb.reshape(emb.shape[0], -1)
        deep = self.dense_out(self.dense_hidden(nn_input)).reshape(-1)

        logits = fm_output + deep
        return {"logits": logits, "probs": torch.sigmoid(logits).reshape(-1, 1)}


# The wire dtype of the id column, resolved from the BUILT model's
# input_dim by custom_model (int16 while every id of the vocabulary fits),
# never from the data: batch_parse is a module function, so the value
# lives beside it, and one model gives one dtype for every batch.  An id
# an int16 wire cannot carry is >= 2^15 > input_dim, outside the
# vocabulary, so batch_parse refuses it as corrupt data.
_ID_WIRE_DTYPE = np.int16


def _id_wire_dtype(input_dim: int):
    return np.int16 if input_dim <= np.iinfo(np.int16).max else np.int32


def custom_model(**kwargs):
    global _ID_WIRE_DTYPE
    model = DeepFM(**kwargs)
    _ID_WIRE_DTYPE = _id_wire_dtype(model.input_dim)
    return model


def loss(labels, predictions):
    logits = predictions["logits"].reshape(-1)
    labels = torch.as_tensor(labels, device=logits.device)
    return F.binary_cross_entropy_with_logits(
        logits, labels.reshape(-1).to(torch.float32)
    )


def optimizer(lr=0.1):
    """A factory: ``optimizer()(model.parameters())`` is plain SGD at
    ``lr``, ``optax.sgd``'s update."""
    return functools.partial(torch.optim.SGD, lr=lr)


def dataset_fn(dataset, mode, metadata):
    def _parse(record):
        ex = decode_example(record)
        feature = ex["feature"].astype(np.int32)
        if mode == Modes.PREDICTION:
            return {"feature": feature}
        return {"feature": feature}, ex["label"].astype(np.int32)

    dataset = dataset.map(_parse)
    if mode == Modes.TRAINING:
        dataset = dataset.shuffle(1024, seed=0)
    return dataset


def batch_parse(example_batch, mode):
    """The batched ``dataset_fn``: ids at the wire dtype of the built
    model's vocabulary, int32 labels.  Ids are checked, never coerced: a
    negative id, or one past the wire dtype's range (so past the
    vocabulary), raises as corrupt data."""
    ids = example_batch["feature"]
    if ids.size:
        lo = int(ids.min())
        if lo < 0:
            raise ValueError(
                f"negative feature id {lo}: deepfm ids must be >= 0 "
                "(0 is the mask_zero padding id) — the record data is "
                "corrupt"
            )
        hi = int(ids.max())
        if hi > np.iinfo(_ID_WIRE_DTYPE).max:
            raise ValueError(
                f"feature id {hi} exceeds {np.dtype(_ID_WIRE_DTYPE).name} "
                "range, so it is past the largest input_dim that dtype "
                "resolves for — outside the embedding vocab (corrupt "
                "data, or the model was built with a smaller input_dim "
                "than the dataset needs: pass --model_params "
                "input_dim=...)"
            )
    feature = ids.astype(_ID_WIRE_DTYPE)
    if mode == Modes.PREDICTION:
        return {"feature": feature}
    return {"feature": feature}, example_batch["label"].astype(np.int32)


def eval_metrics_fn():
    return {
        "accuracy": {"logits": BinaryAccuracy(from_logits=True)},
        "auc": {"probs": AUC()},
    }


def custom_data_reader(data_origin, records_per_task=None, **kwargs):
    from elasticdl_tpu_torch.data.recordio_reader import RecordIODataReader

    return RecordIODataReader(data_dir=data_origin)
