"""Long-context causal transformer LM, the port of
``elasticdl_tpu/models/long_seq_transformer.py``.

Spec contract: ``custom_model`` / ``dataset_fn`` / ``loss`` /
``optimizer`` / ``eval_metrics_fn``, so a manifest the JAX package wrote
(``model_def: long_seq_transformer.long_seq_transformer.custom_model``)
builds this model and the same ``train`` command line trains it: records
are token sequences (``data/recordio_gen/synthetic.py::gen_sequence``),
the task is next-token prediction.  Its attention runs the flash kernels
on CUDA, in both directions when it trains.

Not ported yet: decode mode and ``generate``, MoE, sequence
parallelism.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.layers.attention import (
    LAYER_NORM_EPS,
    TransformerBlock,
    dense,
    layer_norm,
    sinusoidal_positions,
    to_torch_dtype,
)
from elasticdl_tpu_torch.trainer.metrics import Accuracy

VOCAB = 256


def check_token_ids(tokens, vocab_size: int) -> None:
    """Raise on a token id outside ``[0, vocab_size)``.  The JAX model
    gathers with fill semantics (NaN rows); ``F.embedding`` on CUDA would
    hit a device assert that kills the process's CUDA context, so the
    port refuses such ids before they reach the card.  A CUDA graph's
    capture cannot read the card, so there the check is left to the
    stacked path, which makes it on the host group before the copy in
    (``SPMDTrainer.place_group``)."""
    if isinstance(tokens, torch.Tensor):
        if tokens.numel() == 0:
            return
        if tokens.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        lo, hi = (int(x) for x in torch.aminmax(tokens))
    else:
        tokens = np.asarray(tokens)
        if tokens.size == 0:
            return
        lo, hi = int(tokens.min()), int(tokens.max())
    if lo < 0 or hi >= vocab_size:
        raise ValueError(
            f"token ids must lie in [0, {vocab_size}), got [{lo}, {hi}]"
        )


class TransformerLM(nn.Module):
    """Token embedding + sinusoidal positions -> ``num_layers`` causal
    ``TransformerBlock``s -> LayerNorm -> ``lm_head`` logits.

    ``dtype`` (e.g. ``"bfloat16"``) is the compute dtype: activations and
    products run in it, parameters stay f32, logits come out in it."""

    def __init__(
        self,
        vocab_size: int = VOCAB,
        embed_dim: int = 128,
        num_heads: int = 4,
        num_layers: int = 2,
        dropout_rate: float = 0.0,
        num_experts: int = 0,
        num_kv_heads: int = 0,
        dtype=None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.dtype = to_torch_dtype(dtype)
        self.dropout_rate = dropout_rate
        self.tok_embed = nn.Embedding(vocab_size, embed_dim)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                embed_dim, num_heads, causal=True, dropout_rate=dropout_rate,
                num_experts=num_experts, num_kv_heads=num_kv_heads,
                dtype=dtype,
            )
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.lm_head = nn.Linear(embed_dim, vocab_size)

    def validate_features(self, features) -> None:
        """Host-side check of a request's features (serving calls it
        before anything reaches the device)."""
        tokens = features["tokens"] if isinstance(features, dict) else features
        check_token_ids(tokens, self.vocab_size)

    def forward(
        self, features, training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Logits ``(batch, seq, vocab)``.  ``training=True`` turns dropout
        on, with masks drawn from ``generator`` (the train step passes
        ``layers.attention.dropout_generator(step, device)``)."""
        if not training:
            generator = None
        elif self.dropout_rate and generator is None:
            raise ValueError("training with dropout needs a generator")
        tokens = features["tokens"] if isinstance(features, dict) else features
        tokens = torch.as_tensor(tokens, device=self.lm_head.weight.device)
        check_token_ids(tokens, self.vocab_size)
        dt = self.dtype or torch.float32
        x = self.tok_embed(tokens.long()).to(dt)
        x = x + sinusoidal_positions(
            tokens.shape[1], self.embed_dim, device=x.device
        )[None].to(x.dtype)
        for block in self.blocks:
            x = block(x, generator)
        x = layer_norm(x, self.ln_f, self.dtype)
        return dense(x, self.lm_head, self.dtype)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: every matrix N(0, 1/fan_in) (the embedding
    table N(0, 1/embed_dim)), biases 0, LayerNorm scale 1 and bias 0."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                std = 1.0 / math.sqrt(module.in_features)
                module.weight.normal_(0.0, std, generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                std = 1.0 / math.sqrt(module.embedding_dim)
                module.weight.normal_(0.0, std, generator=generator)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


def custom_model(**kwargs):
    return TransformerLM(**kwargs)


def loss(labels, logits):
    """Mean next-token cross entropy, on f32 logits."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    return F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1)
    )


def optimizer(lr=3e-3):
    """A factory: ``optimizer()(model.parameters())`` is Adam at ``lr``
    (torch optimizers take the parameters; optax's did not).  torch's
    Adam and ``optax.adam`` make the same update (b1 0.9, b2 0.999, eps
    1e-8 outside the square root)."""
    return functools.partial(torch.optim.Adam, lr=lr)


def dataset_fn(dataset, mode, metadata):
    """Records -> ``({"tokens": x[:-1]}, x[1:])`` int32 pairs (features
    alone when predicting)."""
    # imported here: trainer.state imports this module (through
    # utils.flax_weights)
    from elasticdl_tpu_torch.trainer.state import Modes

    def _parse(record):
        ex = decode_example(record)
        tokens = ex["tokens"].astype(np.int32)
        feats = {"tokens": tokens[:-1]}
        if mode == Modes.PREDICTION:
            return feats
        return feats, tokens[1:]

    return dataset.map(_parse)


def eval_metrics_fn():
    return {"accuracy": Accuracy()}
