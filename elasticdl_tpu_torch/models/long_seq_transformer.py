"""Long-context causal transformer LM, the port of
``elasticdl_tpu/models/long_seq_transformer.py``.

Spec contract: ``custom_model`` / ``dataset_fn`` / ``loss`` /
``optimizer`` / ``eval_metrics_fn``, so a manifest the JAX package wrote
(``model_def: long_seq_transformer.long_seq_transformer.custom_model``)
builds this model and the same ``train`` command line trains it: records
are token sequences (``data/recordio_gen/synthetic.py::gen_sequence``),
the task is next-token prediction.  Its attention runs the flash kernels
on CUDA, in both directions when it trains.

:func:`generate` decodes autoregressively with KV caches: a copy of the
model in decode mode (``decode=True``) takes one token per call, and an
explicit :class:`DecodeCache` (each layer's :class:`KVCache` and the
one cursor ``pos``) replaces the JAX model's ``cache`` collection.

Not ported yet: MoE, sequence parallelism.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.data.reader import decode_example
from elasticdl_tpu_torch.layers.attention import (
    LAYER_NORM_EPS,
    KVCache,
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


class DecodeCache:
    """A decode-mode model's state between calls: each layer's
    :class:`KVCache`, the sinusoidal encoding over ``max_decode_len``
    positions, and ``pos``, the one cursor that the position encoding
    and every layer's cache write read (the JAX model's ``cache/pos``).
    Made by :meth:`TransformerLM.init_cache`; each call advances ``pos``
    by one."""

    def __init__(self, layers: list[KVCache], positions: torch.Tensor):
        self.layers = layers
        self.positions = positions
        self.pos = 0


class TransformerLM(nn.Module):
    """Token embedding + sinusoidal positions -> ``num_layers`` causal
    ``TransformerBlock``s -> LayerNorm -> ``lm_head`` logits.

    ``dtype`` (e.g. ``"bfloat16"``) is the compute dtype: activations and
    products run in it, parameters stay f32, logits come out in it.
    ``decode=True`` (with ``max_decode_len``) takes one token per call
    against a :class:`DecodeCache` passed as ``cache``."""

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
        decode: bool = False,
        max_decode_len: int = 0,
    ):
        super().__init__()
        # the constructor's arguments, for a decode-mode copy (generate)
        self.config = dict(
            vocab_size=vocab_size, embed_dim=embed_dim, num_heads=num_heads,
            num_layers=num_layers, dropout_rate=dropout_rate,
            num_experts=num_experts, num_kv_heads=num_kv_heads, dtype=dtype,
        )
        self.decode = decode
        self.max_decode_len = max_decode_len
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
                dtype=dtype, decode=decode, max_decode_len=max_decode_len,
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

    def init_cache(self, batch: int) -> DecodeCache:
        """An empty :class:`DecodeCache` for ``batch`` rows on the
        model's device, its KV caches in the compute dtype."""
        if not self.decode:
            raise ValueError("init_cache needs a decode-mode model (decode=True)")
        if not self.max_decode_len:
            raise ValueError("decode=True needs max_decode_len")
        device = self.lm_head.weight.device
        dt = self.dtype or torch.float32
        return DecodeCache(
            [block.attn.empty_cache(batch, dt, device) for block in self.blocks],
            sinusoidal_positions(self.max_decode_len, self.embed_dim, device=device),
        )

    def forward(
        self, features, training: bool = False,
        generator: torch.Generator | None = None,
        cache: DecodeCache | None = None,
    ) -> torch.Tensor:
        """Logits ``(batch, seq, vocab)``.  ``training=True`` turns dropout
        on, with masks drawn from ``generator`` (the train step passes
        ``layers.attention.dropout_generator(step, device)``).  In decode
        mode ``cache`` is required and advances by one position; the
        caller checks the token ids (:func:`generate` checks the prompt
        once)."""
        if not training:
            generator = None
        elif self.dropout_rate and generator is None:
            raise ValueError("training with dropout needs a generator")
        tokens = features["tokens"] if isinstance(features, dict) else features
        tokens = torch.as_tensor(tokens, device=self.lm_head.weight.device)
        dt = self.dtype or torch.float32
        if self.decode:
            if cache is None:
                raise ValueError("decode mode needs a DecodeCache (init_cache)")
            pos = cache.pos
            if pos >= self.max_decode_len:
                raise ValueError(
                    f"decode cursor {pos} is past max_decode_len {self.max_decode_len}"
                )
            x = self.tok_embed(tokens.long()).to(dt)
            x = x + cache.positions[pos:pos + 1][None].to(x.dtype)
            for block, layer_cache in zip(self.blocks, cache.layers):
                x = block(x, generator, decode_pos=pos, cache=layer_cache)
            cache.pos = pos + 1
        else:
            check_token_ids(tokens, self.vocab_size)
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


def _flat_params(params) -> dict:
    """A flax parameter tree (nested dicts) or its flat ``/``-joined
    form, as the flat dict ``utils/flax_weights.py`` reads."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(f"{prefix}/{key}" if prefix else str(key), value)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    return flat


def generate(
    params,
    prompt,
    num_steps: int,
    model: TransformerLM | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    rng: torch.Generator | None = None,
    device=None,
    **model_kwargs,
) -> torch.Tensor:
    """Autoregressive generation with KV caches, the JAX package's
    ``generate`` with its arguments and errors.

    ``params``: the flax parameter tree (or its flat form), carried into
    the port through ``utils/flax_weights.py``; None takes ``model``'s
    own weights.  ``model``: a :class:`TransformerLM` whose
    hyperparameters (and, with ``params=None``, weights) the decode model
    takes; else ``model_kwargs`` name them.  ``prompt``: ``(batch,
    prompt_len)`` int tokens, checked against the vocabulary once.
    ``temperature <= 0`` decodes greedily; ``> 0`` samples from
    ``softmax(logits / temperature)``, cut to the ``top_k`` most likely
    tokens (clamped to the vocab) when ``top_k > 0``, with ``rng`` (a
    ``torch.Generator`` on the model's device; its bits are not JAX's).
    ``device``: where the decode model runs when ``model`` is None (CUDA
    unless the caller asks for the CPU); else ``model``'s device.

    The prompt is prefilled one token at a time, as in JAX, and the
    final step's forward (whose token would be unused) is skipped.
    Returns ``(batch, prompt_len + num_steps)`` int64 tokens on the
    model's device."""
    from elasticdl_tpu_torch.utils import flax_weights
    from elasticdl_tpu_torch.utils.device import resolve_device

    if model is not None and model_kwargs:
        raise ValueError(
            "pass either a model or model_kwargs, not both "
            f"(got model + {sorted(model_kwargs)})"
        )
    if temperature > 0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs an rng generator")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if params is None and model is None:
        raise ValueError("generate needs params or a model with weights")
    if model is not None:
        dev = model.lm_head.weight.device
        config = dict(model.config)
    else:
        dev = resolve_device("cuda" if device is None else device)
        config = dict(model_kwargs)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64).to(dev)
    batch, prompt_len = prompt.shape
    max_len = prompt_len + num_steps
    # built without initialising (meta tensors), then given the weights:
    # a gpt2s-sized random init on the host would cost seconds a call
    with torch.device("meta"):
        decode_model = TransformerLM(**config, decode=True, max_decode_len=max_len)
    if params is not None:
        weights = flax_weights.torch_state_from_flax(_flat_params(params), decode_model)
    else:
        weights = model.state_dict()
    decode_model.load_state_dict(weights, assign=True)
    decode_model = decode_model.to(dev).eval()
    if decode_model.dtype is not None:
        # the projections' and the table's weights cast to the compute
        # dtype once (``dense`` casts them at every use otherwise; the
        # values are the same), LayerNorm's kept in f32
        for module in decode_model.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.to(decode_model.dtype)
    check_token_ids(prompt, decode_model.vocab_size)
    cache = decode_model.init_cache(batch)

    def select(logits):
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        scaled = logits.float() / temperature
        if top_k:
            kth = torch.topk(scaled, min(top_k, scaled.shape[-1]), dim=-1).values[:, -1:]
            scaled = torch.where(scaled >= kth, scaled, -1e30)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0]

    def step(token):
        return select(decode_model({"tokens": token}, cache=cache)[:, -1])

    with torch.inference_mode():
        next_token = None
        for i in range(prompt_len):  # prefill one token at a time
            next_token = step(prompt[:, i:i + 1])
        out = [prompt[:, i] for i in range(prompt_len)]
        for i in range(num_steps):
            out.append(next_token)
            if i < num_steps - 1:  # the final step's forward would be unused
                next_token = step(next_token[:, None])
        return torch.stack(out, dim=1).long()
