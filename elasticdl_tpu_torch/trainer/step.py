"""Step builders: train / evaluate / predict; the counterpart of
``elasticdl_tpu/trainer/step.py``.

PyTorch runs eagerly, so there is no ``jit`` and no donation: a step is
a plain function of ``(state, features, labels[, weights])`` that
updates ``state`` in place (``TrainState.apply_gradients``).  The same
function is what ``SPMDTrainer.train_steps_stacked`` captures into a
CUDA graph, so nothing in it reads the device from the host.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from elasticdl_tpu_torch.layers.attention import dropout_generator
from elasticdl_tpu_torch.layers.normalization import frozen_statistics
from elasticdl_tpu_torch.parallel import elastic
from elasticdl_tpu_torch.trainer.state import TrainState, wants_named_parameters
from elasticdl_tpu_torch.utils.tree_utils import map_tree


def _cast_floats(tree, dtype):
    if dtype is None:
        return tree
    return map_tree(
        lambda x: x.to(dtype)
        if isinstance(x, torch.Tensor) and x.is_floating_point()
        else x,
        tree,
    )


def weighted_mean_loss(loss_fn, labels, outputs, weights, weight_total=None):
    """``sum(w_i * loss_i) / max(W, 1)`` with per-row losses from
    ``loss_fn`` on singleton batches, vmapped over the rows as the JAX
    package vmaps them (``torch.func.vmap``: one batched call, not a
    call per row).

    THE mask semantics of shape-canonical batching: a row of weight 0
    (padding ``pad_to`` appended) contributes exactly zero to this loss
    and so exactly zero gradient.  For a ``loss_fn`` that is a mean of
    per-row terms, all-ones weights give ``loss_fn(labels, outputs)`` up
    to summation order.

    ``W`` is ``sum(w_i)``, or ``weight_total`` when given: a process of a
    data-parallel world holds some rows of the global batch and divides
    by the GLOBAL weight sum, so that the processes' losses (and
    gradients) sum to the global batch's."""

    def one_row(labels_row, outputs_row):
        return loss_fn(
            map_tree(lambda x: x.unsqueeze(0), labels_row),
            map_tree(lambda x: x.unsqueeze(0), outputs_row),
        )

    per_row = torch.func.vmap(one_row)(labels, outputs)
    weights = weights.to(per_row.dtype)
    total = weights.sum() if weight_total is None else weight_total.to(per_row.dtype)
    # max(sum, 1) guards the (never-dispatched) all-zero mask
    return (weights * per_row).sum() / torch.clamp(total, min=1.0)


def build_train_step(
    loss_fn: Callable,
    compute_dtype=None,
    device_parse: Callable | None = None,
    remat: bool = False,
    process_group=None,
) -> Callable:
    """Build ``train_step(state, features, labels, weights=None,
    generators=None) -> (state, {"loss": loss})``.

    weights: optional ``(batch,)`` per-row sample weights; the loss is
        then :func:`weighted_mean_loss`, so zero-weight padding rows give
        zero gradient.
    compute_dtype: cast float features before the forward; parameters
        and optimizer state stay f32 (the model casts inside its layers).
    device_parse: the model's optional device-side half of its parse,
        run on the placed features before the forward (and before the
        ``compute_dtype`` cast): compact wire dtypes cross to the device
        and widen there (uint8 images to ``f32 / 255``).
    remat: run the whole forward and loss under
        ``torch.utils.checkpoint`` (the JAX package wraps its whole
        ``forward_loss`` in one ``jax.checkpoint``): only the inputs are
        kept, and the backward runs the forward again.  That second run
        draws the same dropout masks and leaves BatchNorm's running
        statistics as the first run left them
        (:func:`~elasticdl_tpu_torch.layers.normalization.frozen_statistics`),
        so the step's gradients and statistics are those without remat.

    process_group: a data-parallel step over the group's processes
        (the dp axis of the JAX step).  ``features`` and ``labels`` are
        this process's rows of the global batch
        (``parallel/elastic.py::local_batch_ranges``), ``weights`` the
        global batch's whole row mask (required).  The loss divides by
        the global weight sum, which every process reads off the mask
        with no communication; BatchNorm and dropout act on the global
        batch (``elastic.current_rows``); the gradients are SUM-all-
        reduced in f32 over the group before the update, so every
        process applies the global batch's gradients to its copy of the
        state.  The loss returned is this process's share of the global
        loss.

    Dropout masks come from ``dropout_generator(state.step, device)``:
    the same for a replayed step, fresh for every step, and built anew
    for each run of the forward.  ``generators`` replaces that: the
    forward's runs take its generators in order (one per run; two with
    remat), which a CUDA graph registers and seeds before each replay
    with ``dropout_generator``'s seed of the step it replays.
    """

    def forward_loss(state: TrainState, features, labels, weights, next_generator,
                     weight_total=None):
        if device_parse is not None:
            features = device_parse(features)
        features = _cast_floats(features, compute_dtype)
        outputs = state.model(features, training=True, generator=next_generator())
        if weights is None:
            loss = loss_fn(labels, outputs)
        else:
            loss = weighted_mean_loss(loss_fn, labels, outputs, weights, weight_total)
        # the JAX step adds losses sown by layers (MoE load balancing);
        # no ported layer sows one yet
        return loss.float()

    if remat:
        plain_forward_loss = forward_loss

        def forward_loss(state, features, labels, weights, next_generator,
                         weight_total=None):
            return checkpoint(
                plain_forward_loss, state, features, labels, weights,
                next_generator, weight_total, use_reentrant=False,
                # dropout draws from explicit generators, not the global
                # RNG, whose state a CUDA graph capture cannot read
                preserve_rng_state=False,
                context_fn=lambda: (
                    contextlib.nullcontext(), frozen_statistics(state.model)
                ),
            )

    def train_step(state: TrainState, features, labels, weights=None, generators=None):
        state.model.train()
        if generators is None:
            device = next(state.model.parameters()).device

            def next_generator():
                return dropout_generator(state.step, device)
        else:
            next_generator = iter(generators).__next__
        named = [
            (n, p) for n, p in state.model.named_parameters() if p.requires_grad
        ]
        # the last step's gradients go before this one's are made: a
        # 100M-row table's dense gradient is 25.6 GB, and two of them
        # beside the table would not fit one card
        for _, p in named:
            p.grad = None
        if process_group is None:
            loss = forward_loss(state, features, labels, weights, next_generator)
            grads = torch.autograd.grad(
                loss, [p for _, p in named], allow_unused=True
            )
        else:
            if weights is None:
                raise ValueError("a data-parallel step needs the batch's row mask")
            world_size = dist.get_world_size(process_group)
            (start, stop), = elastic.local_batch_ranges(
                weights.shape[0], world_size, dist.get_rank(process_group)
            )
            rows = elastic.DataParallelRows(
                process_group, start, stop, weights.shape[0], world_size
            )
            # the backward runs inside too: it all-reduces BatchNorm's
            # statistics' gradients (and, with remat, reruns the forward)
            with elastic.data_parallel_rows(rows):
                loss = forward_loss(
                    state, features, labels, weights[start:stop],
                    next_generator, weight_total=weights.sum(),
                )
                grads = torch.autograd.grad(
                    loss, [p for _, p in named], allow_unused=True
                )
            # a row-sharded table's gradient is already the world's (the
            # lookup's exchange carried each row's to its owner)
            grads = all_reduce_gradients(
                grads, process_group,
                skip=[getattr(p, "row_sharded", False) for _, p in named],
            )
        state.apply_gradients({n: g for (n, _), g in zip(named, grads)})
        return state, {"loss": loss.detach()}

    return train_step


def all_reduce_gradients(grads, process_group, skip=None) -> list:
    """SUM-all-reduce ``grads`` (``None`` for unused parameters, the same
    on every process) over ``process_group`` in f32, as one flat buffer:
    one collective per step.  A gradient whose ``skip`` flag is set (a
    row-sharded table's) is returned as it is and never enters the
    buffer."""
    skip = skip or [False] * len(grads)
    present = [g for g, s in zip(grads, skip) if g is not None and not s]
    if not present:
        return list(grads)
    flat = torch.cat([g.reshape(-1).float() for g in present])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=process_group)
    out, offset = [], 0
    for g, s in zip(grads, skip):
        if g is None or s:
            out.append(g)
            continue
        out.append(flat[offset:offset + g.numel()].view(g.shape).to(g.dtype))
        offset += g.numel()
    return out


def build_eval_step(
    loss_fn: Callable | None = None,
    device_parse: Callable | None = None,
) -> Callable:
    """Build ``eval_step(state, features, labels, weights=None) ->
    outputs`` or ``(outputs, loss)``, after the model's optional
    device-side parse of the features; with ``weights`` the loss is
    :func:`weighted_mean_loss`, exact over the real rows."""

    def eval_step(state: TrainState, features, labels, weights=None):
        state.model.eval()
        with torch.no_grad():
            if device_parse is not None:
                features = device_parse(features)
            outputs = state.model(features)
            if loss_fn is None:
                return outputs
            if weights is None:
                return outputs, loss_fn(labels, outputs)
            return outputs, weighted_mean_loss(loss_fn, labels, outputs, weights)

    return eval_step


def build_predict_step(device_parse: Callable | None = None) -> Callable:
    """``predict_step(model, features) -> outputs``: the model in eval
    mode under ``torch.inference_mode()``, after the model's optional
    device-side parse of the features."""

    def predict_step(model: torch.nn.Module, features):
        model.eval()
        with torch.inference_mode():
            if device_parse is not None:
                features = device_parse(features)
            return model(features)

    return predict_step


def _is_optimizer_factory(spec) -> bool:
    """A torch optimizer class, a ``functools.partial`` of one, or a
    factory marked with ``takes_named_parameters``: it takes the
    parameters and builds the optimizer."""
    if wants_named_parameters(spec):
        return True
    if isinstance(spec, functools.partial):
        spec = spec.func
    return isinstance(spec, type) and issubclass(spec, torch.optim.Optimizer)


def resolve_optimizer(spec_optimizer, learning_rate: float | None = None):
    """The model module's ``optimizer`` export is either a
    ``params -> Optimizer`` factory (an optimizer class or a partial of
    one, returned as it is, as the JAX package returns an optax
    transformation) or a function ``(lr=...) -> factory`` (the zoo's
    form, called with ``learning_rate`` when given)."""
    if _is_optimizer_factory(spec_optimizer):
        return spec_optimizer
    if callable(spec_optimizer):
        try:
            if learning_rate is not None:
                return spec_optimizer(lr=learning_rate)
            return spec_optimizer()
        except TypeError:
            return spec_optimizer()
    raise TypeError(
        f"optimizer spec must be a torch optimizer factory or a function "
        f"returning one, got {type(spec_optimizer)!r}"
    )
