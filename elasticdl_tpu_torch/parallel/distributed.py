"""The trainer: device-side state plus the train/eval/predict steps; the
counterpart of ``elasticdl_tpu/parallel/distributed.py::SPMDTrainer``.

One trainer holds one device: an explicit ``device`` takes the place of
the JAX trainer's mesh.  With a ``process_group`` it is one process of a
data-parallel world (the mesh's dp axis across processes): it places
only its own rows of each canonical batch (``place_step``,
``place_group``; ``parallel/elastic.py::local_batch_ranges``) beside the
whole row mask, and its step SUM-all-reduces the gradients over the
group (``trainer/step.py``).  The shape-canonical batching below
(``pad_to`` + ``row_mask``) is the one every runtime uses, so padded
rows carry zero weight.

k optimizer steps in one dispatch (``train_steps_stacked``, JAX's
jitted ``lax.scan``) are one CUDA graph replay on the card: the first
group of a given ``(k, shapes)`` runs as k eager steps on a side stream
(it also warms the optimizer's state, the allocator and the libraries),
the second is captured into a graph of the k steps over static input
buffers and replayed, and every later one is copied into those buffers
and replayed.  On the CPU, which has no graphs, and under a process
group on any device, the k steps run eagerly: a capture of collectives
waits for worlds of a card per process.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.layers.attention import dropout_seed
from elasticdl_tpu_torch.parallel.elastic import local_batch_ranges
from elasticdl_tpu_torch.trainer.state import TrainState, make_capturable
from elasticdl_tpu_torch.trainer.step import (
    build_eval_step,
    build_predict_step,
    build_train_step,
)
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.tree_utils import map_tree, to_host, tree_leaves


class SPMDTrainer:
    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn: Callable,
        tx: Callable,
        compute_dtype=None,
        device: str | torch.device = "cuda",
        device_parse: Callable | None = None,
        remat: bool = False,
        process_group=None,
    ):
        """``model`` comes with its weights (torch modules initialise
        eagerly; the JAX trainer inits from a sample batch instead) and
        is moved to ``device``; ``tx`` builds the optimizer from the
        parameters (``resolve_optimizer``'s result).  ``device`` is CUDA
        unless the caller asks for the CPU.  ``device_parse`` (the
        model's device-side half of its parse) runs in every step on the
        placed features.  ``remat`` recomputes the forward in the
        backward (``build_train_step``).  ``process_group``: this trainer
        is one process of that data-parallel world (module docstring);
        the caller restores every process from one checkpoint or calls
        :meth:`broadcast_state`."""
        self.device = resolve_device(device)
        self.state = TrainState.create(model.to(self.device), tx)
        self.process_group = process_group
        if process_group is None:
            self._rank, self._world_size = 0, 1
        else:
            self._rank = dist.get_rank(process_group)
            self._world_size = dist.get_world_size(process_group)
        # set by the first stacked group on the card (make_capturable)
        self._graph_lr_ok: bool | None = None
        self._remat = remat
        self._train_step = build_train_step(
            loss_fn, compute_dtype=compute_dtype, device_parse=device_parse,
            remat=remat, process_group=process_group,
        )
        self._eval_step = build_eval_step(loss_fn, device_parse=device_parse)
        self._predict_step = build_predict_step(device_parse)
        self._check_features = getattr(model, "validate_features", None)
        # (k, shapes) -> None once its first group ran eagerly, then the
        # captured _StepsGraph
        self._graphs: dict = {}
        # how each step was taken (read by the smoke and the tests):
        # single_steps through train_step; groups of k as eager steps
        # (the CPU, and a key's first group on the card), captures and
        # graph replays
        self.dispatch_counts = dict.fromkeys(
            ("single_steps", "eager_groups", "graph_captures", "graph_replays"), 0
        )

    # ---- batch placement --------------------------------------------------

    def place_batch(self, tree):
        """A host batch (numpy arrays or tensors) as tensors on the
        trainer's device."""

        def _place(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(self.device)

        return map_tree(_place, tree)

    def place_stacked(self, tree):
        """A ``(k, rows, ...)`` host group on the trainer's device: on the
        card through pinned memory, without blocking the host (the copy is
        ordered on the current stream)."""
        if self.device.type != "cuda":
            return self.place_batch(tree)

        def _place(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.pin_memory().to(self.device, non_blocking=True)

        return map_tree(_place, tree)

    def _local_rows(self, tree, rows: int, axis: int):
        """This process's rows of a host batch tree, along ``axis`` (the
        whole tree outside a data-parallel world)."""
        if self.process_group is None:
            return tree
        (start, stop), = local_batch_ranges(rows, self._world_size, self._rank)
        index = (slice(None),) * axis + (slice(start, stop),)
        return map_tree(lambda x: x[index], tree)

    def place_local(self, tree):
        """A canonical host batch tree on the device: in a data-parallel
        world this process's rows of it (an evaluation or prediction
        batch; ``parallel/elastic.py::gather_rows_to_chief`` brings the
        outputs back together)."""
        rows = int(np.shape(tree_leaves(tree)[0])[0])
        return self.place_batch(self._local_rows(tree, rows, 0))

    def place_step(self, features, labels, weights):
        """One canonical host batch ``(features, labels, weights)`` on the
        device, for :meth:`train_step`: in a data-parallel world this
        process's rows of the features and labels, beside the whole row
        mask."""
        rows = int(np.shape(weights)[0])
        return (
            self.place_batch(self._local_rows(features, rows, 0)),
            self.place_batch(self._local_rows(labels, rows, 0)),
            self.place_batch(weights),
        )

    def place_group(self, features, labels, weights):
        """A stacked host group ``(features, labels, weights)`` placed
        with :meth:`place_stacked` (this process's rows of the features
        and labels in a data-parallel world, as :meth:`place_step`),
        after the model's host check of the features
        (``validate_features``, where the model has one): a graph replay
        runs no check of its own on the card."""
        if self._check_features is not None:
            self._check_features(features)
        rows = int(np.shape(weights)[1])
        return (
            self.place_stacked(self._local_rows(features, rows, 1)),
            self.place_stacked(self._local_rows(labels, rows, 1)),
            self.place_stacked(weights),
        )

    def pad_to(self, tree, rows: int):
        """Pad the batch's leading dim to EXACTLY ``rows`` (repeating the
        last row; padded rows carry zero weight via :meth:`row_mask`, so
        the fill only has to be shape/dtype-valid, not meaningful)."""

        def _pad(x):
            x = np.asarray(x)
            n = x.shape[0]
            if n == rows:
                return x
            if n > rows:
                raise ValueError(
                    f"batch of {n} rows exceeds the canonical shape "
                    f"({rows} rows)"
                )
            return np.concatenate(
                [x, np.repeat(x[-1:], rows - n, axis=0)], axis=0
            )

        return map_tree(_pad, tree)

    def row_mask(self, n_real: int, rows: int) -> np.ndarray:
        """``(rows,)`` float32 sample weights: 1 for the real rows, 0 for
        the padding :meth:`pad_to` appended."""
        mask = np.zeros(rows, np.float32)
        mask[:n_real] = 1.0
        return mask

    def place_canonical(self, tree, rows: int):
        """pad_to + place_batch: THE canonical-shape feed; outputs are
        trimmed back by :func:`trim_pad`, and the loss side carries
        :meth:`place_mask` weights so the padding is weightless."""
        return self.place_batch(self.pad_to(tree, rows))

    def place_mask(self, n_real: int, rows: int) -> torch.Tensor:
        """:meth:`row_mask` placed like any 1-D batch leaf."""
        return self.place_batch(self.row_mask(n_real, rows))

    # ---- steps ------------------------------------------------------------

    def train_step(self, features, labels, weights=None) -> dict:
        """One optimizer step; returns ``{"loss": 0-d f32 tensor}`` on
        the device (read it with ``float()``, which waits for the step)."""
        _state, metrics = self._train_step(self.state, features, labels, weights)
        self.dispatch_counts["single_steps"] += 1
        return metrics

    def train_steps_stacked(self, features, labels, weights) -> dict:
        """k optimizer steps on placed ``(k, rows, ...)`` groups and
        ``(k, rows)`` row weights, the same as k :meth:`train_step` calls
        on their slices; returns the last step's metrics.  On the card a
        group of a ``(k, shapes)`` seen before is one CUDA graph replay
        (module docstring); a capture that fails raises.  The first group
        on the card moves the optimizer's step count (and a scheduled lr)
        to the device (``make_capturable``), so that a graph replays its
        update; single-step runs never get there and keep the optimizer
        as built."""
        k = int(tree_leaves(features)[0].shape[0])
        if self.device.type != "cuda" or self.process_group is not None:
            self.dispatch_counts["eager_groups"] += 1
            return self._eager_steps(k, features, labels, weights)
        if self._graph_lr_ok is None:
            self._graph_lr_ok = make_capturable(self.state.optimizer, self.device)
        inputs = (features, labels, weights)
        key = (k, repr(map_tree(lambda x: (tuple(x.shape), x.dtype), inputs)))
        if key not in self._graphs:
            # torch's graph warm-up: real steps on a side stream
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                metrics = self._eager_steps(k, features, labels, weights)
            current.wait_stream(side)
            self._graphs[key] = None
            self.dispatch_counts["eager_groups"] += 1
            return metrics
        graph = self._graphs[key]
        if graph is None:
            graph = self._graphs[key] = _StepsGraph(self, k, inputs)
            self.dispatch_counts["graph_captures"] += 1
        metrics = graph.replay(inputs)
        self.dispatch_counts["graph_replays"] += 1
        return metrics

    def _eager_steps(self, k, features, labels, weights) -> dict:
        for j in range(k):
            _state, metrics = self._train_step(
                self.state, *(map_tree(lambda x: x[j], t) for t in (features, labels, weights))
            )
        return metrics

    def broadcast_state(self) -> int:
        """Give every process of the world process 0's parameters,
        buffers and step count (the start of a world: process 0 alone
        restores a checkpoint, or keeps its seeded weights); returns the
        step.  The optimizer's state is fresh on every process."""
        if self.process_group is None:
            return self.state.step
        src = dist.get_global_rank(self.process_group, 0)
        step = torch.tensor([self.state.step], dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for tensor in [step, *self.state.model.parameters(), *self.state.model.buffers()]:
                dist.broadcast(tensor.data, src, group=self.process_group)
        self.state.step = int(step.item())
        return self.state.step

    def eval_step(self, features, labels, weights=None):
        return self._eval_step(self.state, features, labels, weights)

    def predict_step(self, features):
        return self._predict_step(self.state.model, features)

    @property
    def step(self) -> int:
        """Model version: optimizer steps taken."""
        return self.state.step


class _StepsGraph:
    """A CUDA graph of k train steps over static ``(k, rows, ...)``
    input buffers.

    Each captured step draws its dropout masks from generators of its own
    (two with remat: the forward and its recompute), registered with the
    graph and seeded before each replay with ``dropout_seed`` of the
    step it replays, so the replay reads that seed at offset 0: the masks
    of ``dropout_generator(step)``, as in an eager step.  A scheduled lr
    is read from a ``(k,)`` device tensor filled before each replay
    (``LRSchedule.feeding``).  Parameters, buffers and optimizer state
    are captured where they are: restores copy into them in place."""

    def __init__(self, trainer: SPMDTrainer, k: int, inputs):
        state = trainer.state
        schedule = getattr(state.optimizer, "lr_schedule", None)
        if schedule is not None and not trainer._graph_lr_ok:
            raise NotImplementedError(
                f"--steps_per_dispatch {k} on the card replays a CUDA graph, "
                f"and {type(state.optimizer).__name__} reads its scheduled lr "
                "on the host, which a graph would freeze: use an optimizer "
                "with capturable=True (Adam, AdamW), or --steps_per_dispatch 1"
            )
        self.k, self.state, self.schedule = k, state, schedule
        self.static = map_tree(torch.empty_like, inputs)
        self._copy_in(inputs)
        self.generators = [
            [torch.Generator(device=trainer.device) for _ in range(2 if trainer._remat else 1)]
            for _ in range(k)
        ]
        self.graph = torch.cuda.CUDAGraph()
        for gens in self.generators:
            for gen in gens:
                self.graph.register_generator_state(gen)
        self.feed = (
            torch.zeros(k, dtype=torch.float32, device=trainer.device)
            if schedule is not None else None
        )
        feeding = (
            schedule.feeding(self.feed) if schedule is not None
            else contextlib.nullcontext()
        )
        step0 = state.step
        features, labels, weights = self.static
        try:
            with feeding, torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                for j in range(k):
                    _state, metrics = trainer._train_step(
                        state,
                        *(map_tree(lambda x: x[j], t) for t in (features, labels, weights)),
                        generators=self.generators[j],
                    )
        finally:
            # the capture ran no step
            state.step = step0
        self.loss = metrics["loss"]

    def _copy_in(self, inputs):
        for dst, src in zip(tree_leaves(self.static), tree_leaves(inputs)):
            dst.copy_(src, non_blocking=True)

    def replay(self, inputs) -> dict:
        self._copy_in(inputs)
        for j, gens in enumerate(self.generators):
            for gen in gens:
                gen.manual_seed(dropout_seed(self.state.step + j))
        if self.schedule is not None:
            self.feed.copy_(torch.tensor(self.schedule.values(self.k)))
            self.schedule.updates += self.k
        self.graph.replay()
        self.state.step += self.k
        return {"loss": self.loss.clone()}


def trim_pad(outputs, n: int):
    """Drop the rows padding added (device tensors come back as host
    numpy, bf16 as ``ml_dtypes.bfloat16``)."""
    return map_tree(
        lambda x: to_host(x)[:n] if isinstance(x, torch.Tensor)
        else np.asarray(x)[:n],
        outputs,
    )
