"""Model-zoo module loading and spec resolution; the counterpart of
``elasticdl_tpu/utils/model_utils.py``.

The same ``model_def`` strings resolve to the port's modules: with an
empty ``model_zoo`` the module is imported from the built-in
``elasticdl_tpu_torch.models`` zoo, so a manifest the JAX package wrote
(``long_seq_transformer.long_seq_transformer.custom_model``) builds the
port's model.  ``custom_model`` returns a ``torch.nn.Module``;
``optimizer`` returns a factory that takes the model's parameters.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
from dataclasses import dataclass, field
from typing import Any, Callable

_BUILTIN_ZOO = "elasticdl_tpu_torch.models."


def load_module_from_path(module_file: str):
    """Import a python module from an absolute file path."""
    spec = importlib.util.spec_from_file_location(module_file, module_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _split_model_def(model_def: str) -> tuple[str, str]:
    """``pkg.module.func`` -> (``pkg/module.py`` relpath, ``func``)."""
    parts = model_def.split(".")
    if len(parts) < 2:
        raise ValueError(
            "model_def must be 'module_path.function_name', got %r"
            % model_def
        )
    return os.path.join(*parts[:-1]) + ".py", parts[-1]


def load_model_module(model_zoo: str, model_def: str):
    """Load the model module named by ``model_def``: rooted at the
    ``model_zoo`` directory when one is given, else from the built-in
    ``elasticdl_tpu_torch.models`` package."""
    rel_path, func_name = _split_model_def(model_def)
    if model_zoo:
        module_file = os.path.join(model_zoo, rel_path)
        if not os.path.exists(module_file):
            raise FileNotFoundError(module_file)
        module = load_module_from_path(module_file)
    else:
        dotted = _BUILTIN_ZOO + model_def.rsplit(".", 1)[0]
        # tolerate the dir/file repetition (long_seq_transformer.
        # long_seq_transformer) by trying the full dotted path first,
        # then the last component alone
        try:
            module = importlib.import_module(dotted)
        except ModuleNotFoundError as e:
            # fall back only when the named module itself is missing, not
            # when a dependency imported inside it is
            if e.name is None or not dotted.startswith(e.name):
                raise
            last = dotted.rsplit(".", 1)[-1]
            module = importlib.import_module(_BUILTIN_ZOO + last)
    return module, func_name


@dataclass
class ModelSpec:
    """The resolved model-zoo contract."""

    model_fn: Callable[..., Any]
    loss: Callable
    optimizer: Callable
    dataset_fn: Callable | None = None
    # optional batched alternative to dataset_fn:
    # ``batch_parse(example_batch: dict[str, ndarray], mode)`` receives a
    # whole decoded minibatch and returns the element dataset_fn's mapped
    # elements would after batching
    batch_parse: Callable | None = None
    # optional device-side half of the parse, applied inside the predict
    # step before the model.  Signature: features -> features
    device_parse: Callable | None = None
    eval_metrics_fn: Callable | None = None
    learning_rate_scheduler: Any | None = None
    prediction_outputs_processor: Any | None = None
    custom_data_reader: Callable | None = None
    # optional module hook ``sharding_rules(mesh) -> [Rule]``: the
    # model's forced layout (``deepfm_sharded_embedding`` row-shards its
    # tables over a world); callers pass ``parallel.mesh.world_mesh``
    sharding_rules: Callable | None = None
    model_params: dict = field(default_factory=dict)
    module: Any = None

    def build_model(self, device=None):
        """The model, its embedding tables built on ``device`` (None:
        the CPU; ``layers/embedding.py::tables_on``)."""
        from elasticdl_tpu_torch.layers.embedding import tables_on

        with tables_on(device):
            return self.model_fn(**self.model_params)

    def rules_for(self, num_processes: int) -> tuple:
        """The model's sharding rules on a world of ``num_processes``
        (none without the hook)."""
        if self.sharding_rules is None:
            return ()
        from elasticdl_tpu_torch.parallel.mesh import world_mesh

        return tuple(self.sharding_rules(world_mesh(num_processes)))


def resolve_model_spec(
    module,
    entry_fn_name: str,
    dataset_fn: str = "dataset_fn",
    loss: str = "loss",
    optimizer: str = "optimizer",
    eval_metrics_fn: str = "eval_metrics_fn",
    custom_data_reader: str = "custom_data_reader",
    prediction_outputs_processor: str = "PredictionOutputsProcessor",
) -> ModelSpec:
    """Resolve the spec functions from a loaded model module, honoring
    user-renamed spec functions; ``loss`` and ``optimizer`` are
    required."""

    def _get(name, required=False):
        obj = getattr(module, name, None)
        if obj is None and required:
            raise AttributeError(
                f"model module {module.__name__!r} must define {name!r}"
            )
        return obj

    model_fn = _get(entry_fn_name)
    if model_fn is None:
        raise AttributeError(
            f"model module {module.__name__!r} has no entry {entry_fn_name!r}"
        )
    processor_cls = _get(prediction_outputs_processor)
    return ModelSpec(
        model_fn=model_fn,
        loss=_get(loss, required=True),
        optimizer=_get(optimizer, required=True),
        dataset_fn=_get(dataset_fn),
        # the batched parse pairs with the default dataset_fn; a
        # user-renamed --dataset_fn selects a different parse, which
        # batch_parse must not bypass
        batch_parse=(
            _get("batch_parse") if dataset_fn == "dataset_fn" else None
        ),
        device_parse=(
            _get("device_parse") if dataset_fn == "dataset_fn" else None
        ),
        eval_metrics_fn=_get(eval_metrics_fn),
        learning_rate_scheduler=_get("learning_rate_scheduler"),
        prediction_outputs_processor=(
            processor_cls() if processor_cls is not None else None
        ),
        custom_data_reader=_get(custom_data_reader),
        sharding_rules=_get("sharding_rules"),
        module=module,
    )


def get_model_spec(
    model_zoo: str,
    model_def: str,
    model_params: dict | None = None,
    dataset_fn: str = "dataset_fn",
    loss: str = "loss",
    optimizer: str = "optimizer",
    eval_metrics_fn: str = "eval_metrics_fn",
    custom_data_reader: str = "custom_data_reader",
    prediction_outputs_processor: str = "PredictionOutputsProcessor",
) -> ModelSpec:
    """One-call loader: module + spec + the model's constructor params;
    the spec names may be renamed as the JAX package's flags allow."""
    module, entry = load_model_module(model_zoo, model_def)
    spec = resolve_model_spec(
        module,
        entry,
        dataset_fn=dataset_fn,
        loss=loss,
        optimizer=optimizer,
        eval_metrics_fn=eval_metrics_fn,
        custom_data_reader=custom_data_reader,
        prediction_outputs_processor=prediction_outputs_processor,
    )
    spec.model_params = dict(model_params or {})
    return spec
