"""Model export / import in the JAX package's layout; the counterpart of
``elasticdl_tpu/utils/export_utils.py``.

An export directory is the one the JAX package writes and reads::

    {output}/
      manifest.json   (model_def, model_params, model_version, ...)
      params.npz      (flax-named parameters, '/'-joined paths)
      model_state.npz (batch_stats etc., if any)

so the port serves a JAX export as it stands, and the JAX package loads
an export the port wrote.  Weights cross through
:mod:`elasticdl_tpu_torch.utils.flax_weights`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

import elasticdl_tpu_torch
from elasticdl_tpu_torch.utils.device import resolve_device
from elasticdl_tpu_torch.utils.flax_weights import (
    flax_flat_from_torch,
    flax_state_from_torch,
    torch_state_from_flax,
)
from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.model_utils import get_model_spec

_MANIFEST = "manifest.json"


def export_model(
    output_dir: str,
    model: torch.nn.Module,
    model_def: str,
    model_params: dict | None = None,
    model_zoo: str = "",
    model_version: int = 0,
    tables: dict | None = None,
) -> str:
    """Write ``model`` as an export the JAX package can load:
    ``model_def``/``model_params`` must name the same model in both
    packages' zoos.  ``tables``: whole tables by flax name, for a model
    that holds them row-sharded
    (``parallel/elastic.py::gather_sharded_tables_to_chief``)."""
    os.makedirs(output_dir, exist_ok=True)
    tables = tables or {}
    flat = flax_flat_from_torch(model, skip=set(tables))
    flat.update(tables)
    np.savez(os.path.join(output_dir, "params.npz"), **flat)
    model_state = flax_state_from_torch(model)
    if model_state:
        np.savez(os.path.join(output_dir, "model_state.npz"), **model_state)
    manifest = {
        "framework": "elasticdl_tpu_torch",
        "version": elasticdl_tpu_torch.__version__,
        "model_zoo": model_zoo,
        "model_def": model_def,
        "model_params": dict(model_params or {}),
        "model_version": int(model_version),
    }
    with open(os.path.join(output_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    logger.info("Exported model (version %d) to %s", model_version, output_dir)
    return output_dir


def read_manifest(output_dir: str) -> dict:
    """The export's manifest dict (cheap: no npz load)."""
    with open(os.path.join(output_dir, _MANIFEST)) as f:
        return json.load(f)


def load_flats(output_dir: str) -> tuple[dict, dict]:
    """``(flat_params, flat_state)``: the export's name-keyed arrays."""
    with np.load(os.path.join(output_dir, "params.npz")) as z:
        flat_params = {k: z[k] for k in z.files}
    flat_state = {}
    state_path = os.path.join(output_dir, "model_state.npz")
    if os.path.exists(state_path):
        with np.load(state_path) as z:
            flat_state = {k: z[k] for k in z.files}
    return flat_params, flat_state


def build_with_weights(spec, flat_params: dict, flat_state: dict,
                       device: torch.device) -> torch.nn.Module:
    """Build ``spec``'s model without initialising it (meta tensors),
    give it the flat flax weights and model state (BatchNorm's running
    statistics), and move it to ``device`` in eval mode."""
    with torch.device("meta"):
        model = spec.build_model()
    model.load_state_dict(
        torch_state_from_flax(flat_params, model, flat_state), assign=True
    )
    return model.to(device).eval()


def load_exported_model(output_dir: str, device: str | torch.device = "cuda"):
    """``(model, flat_params, flat_state)``: the export's model, built
    from its manifest with the weights loaded, on ``device`` in eval
    mode, and the flat arrays it was loaded from."""
    device = resolve_device(device)
    manifest = read_manifest(output_dir)
    spec = get_model_spec(
        manifest.get("model_zoo", ""),
        manifest["model_def"],
        model_params=manifest.get("model_params", {}),
    )
    flat_params, flat_state = load_flats(output_dir)
    model = build_with_weights(spec, flat_params, flat_state, device)
    return model, flat_params, flat_state
