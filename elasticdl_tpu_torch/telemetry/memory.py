"""Device-memory accounting for the device pipeline; the part of
``elasticdl_tpu/telemetry/memory.py`` that the staging admission control
(``trainer/device_pipeline.py::staging_budget_bytes``) reads.

The JAX package's component ledger, its host readings and its
telemetry surfaces come with slice 10 (telemetry).
"""

from __future__ import annotations

import torch

from elasticdl_tpu_torch.utils.tree_utils import tree_leaves


def pytree_bytes(tree) -> int:
    """Total bytes of a tree's tensor and numpy leaves; other leaves
    (scalars, None) count 0."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(getattr(leaf, "nbytes", 0) or 0)
    return total


def read_device_memory(device=None) -> dict:
    """The CUDA device's memory as ``{"bytes_in_use", "bytes_limit"}``,
    or ``{}`` without CUDA (the CPU has no device budget).

    ``bytes_limit`` is the card's total memory (``torch.cuda.mem_get_info``);
    ``bytes_in_use`` is everything that is not free to this process's
    allocator: its allocated tensors plus what other contexts hold, so
    that ``bytes_limit - bytes_in_use`` is the headroom (free memory and
    the allocator's cached, unallocated blocks)."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(device)
    allocated = torch.cuda.memory_allocated(device)
    reserved = torch.cuda.memory_reserved(device)
    in_use = allocated + (total - free - reserved)
    return {"bytes_in_use": int(in_use), "bytes_limit": int(total)}
