"""Memory readings; the part of ``elasticdl_tpu/telemetry/memory.py`` that
the port uses: the device memory the staging admission control reads
(``trainer/device_pipeline.py::staging_budget_bytes``), and the host
readings of the master's ``/healthz`` headroom block.

The JAX package's component ledger, its ``memory_sample`` events and the
``elasticdl_memory_bytes`` family come with slice 10b.
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


def read_host_rss() -> int | None:
    """Resident set size of THIS process (``/proc/self/status`` VmRSS),
    bytes; None where /proc is unavailable."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    return None


def _read_meminfo(field: str) -> int | None:
    try:
        with open("/proc/meminfo", encoding="ascii") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    return None


def read_host_available() -> int | None:
    """Host-wide MemAvailable, bytes (the /healthz headroom source)."""
    return _read_meminfo("MemAvailable")


# MemTotal is constant for the machine's uptime: read it once so the
# per-sample pressure check costs no extra /proc parse (and none while
# holding the ledger lock).  The sentinel distinguishes "never read"
# from "read, unavailable" (non-Linux).
_host_total_cache: list = []


def read_host_total() -> int | None:
    if not _host_total_cache:
        _host_total_cache.append(_read_meminfo("MemTotal"))
    return _host_total_cache[0]


def host_memory_health() -> dict:
    """The /healthz headroom block: point-in-time host RSS, host-wide
    availability and the headroom share (None-safe on /proc-less
    platforms)."""
    rss = read_host_rss()
    available = read_host_available()
    total = read_host_total()
    return {
        "host_rss_bytes": rss,
        "host_available_bytes": available,
        "headroom_share": round(available / total, 4)
        if available is not None and total
        else None,
    }
