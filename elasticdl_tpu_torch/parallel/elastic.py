"""Multi-process worlds on ``torch.distributed``; the counterpart of
``elasticdl_tpu/parallel/elastic.py`` and of ``batch_divisor``
(``parallel/mesh.py``).

Membership is the master's: it assigns ``process_id``,
``num_processes`` and ``coordinator_addr`` to each worker through its
argv, and re-forms the whole world (a new cluster version and a new
coordinator port) when a worker dies.  Process 0 hosts the world's
``TCPStore`` at the coordinator address; every process joins one
default process group over it.

The collective backend is a rule, not a fallback (:func:`choose_backend`):

- NCCL when the job runs on CUDA and every process has a card of its
  own (NCCL refuses two ranks on one device);
- gloo on CUDA tensors when the processes share cards;
- gloo on the CPU.

A backend that fails to form the world raises.

The data-parallel axis: each process trains the rows
:func:`local_batch_ranges` gives it of every canonical batch, and the
layers that mix rows (BatchNorm's statistics, dropout's mask) read
:func:`current_rows` to act on the global batch as one process would.
An evaluation or prediction batch runs the same split, and
:func:`gather_rows_to_chief` brings every process's output rows to
process 0, in global batch order.
"""

from __future__ import annotations

import contextlib
import datetime
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from elasticdl_tpu_torch.utils.log_utils import default_logger as logger
from elasticdl_tpu_torch.utils.tree_utils import map_tree

BACKEND_NCCL = "nccl"
BACKEND_GLOO = "gloo"


def pick_coordinator_port() -> int:
    """A free TCP port for the next world's store (each re-formation gets
    a fresh one: the old store died with its process 0)."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def choose_backend(device: str | torch.device, num_processes: int) -> str:
    """The collective backend of a world of ``num_processes`` on
    ``device`` (module docstring)."""
    if torch.device(device).type != "cuda":
        return BACKEND_GLOO
    if num_processes <= torch.cuda.device_count():
        return BACKEND_NCCL
    return BACKEND_GLOO


def rank_device(device: str | torch.device, process_id: int) -> torch.device:
    """The device process ``process_id`` trains on: its own card when
    there are enough, else they share them round robin."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA world needs a card; none is visible")
    return torch.device("cuda", process_id % count)


@dataclass(frozen=True)
class World:
    """This process's place in its world."""

    process_id: int
    num_processes: int
    backend: str
    device: torch.device
    group: object = None  # the default process group


def initialize_world(
    coordinator_addr: str,
    num_processes: int,
    process_id: int,
    device: str | torch.device = "cuda",
    timeout_secs: float = 60.0,
) -> World:
    """Join the job's world: process 0 hosts the ``TCPStore`` at
    ``coordinator_addr``, and every process inits the default process
    group over it with the backend of :func:`choose_backend`."""
    backend = choose_backend(device, num_processes)
    rank_dev = rank_device(device, process_id)
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    host, _, port = coordinator_addr.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_secs)
    store = dist.TCPStore(
        host or "localhost", int(port), num_processes,
        is_master=process_id == 0, timeout=timeout,
    )
    dist.init_process_group(
        backend, store=store, rank=process_id, world_size=num_processes,
        timeout=timeout,
    )
    logger.info(
        "Joined distributed world: process %d/%d on %s, backend %s "
        "(rule: nccl when every process has a card of its own, gloo when "
        "processes share a card or run on the CPU; coordinator %s)",
        process_id, num_processes, rank_dev, backend, coordinator_addr,
    )
    return World(process_id, num_processes, backend, rank_dev, dist.group.WORLD)


def shutdown_world():
    """Leave the world; peers may already be gone, which is not an
    error here."""
    if not dist.is_initialized():
        return
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — peers may already be gone
        logger.exception("Destroying the process group failed")


def local_batch_ranges(
    global_rows: int, num_processes: int, process_index: int
) -> list[tuple[int, int]]:
    """The ``[start, stop)`` rows of a global batch of ``global_rows``
    that ``process_index`` owns: equal contiguous blocks in process
    order (the JAX package's dp sharding over one device per process)."""
    if global_rows % num_processes:
        raise ValueError(
            f"a global batch of {global_rows} rows does not split over "
            f"{num_processes} processes (canonical rows are a multiple of "
            f"the batch divisor)"
        )
    per = global_rows // num_processes
    return [(process_index * per, (process_index + 1) * per)]


def gather_rows_to_chief(tree, group):
    """Every process's rows of a batch tree (tensors of one row count on
    every process: its block of the global batch), concatenated in
    process order, which is global batch order, on process 0 of
    ``group``; None on the others.  The counterpart of the JAX package's
    ``replicate_to_hosts`` (:306), which gathers to every process: only
    process 0 reports or processes the rows, so the others would discard
    them.

    The rows travel as raw bytes (any dtype, bf16 included).  On gloo
    they pass through host memory, since gloo gathers CPU tensors only;
    on NCCL they stay on the card."""
    world = dist.get_world_size(group)
    chief = dist.get_rank(group) == 0
    dst = dist.get_global_rank(group, 0)
    on_host = dist.get_backend(group) == BACKEND_GLOO

    def gather(x):
        x = x.detach()
        if on_host:
            x = x.cpu()
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(world)] if chief else None
        dist.gather(raw, parts, dst=dst, group=group)
        if not chief:
            return None
        return torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts], 0)

    out = map_tree(gather, tree)
    return out if chief else None


def state_checkpoint_parts(state, mesh=None, materialize_dense: bool = True):
    """Split the live state into ``(dense, parts)``, the counterpart of
    the JAX package's ``state_checkpoint_parts`` (:160), with its
    signature and contract: ``dense`` maps checkpoint names to whole
    host arrays, ``parts`` maps a row-sharded table's name to the
    ``(ids, rows)`` this process owns.

    ``dense`` is the name-keyed flat layout of a checkpoint
    (``trainer/state.py::state_to_checkpoint``: ``params/...`` and
    ``batch_stats/...``), so a replica restore and a disk restore apply
    one format through one function
    (``trainer/checkpointing.py::apply_restored_values``).  It is read
    from this process's copy of the state, a device-to-host copy on the
    calling thread after the step's work on the current stream, and
    skipped when ``materialize_dense`` is False (only the chief's share
    carries it; the others would discard it).

    ``parts`` is empty: every leaf of the port's state is replicated on
    every process of a world until sharded tables come (slice 9), so no
    collective runs here and ``mesh`` (the world's group, or None) is
    not read."""
    del mesh
    # trainer.state imports the layers, which import this module
    from elasticdl_tpu_torch.trainer.state import state_to_checkpoint

    dense = state_to_checkpoint(state) if materialize_dense else {}
    return dense, {}


def batch_divisor(num_processes: int) -> int:
    """Global batch rows must be divisible by this for placement."""
    return max(1, int(num_processes))


# ---- the rows this process holds of the global batch ----------------------


@dataclass(frozen=True)
class DataParallelRows:
    """Inside a data-parallel step: this process holds rows
    ``[start, stop)`` of a global batch of ``total`` rows, split over
    ``world_size`` processes of ``group``."""

    group: object
    start: int
    stop: int
    total: int
    world_size: int


_current_rows: DataParallelRows | None = None


@contextlib.contextmanager
def data_parallel_rows(rows: DataParallelRows):
    """Within: :func:`current_rows` is ``rows`` (the training step of a
    data-parallel trainer sets it around its forward and backward)."""
    global _current_rows
    previous, _current_rows = _current_rows, rows
    try:
        yield rows
    finally:
        _current_rows = previous


def current_rows() -> DataParallelRows | None:
    """The data-parallel rows of the step being run, or None outside a
    data-parallel step."""
    return _current_rows
