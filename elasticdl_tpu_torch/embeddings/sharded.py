"""Row-sharded embedding tables in a ``torch.distributed`` world: the
port's counterpart of GSPMD's ``P(dp, None)`` table layout.

Where a model's ``sharding_rules(mesh)`` shard a table and the world has
more than one process, :func:`shard_tables` leaves each process only the
rows ``planner.shard_row_ranges(rows, world_size)[rank]`` of it, and the
table's :class:`~elasticdl_tpu_torch.layers.embedding.Embedding` looks
ids up through :func:`exchange_lookup`, the exchange the reference made
over gRPC with its parameter servers (``ps/embedding_table.py``'s pull):

1. a count exchange: each process tells every other how many of its ids
   that one owns;
2. the ids go to their owners (``all_to_all_single``);
3. each owner gathers its rows and sends them back through the
   autograd-aware ``torch.distributed.nn.functional.all_to_all_single``,
   so the backward carries each row's gradient to its owner, where the
   gather's backward sums the contributions of every process.

The table's gradient is therefore already the world's: the train step
leaves it out of the gradient all-reduce (``trainer/step.py``), and the
optimizer applies it on the shard.  Checkpoints and replicas carry a
sharded table as ``(ids, rows)`` parts
(``parallel/elastic.py::state_checkpoint_parts``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.embeddings.planner import shard_row_ranges


@dataclass(frozen=True)
class TableShard:
    """This process's share of one row-sharded table: ``name`` is the
    table's checkpoint name (``params/embedding/embedding``),
    ``num_rows`` the whole table's rows, ``ranges`` every process's
    ``[lo, hi)`` in rank order."""

    name: str
    num_rows: int
    ranges: tuple
    rank: int
    group: object = None

    @property
    def lo(self) -> int:
        return self.ranges[self.rank][0]

    @property
    def hi(self) -> int:
        return self.ranges[self.rank][1]

    @property
    def widest(self) -> int:
        """The most rows any process holds."""
        return max(hi - lo for lo, hi in self.ranges)


def _module_and_attr(model: nn.Module, torch_key: str):
    path, _, attr = torch_key.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def row_rules(rules) -> list:
    """The rules that shard rows alone (``(axis, None)``); others are not
    read."""
    return [
        r for r in rules or ()
        if len(r.spec) == 2 and r.spec[0] is not None and r.spec[1] is None
    ]


def tables_to_shard(model: nn.Module, rules) -> list:
    """The parameter entries (``utils/flax_weights.py``) of ``model``'s
    tables that ``rules`` row-shard; raises when a rule matches a
    parameter that is not an embedding table."""
    from elasticdl_tpu_torch.layers.embedding import Embedding
    from elasticdl_tpu_torch.utils import flax_weights

    rules = row_rules(rules)
    entries = [
        e for e in flax_weights.param_entries(model)
        if any(rule.matches(e.flax_key) for rule in rules)
    ] if rules else []
    for entry in entries:
        module, attr = _module_and_attr(model, entry.torch_key)
        if not isinstance(module, Embedding) or attr != "embedding":
            raise ValueError(
                f"sharding rule matches {entry.flax_key!r}, which is not an "
                "embedding table"
            )
    return entries


def shard_tables(model: nn.Module, rules, group) -> dict:
    """Keep, of every table a rule row-shards, only this process's rows
    in ``group`` (in place, before the optimizer is built); returns
    ``{checkpoint name: TableShard}``.  In the port's worlds a rule's
    axis is ``dp``, the processes of ``group``."""
    if group is None or dist.get_world_size(group) <= 1:
        return {}
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    shards = {}
    for entry in tables_to_shard(model, rules):
        module, _attr = _module_and_attr(model, entry.torch_key)
        table = module.embedding
        ranges = tuple(shard_row_ranges(table.shape[0], world))
        shard = TableShard(
            f"params/{entry.flax_key}", int(table.shape[0]), ranges, rank, group
        )
        lo, hi = ranges[rank]
        module.embedding = nn.Parameter(table.detach()[lo:hi].clone())
        # read by the step's gradient all-reduce and the broadcast
        module.embedding.row_sharded = True
        module.shard = shard
        shards[shard.name] = shard
    return shards


def sharded_tables(model: nn.Module) -> dict:
    """``{checkpoint name: (parameter, TableShard)}`` of the model's
    row-sharded tables (empty outside a sharded world)."""
    out = {}
    for module in model.modules():
        shard = getattr(module, "shard", None)
        if shard is not None:
            out[shard.name] = (module.embedding, shard)
    return out


def _owners(ids: torch.Tensor, shard: TableShard) -> torch.Tensor:
    bounds = torch.tensor(
        [hi for _, hi in shard.ranges[:-1]], dtype=ids.dtype, device=ids.device
    )
    return torch.bucketize(ids, bounds, right=True)


def exchange_lookup(table: torch.Tensor, ids: torch.Tensor, shard: TableShard) -> torch.Tensor:
    """The rows of ``ids`` (any shape, every id in ``[0, num_rows)``) of
    the row-sharded table whose local rows are ``table``: ids to their
    owners, rows back (module docstring).  Collective: every process of
    the shard's group calls it at the same point with its own ids."""
    from torch.distributed.nn.functional import all_to_all_single as all_to_all_grad

    group = shard.group
    flat = ids.reshape(-1).long()
    owner = _owners(flat, shard)
    order = torch.argsort(owner, stable=True)
    send_counts = torch.bincount(owner, minlength=len(shard.ranges))
    recv_counts = torch.empty_like(send_counts)
    dist.all_to_all_single(recv_counts, send_counts, group=group)
    send_splits = send_counts.tolist()
    recv_splits = recv_counts.tolist()
    recv_ids = flat.new_empty(sum(recv_splits))
    dist.all_to_all_single(
        recv_ids, flat[order], recv_splits, send_splits, group=group
    )
    rows = F.embedding(recv_ids - shard.lo, table)
    back = all_to_all_grad(
        rows.new_empty((flat.numel(), table.shape[1])), rows,
        send_splits, recv_splits, group=group,
    )
    # back holds the rows in owner order: undo the sort
    return back[torch.argsort(order)].reshape(ids.shape + (table.shape[1],))
