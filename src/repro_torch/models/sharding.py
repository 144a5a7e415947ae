"""A rank's share of a sharded GNN or DCN-v2 step.

The reference shards these cells with GSPMD (``repro.launch.cells``): a
full graph's node and edge arrays over every rank of the mesh, DCN-v2's
embedding tables by rows over "model" and its batch over the data axes.
XLA partitions the whole-graph step and places the collectives. The port
has no such compiler, so a rank runs its own share of the step in the
same pattern, and the models call three hooks that are no-ops on one
card:

  * ``node_table(h)``: the rank's [N/P, ...] node rows -> the whole
    [N, ...] table (an all-gather), which its E/P edges index by global
    node id; backward: the cotangent summed over the ranks, the rank's
    rows kept (a reduce-scatter);
  * ``reduce_nodes(partial, op)``: [N + 1, ...] segment sums ("sum") or
    extremes ("max", "min") of the rank's edges -> the whole graph's (an
    all-reduce); backward: the cotangents summed over the ranks, to the
    entries that hold the extreme;
  * ``own_rows(full)``: the rank's rows of a whole [N, ...] array;

and, for the tables, ``lookup(table, ids)``: the rank's [V/M, D] rows
looked up at global ids (0 where another rank holds the row), summed
over the "model" group (an all-reduce whose backward is the identity:
every rank of the group computes the same loss from it).

``graph_shard(comm, n_nodes)`` and ``table_shard(comm, index, extent)``
set them for a block of code. ``comm`` is anything with ``rank``,
``world_size``, ``all_gather(vec)`` (a 1-D tensor, rank-major) and
``all_reduce(t, op)`` ("sum" or "max"): ``core.distributed.ShardComm``
on real ranks, :class:`MetaComm` on meta tensors (the dry run: shapes
only, the outputs of the collectives made but not filled).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

__all__ = ["MetaComm", "GraphShard", "TableShard", "graph_shard",
           "table_shard", "current_graph", "node_table", "reduce_nodes",
           "own_rows", "n_nodes", "lookup"]

_GRAPH = contextvars.ContextVar("graph_shard", default=None)
_TABLES = contextvars.ContextVar("table_shard", default=None)


class MetaComm:
    """The collectives' outputs at their shapes, on any device: what a
    rank of ``world_size`` holds after each (for the dry run's meta
    tensors; the values are not the sums)."""

    def __init__(self, world_size: int, rank: int = 0):
        self.world_size, self.rank = int(world_size), int(rank)

    def all_gather(self, vec: torch.Tensor) -> torch.Tensor:
        return vec.repeat(self.world_size)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return t.clone()


def _all_reduce(comm, t: torch.Tensor, op: str) -> torch.Tensor:
    if op == "min":
        return -comm.all_reduce(-t, "max")
    return comm.all_reduce(t, op)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, shard):
        ctx.shard = shard
        flat = shard.comm.all_gather(h.contiguous().reshape(-1))
        return flat.reshape((-1,) + tuple(h.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        return shard.own(_all_reduce(shard.comm, g.contiguous(), "sum")), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, shard, op):
        out = _all_reduce(shard.comm, partial, op)
        ctx.shard, ctx.op = shard, op
        if op != "sum":
            ctx.save_for_backward(partial == out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(ctx.shard.comm, g.contiguous(), "sum")
        if ctx.op != "sum":
            (holds,) = ctx.saved_tensors
            g = g * holds.to(g.dtype)
        return g, None, None


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, comm):
        return comm.all_reduce(partial, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class GraphShard:
    """Rank ``comm.rank`` of ``comm.world_size`` holding node rows
    [rank · N/P, (rank + 1) · N/P) of a graph of ``n_nodes`` (N, a
    multiple of P) and its share of the edges, indexed by global id."""

    def __init__(self, comm, n_nodes: int):
        self.comm = comm
        self.n_nodes = int(n_nodes)
        self.world = comm.world_size
        if self.n_nodes % self.world:
            raise ValueError(f"{self.n_nodes} nodes do not divide over "
                             f"{self.world} ranks")
        self.rows = self.n_nodes // self.world
        self.start = comm.rank * self.rows

    def table(self, h: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(h, self)

    def reduce(self, partial: torch.Tensor, op: str) -> torch.Tensor:
        return _Reduce.apply(partial, self, op)

    def own(self, full: torch.Tensor) -> torch.Tensor:
        return full[self.start:self.start + self.rows]


class TableShard:
    """Rank ``index`` of the ``extent`` ranks of a "model" group, holding
    rows [index · V/M, (index + 1) · V/M) of each table; ``comm`` sums
    over the group (None: a group of one)."""

    def __init__(self, comm, index: int, extent: int):
        self.comm, self.index, self.extent = comm, int(index), int(extent)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        rows = table.shape[0]
        local = ids.long() - self.index * rows
        held = (local >= 0) & (local < rows)
        emb = torch.index_select(table, 0, local.clamp(0, rows - 1))
        emb = torch.where(held[:, None], emb, 0.0)
        if self.comm is None or self.extent == 1:
            return emb
        return _GroupSum.apply(emb, self.comm)


@contextlib.contextmanager
def _scoped(var: contextvars.ContextVar, value):
    token = var.set(value)
    try:
        yield value
    finally:
        var.reset(token)


def graph_shard(comm, n_nodes: int):
    """Run the GNN models as rank ``comm.rank``'s share of a graph of
    ``n_nodes`` nodes inside the ``with`` block (see the module
    docstring)."""
    return _scoped(_GRAPH, GraphShard(comm, n_nodes))


def table_shard(comm, index: int, extent: int):
    """Look DCN-v2's tables up as rank ``index`` of a "model" group of
    ``extent`` inside the ``with`` block (see the module docstring)."""
    return _scoped(_TABLES, TableShard(comm, index, extent))


def current_graph() -> Optional[GraphShard]:
    return _GRAPH.get()


def n_nodes(h: torch.Tensor) -> int:
    """The graph's node count: ``h``'s rows, or the sharded graph's."""
    g = _GRAPH.get()
    return h.shape[0] if g is None else g.n_nodes


def node_table(h: torch.Tensor) -> torch.Tensor:
    g = _GRAPH.get()
    return h if g is None else g.table(h)


def reduce_nodes(partial: torch.Tensor, op: str = "sum") -> torch.Tensor:
    g = _GRAPH.get()
    return partial if g is None else g.reduce(partial, op)


def own_rows(full: torch.Tensor) -> torch.Tensor:
    g = _GRAPH.get()
    return full if g is None else g.own(full)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> Optional[torch.Tensor]:
    """The sharded lookup of ``table`` at ``ids``, or None on one card."""
    t = _TABLES.get()
    return None if t is None else t.lookup(table, ids)
