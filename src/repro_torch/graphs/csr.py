"""CSR graph container and the sketch fold plans, on torch tensors.

A copy of ``repro.graphs.csr`` (the JAX reference) for the two plans the
main path runs: the bucketed ``FoldPlan`` that the plain-torch reference
engine walks, and the ``FusedFoldPlan`` whose rounds the CUDA kernels in
``repro_torch.kernels.mg_sketch.fused`` fold in one launch each.

Plan construction is host-side numpy, line for line the reference's; only
the final arrays become tensors on the requested device. Dtypes are kept:
int32 offsets, indices, labels and plan arrays, float32 weights.

  * every vertex's neighbour list is chunked into rows of at most
    ``chunk`` entries ("virtual vertices"; the paper's D_H = 128);
  * a row folds into one k-slot partial sketch, and the rows of one vertex
    merge in later rounds (MG summaries are mergeable), so the number of
    rounds is O(log_{chunk/k} D_max).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

PAD = np.int32(-1)  # gather sentinel for padded entries


def _tensor(x: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


@dataclasses.dataclass
class CSRGraph:
    """Symmetric weighted graph in CSR form (tensors on one device)."""

    offsets: torch.Tensor  # [N+1] int32 — row offsets
    indices: torch.Tensor  # [M] int32 — neighbor ids (both directions stored)
    weights: torch.Tensor  # [M] float32 — edge weights (w_ij == w_ji)
    n_nodes: int  # int — vertex count N
    n_edges: int  # int — directed edge slots == len(indices)

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    @property
    def total_weight(self) -> torch.Tensor:
        """m = half the sum of all directed edge weights."""
        return 0.5 * torch.sum(self.weights)

    def sources(self) -> torch.Tensor:
        """Per-directed-edge source vertex id (expanded CSR rows), [M] int32."""
        ids = torch.arange(self.n_nodes, dtype=torch.int32, device=self.device)
        return torch.repeat_interleave(ids, self.degrees.long(),
                                       output_size=self.n_edges)


def graph_from_arrays(offsets, indices, weights, n_nodes: int,
                      device=None) -> CSRGraph:
    """Carry a graph across: CSR arrays (numpy, e.g. from the JAX package's
    ``CSRGraph``) become the port's ``CSRGraph`` on ``device``."""
    device = resolve_device(device)
    offsets = np.asarray(offsets)
    indices = np.asarray(indices)
    weights = np.asarray(weights)
    if offsets.shape != (n_nodes + 1,):
        raise ValueError(f"offsets has shape {offsets.shape}, expected "
                         f"({n_nodes + 1},)")
    if indices.shape != weights.shape or indices.ndim != 1:
        raise ValueError("indices and weights must be 1-D of one length")
    if int(offsets[-1]) != len(indices):
        raise ValueError("offsets[-1] must equal the number of entries")
    return CSRGraph(offsets=_tensor(offsets, device, torch.int32),
                    indices=_tensor(indices, device, torch.int32),
                    weights=_tensor(weights, device, torch.float32),
                    n_nodes=int(n_nodes), n_edges=int(len(indices)))


def build_csr(edges: np.ndarray, n_nodes: int, weights: np.ndarray | None = None,
              symmetrize: bool = True, dedupe: bool = True,
              device=None) -> CSRGraph:
    """Build a CSRGraph from an [E, 2] int array of (possibly directed) edges.

    Self-loops are dropped (the paper's LPA skips j == i during voting).
    Duplicate edges have their weights accumulated.
    """
    device = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    if weights is None:
        weights = np.ones(len(edges), dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    keep = edges[:, 0] != edges[:, 1]
    edges, weights = edges[keep], weights[keep]
    if symmetrize and len(edges):
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
        weights = np.concatenate([weights, weights], axis=0)
    if len(edges):
        key = edges[:, 0] * n_nodes + edges[:, 1]
        order = np.argsort(key, kind="stable")
        key, edges, weights = key[order], edges[order], weights[order]
        if dedupe:
            first = np.concatenate([[True], key[1:] != key[:-1]])
            group = np.cumsum(first) - 1
            weights = np.bincount(group, weights=weights,
                                  minlength=int(group[-1]) + 1).astype(np.float32)
            edges = edges[first]
    counts = np.bincount(edges[:, 0], minlength=n_nodes) if len(edges) else \
        np.zeros(n_nodes, dtype=np.int64)
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return CSRGraph(
        offsets=_tensor(offsets, device, torch.int32),
        indices=_tensor(edges[:, 1], device, torch.int32),
        weights=_tensor(weights, device, torch.float32),
        n_nodes=int(n_nodes),
        n_edges=int(len(edges)),
    )


# ---------------------------------------------------------------------------
# Bucketed plan: the plain-torch reference engine's layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FoldBucket:
    """One statically-shaped padded tile group inside a fold round."""

    width: int             # int — D, entries per row (power of two, <= chunk)
    gather: torch.Tensor   # [R, D] int32 — indices into the round's entry arrays (PAD = -1)
    out_pos: torch.Tensor  # [R] int32 — canonical (vertex, chunk-rank) row position
    vertex: torch.Tensor   # [R] int32 — owning vertex of each row
    n_rows: int            # int — R, rows in this bucket's tile


@dataclasses.dataclass(frozen=True)
class FoldRound:
    buckets: Tuple[FoldBucket, ...]  # tuple[FoldBucket] — one padded tile per width
    n_entries_in: int    # int — length of the entry arrays this round consumes
    n_rows_total: int    # int — partial sketches produced (canonical rows)


@dataclasses.dataclass(frozen=True)
class FoldPlan:
    """Static multi-round reduction plan for the sketch folds.

    ``row_rank0`` maps each canonical round-0 row to its chunk rank within
    its vertex (``max_rows0`` = max chunk rows any vertex owns).
    """

    rounds: Tuple[FoldRound, ...]  # tuple[FoldRound] — one bucketed fold round each
    row_to_vertex: torch.Tensor  # [final n_rows] int32 — owning vertex of each final sketch
    n_nodes: int  # int — vertex count N of the planned graph
    k: int        # int — sketch slots per row
    chunk: int    # int — entries per virtual-vertex row (paper D_H)
    row_rank0: Optional[torch.Tensor] = None  # [round-0 n_rows] int32 — chunk rank
    max_rows0: int = 1  # int — max chunk rows any vertex owns on round 0

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


def _bucket_widths(chunk: int, min_width: int = 4) -> List[int]:
    widths, w = [], min_width
    while w < chunk:
        widths.append(w)
        w *= 2
    widths.append(chunk)
    return widths


def _plan_round(counts: np.ndarray, starts: np.ndarray, chunk: int,
                widths: Sequence[int]):
    """Chunk per-vertex entry ranges [starts, starts+counts) into bucketed rows.

    Row order before bucketing is canonical: grouped by vertex, then chunk
    rank. Returns (buckets, n_chunks_per_vertex, row_vertex_canonical) where
    each bucket is (width, gather[R, D], out_pos[R], vertex[R]).
    """
    n = len(counts)
    n_chunks = ((counts + chunk - 1) // chunk).astype(np.int64)
    total_rows = int(n_chunks.sum())
    row_vertex = np.repeat(np.arange(n, dtype=np.int64), n_chunks)
    row_rank = np.arange(total_rows, dtype=np.int64) - np.repeat(
        np.cumsum(n_chunks) - n_chunks, n_chunks)
    row_start = starts[row_vertex] + row_rank * chunk
    row_count = np.minimum(counts[row_vertex] - row_rank * chunk, chunk)

    buckets = []
    widths_arr = np.asarray(widths)
    which = np.searchsorted(widths_arr, row_count)  # smallest width >= count
    for wi, width in enumerate(widths):
        sel = np.nonzero(which == wi)[0]
        if sel.size == 0:
            continue
        rs, rc, rv = row_start[sel], row_count[sel], row_vertex[sel]
        gather = rs[:, None] + np.arange(width)[None, :]
        mask = np.arange(width)[None, :] < rc[:, None]
        gather = np.where(mask, gather, PAD).astype(np.int32)
        buckets.append((int(width), gather, sel.astype(np.int32),
                        rv.astype(np.int32)))
    return buckets, n_chunks, row_vertex


def build_fold_plan(degrees: np.ndarray, k: int = 8, chunk: int = 128,
                    min_width: int = 4, device=None) -> FoldPlan:
    """Construct the static multi-round fold plan from the degree sequence."""
    device = resolve_device(device)
    degrees = np.asarray(degrees, dtype=np.int64)
    n = len(degrees)
    if chunk <= k:
        raise ValueError(f"chunk ({chunk}) must exceed sketch slots k ({k})")
    widths = _bucket_widths(chunk, min_width)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])

    rounds: List[FoldRound] = []
    counts, starts = degrees, offsets[:-1].copy()
    n_entries = int(degrees.sum())
    row_rank0 = None
    max_rows0 = 1
    while True:
        np_buckets, n_chunks, row_vertex = _plan_round(counts, starts, chunk, widths)
        n_rows = int(n_chunks.sum())
        if row_rank0 is None:  # round 0: static (vertex, rank) coordinates
            row_rank0 = np.arange(n_rows, dtype=np.int64) - np.repeat(
                np.cumsum(n_chunks) - n_chunks, n_chunks)
            max_rows0 = max(int(n_chunks.max()) if len(n_chunks) else 0, 1)
        rounds.append(FoldRound(
            buckets=tuple(
                FoldBucket(width=w, gather=_tensor(g, device),
                           out_pos=_tensor(p, device),
                           vertex=_tensor(v, device), n_rows=len(v))
                for (w, g, p, v) in np_buckets),
            n_entries_in=n_entries,
            n_rows_total=n_rows,
        ))
        if np.all(n_chunks <= 1):
            final_row_vertex = row_vertex
            break
        # Next round consumes the flattened [n_rows, k] canonical sketches;
        # vertex i's entries are contiguous at k * [chunk-row span of i].
        counts = n_chunks * k
        starts = np.zeros(n, dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        n_entries = n_rows * k

    return FoldPlan(rounds=tuple(rounds),
                    row_to_vertex=_tensor(final_row_vertex, device, torch.int32),
                    n_nodes=n, k=k, chunk=chunk,
                    row_rank0=_tensor(row_rank0, device, torch.int32),
                    max_rows0=max_rows0)


# ---------------------------------------------------------------------------
# Fused plan: one kernel launch per round
# ---------------------------------------------------------------------------
#
# Every gather the bucketed plan produces is a masked contiguous range
# (row_start + arange(width), masked by count), so a round needs only two
# scalars per row: (start, count). Rows are ordered vertex-major (all chunk
# rows of a vertex contiguous, in rank order) with vertices sorted by
# ascending entry count: round r+1 reads vertex v's round-r partial sketches
# as ONE contiguous slice of the round-r output, and rows of similar width
# share a warp on the card.


@dataclasses.dataclass(frozen=True)
class FusedRound:
    """Per-round metadata of the fused single-launch fold."""

    row_start: torch.Tensor  # [n_steps, tile_r] int32 — offset into the flat entries (0 on pad rows)
    row_count: torch.Tensor  # [n_steps, tile_r] int32 — valid entries of the row (0 on pad rows)
    step_dmax: torch.Tensor  # [n_steps, 1] int32 — max row_count within the step
    n_entries_in: int        # int — flat entry-array length this round consumes
    # [n_steps * tile_r] int32 — owning vertex of each padded row (-1 on pad rows)
    row_vertex: Optional[torch.Tensor] = None

    @property
    def n_steps(self) -> int:
        return self.row_start.shape[0]

    @property
    def tile_r(self) -> int:
        return self.row_start.shape[1]


@dataclasses.dataclass(frozen=True)
class FusedFoldPlan:
    """Static fused reduction plan: one kernel launch per round.

    ``row_to_vertex0``/``row_rank0`` map each round-0 padded row to its
    (owning vertex, chunk rank).
    """

    rounds: Tuple[FusedRound, ...]  # tuple[FusedRound] — one fused fold round each
    row_to_vertex: torch.Tensor  # [last n_steps * tile_r] int32 — owning vertex (-1 pad)
    n_nodes: int  # int — vertex count N of the planned graph
    k: int        # int — sketch slots per row
    chunk: int    # int — entries per virtual-vertex row (paper D_H)
    row_to_vertex0: Optional[torch.Tensor] = None  # [round-0 n_steps * tile_r] int32
    row_rank0: Optional[torch.Tensor] = None       # [round-0 n_steps * tile_r] int32
    max_rows0: int = 1  # int — max chunk rows any vertex owns on round 0

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


def build_fused_fold_plan(degrees: np.ndarray, k: int = 8, chunk: int = 128,
                          tile_r: int = 128, device=None) -> FusedFoldPlan:
    """Construct the fused multi-round plan from the degree sequence.

    Folds the identical entry sequences as ``build_fold_plan`` (same
    chunking, same within-row order), so per-vertex results are
    bit-identical; only the row ordering and the launch structure differ.
    """
    device = resolve_device(device)
    degrees = np.asarray(degrees, dtype=np.int64)
    n = len(degrees)
    if chunk <= k:
        raise ValueError(f"chunk ({chunk}) must exceed sketch slots k ({k})")

    counts = degrees.copy()
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    starts = offsets[:-1].copy()
    n_entries = int(degrees.sum())

    rounds: List[FusedRound] = []
    rtv0 = rank0 = None
    max_rows0 = 1
    while True:
        order = np.argsort(counts, kind="stable")  # ascending entry count
        n_chunks = ((counts + chunk - 1) // chunk).astype(np.int64)
        nc_ord = n_chunks[order]
        total_rows = int(nc_ord.sum())
        row_vertex = np.repeat(order, nc_ord)
        row_rank = np.arange(total_rows, dtype=np.int64) - np.repeat(
            np.cumsum(nc_ord) - nc_ord, nc_ord)
        row_start = starts[row_vertex] + row_rank * chunk
        row_count = np.minimum(counts[row_vertex] - row_rank * chunk, chunk)

        pad = (-total_rows) % tile_r if total_rows else tile_r
        rs = np.concatenate([row_start, np.zeros(pad, np.int64)])
        rc = np.concatenate([row_count, np.zeros(pad, np.int64)])
        rv_pad = np.concatenate(
            [row_vertex, np.full(pad, -1, np.int64)]).astype(np.int32)
        n_steps = len(rs) // tile_r
        rs2 = rs.reshape(n_steps, tile_r).astype(np.int32)
        rc2 = rc.reshape(n_steps, tile_r).astype(np.int32)
        rounds.append(FusedRound(
            row_start=_tensor(rs2, device), row_count=_tensor(rc2, device),
            step_dmax=_tensor(rc2.max(axis=1, keepdims=True), device),
            n_entries_in=n_entries, row_vertex=_tensor(rv_pad, device)))
        if rtv0 is None:  # round 0: (vertex, rank) per padded row
            rtv0 = rv_pad
            rank0 = np.concatenate(
                [row_rank, np.zeros(pad, np.int64)]).astype(np.int32)
            max_rows0 = max(int(n_chunks.max()) if len(n_chunks) else 0, 1)
        if np.all(n_chunks <= 1):
            rtv = rv_pad
            break
        # Next round consumes this round's padded output [n_steps*tile_r, k]
        # flattened; vertex v's entries start at (v's first row) * k.
        first_row = np.zeros(n, dtype=np.int64)
        first_row[order] = np.cumsum(nc_ord) - nc_ord
        starts = first_row * k
        counts = n_chunks * k
        n_entries = n_steps * tile_r * k

    return FusedFoldPlan(rounds=tuple(rounds), row_to_vertex=_tensor(rtv, device),
                         n_nodes=n, k=k, chunk=chunk,
                         row_to_vertex0=_tensor(rtv0, device),
                         row_rank0=_tensor(rank0, device), max_rows0=max_rows0)


def fused_dispatches(plan: FusedFoldPlan) -> int:
    """Kernel launches per MG iteration: one per round (the final round's
    launch also performs candidate selection)."""
    return plan.n_rounds


def fused_work_rows(plan: FusedFoldPlan) -> int:
    """Real fold rows one dense iteration computes (all rounds)."""
    return sum(int(torch.count_nonzero(r.row_vertex >= 0))
               for r in plan.rounds)
