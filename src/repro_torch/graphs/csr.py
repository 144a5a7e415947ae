"""CSR graph container and the sketch fold plans, on torch tensors.

A copy of ``repro.graphs.csr`` (the JAX reference) for three plans: the
bucketed ``FoldPlan`` that the plain-torch reference engine walks, the
``FusedFoldPlan`` whose rounds the CUDA kernels in
``repro_torch.kernels.mg_sketch.fused`` fold in one launch each, and the
windowed ``StreamedFoldPlan`` (optionally with round 0 pre-aligned) whose
rounds the kernels in ``repro_torch.kernels.mg_sketch.streaming`` fold in
one launch each, one block per window.

Plan construction is host-side numpy, line for line the reference's; only
the final arrays become tensors on the requested device. Dtypes are kept:
int32 indices, labels and plan arrays, float32 weights. Slot positions
come in two widths, chosen by the data (:func:`offsets_dtype`): a graph of
at most 2**31 - 1 slots has int32 offsets, as in the reference; past that
its offsets are int64, and so are the fused plan's round-0 row starts,
the only plan array that holds a slot position of the graph on that
path. The bucketed and the streamed plans store slot positions as int32
and refuse such a graph with a ``ValueError``.

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
from repro_torch.trace import host_read

PAD = np.int32(-1)  # gather sentinel for padded entries
#: the most slots an int32 slot position addresses
INT32_SLOTS = 2**31 - 1


def offsets_dtype(n_slots: int) -> torch.dtype:
    """The width of a graph's offsets: int32 up to :data:`INT32_SLOTS`
    slots, int64 past that."""
    return torch.int32 if n_slots <= INT32_SLOTS else torch.int64


def refuse_wide(n_slots: int, what: str) -> None:
    """Raise ``ValueError`` when ``what``, which stores int32 slot
    positions, is asked to address more than :data:`INT32_SLOTS` slots."""
    if n_slots > INT32_SLOTS:
        raise ValueError(f"{what} stores int32 slot positions and cannot "
                         f"address {n_slots:,} slots (more than "
                         f"{INT32_SLOTS:,}); fold_backend='pallas_fused' "
                         f"runs such a graph")


def _tensor(x: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


@dataclasses.dataclass
class CSRGraph:
    """Symmetric weighted graph in CSR form (tensors on one device).

    ``offsets`` are int32 for a graph of at most 2**31 - 1 slots and int64
    past that (:func:`offsets_dtype`, which the constructors here follow); a
    graph given with int64 offsets takes the wide path whatever its size.
    """

    offsets: torch.Tensor  # [N+1] int32 or int64 — row offsets
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
    return CSRGraph(offsets=_tensor(offsets, device,
                                    offsets_dtype(len(indices))),
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
    if weights is None and symmetrize and dedupe:
        return _unit_weight_csr(edges, n_nodes, device)
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
        offsets=_tensor(offsets, device, offsets_dtype(len(edges))),
        indices=_tensor(edges[:, 1], device, torch.int32),
        weights=_tensor(weights, device, torch.float32),
        n_nodes=int(n_nodes),
        n_edges=int(len(edges)),
    )


def _unit_weight_csr(edges: np.ndarray, n_nodes: int,
                     device: torch.device) -> CSRGraph:
    """``build_csr`` of unweighted edges, symmetrized and deduplicated:
    the same arrays from the sorted slot keys ``src * n + dst`` alone.
    Every weight is 1, so equal keys are interchangeable and the keys
    sort in place (no stable argsort, no gather of the edges); a slot's
    weight is its key's multiplicity, and (src, dst) come back from the
    key. About half the time and memory on the generators' graphs."""
    keep = edges[:, 0] != edges[:, 1]
    src, dst = edges[keep, 0], edges[keep, 1]
    key = np.concatenate([src * n_nodes + dst, dst * n_nodes + src])
    del src, dst, keep
    key.sort()
    first = np.ones(len(key), dtype=bool)
    np.not_equal(key[1:], key[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    del first
    weights = np.diff(starts, append=len(key)).astype(np.float32)
    src, dst = np.divmod(key[starts], n_nodes)
    del key, starts
    offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n_nodes), out=offsets[1:])
    return CSRGraph(
        offsets=_tensor(offsets, device, offsets_dtype(len(dst))),
        indices=_tensor(dst, device, torch.int32),
        weights=_tensor(weights, device, torch.float32),
        n_nodes=int(n_nodes),
        n_edges=int(len(dst)),
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
    """Construct the static multi-round fold plan from the degree sequence.
    Its gathers are int32 slot positions: a sequence of more than 2**31 - 1
    slots raises ``ValueError``."""
    device = resolve_device(device)
    degrees = np.asarray(degrees, dtype=np.int64)
    refuse_wide(int(degrees.sum()), "the bucketed plan (fold_backend 'jnp' "
                "or 'pallas')")
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


def plan_padded_entries(plan: FoldPlan) -> int:
    """Total padded entry slots across all rounds (the bucketed fold's
    compute volume: every bucket's [R, D] tile)."""
    return sum(b.width * b.n_rows for r in plan.rounds for b in r.buckets)


def plan_dispatches(plan: FoldPlan) -> int:
    """Kernel launches per MG iteration of the per-bucket ``pallas``
    backend: one K9 launch per width bucket per round."""
    return sum(len(r.buckets) for r in plan.rounds)


def plan_round0_dispatches(plan: FoldPlan) -> int:
    """Kernel launches of one round-0-only pass on the per-bucket backend
    (the BM fold: one K10 launch per round-0 width bucket)."""
    return len(plan.rounds[0].buckets) if plan.rounds else 0


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

    # [n_steps, tile_r] — offset into the flat entries (0 on pad rows):
    # int32, or int64 on round 0 of a graph with int64 offsets
    row_start: torch.Tensor
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
                          tile_r: int = 128, device=None,
                          starts_dtype: Optional[torch.dtype] = None
                          ) -> FusedFoldPlan:
    """Construct the fused multi-round plan from the degree sequence.

    Folds the identical entry sequences as ``build_fold_plan`` (same
    chunking, same within-row order), so per-vertex results are
    bit-identical; only the row ordering and the launch structure differ.

    Round 0's row starts are slot positions of the graph, kept in
    ``starts_dtype``, the width of the graph's offsets (None: the width
    :func:`offsets_dtype` gives the sequence's slot count); later rounds
    index k-slot sketches and are int32.
    """
    device = resolve_device(device)
    degrees = np.asarray(degrees, dtype=np.int64)
    n = len(degrees)
    if chunk <= k:
        raise ValueError(f"chunk ({chunk}) must exceed sketch slots k ({k})")
    n_slots = int(degrees.sum())
    if starts_dtype is None:
        starts_dtype = offsets_dtype(n_slots)
    if starts_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"row starts are int32 or int64, not {starts_dtype}")
    if starts_dtype == torch.int32:
        refuse_wide(n_slots, "a fused plan with int32 row starts")

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
        if rounds:  # a later round's starts index its input's sketches
            assert n_entries <= INT32_SLOTS, n_entries
            rs2 = rs.reshape(n_steps, tile_r).astype(np.int32)
        else:
            rs2 = rs.reshape(n_steps, tile_r)
        rc2 = rc.reshape(n_steps, tile_r).astype(np.int32)
        rounds.append(FusedRound(
            row_start=_tensor(rs2, device, starts_dtype if not rounds
                              else None),
            row_count=_tensor(rc2, device),
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


def fused_hbm_entries(plan: FusedFoldPlan) -> int:
    """Real entries the fused fold reads from device memory per iteration
    (the kernels read exactly ``row_count`` entries a row, so pad slots
    cost no traffic)."""
    return int(sum(int(r.row_count.sum()) for r in plan.rounds))


def fused_dispatches(plan: FusedFoldPlan) -> int:
    """Kernel launches per MG iteration: one per round (the final round's
    launch also performs candidate selection)."""
    return plan.n_rounds


def fused_work_rows(plan: FusedFoldPlan) -> int:
    """Real fold rows one dense iteration computes (all rounds)."""
    return sum(host_read(torch.count_nonzero(r.row_vertex >= 0),
                         "dense_rows") for r in plan.rounds)


# ---------------------------------------------------------------------------
# Streamed plan: fixed-size entry windows, one block per window on the card
# ---------------------------------------------------------------------------
#
# The streamed plan re-lays every round's entries into fixed-size windows of
# at most ``window_entries`` slots such that no row straddles a window
# boundary: each window owns at most ``tile_r`` rows whose entries are
# packed contiguously at window-relative offsets, with the invariant
# ``rel_start + chunk <= window_entries``. Windows close greedily on
# whichever cap hits first (rows == tile_r, or entries past the slice-safe
# limit), and the materialized window stride is shrunk to the widest window
# actually produced (a multiple of _STREAM_ALIGN). The kernels
# (repro_torch.kernels.mg_sketch.streaming) run one block per window.

_STREAM_ALIGN = 128  # the materialized window stride is a multiple of this


@dataclasses.dataclass(frozen=True)
class StreamedRound:
    """Per-round metadata of the windowed fold.

    Shapes (W = ``window_entries``, R = rows per window = the plan's
    ``tile_r``): the round covers ``n_windows`` windows; window ``w`` owns
    entry slots ``[w*W, (w+1)*W)`` of the windowed layout and row slots
    ``[w*R, (w+1)*R)`` of the padded output.
    """

    entry_gather: torch.Tensor  # [n_windows * W] int32 — source position per windowed slot (-1 = pad)
    row_start: torch.Tensor     # [n_windows, R] int32 — window-RELATIVE entry offset (0 on pad rows)
    row_count: torch.Tensor     # [n_windows, R] int32 — valid entries of the row (0 on pad rows)
    step_dmax: torch.Tensor     # [n_windows, 1] int32 — max row_count within the window
    n_entries_in: int           # int — flat source entry-array length this round consumes
    window_entries: int         # int — W, entry slots per window (slice-safe: rel+chunk <= W)
    # [n_windows * R] int32 — owning vertex of each row slot (-1 on pad slots)
    row_vertex: Optional[torch.Tensor] = None
    # bool — True when the round's source entries are ALREADY in the
    # windowed layout (build_streamed_fold_plan(aligned=True) round 0):
    # entry_gather is the identity over real slots, n_entries_in is
    # n_windows * W, and the round wrappers skip the re-layout gather
    aligned: bool = False

    @property
    def n_windows(self) -> int:
        return self.row_start.shape[0]

    @property
    def tile_r(self) -> int:
        return self.row_start.shape[1]


@dataclasses.dataclass(frozen=True)
class StreamedFoldPlan:
    """Static windowed reduction plan: one kernel launch per round, one
    block per window of at most ``window_entries`` entry slots.

    With ``aligned_entry_vertex``/``aligned_entry_weights`` set
    (``build_streamed_fold_plan(aligned=True)``), round 0's entry arrays
    are pre-materialized in the windowed layout: ``lpa_move`` gathers
    neighbour labels straight into window slots and round 0 skips the
    per-iteration re-layout gather.
    """

    rounds: Tuple[StreamedRound, ...]  # tuple[StreamedRound] — one windowed fold round each
    row_to_vertex: torch.Tensor  # [last n_windows * tile_r] int32 — owning vertex (-1 pad)
    n_nodes: int   # int — vertex count N of the planned graph
    k: int         # int — sketch slots per row
    chunk: int     # int — entries per virtual-vertex row (paper D_H)
    row_to_vertex0: Optional[torch.Tensor] = None  # [round-0 n_windows * tile_r] int32
    row_rank0: Optional[torch.Tensor] = None       # [round-0 n_windows * tile_r] int32
    max_rows0: int = 1  # int — max chunk rows any vertex owns on round 0
    # [round-0 n_windows * W] int32 — neighbour VERTEX id per round-0
    # window slot, sentinel n_nodes on pad slots (None: unaligned layout).
    # ``lpa_move`` gathers labels_ext[aligned_entry_vertex], where
    # labels_ext appends one -1 slot, yielding windowed entry labels.
    aligned_entry_vertex: Optional[torch.Tensor] = None
    # [round-0 n_windows * W] float32 — edge weight per round-0 window slot
    # (0.0 on pad slots). None: unaligned layout.
    aligned_entry_weights: Optional[torch.Tensor] = None

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def aligned(self) -> bool:
        """True when round 0 carries the pre-materialized windowed layout."""
        return self.aligned_entry_vertex is not None


def _pack_stream_windows(row_count: np.ndarray, chunk: int, tile_r: int,
                         window_cap: int) -> dict:
    """Greedily assign rows (kept in order) to slice-safe entry windows.

    Rows pack contiguously: row i's window-relative start is the sum of the
    counts of the rows before it in the same window. A window closes when it
    holds ``tile_r`` rows or when the next row's ``rel_start + chunk`` would
    exceed ``window_cap``.

    Returns numpy arrays: ``win_of_row``/``rel_start``/``slot_of_row`` per
    row, plus ``n_windows`` and the aligned ``window_entries`` stride
    actually needed (>= ``chunk``).
    """
    if window_cap < chunk:
        raise ValueError(f"window_cap ({window_cap}) must be >= chunk "
                         f"({chunk}) for slice-safe rows")
    n_rows = len(row_count)
    if n_rows == 0:
        w = -(-chunk // _STREAM_ALIGN) * _STREAM_ALIGN
        return {"win_of_row": np.zeros(0, np.int64),
                "rel_start": np.zeros(0, np.int64),
                "slot_of_row": np.zeros(0, np.int64),
                "n_windows": 1, "window_entries": w}
    cum = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(row_count, out=cum[1:])
    firsts = []
    p = 0
    while p < n_rows:
        # last includable row q has rel_start = cum[q]-cum[p] <= cap - chunk
        q = int(np.searchsorted(cum, cum[p] + window_cap - chunk,
                                side="right"))
        q = max(min(q, p + tile_r, n_rows), p + 1)
        firsts.append(p)
        p = q
    firsts_arr = np.asarray(firsts, dtype=np.int64)
    n_windows = len(firsts)
    rows_per_win = np.diff(np.concatenate([firsts_arr, [n_rows]]))
    win_of_row = np.repeat(np.arange(n_windows, dtype=np.int64), rows_per_win)
    rel_start = cum[:-1] - cum[firsts_arr[win_of_row]]
    slot_of_row = win_of_row * tile_r + (np.arange(n_rows) -
                                         firsts_arr[win_of_row])
    need = int((rel_start + chunk).max())
    w = -(-max(need, chunk) // _STREAM_ALIGN) * _STREAM_ALIGN
    return {"win_of_row": win_of_row, "rel_start": rel_start,
            "slot_of_row": slot_of_row, "n_windows": n_windows,
            "window_entries": w}


def _materialize_stream_round(row_vstart: np.ndarray, row_count: np.ndarray,
                              pack: dict, pos_table: np.ndarray | None,
                              tile_r: int) -> dict:
    """Build one round's arrays from a window packing.

    ``row_vstart`` is each row's start in the round's *virtual* vertex-major
    entry space; ``pos_table`` (None on round 0) maps virtual positions to
    actual positions in the previous round's padded flattened output.
    Returns int32 numpy arrays: ``entry_gather`` [n_windows * W],
    ``row_start``/``row_count`` [n_windows, R], ``step_dmax`` [n_windows, 1].
    """
    n_rows = len(row_count)
    n_windows, w = pack["n_windows"], pack["window_entries"]
    gather = np.full(n_windows * w, -1, dtype=np.int64)
    if n_rows:
        cum = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(row_count, out=cum[1:])
        total = int(cum[-1])
        row_of_entry = np.repeat(np.arange(n_rows, dtype=np.int64), row_count)
        intra = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1],
                                                             row_count)
        out_pos = (pack["win_of_row"][row_of_entry] * w
                   + pack["rel_start"][row_of_entry] + intra)
        src = row_vstart[row_of_entry] + intra
        if pos_table is not None:
            src = pos_table[src]
        gather[out_pos] = src
    rs = np.zeros((n_windows * tile_r,), dtype=np.int64)
    rc = np.zeros((n_windows * tile_r,), dtype=np.int64)
    rs[pack["slot_of_row"]] = pack["rel_start"]
    rc[pack["slot_of_row"]] = row_count
    rs = rs.reshape(n_windows, tile_r).astype(np.int32)
    rc = rc.reshape(n_windows, tile_r).astype(np.int32)
    return {"entry_gather": gather.astype(np.int32), "row_start": rs,
            "row_count": rc,
            "step_dmax": rc.max(axis=1, keepdims=True).astype(np.int32)}


def build_streamed_rounds(counts: np.ndarray, starts: np.ndarray,
                          n_entries: int, *, k: int, chunk: int, tile_r: int,
                          window_cap: int, min_rounds: int = 1
                          ) -> Tuple[List[dict], np.ndarray]:
    """Host-side core of the streamed plan.

    ``counts``/``starts`` [N] give each vertex's entry range in the round-0
    source array of length ``n_entries`` (CSR degrees/offsets). Folds the
    identical per-row entry sequences as ``build_fused_fold_plan`` (same
    chunking, same ascending-count row sort), so per-vertex results are
    bit-identical; only the window re-layout differs. ``min_rounds``
    forces extra merge rounds.

    Returns (one numpy dict per round with the ``StreamedRound`` fields,
    final ``row_to_vertex`` [last n_windows * tile_r], -1 on pad slots).
    """
    counts = np.asarray(counts, dtype=np.int64).copy()
    starts = np.asarray(starts, dtype=np.int64).copy()
    n = len(counts)
    rounds: List[dict] = []
    pos_table: np.ndarray | None = None
    r = 0
    while True:
        order = np.argsort(counts, kind="stable")  # ascending entry count
        n_chunks = ((counts + chunk - 1) // chunk).astype(np.int64)
        nc_ord = n_chunks[order]
        total_rows = int(nc_ord.sum())
        row_vertex = np.repeat(order, nc_ord)
        row_rank = np.arange(total_rows, dtype=np.int64) - np.repeat(
            np.cumsum(nc_ord) - nc_ord, nc_ord)
        row_vstart = starts[row_vertex] + row_rank * chunk
        row_count = np.minimum(counts[row_vertex] - row_rank * chunk, chunk)
        pack = _pack_stream_windows(row_count, chunk, tile_r, window_cap)
        rnd = _materialize_stream_round(row_vstart, row_count, pack,
                                        pos_table, tile_r)
        rnd.update(n_entries_in=int(n_entries),
                   window_entries=pack["window_entries"])
        # slot -> (owning vertex, chunk rank) of this round's rows (-1/0 on
        # pad slots) — round 0's is what the BM fold and rescan reduce over
        slot_v = np.full(pack["n_windows"] * tile_r, -1, dtype=np.int64)
        slot_r = np.zeros(pack["n_windows"] * tile_r, dtype=np.int64)
        slot_v[pack["slot_of_row"]] = row_vertex
        slot_r[pack["slot_of_row"]] = row_rank
        rnd.update(row_to_vertex=slot_v.astype(np.int32),
                   row_rank=slot_r.astype(np.int32),
                   max_rows=max(int(n_chunks.max()) if len(n_chunks) else 0,
                                1))
        rounds.append(rnd)
        if np.all(n_chunks <= 1) and (r + 1) >= min_rounds:
            rtv = np.full(pack["n_windows"] * tile_r, -1, dtype=np.int64)
            rtv[pack["slot_of_row"]] = row_vertex
            return rounds, rtv.astype(np.int32)
        # Next round consumes each vertex's partial [k]-slot sketches in
        # (vertex, rank) order; pos_table maps that vertex-major virtual
        # space to the actual padded slots of this round's output.
        vm = np.lexsort((row_rank, row_vertex))
        slots_vm = pack["slot_of_row"][vm]
        pos_table = (slots_vm[:, None] * k
                     + np.arange(k, dtype=np.int64)).reshape(-1)
        counts = n_chunks * k
        starts = np.zeros(n, dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        n_entries = pack["n_windows"] * tile_r * k
        r += 1


def build_streamed_fold_plan(degrees: np.ndarray, k: int = 8,
                             chunk: int = 128, tile_r: int = 128,
                             window_entries: int = 8192, *,
                             indices: np.ndarray | None = None,
                             weights: np.ndarray | None = None,
                             aligned: bool = False,
                             device=None) -> StreamedFoldPlan:
    """Construct the windowed plan from the degree sequence.

    ``window_entries`` caps the entry slots per window. Folds the identical
    entry sequences as ``build_fold_plan``/``build_fused_fold_plan``, so
    per-vertex results are bit-identical; only the windowed layout and the
    per-window launch grid differ.

    ``aligned=True`` (requires the CSR ``indices``/``weights`` on the
    host) stores the round-0 entry arrays window-aligned at build time:
    the plan carries ``aligned_entry_vertex``/``aligned_entry_weights``,
    round 0's ``entry_gather`` becomes the identity over window slots
    (real slots -> themselves, pads -> -1) and its ``n_entries_in`` the
    window-slot count. Later rounds are unchanged.
    """
    device = resolve_device(device)
    degrees = np.asarray(degrees, dtype=np.int64)
    refuse_wide(int(degrees.sum()), "the streamed plan (fold_backend "
                "'pallas_stream')")
    n = len(degrees)
    if chunk <= k:
        raise ValueError(f"chunk ({chunk}) must exceed sketch slots k ({k})")
    if aligned and (indices is None or weights is None):
        raise ValueError("aligned=True needs the CSR indices and weights to "
                         "pre-materialize the windowed round-0 entries")
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=offsets[1:])
    rounds_np, rtv = build_streamed_rounds(
        degrees, offsets[:-1], int(degrees.sum()), k=k, chunk=chunk,
        tile_r=tile_r, window_cap=window_entries)
    aev = aew = None
    rounds = []
    for ri, r in enumerate(rounds_np):
        eg, n_in, is_aligned = r["entry_gather"], r["n_entries_in"], False
        if aligned and ri == 0:
            idx = np.asarray(indices, dtype=np.int64)
            wgt = np.asarray(weights, dtype=np.float32)
            valid = eg >= 0
            safe = np.maximum(eg, 0)
            src_v = idx[safe] if idx.size else np.zeros_like(safe)
            src_w = wgt[safe] if wgt.size else np.zeros(safe.shape, np.float32)
            # pad slots: sentinel vertex n (the -1 label slot lpa_move
            # appends) and weight 0.0, the fold's no-op entry
            aev = _tensor(np.where(valid, src_v, n).astype(np.int32), device)
            aew = _tensor(np.where(valid, src_w, 0.0).astype(np.float32),
                          device)
            n_slots = eg.shape[0]
            eg = np.where(valid, np.arange(n_slots, dtype=np.int64),
                          -1).astype(np.int32)
            n_in, is_aligned = n_slots, True
        rounds.append(
            StreamedRound(entry_gather=_tensor(eg, device),
                          row_start=_tensor(r["row_start"], device),
                          row_count=_tensor(r["row_count"], device),
                          step_dmax=_tensor(r["step_dmax"], device),
                          n_entries_in=int(n_in),
                          window_entries=r["window_entries"],
                          row_vertex=_tensor(r["row_to_vertex"], device),
                          aligned=is_aligned))
    return StreamedFoldPlan(rounds=tuple(rounds),
                            row_to_vertex=_tensor(rtv, device),
                            n_nodes=n, k=k, chunk=chunk,
                            row_to_vertex0=_tensor(
                                rounds_np[0]["row_to_vertex"], device),
                            row_rank0=_tensor(rounds_np[0]["row_rank"],
                                              device),
                            max_rows0=rounds_np[0]["max_rows"],
                            aligned_entry_vertex=aev,
                            aligned_entry_weights=aew)


def streamed_dispatches(plan: StreamedFoldPlan) -> int:
    """Kernel launches per MG iteration: one per round (the final round's
    launch also selects); the window grid lives inside each launch."""
    return plan.n_rounds


def streamed_window_slots(plan: StreamedFoldPlan) -> int:
    """Windowed entry slots materialized per iteration across rounds
    (pad slots included, unlike :func:`streamed_hbm_entries`)."""
    return sum(r.n_windows * r.window_entries for r in plan.rounds)


def streamed_gather_slots(plan: StreamedFoldPlan) -> int:
    """Windowed re-layout gather slots the streamed engine materializes per
    iteration. Aligned rounds are excluded: their windowed entries were
    materialized once at build time."""
    return sum(r.n_windows * r.window_entries for r in plan.rounds
               if not r.aligned)


def streamed_hbm_entries(plan: StreamedFoldPlan) -> int:
    """Real entries the streamed fold reads per iteration (equal to the
    fused plan's: the window re-layout adds pad slots, no real entries)."""
    return int(sum(int(r.row_count.sum()) for r in plan.rounds))


def streamed_peak_window_bytes(plan: StreamedFoldPlan) -> int:
    """The reference's per-step resident entry bytes of the widest round:
    a double-buffered (int32 label + float32 weight) window, ``2 * W * 8``
    bytes. Kept for parity with the reference's accounting; the CUDA
    kernels stage nothing and read each entry once from device memory."""
    if not plan.rounds:
        return 0
    return max(2 * r.window_entries * 8 for r in plan.rounds)


def streamed_work_rows(plan: StreamedFoldPlan) -> int:
    """Real fold rows one dense iteration computes (all rounds)."""
    return sum(host_read(torch.count_nonzero(r.row_vertex >= 0),
                         "dense_rows") for r in plan.rounds)


# ---------------------------------------------------------------------------
# Sparse frontier compaction
# ---------------------------------------------------------------------------
#
# The sparse frontier path compacts each round's *active* rows (rows whose
# owning vertex is on the frontier; on the streamed plan, whole windows
# holding one) into a fixed-capacity index buffer, so the kernels launch
# over the active rows only. Unfilled capacity slots hold a sentinel index
# one past the last real row; the drivers read a neutral row (start 0,
# count 0, vertex -1) there, which folds to an empty sketch and scatters
# into a dump slot that is sliced off. Whether a frontier *fits* the
# capacity is decided between iterations (``fused_active_rows``,
# ``streamed_active_windows``); on overflow ``lpa()`` runs the dense gated
# fold instead. The counts are taken on the plan's device and only the
# integers reach the host.


def compact_active_rows(active: torch.Tensor, cap: int) -> torch.Tensor:
    """Compact the set lanes of ``active`` [rows] bool into a [cap] int32
    index buffer.

    Slot ``j`` holds the row index of the j-th active lane; slots past the
    number of active lanes hold the sentinel ``rows``. Active lanes beyond
    ``cap`` are dropped, so callers check the fit first. Every real slot
    is written once; inactive and overflowing lanes all write the dump
    slot ``cap``, which is sliced off (so the order in which a device
    applies those duplicate writes does not matter).
    """
    rows = active.shape[0]
    idx = torch.full((cap + 1,), rows, dtype=torch.int32,
                     device=active.device)
    if rows == 0:
        return idx[:cap]
    pos = torch.cumsum(active.to(torch.int32), 0) - 1
    slot = torch.where(active & (pos < cap), pos, cap)
    idx[slot] = torch.arange(rows, dtype=torch.int32, device=active.device)
    return idx[:cap]


def _round_active(row_vertex: torch.Tensor, frontier) -> torch.Tensor:
    """Per-row activity mask of one round: real rows whose owning vertex
    is on the frontier (a bool tensor or array of [N])."""
    rv = row_vertex.reshape(-1)
    front = torch.as_tensor(frontier, device=rv.device).to(torch.bool)
    real = rv >= 0
    return real & front[torch.clamp_min(rv, 0).long()]


def fused_active_rows(plan: FusedFoldPlan, frontier) -> List[int]:
    """Per-round active fold-row counts of a frontier.

    The sparse fused fold fits a row capacity ``cap_rows`` iff every
    round's count here is <= ``cap_rows``.
    """
    if not plan.rounds:
        return []
    counts = torch.stack([torch.count_nonzero(_round_active(r.row_vertex,
                                                            frontier))
                          for r in plan.rounds])
    return host_read(counts, "fit")


def streamed_active_windows(plan: StreamedFoldPlan,
                            frontier) -> List[Tuple[int, int]]:
    """Per-round ``(active_windows, rows_in_active_windows)`` of a
    frontier.

    The sparse streamed fold compacts whole windows: a window is active
    when any of its rows is, and every real row of an active window is
    folded (the inactive ones compute values the gate then masks). Each
    active window holds at least one active row, so a row capacity that
    admits the fused path admits the streamed one too.
    """
    if not plan.rounds:
        return []
    stats = []
    for rnd in plan.rounds:
        shape = (rnd.n_windows, rnd.tile_r)
        win_active = _round_active(rnd.row_vertex, frontier).reshape(
            shape).any(dim=1)
        real = (rnd.row_vertex.reshape(shape) >= 0) & win_active[:, None]
        stats.append(torch.stack([torch.count_nonzero(win_active),
                                  torch.count_nonzero(real)]))
    return [(w, r) for w, r in host_read(torch.stack(stats), "fit")]
