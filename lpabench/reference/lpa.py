"""The plain reference: νMG-LPA, dense or frontier-gated, in plain torch.

A frozen statement of what a detection computes, written from the paper's
Algorithms 1-2 and the repository's published semantics, and independent
of the program: it reads only the graph's CSR arrays (offsets, neighbour
ids, weights) and the configuration, and works everything else out again.

One iteration, for every vertex v at once:

  1. gather: the labels of v's neighbours, in CSR order, with the slot
     weights;
  2. fold: v's slots, cut into rows of at most ``chunk`` entries, each row
     folded into a k-slot weighted Misra-Gries sketch (a matching slot
     adds the weight; else the first free slot, one of weight 0, takes the
     entry; else every slot loses the weight, clamped at 0). While any
     vertex has more than one row, a further round folds each vertex's
     row sketches (k entries a row, empty slots included, in row order)
     into rows of ``chunk`` entries the same way;
  3. select: among the final sketch's slots of weight > 0 and the
     incumbent label (weighted by its slot, else 0), the largest weight
     wins, ties go to the smallest ``hash_mix(label, seed)`` and then to
     the smallest label;
  4. move: on Pick-Less iterations (``it % rho == 0``) only a smaller
     label may be taken, on the others any other label; with the gate, only
     vertices on the frontier move;
  5. frontier: the vertices with a neighbour that changed, joined with the
     old frontier on Pick-Less iterations; the fraction entering the
     iteration is recorded as float32 ``count * (1 / n)``.

A detection starts from labels 0..n-1 and the whole frontier, runs
iterations with seed ``it + 1`` and stops after a non-Pick-Less
iteration whose changed fraction is below ``tau``, or at ``max_iters``.

``value_dtype`` is the type of the sketch weights and of every sum over
them: float32 as the configuration states, or a lower type for the
control. Work is done in blocks of rows and vertices, so the reference
fits beside nothing else on the card at the benchmark's sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

INT_MAX = 2**31 - 1
UINT_MAX = 0xFFFFFFFF
_M32 = 0xFFFFFFFF
#: entries (or sketch slots, whichever is more) folded per block
BLOCK_ENTRIES = 1 << 28
#: vertices selected or marked per block
BLOCK_VERTICES = 1 << 23


@dataclasses.dataclass
class Detection:
    """What a detection produced."""

    labels: torch.Tensor    # [N] int32 final labels
    iterations: int         # iterations run
    changed_history: list   # vertices that moved, per iteration
    frontier_history: list  # float32 frontier fraction entering each one
    converged: bool         # stopped by tau (not by max_iters)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash_mix(labels: torch.Tensor, seed: int) -> torch.Tensor:
    """The per-iteration tie-break hash (Knuth multiplicative, then
    xorshifts), as uint32 values held in int64."""
    seed_term = ((int(seed) & _M32) * 0x9E3779B9) & _M32
    h = _mul32(labels.to(torch.int64) & _M32, 2654435761) ^ seed_term
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA77)
    return h ^ (h >> 13)


def mg_fold(lab: torch.Tensor, wgt: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold [R, W] (label, weight) rows, left to right, into [R, k]
    weighted Misra-Gries sketches. Entries with weight <= 0 or label < 0
    are no-ops."""
    rows, width = lab.shape
    dev = lab.device
    slot = torch.arange(k, device=dev)
    s_k = torch.full((rows, k), -1, dtype=torch.int32, device=dev)
    s_v = torch.zeros((rows, k), dtype=wgt.dtype, device=dev)
    for i in range(width):
        c, w = lab[:, i:i + 1], wgt[:, i:i + 1]
        valid = (w > 0) & (c >= 0)
        held = s_v > 0
        hit = held & (s_k == c) & valid
        s_v = torch.where(hit, s_v + w, s_v)
        free = ~held
        new = valid & ~hit.any(1, keepdim=True)
        has_free = free.any(1, keepdim=True)
        first = torch.argmax(free.to(torch.int32), 1, keepdim=True)
        take = new & has_free & (slot == first)
        s_k = torch.where(take, c, s_k)
        s_v = torch.where(take, w, s_v)
        drop = new & ~has_free
        s_v = torch.where(drop, torch.clamp_min(s_v - w, 0), s_v)
    return s_k, s_v


def fold_rows(entry_lab: torch.Tensor, entry_wgt: torch.Tensor,
              starts: torch.Tensor, counts: torch.Tensor, k: int,
              chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold rows ``[starts[r], starts[r] + counts[r])`` (1 <= count <=
    chunk) of the flat entry arrays: [rows, k] sketches in row order.
    Rows of similar length are folded together, in blocks."""
    n_rows = starts.numel()
    dev = entry_lab.device
    out_k = torch.empty((n_rows, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((n_rows, k), dtype=entry_wgt.dtype, device=dev)
    width, low = 1, 0
    while low < chunk:
        rows = torch.nonzero((counts > low) & (counts <= width)).squeeze(1)
        step = max(1, BLOCK_ENTRIES // max(width, k))
        lane = torch.arange(width, device=dev)
        for b in range(0, rows.numel(), step):
            r = rows[b:b + step]
            inside = lane < counts[r, None]
            pos = torch.where(inside, starts[r, None] + lane, 0)
            lab = torch.where(inside, entry_lab[pos], -1)
            wgt = torch.where(inside, entry_wgt[pos], 0)
            out_k[r], out_v[r] = mg_fold(lab, wgt, k)
        low, width = width, min(2 * width, chunk)
    return out_k, out_v


def final_sketches(offsets: torch.Tensor, nbr_lab: torch.Tensor,
                   wgt: torch.Tensor, k: int, chunk: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every vertex's final sketch, [N, k] labels and weights (empty,
    (-1, 0), for a vertex with no slots), from the gathered neighbour
    labels ``nbr_lab`` and the slot weights, both in CSR order.

    A vertex left with one row keeps that row's sketch: folding a lone
    sketch again (at most k entries of distinct labels into k free
    slots) gives back the same (label, weight) pairs, and the selection
    does not depend on their order, so later rounds fold only the
    vertices that still have more than one row."""
    dev = offsets.device
    offsets = offsets.to(torch.int64)
    n = offsets.numel() - 1
    out_k = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    out_v = torch.zeros((n, k), dtype=wgt.dtype, device=dev)
    vertex = torch.arange(n, device=dev)
    counts = offsets[1:] - offsets[:-1]
    starts = offsets[:-1]
    lab, val = nbr_lab, wgt
    while vertex.numel():
        n_rows = (counts + chunk - 1) // chunk
        first = torch.cumsum(n_rows, 0) - n_rows
        owner = torch.repeat_interleave(torch.arange(vertex.numel(),
                                                     device=dev), n_rows)
        rank = torch.arange(owner.numel(), device=dev) - first[owner]
        row_start = starts[owner] + rank * chunk
        row_count = torch.clamp_max(counts[owner] - rank * chunk, chunk)
        s_k, s_v = fold_rows(lab, val, row_start, row_count, k, chunk)
        done = n_rows == 1
        out_k[vertex[done]] = s_k[first[done]]
        out_v[vertex[done]] = s_v[first[done]]
        more = n_rows > 1
        # the next round: each remaining vertex's row sketches, in order
        keep = more[owner]
        lab, val = s_k[keep].reshape(-1), s_v[keep].reshape(-1)
        vertex, counts = vertex[more], n_rows[more] * k
        starts = torch.cumsum(counts, 0) - counts
    return out_k, out_v


def select(s_k: torch.Tensor, s_v: torch.Tensor, labels: torch.Tensor,
           seed: int) -> torch.Tensor:
    """The wanted label of every vertex from its final sketch."""
    want = torch.empty_like(labels)
    for lo in range(0, labels.numel(), BLOCK_VERTICES):
        hi = lo + BLOCK_VERTICES
        lab, sk, sv = labels[lo:hi], s_k[lo:hi], s_v[lo:hi]
        cand = torch.where(sv > 0, sk, -1)
        own = torch.amax(torch.where(cand == lab[:, None], sv, 0), 1)
        cand = torch.cat([cand, lab[:, None]], 1)
        w = torch.cat([sv, own[:, None]], 1)
        valid = cand >= 0
        w = torch.where(valid, w, -1)
        tied = valid & (w >= torch.amax(w, 1, keepdim=True))
        h = torch.where(tied, hash_mix(cand, seed), UINT_MAX)
        best = tied & (h <= torch.amin(h, 1, keepdim=True))
        c = torch.amin(torch.where(best, cand, INT_MAX), 1)
        want[lo:hi] = torch.where(c == INT_MAX, lab, c)
    return want


def neighbours_changed(offsets: torch.Tensor, indices: torch.Tensor,
                       changed: torch.Tensor) -> torch.Tensor:
    """[N] bool: v has a neighbour that changed (the graph is symmetric,
    so v's own CSR row lists every vertex that has v as a neighbour)."""
    n = offsets.numel() - 1
    out = torch.empty(n, dtype=torch.bool, device=changed.device)
    offsets = offsets.to(torch.int64)
    for lo in range(0, n, BLOCK_VERTICES):
        hi = min(lo + BLOCK_VERTICES, n)
        a, b = int(offsets[lo]), int(offsets[hi])
        ends = offsets[lo + 1:hi + 1] - a
        seen = torch.cumsum(changed[indices[a:b]].to(torch.int64), 0)
        seen = torch.cat([seen.new_zeros(1), seen])
        out[lo:hi] = seen[ends] > seen[offsets[lo:hi] - a]
    return out


def detect(offsets: torch.Tensor, indices: torch.Tensor,
           weights: torch.Tensor, *, k: int, chunk: int, rho: int,
           tau: float, max_iters: int, gate: bool, track_frontier: bool,
           value_dtype: torch.dtype = torch.float32,
           observe: Optional[Callable[[int, torch.Tensor], None]] = None
           ) -> Detection:
    """One detection on the CSR graph (tensors on one device).

    ``observe(it, active)``, where given, sees each iteration's set of
    vertices that may move (the frontier with the gate, else every
    vertex) before the move."""
    n = offsets.numel() - 1
    dev = offsets.device
    wgt = weights.to(value_dtype)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    frontier = torch.ones(n, dtype=torch.bool, device=dev)
    changed_history, frontier_history = [], []
    converged = False
    it = 0
    for it in range(max_iters):
        pick_less = it % rho == 0
        if observe is not None:
            observe(it, frontier if gate else torch.ones_like(frontier))
        s_k, s_v = final_sketches(offsets, torch.index_select(labels, 0, indices),
                                  wgt, k,
                                  chunk)
        want = select(s_k, s_v, labels, it + 1)
        del s_k, s_v
        allowed = (want < labels) if pick_less else (want != labels)
        if gate:
            allowed &= frontier
        new = torch.where(allowed, want, labels)
        changed = new != labels
        if gate or track_frontier:
            if track_frontier:
                count = np.float32(int(frontier.sum()))
                frontier_history.append(
                    float(count * (np.float32(1) / np.float32(n))))
            marked = neighbours_changed(offsets, indices, changed)
            frontier = (frontier | marked) if pick_less else marked
        delta = int(changed.sum())
        changed_history.append(delta)
        labels = new
        if not pick_less and delta / max(n, 1) < tau:
            converged = True
            break
    return Detection(labels=labels, iterations=it + 1,
                     changed_history=changed_history,
                     frontier_history=frontier_history, converged=converged)
