"""Vectorized weighted Misra-Gries / Boyer-Moore sketch folds (plain torch).

A copy of ``repro.core.sketch``: every row of a tile owns one whole
sketch (k MG slots on a trailing axis, or one BM carry), and one
accumulate step is a handful of elementwise ops over all rows at once.
The paper's MG rule (:func:`mg_fold_tile`) and the exact weighted MG
variant (:func:`mg_fold_tile_exact_weighted`, plain torch only, as in the
reference) share the plan walk :func:`run_mg_plan`, whose tile fold is
injectable, as :func:`run_bm_plan`'s is. Also here: the BM merge of
per-row partial states and the rescan (double-scan) second pass with its
deterministic rank-ordered merge.

These functions run on any device. They are the plain-torch reference
engine (``fold_backend="jnp"``) and the oracle the CUDA kernels of
``repro_torch.kernels.mg_sketch`` are held against, bit for bit:
every fold is a fixed sequence of float32 adds, subtracts and maxes per
row, with no multiply to contract and no reduction whose order is free.
The one float reduction across rows, :func:`merge_rescan_partials`, is
written as explicit left folds in the reference's order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.graphs.csr import FoldPlan

INT_MAX = torch.iinfo(torch.int32).max
UINT_MAX = 0xFFFFFFFF
_MASK32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``c`` below 2**32, without int64 overflow: split ``x`` into 16-bit
    halves so that every partial product stays below 2**48."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def hash_mix(x: torch.Tensor, seed) -> torch.Tensor:
    """Cheap per-iteration label hash (Knuth multiplicative + xorshift).

    The uint32 arithmetic of the reference, computed in int64 and masked to
    32 bits: the result is the uint32 hash as a non-negative int64, so
    comparisons between hashes keep the uint32 order.
    """
    seed_term = ((int(seed) & _MASK32) * 0x9E3779B9) & _MASK32
    h = _mul_u32(x.to(torch.int64) & _MASK32, 2654435761)
    h = h ^ seed_term
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x85EBCA77)
    return h ^ (h >> 13)


def _gather_entries(gather: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather [R, D] padded (label, weight) tiles from flat entry arrays."""
    safe = torch.clamp_min(gather, 0).long()
    valid = gather >= 0
    gl = torch.where(valid, labels[safe], -1)
    gw = torch.where(valid, weights[safe], 0.0)
    return gl, gw


def mg_fold_tile(labels: torch.Tensor, weights: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a padded [R, D] (label, weight) tile into [R, k] MG sketches.

    The paper's sketchAccumulate (Alg. 2), one row per sketch: matching
    slot += w; else claim the first free slot; else decrement every slot
    by w, clamped at 0 so the slot frees. Returns int32 labels and float32
    weights.
    """
    r, d = labels.shape
    dev = labels.device
    slot_iota = torch.arange(k, dtype=torch.int32, device=dev)
    s_k = torch.full((r, k), -1, dtype=torch.int32, device=dev)
    s_v = torch.zeros((r, k), dtype=torch.float32, device=dev)
    for i in range(d):
        c, w = labels[:, i], weights[:, i]  # [R]
        valid = (w > 0) & (c >= 0)
        occupied = s_v > 0
        match = occupied & (s_k == c[:, None]) & valid[:, None]
        any_match = match.any(dim=1)
        s_v = s_v + torch.where(match, w[:, None], 0.0)
        free = ~occupied
        has_free = free.any(dim=1)
        # torch.argmax rejects bool; on ints it returns the first maximum
        first_free = torch.argmax(free.to(torch.int32), dim=1)
        claim_row = valid & ~any_match & has_free
        claim = claim_row[:, None] & (slot_iota[None, :] == first_free[:, None])
        s_k = torch.where(claim, c[:, None], s_k)
        s_v = torch.where(claim, w[:, None], s_v)
        dec_row = valid & ~any_match & ~has_free
        s_v = torch.clamp_min(
            s_v - torch.where(dec_row[:, None], w[:, None], 0.0), 0.0)
    return s_k, s_v


def mg_fold_tile_exact_weighted(labels: torch.Tensor, weights: torch.Tensor,
                                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact weighted Misra-Gries fold (beyond the paper).

    As :func:`mg_fold_tile` but for the eviction: a row with no match and
    no free slot subtracts m = min(min slot weight, w) from every slot
    (clamped at 0) and from the incoming w, then writes the leftover
    w - m, if positive, into the first slot of least weight. Any label
    with total weight > W/(k+1) survives for arbitrary positive weights.
    The float32 order is the reference's: m, the clamped subtraction,
    then ``w - m``.
    """
    r, d = labels.shape
    dev = labels.device
    slot_iota = torch.arange(k, dtype=torch.int32, device=dev)
    s_k = torch.full((r, k), -1, dtype=torch.int32, device=dev)
    s_v = torch.zeros((r, k), dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    for i in range(d):
        c, w = labels[:, i], weights[:, i]  # [R]
        valid = (w > 0) & (c >= 0)
        occupied = s_v > 0
        match = occupied & (s_k == c[:, None]) & valid[:, None]
        any_match = match.any(dim=1)
        s_v = s_v + torch.where(match, w[:, None], 0.0)
        free = ~occupied
        has_free = free.any(dim=1)
        first_free = torch.argmax(free.to(torch.int32), dim=1)
        claim_row = valid & ~any_match & has_free
        claim = claim_row[:, None] & (slot_iota[None, :] == first_free[:, None])
        s_k = torch.where(claim, c[:, None], s_k)
        s_v = torch.where(claim, w[:, None], s_v)
        dec_row = valid & ~any_match & ~has_free
        m = torch.minimum(torch.amin(s_v, dim=1), w)
        s_v = torch.clamp_min(
            s_v - torch.where(dec_row[:, None], m[:, None], 0.0), 0.0)
        leftover = w - m
        # argmin returns the first index among equal minima, as jnp.argmin
        min_slot = torch.argmin(torch.where(dec_row[:, None], s_v, inf),
                                dim=1)
        take = dec_row & (leftover > 0)
        claim2 = take[:, None] & (slot_iota[None, :] == min_slot[:, None])
        s_k = torch.where(claim2, c[:, None], s_k)
        s_v = torch.where(claim2, leftover[:, None], s_v)
    return s_k, s_v


def bm_fold_tile(labels: torch.Tensor, weights: torch.Tensor,
                 init_label: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a padded [R, D] tile into [R] weighted Boyer-Moore states.

    Paper Alg. 3 lines 13-18: the carry starts as (C[i], 0) — the incumbent
    label with zero votes — then match += w; else if w# > w: w# -= w; else
    replace candidate. The update is the reference's
    ``wk + where(same, w, 0) - where(bigger, w, 0)`` term for term.
    """
    r, d = labels.shape
    if init_label is None:
        init_label = torch.full((r,), -1, dtype=torch.int32,
                                device=labels.device)
    ck = init_label
    wk = torch.zeros((r,), dtype=torch.float32, device=labels.device)
    for i in range(d):
        c, w = labels[:, i], weights[:, i]
        valid = (w > 0) & (c >= 0)
        same = valid & (c == ck)
        bigger = valid & ~same & (wk > w)
        replace = valid & ~same & ~bigger
        wk = wk + torch.where(same, w, 0.0) - torch.where(bigger, w, 0.0)
        ck = torch.where(replace, c, ck)
        wk = torch.where(replace, w, wk)
    return ck, wk


def run_mg_plan(plan: FoldPlan, entry_labels: torch.Tensor,
                entry_weights: torch.Tensor, *, fold_tile=mg_fold_tile
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the full multi-round MG fold.

    ``entry_labels/_weights`` are the round-0 entry arrays: the neighbor
    community labels C[graph.indices] and edge weights, in CSR order.
    Returns ([final_rows, k] sketch labels, weights); final rows map to
    vertices via ``plan.row_to_vertex``. ``fold_tile`` folds one bucket's
    padded [R, D] tile (:func:`mg_fold_tile`, the exact weighted variant,
    or the per-bucket CUDA kernel K9 of ``kernels.mg_sketch.ops``).
    """
    k = plan.k
    dev = entry_labels.device
    labels, weights = entry_labels, entry_weights
    for rnd in plan.rounds:
        out_k = torch.zeros((rnd.n_rows_total, k), dtype=torch.int32, device=dev)
        out_v = torch.zeros((rnd.n_rows_total, k), dtype=torch.float32,
                            device=dev)
        for bucket in rnd.buckets:
            gl, gw = _gather_entries(bucket.gather, labels, weights)
            s_k, s_v = fold_tile(gl, gw, k)
            pos = bucket.out_pos.long()  # unique: each canonical row once
            out_k[pos] = s_k
            out_v[pos] = s_v
        labels, weights = out_k.reshape(-1), out_v.reshape(-1)
    return out_k, out_v


def _bm_select(n: int, cur_labels: torch.Tensor, best_w: torch.Tensor,
               keep: torch.Tensor, best_c: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BM merge's last step: the incumbent wins a tie it is in, a
    vertex with no candidate gets (-1, 0.0)."""
    best_c = torch.where(keep[:n], cur_labels, best_c[:n])
    has = best_c != INT_MAX
    return (torch.where(has, best_c, -1),
            torch.where(has, torch.clamp_min(best_w[:n], 0.0), 0.0))


def run_bm_plan(plan: FoldPlan, entry_labels: torch.Tensor,
                entry_weights: torch.Tensor, cur_labels: torch.Tensor, *,
                fold_tile=bm_fold_tile) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the BM fold + the paper's max-reduce merge across partial states.

    Every partial carry starts as the vertex's incumbent label with zero
    votes (paper Alg. 3 l. 13). Only round 0 of the plan is folded; the
    partial (c#, w#) states of a vertex merge with a pairwise-max reduce
    (paper §4.7), ties toward the incumbent and then the smaller label.
    Every reduction is a max/min scatter, exact in any order. Returns
    per-vertex (label [N], weight [N]); vertices with no entries get -1.
    ``fold_tile`` folds one round-0 bucket's tile from its rows'
    incumbents (:func:`bm_fold_tile`, or the CUDA kernel K10).
    """
    n = plan.n_nodes
    dev = entry_labels.device
    best_w = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    parts = []
    for bucket in plan.rounds[0].buckets:
        gl, gw = _gather_entries(bucket.gather, entry_labels, entry_weights)
        vertex = bucket.vertex.long()
        ck, wk = fold_tile(gl, gw, cur_labels[vertex])
        parts.append((vertex, ck, wk))
        best_w.scatter_reduce_(0, vertex, wk, "amax")
    # prefer the incumbent among max-weight partials, then the smaller label
    keep = torch.zeros((n,), dtype=torch.int32, device=dev)
    for vertex, ck, wk in parts:
        at_best = (wk >= best_w[vertex]) & (ck == cur_labels[vertex])
        keep.scatter_reduce_(0, vertex, at_best.to(torch.int32), "amax")
    keep = keep > 0
    best_c = torch.full((n,), INT_MAX, dtype=torch.int32, device=dev)
    for vertex, ck, wk in parts:
        is_best = (wk >= best_w[vertex]) & (ck >= 0) & ~keep[vertex]
        best_c.scatter_reduce_(0, vertex, torch.where(is_best, ck, INT_MAX),
                               "amin")
    return _bm_select(n, cur_labels, best_w, keep, best_c)


def bm_init_rows(row_vertex: torch.Tensor, cur_labels: torch.Tensor
                 ) -> torch.Tensor:
    """Per-row BM initial carries: each row starts as its owning vertex's
    incumbent label (paper Alg. 3 l. 13), -1 on pad rows."""
    real = row_vertex >= 0
    return torch.where(real, cur_labels[torch.clamp_min(row_vertex, 0).long()],
                       -1)


def bm_merge_rows(n: int, cur_labels: torch.Tensor, row_vertex: torch.Tensor,
                  ck: torch.Tensor, wk: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-row BM partial states into per-vertex (label, weight).

    :func:`run_bm_plan`'s merge over ONE flat row set: ``row_vertex`` [R]
    maps each partial (``ck``, ``wk``) to its owner (-1 = pad row, sent to
    a dump slot). Every reduction is a max/min scatter, exact in any order,
    so any engine row order merges bit-identically to the reference.
    """
    dev = ck.device
    real = row_vertex >= 0
    safe = torch.where(real, row_vertex, n).long()  # dump slot for pad rows
    cur_ext = torch.cat([cur_labels, cur_labels.new_full((1,), -1)])
    best_w = torch.full((n + 1,), -1.0, dtype=torch.float32, device=dev)
    best_w.scatter_reduce_(0, safe, torch.where(real, wk, -1.0), "amax")
    at_best = real & (wk >= best_w[safe])
    keep = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    keep.scatter_reduce_(0, safe, (at_best & (ck == cur_ext[safe]))
                         .to(torch.int32), "amax")
    keep = keep > 0
    is_best = at_best & (ck >= 0) & ~keep[safe]
    best_c = torch.full((n + 1,), INT_MAX, dtype=torch.int32, device=dev)
    best_c.scatter_reduce_(0, safe, torch.where(is_best, ck, INT_MAX), "amin")
    return _bm_select(n, cur_labels, best_w, keep, best_c)


def choose_from_candidates(cand_c: torch.Tensor, cand_w: torch.Tensor,
                           labels: torch.Tensor, seed) -> torch.Tensor:
    """Unified move selection over per-vertex candidate sets [N, S].

    The incumbent label (with its candidate-set weight, 0 if absent) always
    competes. Winner = max weight, ties broken by the per-iteration hash,
    then by smaller label. Returns the chosen label per vertex (== current
    label when the vertex should not move).
    """
    cur_w = torch.amax(torch.where((cand_c == labels[:, None]) & (cand_w > 0),
                                   cand_w, 0.0), dim=1)
    cand_c = torch.cat([cand_c, labels[:, None]], dim=1)
    cand_w = torch.cat([cand_w, cur_w[:, None]], dim=1)
    valid = cand_c >= 0
    w = torch.where(valid, cand_w, -1.0)
    w_best = torch.amax(w, dim=1)
    tied = valid & (w >= w_best[:, None])
    h = hash_mix(cand_c, seed)
    h = torch.where(tied, h, UINT_MAX)
    h_best = torch.amin(h, dim=1)
    # resolve identical hashes toward the smaller label
    in_hash = tied & (h <= h_best[:, None])
    c_best = torch.amin(torch.where(in_hash, cand_c, INT_MAX), dim=1)
    return torch.where(c_best == INT_MAX, labels, c_best)


def scatter_rows(plan: FoldPlan, s_k: torch.Tensor, s_v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter final-round sketches [rows, k] to per-vertex [N, k]."""
    n, k = plan.n_nodes, plan.k
    dev = s_k.device
    rtv = plan.row_to_vertex.long()  # unique: one final row per vertex
    cand_c = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    cand_w = torch.zeros((n, k), dtype=torch.float32, device=dev)
    cand_c[rtv] = s_k
    cand_w[rtv] = s_v
    return cand_c, cand_w


def select_best(plan: FoldPlan, s_k: torch.Tensor, s_v: torch.Tensor,
                labels: torch.Tensor, seed) -> torch.Tensor:
    """Pick the new label per vertex from final sketches (single-scan mode)."""
    cand_c, cand_w = scatter_rows(plan, s_k, s_v)
    cand_c = torch.where(cand_w > 0, cand_c, -1)
    return choose_from_candidates(cand_c, cand_w, labels, seed)


def rescan_row_partials(labels: torch.Tensor, weights: torch.Tensor,
                        row_cand: torch.Tensor) -> torch.Tensor:
    """Per-row exact candidate weights for the rescan second pass.

    ``labels``/``weights`` [R, D] are a padded round-0 entry tile;
    ``row_cand`` [R, k] each row's (owning vertex's) candidate labels (-1
    empties). Accumulates sequentially over the entry axis, with no
    ``w > 0`` test: an entry of weight <= 0 whose label is a candidate is
    added too. Returns [R, k] float32 partial linking weights.
    """
    acc = torch.zeros(row_cand.shape, dtype=torch.float32,
                      device=row_cand.device)
    for i in range(labels.shape[1]):
        c, w = labels[:, i], weights[:, i]
        hit = (row_cand == c[:, None]) & (row_cand >= 0)
        acc = acc + torch.where(hit, w[:, None], 0.0)
    return acc


#: Ranks summed per chunk by :func:`merge_rescan_partials` — the
#: reference's dense-table chunk, which sets the float order of the merge.
_RANK_CHUNK = 8


def merge_rescan_partials(n: int, k: int, max_rows: int,
                          row_vertex: torch.Tensor, row_rank: torch.Tensor,
                          parts: torch.Tensor) -> torch.Tensor:
    """Reduce per-row rescan partials [R, k] to per-vertex weights [N, k].

    The reference sums a vertex's partials in a fixed order whatever the
    engine's row order: the ranks of each ``_RANK_CHUNK``-rank chunk as a
    left fold ``((0 + p_lo) + p_lo+1) + ...``, then the chunk sums as a
    left fold in ascending chunk order. It does so through a dense
    [N+1, _RANK_CHUNK, k] table per chunk, where a vertex without a row at
    some rank adds 0.0. No partial and no running sum is ever -0.0 (each
    starts at +0.0), so adding 0.0 changes no bit, and this version adds
    only the cells that exist:

      * chunk 0 folds into an [N+1, k] table, rank by rank (rank 0 is one
        row per vertex; ranks 1..7 only the rows of vertices with more);
      * chunks >= 1 exist only for the few vertices with more than
        ``_RANK_CHUNK`` rows: their chunk sums fold into a small
        [n_big, n_chunks, k] table, then one add per chunk, in order.

    Rows of pad (``row_vertex < 0``) are ignored. Results are the
    reference's bit for bit on any device.
    """
    dev = parts.device
    real = row_vertex >= 0
    safe = torch.where(real, row_vertex, n).long()  # dump slot for the rest
    s0 = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
    s0[torch.where(real & (row_rank == 0), safe, n)] = parts
    hi = torch.nonzero(real & (row_rank > 0)).squeeze(1)
    if hi.numel() == 0:
        return s0[:n]
    hv, hr, hp = safe[hi], row_rank[hi].long(), parts[hi]
    for j in range(1, min(_RANK_CHUNK, max_rows)):
        on = hr == j
        idx = torch.where(on, hv, n)
        s0[idx] = s0[idx] + torch.where(on[:, None], hp, 0.0)
    out = s0[:n]
    far = torch.nonzero(hr >= _RANK_CHUNK).squeeze(1)
    if far.numel() == 0:
        return out
    n_chunks = -(-max_rows // _RANK_CHUNK)
    big, b = torch.unique(hv[far], return_inverse=True)
    n_big = big.numel()
    fr, fp = hr[far], hp[far]
    q, j_of = fr // _RANK_CHUNK, fr % _RANK_CHUNK
    table = torch.zeros((n_big + 1, n_chunks, k), dtype=torch.float32,
                        device=dev)
    for j in range(_RANK_CHUNK):
        on = j_of == j
        bi, qi = torch.where(on, b, n_big), torch.where(on, q, 0)
        table[bi, qi] = table[bi, qi] + torch.where(on[:, None], fp, 0.0)
    acc = out[big]  # 0 + chunk 0's sum
    # one in-place add per chunk on views made in one call: the loop is as
    # long as the hub's chunk count, so its per-step host cost is what counts
    for col in table[:n_big, 1:].unbind(1):
        acc.add_(col)
    out[big] = acc
    return out


def rescan_candidates(plan: FoldPlan, s_k: torch.Tensor,
                      entry_labels: torch.Tensor, entry_weights: torch.Tensor,
                      labels: torch.Tensor, seed) -> torch.Tensor:
    """Double-scan mode (paper §4.4 / Alg. 4): recompute the *exact*
    linking weight of each of the k candidate labels by re-reading the
    neighbourhood, then pick the heaviest. The bucketed reference; the
    fused engine runs the same pass as one kernel launch (K4) and shares
    :func:`rescan_row_partials`'s order and :func:`merge_rescan_partials`.
    """
    n, k = plan.n_nodes, plan.k
    dev = s_k.device
    cand = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    cand[plan.row_to_vertex.long()] = s_k  # unique: one final row per vertex
    rnd = plan.rounds[0]
    rows0 = rnd.n_rows_total
    parts = torch.zeros((rows0, k), dtype=torch.float32, device=dev)
    row_v = torch.full((rows0,), -1, dtype=torch.int32, device=dev)
    for bucket in rnd.buckets:
        gl, gw = _gather_entries(bucket.gather, entry_labels, entry_weights)
        pos = bucket.out_pos.long()  # unique: each canonical row once
        parts[pos] = rescan_row_partials(gl, gw, cand[bucket.vertex.long()])
        row_v[pos] = bucket.vertex
    acc = merge_rescan_partials(n, k, plan.max_rows0, row_v, plan.row_rank0,
                                parts)
    return choose_from_candidates(torch.where(acc > 0, cand, -1), acc,
                                  labels, seed)
