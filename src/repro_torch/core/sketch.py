"""Vectorized weighted Misra-Gries sketch folds and move selection (plain torch).

A copy of the MG half of ``repro.core.sketch``: every row of a tile owns
one whole k-slot sketch, the k slots live on a trailing axis, and one
accumulate step is a handful of elementwise ops over all rows at once.

These functions run on any device. They are the plain-torch reference
engine (``fold_backend="jnp"``) and the oracle the CUDA kernels of
``repro_torch.kernels.mg_sketch.fused`` are held against, bit for bit:
every fold is a fixed sequence of float32 adds, subtracts and maxes per
row, with no multiply to contract and no reduction whose order is free.
"""
from __future__ import annotations

from typing import Tuple

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


def run_mg_plan(plan: FoldPlan, entry_labels: torch.Tensor,
                entry_weights: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the full multi-round MG fold.

    ``entry_labels/_weights`` are the round-0 entry arrays: the neighbor
    community labels C[graph.indices] and edge weights, in CSR order.
    Returns ([final_rows, k] sketch labels, weights); final rows map to
    vertices via ``plan.row_to_vertex``.
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
            s_k, s_v = mg_fold_tile(gl, gw, k)
            pos = bucket.out_pos.long()  # unique: each canonical row once
            out_k[pos] = s_k
            out_v[pos] = s_v
        labels, weights = out_k.reshape(-1), out_v.reshape(-1)
    return out_k, out_v


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
