"""Fused sketch folds: hand-written CUDA kernels, their plain versions and
the drivers that walk a ``FusedFoldPlan`` with them.

Kernels (``src/repro_torch/csrc/mg_fused.cu``, built by
``repro_torch.kernels.build``):

  * **K1** ``mg_fused_fold`` — one launch per fold round: row r folds its
    entries ``[row_start[r], row_start[r] + row_count[r])`` of the flat
    (label, weight) arrays into a k-slot weighted MG sketch. Replaces the
    TPU kernel ``repro/kernels/mg_sketch/fused.py:_fused_fold_kernel``.
  * **K2** ``mg_fused_select`` — the last round: K1's fold, then the move
    selection (max weight, then min ``hash_mix``, then min label, among the
    slots with weight > 0 and the incumbent). Replaces
    ``repro/kernels/mg_sketch/fused.py:_fused_select_kernel``.
  * **K3** ``mg_fused_bm_fold`` — the whole νBM fold in one launch: every
    round-0 row runs a weighted Boyer-Moore scan from its vertex's
    incumbent, a block of 128 rows staged through shared memory. Replaces
    ``repro/kernels/mg_sketch/fused.py:_bm_fold_kernel``.
  * **K4** ``mg_fused_rescan`` — the rescan second pass in one launch:
    every round-0 row sums, per candidate of its vertex, the weights of
    its entries with that label. Replaces
    ``repro/kernels/mg_sketch/fused.py:_rescan_fold_kernel``.

A round's ``row_start`` is int32, or int64 on round 0 of a graph with
int64 offsets (past 2**31 - 1 slots); each kernel is built for both widths
and the wrappers pass the width of the tensor they are given.

Each wrapper (``fused_fold_round``, ``fused_select_round``,
``bm_fold_round_fused``, ``rescan_round_fused``) takes one rule from the
tensors it is given: on the CPU it calls the plain version (the same name
with ``_plain``); on CUDA it launches the kernel on the current stream,
or raises. Nothing falls back. The plain versions are vectorised torch:
the masked ``row_start + arange(chunk)`` gather of the reference's
``_gather_tile``, then the matching column loop of
``repro_torch.core.sketch``.

``LAUNCH_COUNTS`` (``repro_torch.kernels.launches``, one table for the
fused and the streamed kernels) counts the kernel launches of each wrapper
and nothing else, so a run can show that a path went through the kernels.

The MG, BM and rescan drivers are written once (``run_mg_plan_generic``,
``select_best_generic``, ``run_bm_plan_generic``,
``rescan_select_generic``) over an engine's round wrappers and its sparse
compaction (:class:`EngineRounds`); the streamed engine
(``kernels.mg_sketch.streaming``) reuses them with its own. Each driver
takes an optional ``selection`` (``core.fold_program.RoundSelection``):
with one, every launch covers only the rows of the frontier's vertices,
compacted by :func:`sparse_fused_round` and scattered back by
:func:`scatter_sparse_rows`, and the kernels are unchanged.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.sketch import (bm_fold_tile, bm_init_rows,
                                     bm_merge_rows, choose_from_candidates,
                                     merge_rescan_partials, mg_fold_tile,
                                     rescan_row_partials)
from repro_torch.graphs.csr import (FusedFoldPlan, FusedRound, _round_active,
                                    compact_active_rows)
from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts
from repro_torch.trace import span

__all__ = ["SUPPORTED_K", "LAUNCH_COUNTS", "reset_launch_counts",
           "fused_fold_round", "fused_select_round", "bm_fold_round_fused",
           "rescan_round_fused", "fused_fold_round_plain",
           "fused_select_round_plain", "bm_fold_round_plain",
           "rescan_round_plain", "EngineRounds", "FUSED_ROUNDS",
           "take_ext", "sparse_fused_round", "scatter_sparse_rows",
           "run_mg_plan_generic", "run_mg_plan_fused",
           "select_best_generic", "select_best_fused",
           "run_bm_plan_generic", "run_bm_plan_fused",
           "rescan_select_generic", "rescan_select_fused"]

#: sketch widths k the CUDA kernels K1, K2, K4, K5, K6 and K8 are
#: instantiated for
SUPPORTED_K = (4, 8, 32)


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    built = load_library("mg_fused")
    lib = built.lib
    if not getattr(lib, "_repro_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # each launcher takes row_start, then its element width in bytes
        lib.mg_fused_fold.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr,
                                      i32, i32, i32, ptr]
        lib.mg_fused_fold.restype = i32
        lib.mg_fused_select.argtypes = [ptr, i32, ptr, ptr, i32, ptr, ptr,
                                        ptr, i32, i32, i32, ptr]
        lib.mg_fused_select.restype = i32
        lib.mg_fused_bm_fold.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr,
                                         ptr, i32, i32, ptr]
        lib.mg_fused_bm_fold.restype = i32
        lib.mg_fused_rescan.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, ptr]
        lib.mg_fused_rescan.restype = i32
        lib._repro_typed = True
    return lib


#: row-start dtypes of a fused round: int32, or int64 on round 0 of a
#: graph with int64 offsets (the kernels' wide instantiation)
FUSED_STARTS = (torch.int32, torch.int64)


def _check_inputs(rnd: FusedRound, entry_labels: torch.Tensor,
                  entry_weights: torch.Tensor, k: Optional[int],
                  starts: tuple = (torch.int32,)) -> torch.device:
    """Device, dtype, contiguity and shape checks shared by the wrappers
    (``k=None`` for K3, which keeps one carry; ``starts``, the dtypes
    ``row_start`` may have); returns the device the round runs on."""
    dev = entry_labels.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t, dtypes in (
            ("row_start", rnd.row_start, starts),
            ("row_count", rnd.row_count, (torch.int32,)),
            ("entry_labels", entry_labels, (torch.int32,)),
            ("entry_weights", entry_weights, (torch.float32,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, entry_labels on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rnd.row_start.dim() != 2 or rnd.row_count.shape != rnd.row_start.shape:
        raise ValueError("row_start/row_count must be [n_steps, tile_r]")
    want = (rnd.n_entries_in,)
    if entry_labels.shape != want or entry_weights.shape != want:
        raise ValueError(f"entry arrays must be {want} (the round's "
                         f"n_entries_in), got {tuple(entry_labels.shape)} "
                         f"and {tuple(entry_weights.shape)}")
    if k is None:
        return dev
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if dev.type == "cuda" and k not in SUPPORTED_K:
        raise ValueError(f"the CUDA kernels are built for k in {SUPPORTED_K}, "
                         f"got k={k}")
    return dev


def _check_row_tensor(t: torch.Tensor, name: str, shape: tuple,
                      dev: torch.device) -> None:
    """A per-row int32 operand (incumbents, BM inits, rescan candidates)."""
    if (t.device != dev or t.dtype != torch.int32 or t.shape != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {list(shape)} int32 "
                         f"tensor on {dev}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc}")


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def _gather_tile(rnd: FusedRound, entry_labels: torch.Tensor,
                 entry_weights: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[rows, chunk] (label, weight) tiles: row r's lanes are
    ``row_start[r] + arange(chunk)``, masked to (-1, 0.0) past its count."""
    return gather_rows(rnd.row_start.reshape(-1).long(),
                       rnd.row_count.reshape(-1), entry_labels,
                       entry_weights, chunk)


def gather_rows(starts: torch.Tensor, counts: torch.Tensor,
                entry_labels: torch.Tensor, entry_weights: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[rows, chunk] (label, weight) tiles of the rows at int64 ``starts``
    with ``counts`` entries each, masked to (-1, 0.0) past the count."""
    dev = entry_labels.device
    lane = torch.arange(chunk, device=dev)
    valid = lane[None, :] < counts[:, None]
    # masked lanes read one appended pad entry (-1, 0.0)
    idx = torch.where(valid, starts[:, None] + lane[None, :],
                      entry_labels.shape[0])
    el = torch.cat([entry_labels, entry_labels.new_full((1,), -1)])
    ew = torch.cat([entry_weights, entry_weights.new_zeros((1,))])
    return el[idx], ew[idx]


def fused_fold_round_plain(rnd: FusedRound, entry_labels: torch.Tensor,
                           entry_weights: torch.Tensor, *, k: int, chunk: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain torch: padded ([rows, k] int32, [rows, k]
    float32) sketches in fused row order."""
    lab, wgt = _gather_tile(rnd, entry_labels, entry_weights, chunk)
    return mg_fold_tile(lab, wgt, k)


def fused_select_round_plain(rnd: FusedRound, entry_labels: torch.Tensor,
                             entry_weights: torch.Tensor,
                             incumbents: torch.Tensor, seed, *, k: int,
                             chunk: int) -> torch.Tensor:
    """K2's function in plain torch: the winning label per padded row
    ([rows] int32). ``_select_rows`` of the reference is
    ``choose_from_candidates`` over the sketch with empty slots masked."""
    s_k, s_v = fused_fold_round_plain(rnd, entry_labels, entry_weights,
                                      k=k, chunk=chunk)
    return choose_from_candidates(torch.where(s_v > 0, s_k, -1), s_v,
                                  incumbents, seed)


def bm_fold_round_plain(rnd: FusedRound, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, init_labels: torch.Tensor,
                        *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain torch: per-row ([rows] int32 candidate,
    [rows] float32 vote weight) BM states from the carries
    (``init_labels``, 0.0), in fused row order."""
    lab, wgt = _gather_tile(rnd, entry_labels, entry_weights, chunk)
    return bm_fold_tile(lab, wgt, init_labels)


def rescan_round_plain(rnd: FusedRound, entry_labels: torch.Tensor,
                       entry_weights: torch.Tensor, cand_rows: torch.Tensor,
                       *, chunk: int) -> torch.Tensor:
    """K4's function in plain torch: [rows, k] float32 partial linking
    weights of each row's candidates ``cand_rows`` [rows, k]."""
    lab, wgt = _gather_tile(rnd, entry_labels, entry_weights, chunk)
    return rescan_row_partials(lab, wgt, cand_rows)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def fused_fold_round(rnd: FusedRound, entry_labels: torch.Tensor,
                     entry_weights: torch.Tensor, *, k: int, chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round of the fold, every row in one launch (K1).

    Returns padded ([n_steps*tile_r, k] int32, [n_steps*tile_r, k] float32)
    sketches in fused row order; pad rows fold to empty sketches.
    """
    dev = _check_inputs(rnd, entry_labels, entry_weights, k, FUSED_STARTS)
    if dev.type == "cpu":
        return fused_fold_round_plain(rnd, entry_labels, entry_weights,
                                      k=k, chunk=chunk)
    rows = rnd.row_start.numel()
    out_k = torch.empty((rows, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((rows, k), dtype=torch.float32, device=dev)
    rc = _library().mg_fused_fold(
        rnd.row_start.data_ptr(), rnd.row_start.element_size(),
        rnd.row_count.data_ptr(),
        entry_labels.data_ptr(), entry_weights.data_ptr(),
        out_k.data_ptr(), out_v.data_ptr(), rows, k, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mg_fused_fold")
    LAUNCH_COUNTS["fused_fold"] += 1
    return out_k, out_v


def fused_select_round(rnd: FusedRound, entry_labels: torch.Tensor,
                       entry_weights: torch.Tensor, incumbents: torch.Tensor,
                       seed, *, k: int, chunk: int) -> torch.Tensor:
    """The last round: fold + per-row winning label [n_steps*tile_r] (K2)."""
    dev = _check_inputs(rnd, entry_labels, entry_weights, k, FUSED_STARTS)
    rows = rnd.row_start.numel()
    _check_row_tensor(incumbents, "incumbents", (rows,), dev)
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    if dev.type == "cpu":
        return fused_select_round_plain(rnd, entry_labels, entry_weights,
                                        incumbents, seed, k=k, chunk=chunk)
    out_c = torch.empty((rows,), dtype=torch.int32, device=dev)
    rc = _library().mg_fused_select(
        rnd.row_start.data_ptr(), rnd.row_start.element_size(),
        rnd.row_count.data_ptr(),
        incumbents.data_ptr(), seed, entry_labels.data_ptr(),
        entry_weights.data_ptr(), out_c.data_ptr(), rows, k, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mg_fused_select")
    LAUNCH_COUNTS["fused_select"] += 1
    return out_c


def bm_fold_round_fused(rnd: FusedRound, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, init_labels: torch.Tensor,
                        *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole BM fold in one launch (K3): only round 0 is ever folded,
    BM partials merge by max-reduce, not by re-folding.

    ``init_labels`` [n_steps*tile_r] int32 carries each row's incumbent
    (-1 on pad rows). Returns per-row ([rows] int32 candidate, [rows]
    float32 vote weight) partial states in fused row order.
    """
    dev = _check_inputs(rnd, entry_labels, entry_weights, None,
                        FUSED_STARTS)
    rows = rnd.row_start.numel()
    _check_row_tensor(init_labels, "init_labels", (rows,), dev)
    if dev.type == "cpu":
        return bm_fold_round_plain(rnd, entry_labels, entry_weights,
                                   init_labels, chunk=chunk)
    out_c = torch.empty((rows,), dtype=torch.int32, device=dev)
    out_w = torch.empty((rows,), dtype=torch.float32, device=dev)
    rc = _library().mg_fused_bm_fold(
        rnd.row_start.data_ptr(), rnd.row_start.element_size(),
        rnd.row_count.data_ptr(),
        init_labels.data_ptr(), entry_labels.data_ptr(),
        entry_weights.data_ptr(), out_c.data_ptr(), out_w.data_ptr(), rows,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mg_fused_bm_fold")
    LAUNCH_COUNTS["bm_fold"] += 1
    return out_c, out_w


def rescan_round_fused(rnd: FusedRound, entry_labels: torch.Tensor,
                       entry_weights: torch.Tensor, cand_rows: torch.Tensor,
                       *, k: int, chunk: int) -> torch.Tensor:
    """One launch re-reading round 0 to score each row's candidates (K4).

    ``cand_rows`` [n_steps*tile_r, k] int32 holds each row's (owning
    vertex's) candidate labels, -1 empties. Returns [n_steps*tile_r, k]
    float32 partial linking weights in fused row order.
    """
    dev = _check_inputs(rnd, entry_labels, entry_weights, k, FUSED_STARTS)
    rows = rnd.row_start.numel()
    _check_row_tensor(cand_rows, "cand_rows", (rows, k), dev)
    if dev.type == "cpu":
        return rescan_round_plain(rnd, entry_labels, entry_weights,
                                  cand_rows, chunk=chunk)
    out = torch.empty((rows, k), dtype=torch.float32, device=dev)
    rc = _library().mg_fused_rescan(
        rnd.row_start.data_ptr(), rnd.row_start.element_size(),
        rnd.row_count.data_ptr(),
        cand_rows.data_ptr(), entry_labels.data_ptr(),
        entry_weights.data_ptr(), out.data_ptr(), rows, k, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mg_fused_rescan")
    LAUNCH_COUNTS["rescan"] += 1
    return out


# ---------------------------------------------------------------------------
# Sparse frontier compaction (the fused plan's rows)
# ---------------------------------------------------------------------------
#
# The dense gated fold computes every row and lets the frontier mask drop
# off-frontier moves afterwards. The sparse drivers compact each round's
# active rows (rows whose owning vertex is on the frontier) into a capped
# synthetic ``FusedRound`` and launch the unchanged kernels over it.
# Activity is per vertex, so an active vertex's whole chain of rounds is
# folded from real inputs and stays bit-identical to the dense fold; an
# inactive vertex's partials stay empty sketches (-1, 0.0) in the
# scatter-back buffers, read only by rows that are inactive too. The fit
# of the frontier to the capacity is the caller's: ``lpa()`` checks it
# (``csr.fused_active_rows``) and runs the dense fold on overflow.


def take_ext(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x[idx]`` over the rows of ``x`` extended by one row of ``fill``
    at index ``len(x)`` (the compaction's sentinel), without copying
    ``x``."""
    n = x.shape[0]
    if n == 0:
        return torch.full((idx.shape[0],) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=x.device)
    out = x[torch.clamp_max(idx, n - 1).long()]
    # a mask that broadcasts over the trailing dims: a boolean-index store
    # would count the mask's lanes on the host and wait for the device
    sentinel = (idx == n).reshape((-1,) + (1,) * (x.dim() - 1))
    return out.masked_fill_(sentinel, fill)


def sparse_fused_round(rnd: FusedRound, frontier: torch.Tensor,
                       cap_rows: int
                       ) -> Tuple[FusedRound, torch.Tensor, torch.Tensor]:
    """Compact one round's active rows into a capped synthetic round.

    Returns ``(sub_round, idx, row_vertex)``: a ``FusedRound`` of
    ``min(ceil(cap_rows / tile_r), n_steps)`` steps whose rows are the
    active rows in order, then neutral rows (start 0, count 0); the
    [cap] compacted row indices (sentinel = the dense row count); and the
    [cap] owning vertex per compacted row (-1 on sentinel rows).
    """
    n_steps, tile_r = rnd.row_start.shape
    active = _round_active(rnd.row_vertex, frontier)
    cap_steps = min(-(-cap_rows // tile_r), n_steps)
    idx = compact_active_rows(active, cap_steps * tile_r)
    rs = take_ext(rnd.row_start.reshape(-1), idx, 0).reshape(cap_steps,
                                                             tile_r)
    rc = take_ext(rnd.row_count.reshape(-1), idx, 0).reshape(cap_steps,
                                                             tile_r)
    sub = FusedRound(row_start=rs, row_count=rc,
                     step_dmax=torch.amax(rc, dim=1, keepdim=True),
                     n_entries_in=rnd.n_entries_in)
    return sub, idx, take_ext(rnd.row_vertex, idx, -1)


def scatter_sparse_rows(rnd: FusedRound, idx: torch.Tensor,
                        values: torch.Tensor, fill) -> torch.Tensor:
    """Scatter compacted per-row results back to the round's dense rows.

    Real compacted rows hold distinct row indices, each written once;
    sentinel rows all land in a dump row that is sliced off. Unwritten
    rows keep ``fill`` (the empty-sketch value, so later rounds read
    no-op entries for inactive vertices)."""
    rows = rnd.row_start.numel()
    buf = torch.full((rows + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    buf[idx.long()] = values
    return buf[:rows]


# ---------------------------------------------------------------------------
# Plan drivers, shared by the fused and the streamed engines
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineRounds:
    """One engine's round wrappers and its sparse compaction: what the
    generic drivers walk a plan with. The fused engine's are
    :data:`FUSED_ROUNDS`, the streamed engine's
    ``kernels.mg_sketch.streaming.STREAM_ROUNDS``."""

    # (rnd, el, ew, *, k, chunk) -> ([rows, k] int32, [rows, k] float32)
    fold: Callable
    # (rnd, el, ew, incumbents, seed, *, k, chunk) -> [rows] int32
    select: Callable
    # (rnd, el, ew, init, *, chunk) -> ([rows] int32, [rows] float32)
    bm: Callable
    # (rnd, el, ew, cand_rows, *, k, chunk) -> [rows, k] float32
    rescan: Callable
    # (rnd, frontier, cap_rows) -> (sub_round, idx, compacted row_vertex)
    compact: Callable
    # (rnd, idx, values, fill) -> values at the round's dense rows
    scatter: Callable


def _fold_round(ops: EngineRounds, plan, rnd, el: torch.Tensor,
                ew: torch.Tensor, selection
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MG fold round in dense row order: every row, or with a
    ``selection`` only the compacted active rows, scattered back."""
    if selection is None:
        return ops.fold(rnd, el, ew, k=plan.k, chunk=plan.chunk)
    with span("fold.compact"):
        sub, idx, _ = ops.compact(rnd, selection.frontier,
                                  selection.cap_rows)
    c_k, c_v = ops.fold(sub, el, ew, k=plan.k, chunk=plan.chunk)
    with span("fold.compact"):
        return (ops.scatter(rnd, idx, c_k, -1),
                ops.scatter(rnd, idx, c_v, 0.0))


def run_mg_plan_generic(plan, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, ops: EngineRounds,
                        selection=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared MG driver: every fold round through the engine's round
    wrapper, each round reading the previous one's flattened output.
    Returns the final-round padded sketches in the plan's row order (map
    to vertices via ``plan.row_to_vertex``). With a ``selection``
    (``core.fold_program.RoundSelection``) each round launches over its
    compacted active rows only; the output layout is the same."""
    labels, weights = entry_labels, entry_weights
    for rnd in plan.rounds:
        s_k, s_v = _fold_round(ops, plan, rnd, labels, weights, selection)
        labels, weights = s_k.reshape(-1), s_v.reshape(-1)
    return s_k, s_v


def run_mg_plan_fused(plan: FusedFoldPlan, entry_labels: torch.Tensor,
                      entry_weights: torch.Tensor, *, selection=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All fold rounds, one K1 launch each. Returns the final-round padded
    sketches in fused row order (map to vertices via plan.row_to_vertex)."""
    return run_mg_plan_generic(plan, entry_labels, entry_weights,
                               FUSED_ROUNDS, selection)


def select_best_generic(plan, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, labels: torch.Tensor,
                        seed, ops: EngineRounds, selection=None
                        ) -> torch.Tensor:
    """Shared MG iteration: ``n_rounds - 1`` launches of the engine's fold
    wrapper and one of its select wrapper, then the [N] scatter of the
    per-row winners. Returns the wanted label per vertex.

    With a ``selection`` every round launches over its compacted active
    rows: on the frontier the wanted label is bit-identical to the dense
    run's; off the frontier a vertex keeps its label or gets a value the
    gate masks."""
    if plan.n_nodes == 0:
        return labels
    el, ew = entry_labels, entry_weights
    for rnd in plan.rounds[:-1]:
        with span("fold.round"):
            s_k, s_v = _fold_round(ops, plan, rnd, el, ew, selection)
        el, ew = s_k.reshape(-1), s_v.reshape(-1)
    last, rv = plan.rounds[-1], plan.row_to_vertex
    if selection is not None:
        with span("fold.compact"):
            last, _, rv = ops.compact(last, selection.frontier,
                                      selection.cap_rows)
    n = plan.n_nodes
    with span("fold.epilogue"):
        real = rv >= 0
        incumbents = torch.where(real, labels[torch.clamp_min(rv, 0)], -1)
    with span("fold.select"):
        choice = ops.select(last, el, ew, incumbents, seed, k=plan.k,
                            chunk=plan.chunk)
    # [N] scatter of per-row winners. A vertex owns at most one final row,
    # so real rows write distinct slots; pad and sentinel rows all write
    # -1 into the dump slot n, which is sliced off. Vertices with no fold
    # rows (degree 0, or off a selection's frontier) keep their label, as
    # choose_from_candidates does for an empty set.
    with span("fold.epilogue"):
        buf = torch.cat([labels, labels.new_zeros((1,))])
        buf[torch.where(real, rv, n).long()] = torch.where(real, choice, -1)
    return buf[:n]


def select_best_fused(plan: FusedFoldPlan, entry_labels: torch.Tensor,
                      entry_weights: torch.Tensor, labels: torch.Tensor,
                      seed, *, selection=None) -> torch.Tensor:
    """Full fused MG iteration: ``n_rounds - 1`` K1 launches and one K2
    launch. Bit-identical to ``run_mg_plan`` + ``select_best`` on the
    plain-torch reference engine. Returns the wanted label per vertex."""
    return select_best_generic(plan, entry_labels, entry_weights, labels,
                               seed, FUSED_ROUNDS, selection)


def run_bm_plan_generic(plan, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, cur_labels: torch.Tensor,
                        ops: EngineRounds, selection=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared νBM driver: incumbent-initialise each round-0 row from
    ``plan.row_to_vertex0``, run the engine's single round-0 launch and
    merge the per-row partial states per vertex with the
    order-insensitive ``sketch.bm_merge_rows``. Returns per-vertex (label
    [N], weight [N]); vertices with no entries get -1.

    With a ``selection`` the launch covers the compacted active round-0
    rows. Every row of an active vertex is among them, so active vertices
    merge their complete partial set; vertices with no compacted row come
    back (-1, 0.0), which the gate masks."""
    n = plan.n_nodes
    if n == 0:
        dev = entry_labels.device
        return (torch.full((0,), -1, dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev))
    rnd0, rtv0 = plan.rounds[0], plan.row_to_vertex0
    if selection is not None:
        rnd0, _, rtv0 = ops.compact(rnd0, selection.frontier,
                                    selection.cap_rows)
    init = bm_init_rows(rtv0, cur_labels)
    ck, wk = ops.bm(rnd0, entry_labels, entry_weights, init,
                    chunk=plan.chunk)
    return bm_merge_rows(n, cur_labels, rtv0, ck, wk)


def run_bm_plan_fused(plan: FusedFoldPlan, entry_labels: torch.Tensor,
                      entry_weights: torch.Tensor, cur_labels: torch.Tensor,
                      *, selection=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused νBM iteration core: ONE K3 launch + the max-reduce merge.
    Bit-identical to ``repro_torch.core.sketch.run_bm_plan``: per-row
    folds replay the same entry sequences, and the merge is an
    order-insensitive max/min scatter."""
    return run_bm_plan_generic(plan, entry_labels, entry_weights, cur_labels,
                               FUSED_ROUNDS, selection)


def rescan_select_generic(plan, entry_labels: torch.Tensor,
                          entry_weights: torch.Tensor, labels: torch.Tensor,
                          seed, ops: EngineRounds, selection=None
                          ) -> torch.Tensor:
    """Shared double-scan driver: the engine's MG fold, the final
    sketches scattered to per-vertex candidate sets and broadcast to
    round-0 rows via ``plan.row_to_vertex0``, the engine's single rescan
    launch, then the deterministic ``sketch.merge_rescan_partials`` and
    the shared selection.

    With a ``selection`` the fold rounds and the rescan launch cover the
    compacted active rows; the rescan partials are scattered back to
    round 0's dense rows (0.0 elsewhere) before the merge, so inactive
    vertices end with an all-empty candidate set and keep their label."""
    n, k = plan.n_nodes, plan.k
    if n == 0:
        return labels
    s_k, _ = run_mg_plan_generic(plan, entry_labels, entry_weights, ops,
                                 selection)
    rtv = plan.row_to_vertex
    cand = torch.full((n + 1, k), -1, dtype=torch.int32, device=s_k.device)
    # real final rows own distinct vertices; pad rows hit the dump slot n
    cand[torch.where(rtv >= 0, rtv, n).long()] = s_k
    cand[n] = -1
    rnd0, rv0 = plan.rounds[0], plan.row_to_vertex0
    if selection is not None:
        rnd0, idx0, rv0 = ops.compact(rnd0, selection.frontier,
                                      selection.cap_rows)
    cand_rows = cand[torch.where(rv0 >= 0, rv0, n).long()]
    parts = ops.rescan(rnd0, entry_labels, entry_weights, cand_rows, k=k,
                       chunk=plan.chunk)
    if selection is not None:
        parts = ops.scatter(plan.rounds[0], idx0, parts, 0.0)
    acc = merge_rescan_partials(n, k, plan.max_rows0, plan.row_to_vertex0,
                                plan.row_rank0, parts)
    cand = cand[:n]
    return choose_from_candidates(torch.where(acc > 0, cand, -1), acc,
                                  labels, seed)


def rescan_select_fused(plan: FusedFoldPlan, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, labels: torch.Tensor,
                        seed, *, selection=None) -> torch.Tensor:
    """Full double-scan MG iteration on the fused engine: ``n_rounds`` K1
    launches + ONE K4 launch. Bit-identical to the reference
    ``run_mg_plan`` + ``rescan_candidates``."""
    return rescan_select_generic(plan, entry_labels, entry_weights, labels,
                                 seed, FUSED_ROUNDS, selection)


#: the fused engine's round wrappers (K1–K4) and row compaction
FUSED_ROUNDS = EngineRounds(
    fold=fused_fold_round, select=fused_select_round,
    bm=bm_fold_round_fused, rescan=rescan_round_fused,
    compact=sparse_fused_round, scatter=scatter_sparse_rows)
