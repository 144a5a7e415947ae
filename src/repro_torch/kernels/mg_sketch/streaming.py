"""Streamed sketch folds: hand-written CUDA kernels over the windowed
layout of a ``StreamedFoldPlan``, their plain versions, the re-layout
gathers and the drivers.

Kernels (``src/repro_torch/csrc/mg_stream.cu``, built by
``repro_torch.kernels.build``; one block per window, the per-row fold
bodies of the fused kernels, ``csrc/sketch_rows.cuh``):

  * **K5** ``mg_stream_fold`` — one launch per fold round; row slot s of
    window w folds its entries into a k-slot weighted MG sketch. Replaces
    the TPU kernel
    ``repro/kernels/mg_sketch/streaming.py:_stream_fold_kernel``.
  * **K6** ``mg_stream_select`` — the last round: K5's fold, then the move
    selection. Replaces ``streaming.py:_stream_select_kernel``.
  * **K7** ``mg_stream_bm_fold`` — the whole νBM fold in one launch over
    round 0's windows. Replaces ``streaming.py:_stream_bm_kernel``.
  * **K8** ``mg_stream_rescan`` — the rescan second pass in one launch
    over round 0's windows. Replaces ``streaming.py:_stream_rescan_kernel``.

A round covers ``n_windows`` windows: window w owns entry slots
``[w*W, (w+1)*W)`` of the windowed layout and row slots
``[w*tile_r, (w+1)*tile_r)``; ``row_start`` is window-relative. The
windowed (label, weight) arrays come from the round's source arrays
through :func:`windowed_entries`, a plain torch gather (the reference does
it in XLA, outside any Pallas kernel), except on an aligned round
(``StreamedRound.aligned``), whose source arrays are already windowed.

Each round wrapper (``stream_fold_round``, ``stream_select_round``,
``bm_fold_round_stream``, ``rescan_round_stream``) takes the reference's
arguments and one rule from the tensors it is given: on the CPU it calls
the plain version (``*_plain``, the re-layout then the fused module's
masked gather and the ``repro_torch.core.sketch`` fold); on CUDA it
re-lays the entries, then launches the kernel on the current stream, or
raises. Nothing falls back. ``LAUNCH_COUNTS`` is the one table of the
port's kernels (``repro_torch.kernels.launches``).

The drivers are the fused module's generic ones over these wrappers and
the window compaction of the sparse frontier path
(:func:`sparse_stream_round`, :func:`scatter_sparse_windows`):
:data:`STREAM_ROUNDS`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.sketch import (bm_fold_tile, choose_from_candidates,
                                     mg_fold_tile, rescan_row_partials)
from repro_torch.graphs.csr import (StreamedFoldPlan, StreamedRound,
                                    _round_active, compact_active_rows)
from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts
from repro_torch.kernels.mg_sketch.fused import (SUPPORTED_K, EngineRounds,
                                                 _check_inputs,
                                                 _check_row_tensor,
                                                 _raise_on, gather_rows,
                                                 rescan_select_generic,
                                                 run_bm_plan_generic,
                                                 run_mg_plan_generic,
                                                 select_best_generic,
                                                 take_ext)

__all__ = ["SUPPORTED_K", "LAUNCH_COUNTS", "reset_launch_counts",
           "windowed_entries", "round_window_entries", "stream_fold_round",
           "stream_select_round", "bm_fold_round_stream",
           "rescan_round_stream", "stream_fold_round_plain",
           "stream_select_round_plain", "bm_fold_round_stream_plain",
           "rescan_round_stream_plain", "sparse_stream_round",
           "scatter_sparse_windows", "STREAM_ROUNDS", "run_mg_plan_stream",
           "select_best_stream", "run_bm_plan_stream",
           "rescan_select_stream"]


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library("mg_stream").lib
    if not getattr(lib, "_repro_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # ..., n_windows, tile_r, window_entries[, k], device, stream
        lib.mg_stream_fold.argtypes = [ptr] * 6 + [i32, i32, i64, i32, i32,
                                                   ptr]
        lib.mg_stream_select.argtypes = ([ptr] * 3 + [i32] + [ptr] * 3
                                         + [i32, i32, i64, i32, i32, ptr])
        lib.mg_stream_bm_fold.argtypes = [ptr] * 7 + [i32, i32, i64, i32,
                                                      ptr]
        lib.mg_stream_rescan.argtypes = [ptr] * 6 + [i32, i32, i64, i32,
                                                     i32, ptr]
        for fn in (lib.mg_stream_fold, lib.mg_stream_select,
                   lib.mg_stream_bm_fold, lib.mg_stream_rescan):
            fn.restype = i32
        lib._repro_typed = True
    return lib


# ---------------------------------------------------------------------------
# The windowed re-layout (plain torch, as the reference's XLA gather)
# ---------------------------------------------------------------------------


def windowed_entries(gather: torch.Tensor, entry_labels: torch.Tensor,
                     entry_weights: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-lay flat entry arrays into the plan's windowed layout.

    ``gather`` is a round's ``entry_gather`` [n_windows * W] int32 (source
    position per windowed slot, -1 = pad). Pad slots become (label -1,
    weight 0.0), no-ops for the folds. Returns ([n_windows * W] int32
    labels, [n_windows * W] float32 weights).
    """
    if entry_labels.shape[0] == 0:  # edgeless graph: all slots are pads
        return (torch.full(gather.shape, -1, dtype=torch.int32,
                           device=gather.device),
                torch.zeros(gather.shape, dtype=torch.float32,
                            device=gather.device))
    pad = gather < 0
    safe = torch.clamp_min(gather, 0)
    wl = torch.index_select(entry_labels.to(torch.int32), 0, safe)
    wl.masked_fill_(pad, -1)
    ww = torch.index_select(entry_weights.to(torch.float32), 0, safe)
    ww.masked_fill_(pad, 0.0)
    return wl, ww


def round_window_entries(rnd: StreamedRound, entry_labels: torch.Tensor,
                         entry_weights: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The windowed arrays a round's kernel reads: the source arrays
    themselves on an aligned round (pads already hold -1 / 0.0 by plan
    construction), else :func:`windowed_entries` through the round's
    ``entry_gather``."""
    if rnd.aligned:
        return entry_labels.to(torch.int32), entry_weights.to(torch.float32)
    return windowed_entries(rnd.entry_gather, entry_labels, entry_weights)


def _window_tile(rnd: StreamedRound, wl: torch.Tensor, ww: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n_windows * tile_r, chunk] (label, weight) tiles in row-slot
    order: slot s of window w reads ``w*W + row_start[w, s]`` onwards."""
    base = torch.arange(rnd.n_windows, dtype=torch.int64,
                        device=wl.device) * rnd.window_entries
    starts = (base[:, None] + rnd.row_start.long()).reshape(-1)
    return gather_rows(starts, rnd.row_count.reshape(-1), wl, ww, chunk)


def _check_round(rnd: StreamedRound, entry_labels: torch.Tensor,
                 entry_weights: torch.Tensor, k) -> torch.device:
    """The fused wrappers' device/dtype/shape checks, plus the round's
    re-layout map."""
    dev = _check_inputs(rnd, entry_labels, entry_weights, k)
    slots = (rnd.n_windows * rnd.window_entries,)
    eg = rnd.entry_gather
    if (eg.device != dev or eg.dtype != torch.int32 or eg.shape != slots
            or not eg.is_contiguous()):
        raise ValueError(f"entry_gather must be a contiguous {list(slots)} "
                         f"int32 tensor on {dev}")
    if rnd.aligned and rnd.n_entries_in != slots[0]:
        raise ValueError("an aligned round reads n_windows * W source "
                         f"entries, got n_entries_in={rnd.n_entries_in}")
    return dev


def _launch_args(rnd: StreamedRound, dev: torch.device) -> tuple:
    """(n_windows, tile_r, window_entries, device, stream) of a launch."""
    return (rnd.n_windows, rnd.tile_r, rnd.window_entries, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def stream_fold_round_plain(rnd: StreamedRound, entry_labels: torch.Tensor,
                            entry_weights: torch.Tensor, *, k: int,
                            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's round in plain torch: padded ([n_windows * tile_r, k] int32,
    [..., k] float32) sketches in row-slot order."""
    wl, ww = round_window_entries(rnd, entry_labels, entry_weights)
    lab, wgt = _window_tile(rnd, wl, ww, chunk)
    return mg_fold_tile(lab, wgt, k)


def stream_select_round_plain(rnd: StreamedRound, entry_labels: torch.Tensor,
                              entry_weights: torch.Tensor,
                              incumbents: torch.Tensor, seed, *, k: int,
                              chunk: int) -> torch.Tensor:
    """K6's round in plain torch: the winning label per row slot
    ([n_windows * tile_r] int32)."""
    s_k, s_v = stream_fold_round_plain(rnd, entry_labels, entry_weights,
                                       k=k, chunk=chunk)
    return choose_from_candidates(torch.where(s_v > 0, s_k, -1), s_v,
                                  incumbents, seed)


def bm_fold_round_stream_plain(rnd: StreamedRound,
                               entry_labels: torch.Tensor,
                               entry_weights: torch.Tensor,
                               init_labels: torch.Tensor, *, chunk: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's round in plain torch: per-slot ([rows] int32 candidate,
    [rows] float32 vote weight) BM states from (``init_labels``, 0.0)."""
    wl, ww = round_window_entries(rnd, entry_labels, entry_weights)
    lab, wgt = _window_tile(rnd, wl, ww, chunk)
    return bm_fold_tile(lab, wgt, init_labels)


def rescan_round_stream_plain(rnd: StreamedRound, entry_labels: torch.Tensor,
                              entry_weights: torch.Tensor,
                              cand_rows: torch.Tensor, *, chunk: int
                              ) -> torch.Tensor:
    """K8's round in plain torch: [rows, k] float32 partial linking
    weights of each row slot's candidates ``cand_rows`` [rows, k]."""
    wl, ww = round_window_entries(rnd, entry_labels, entry_weights)
    lab, wgt = _window_tile(rnd, wl, ww, chunk)
    return rescan_row_partials(lab, wgt, cand_rows)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def stream_fold_round(rnd: StreamedRound, entry_labels: torch.Tensor,
                      entry_weights: torch.Tensor, *, k: int, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streamed round, every window in one launch (K5).

    ``entry_labels``/``entry_weights`` are the round's source arrays
    (round 0: CSR-order neighbour labels and weights, or the aligned
    windowed arrays on an aligned round; later rounds: the previous
    round's flattened padded sketches). Returns padded
    ([n_windows * tile_r, k] int32, [..., k] float32) sketches in row-slot
    order; pad slots fold to empty sketches.
    """
    dev = _check_round(rnd, entry_labels, entry_weights, k)
    if dev.type == "cpu":
        return stream_fold_round_plain(rnd, entry_labels, entry_weights,
                                       k=k, chunk=chunk)
    wl, ww = round_window_entries(rnd, entry_labels, entry_weights)
    rows = rnd.row_start.numel()
    out_k = torch.empty((rows, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((rows, k), dtype=torch.float32, device=dev)
    n_win, tile_r, w, index, stream = _launch_args(rnd, dev)
    rc = _library().mg_stream_fold(
        rnd.row_start.data_ptr(), rnd.row_count.data_ptr(), wl.data_ptr(),
        ww.data_ptr(), out_k.data_ptr(), out_v.data_ptr(), n_win, tile_r, w,
        k, index, stream)
    _raise_on(rc, "mg_stream_fold")
    LAUNCH_COUNTS["stream_fold"] += 1
    return out_k, out_v


def stream_select_round(rnd: StreamedRound, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, incumbents: torch.Tensor,
                        seed, *, k: int, chunk: int) -> torch.Tensor:
    """The last streamed round: fold + winning label per row slot (K6).

    ``incumbents`` [n_windows * tile_r] int32 carries each row slot's
    current vertex label (-1 on pad slots)."""
    dev = _check_round(rnd, entry_labels, entry_weights, k)
    rows = rnd.row_start.numel()
    _check_row_tensor(incumbents, "incumbents", (rows,), dev)
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    if dev.type == "cpu":
        return stream_select_round_plain(rnd, entry_labels, entry_weights,
                                         incumbents, seed, k=k, chunk=chunk)
    wl, ww = round_window_entries(rnd, entry_labels, entry_weights)
    out_c = torch.empty((rows,), dtype=torch.int32, device=dev)
    n_win, tile_r, w, index, stream = _launch_args(rnd, dev)
    rc = _library().mg_stream_select(
        rnd.row_start.data_ptr(), rnd.row_count.data_ptr(),
        incumbents.data_ptr(), seed, wl.data_ptr(), ww.data_ptr(),
        out_c.data_ptr(), n_win, tile_r, w, k, index, stream)
    _raise_on(rc, "mg_stream_select")
    LAUNCH_COUNTS["stream_select"] += 1
    return out_c


def bm_fold_round_stream(rnd: StreamedRound, entry_labels: torch.Tensor,
                         entry_weights: torch.Tensor,
                         init_labels: torch.Tensor, *, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole BM fold in one launch over round 0's windows (K7).

    ``init_labels`` [n_windows * tile_r] int32 carries each row slot's
    incumbent (-1 on pad slots). Returns per-slot ([rows] int32 candidate,
    [rows] float32 vote weight) partial states in row-slot order.
    """
    dev = _check_round(rnd, entry_labels, entry_weights, None)
    rows = rnd.row_start.numel()
    _check_row_tensor(init_labels, "init_labels", (rows,), dev)
    if dev.type == "cpu":
        return bm_fold_round_stream_plain(rnd, entry_labels, entry_weights,
                                          init_labels, chunk=chunk)
    wl, ww = round_window_entries(rnd, entry_labels, entry_weights)
    out_c = torch.empty((rows,), dtype=torch.int32, device=dev)
    out_w = torch.empty((rows,), dtype=torch.float32, device=dev)
    n_win, tile_r, w, index, stream = _launch_args(rnd, dev)
    rc = _library().mg_stream_bm_fold(
        rnd.row_start.data_ptr(), rnd.row_count.data_ptr(),
        init_labels.data_ptr(), wl.data_ptr(), ww.data_ptr(),
        out_c.data_ptr(), out_w.data_ptr(), n_win, tile_r, w, index, stream)
    _raise_on(rc, "mg_stream_bm_fold")
    LAUNCH_COUNTS["stream_bm"] += 1
    return out_c, out_w


def rescan_round_stream(rnd: StreamedRound, entry_labels: torch.Tensor,
                        entry_weights: torch.Tensor, cand_rows: torch.Tensor,
                        *, k: int, chunk: int) -> torch.Tensor:
    """One launch re-reading round 0's windows to score each row slot's
    candidates (K8). ``cand_rows`` [n_windows * tile_r, k] int32. Returns
    [n_windows * tile_r, k] float32 partial linking weights."""
    dev = _check_round(rnd, entry_labels, entry_weights, k)
    rows = rnd.row_start.numel()
    _check_row_tensor(cand_rows, "cand_rows", (rows, k), dev)
    if dev.type == "cpu":
        return rescan_round_stream_plain(rnd, entry_labels, entry_weights,
                                         cand_rows, chunk=chunk)
    wl, ww = round_window_entries(rnd, entry_labels, entry_weights)
    out = torch.empty((rows, k), dtype=torch.float32, device=dev)
    n_win, tile_r, w, index, stream = _launch_args(rnd, dev)
    rc = _library().mg_stream_rescan(
        rnd.row_start.data_ptr(), rnd.row_count.data_ptr(),
        cand_rows.data_ptr(), wl.data_ptr(), ww.data_ptr(), out.data_ptr(),
        n_win, tile_r, w, k, index, stream)
    _raise_on(rc, "mg_stream_rescan")
    LAUNCH_COUNTS["stream_rescan"] += 1
    return out


# ---------------------------------------------------------------------------
# Sparse frontier compaction (whole windows)
# ---------------------------------------------------------------------------
#
# The streamed analogue of the fused module's compaction, at *window*
# granularity: a window is active when any of its rows belongs to a
# frontier vertex, and the synthetic round gathers the active windows'
# entry_gather blocks and row metadata into ``min(cap_rows, n_windows)``
# windows. Inactive rows that share a window with an active one are
# folded too: on round 0 they compute what the dense fold would (the gate
# masks it); on later rounds they read their vertex's empty scatter-back
# partials and fold to empty sketches.


def sparse_stream_round(rnd: StreamedRound, frontier: torch.Tensor,
                        cap_rows: int
                        ) -> Tuple[StreamedRound, torch.Tensor, torch.Tensor]:
    """Compact one round's active windows into a capped synthetic round.

    Returns ``(sub_round, widx, row_vertex)``: a ``StreamedRound`` over
    ``min(cap_rows, n_windows)`` windows (sentinel windows are all pad:
    entry_gather -1, counts 0), the [cap_w] compacted window indices
    (sentinel = the dense window count), and the [cap_w * tile_r] owning
    vertex per compacted row slot (-1 on sentinel windows).

    The sub-round keeps ``aligned=False`` even on an aligned round: its
    windows are a compacted subset of the aligned layout, not a prefix of
    it, so it re-gathers through ``entry_gather[widx]`` (the identity over
    window slots on an aligned round) from the round's source arrays.
    """
    n_win, tile_r = rnd.row_start.shape
    w = rnd.window_entries
    win_active = _round_active(rnd.row_vertex, frontier).reshape(
        n_win, tile_r).any(dim=1)
    widx = compact_active_rows(win_active, min(cap_rows, n_win))
    sub = StreamedRound(
        entry_gather=take_ext(rnd.entry_gather.reshape(n_win, w), widx,
                              -1).reshape(-1),
        row_start=take_ext(rnd.row_start, widx, 0),
        row_count=take_ext(rnd.row_count, widx, 0),
        step_dmax=take_ext(rnd.step_dmax, widx, 0),
        n_entries_in=rnd.n_entries_in, window_entries=w)
    row_vertex = take_ext(rnd.row_vertex.reshape(n_win, tile_r), widx, -1)
    return sub, widx, row_vertex.reshape(-1)


def scatter_sparse_windows(rnd: StreamedRound, widx: torch.Tensor,
                           values: torch.Tensor, fill) -> torch.Tensor:
    """Scatter compacted per-slot results back to the round's dense row
    slots, whole windows at a time. Real compacted windows are distinct,
    each slot written once; sentinel windows land in a dump window that is
    sliced off; unwritten slots keep the empty-sketch ``fill``."""
    n_win, tile_r = rnd.row_start.shape
    lane = torch.arange(tile_r, dtype=torch.int64, device=widx.device)
    targets = (widx.long()[:, None] * tile_r + lane[None, :]).reshape(-1)
    buf = torch.full(((n_win + 1) * tile_r,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    buf[targets] = values
    return buf[:n_win * tile_r]


# ---------------------------------------------------------------------------
# Plan drivers: the fused module's generic ones over the streamed rounds
# ---------------------------------------------------------------------------

#: the streamed engine's round wrappers (K5–K8) and window compaction
STREAM_ROUNDS = EngineRounds(
    fold=stream_fold_round, select=stream_select_round,
    bm=bm_fold_round_stream, rescan=rescan_round_stream,
    compact=sparse_stream_round, scatter=scatter_sparse_windows)


def run_mg_plan_stream(plan: StreamedFoldPlan, entry_labels: torch.Tensor,
                       entry_weights: torch.Tensor, *, selection=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All fold rounds, one K5 launch each. ``entry_labels``/
    ``entry_weights`` are CSR-order, or window-slot order when the plan is
    aligned (gathered from ``aligned_entry_vertex``/``_weights``). Returns
    the final-round padded sketches in row-slot order (map to vertices via
    ``plan.row_to_vertex``). A ``selection`` compacts every launch to the
    frontier's windows."""
    return run_mg_plan_generic(plan, entry_labels, entry_weights,
                               STREAM_ROUNDS, selection)


def select_best_stream(plan: StreamedFoldPlan, entry_labels: torch.Tensor,
                       entry_weights: torch.Tensor, labels: torch.Tensor,
                       seed, *, selection=None) -> torch.Tensor:
    """Full streamed MG iteration: ``n_rounds - 1`` K5 launches and one K6
    launch. Bit-identical to ``run_mg_plan`` + ``select_best`` and to the
    fused engine (on the frontier, with a ``selection``). Returns the
    wanted label per vertex."""
    return select_best_generic(plan, entry_labels, entry_weights, labels,
                               seed, STREAM_ROUNDS, selection)


def run_bm_plan_stream(plan: StreamedFoldPlan, entry_labels: torch.Tensor,
                       entry_weights: torch.Tensor, cur_labels: torch.Tensor,
                       *, selection=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed νBM iteration core: ONE K7 launch + the max-reduce merge.
    Returns per-vertex (label [N], weight [N]); no-entry vertices get -1."""
    return run_bm_plan_generic(plan, entry_labels, entry_weights, cur_labels,
                               STREAM_ROUNDS, selection)


def rescan_select_stream(plan: StreamedFoldPlan, entry_labels: torch.Tensor,
                         entry_weights: torch.Tensor, labels: torch.Tensor,
                         seed, *, selection=None) -> torch.Tensor:
    """Full double-scan MG iteration on the streamed engine: ``n_rounds``
    K5 launches + ONE K8 launch. Bit-identical to the reference
    ``run_mg_plan`` + ``rescan_candidates``."""
    return rescan_select_generic(plan, entry_labels, entry_weights, labels,
                                 seed, STREAM_ROUNDS, selection)
