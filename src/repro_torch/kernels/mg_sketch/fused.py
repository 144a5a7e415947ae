"""Fused MG fold and select: hand-written CUDA kernels, their plain versions
and the drivers that walk a ``FusedFoldPlan`` with them.

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

Each wrapper (``fused_fold_round``, ``fused_select_round``) takes one rule
from the tensors it is given: on the CPU it calls the plain version
(``fused_fold_round_plain``, ``fused_select_round_plain``); on CUDA it
launches the kernel on the current stream, or raises. Nothing falls back.
The plain versions are vectorised torch: the masked
``row_start + arange(chunk)`` gather of the reference's ``_gather_tile``,
then ``repro_torch.core.sketch.mg_fold_tile``'s column loop.

``LAUNCH_COUNTS`` counts the kernel launches of each wrapper (and nothing
else), so a run can show that the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.sketch import choose_from_candidates, mg_fold_tile
from repro_torch.graphs.csr import FusedFoldPlan, FusedRound

__all__ = ["SUPPORTED_K", "LAUNCH_COUNTS", "reset_launch_counts",
           "fused_fold_round", "fused_select_round",
           "fused_fold_round_plain", "fused_select_round_plain",
           "run_mg_plan_fused", "select_best_fused"]

#: sketch widths k the CUDA kernels are instantiated for
SUPPORTED_K = (4, 8, 32)

#: kernel launches per wrapper since the last reset_launch_counts()
LAUNCH_COUNTS = {"fused_fold": 0, "fused_select": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    built = load_library("mg_fused")
    lib = built.lib
    if not getattr(lib, "_repro_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mg_fused_fold.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                      i32, i32, ptr]
        lib.mg_fused_fold.restype = i32
        lib.mg_fused_select.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, ptr,
                                        i32, i32, i32, ptr]
        lib.mg_fused_select.restype = i32
        lib._repro_typed = True
    return lib


def _check_inputs(rnd: FusedRound, entry_labels: torch.Tensor,
                  entry_weights: torch.Tensor, k: int) -> torch.device:
    """Device, dtype, contiguity and shape checks shared by both wrappers;
    returns the device the round runs on."""
    dev = entry_labels.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t, dtype in (("row_start", rnd.row_start, torch.int32),
                           ("row_count", rnd.row_count, torch.int32),
                           ("entry_labels", entry_labels, torch.int32),
                           ("entry_weights", entry_weights, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, entry_labels on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rnd.row_start.dim() != 2 or rnd.row_count.shape != rnd.row_start.shape:
        raise ValueError("row_start/row_count must be [n_steps, tile_r]")
    want = (rnd.n_entries_in,)
    if entry_labels.shape != want or entry_weights.shape != want:
        raise ValueError(f"entry arrays must be {want} (the round's "
                         f"n_entries_in), got {tuple(entry_labels.shape)} "
                         f"and {tuple(entry_weights.shape)}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if dev.type == "cuda" and k not in SUPPORTED_K:
        raise ValueError(f"the CUDA kernels are built for k in {SUPPORTED_K}, "
                         f"got k={k}")
    return dev


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
    dev = entry_labels.device
    starts = rnd.row_start.reshape(-1).long()
    counts = rnd.row_count.reshape(-1)
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
    dev = _check_inputs(rnd, entry_labels, entry_weights, k)
    if dev.type == "cpu":
        return fused_fold_round_plain(rnd, entry_labels, entry_weights,
                                      k=k, chunk=chunk)
    rows = rnd.row_start.numel()
    out_k = torch.empty((rows, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((rows, k), dtype=torch.float32, device=dev)
    rc = _library().mg_fused_fold(
        rnd.row_start.data_ptr(), rnd.row_count.data_ptr(),
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
    dev = _check_inputs(rnd, entry_labels, entry_weights, k)
    rows = rnd.row_start.numel()
    if (incumbents.device != dev or incumbents.dtype != torch.int32
            or incumbents.shape != (rows,) or not incumbents.is_contiguous()):
        raise ValueError(f"incumbents must be a contiguous [{rows}] int32 "
                         f"tensor on {dev}")
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    if dev.type == "cpu":
        return fused_select_round_plain(rnd, entry_labels, entry_weights,
                                        incumbents, seed, k=k, chunk=chunk)
    out_c = torch.empty((rows,), dtype=torch.int32, device=dev)
    rc = _library().mg_fused_select(
        rnd.row_start.data_ptr(), rnd.row_count.data_ptr(),
        incumbents.data_ptr(), seed, entry_labels.data_ptr(),
        entry_weights.data_ptr(), out_c.data_ptr(), rows, k, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mg_fused_select")
    LAUNCH_COUNTS["fused_select"] += 1
    return out_c


# ---------------------------------------------------------------------------
# Plan drivers
# ---------------------------------------------------------------------------


def run_mg_plan_fused(plan: FusedFoldPlan, entry_labels: torch.Tensor,
                      entry_weights: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All fold rounds, one K1 launch each. Returns the final-round padded
    sketches in fused row order (map to vertices via plan.row_to_vertex)."""
    labels, weights = entry_labels, entry_weights
    for rnd in plan.rounds:
        s_k, s_v = fused_fold_round(rnd, labels, weights, k=plan.k,
                                    chunk=plan.chunk)
        labels, weights = s_k.reshape(-1), s_v.reshape(-1)
    return s_k, s_v


def select_best_fused(plan: FusedFoldPlan, entry_labels: torch.Tensor,
                      entry_weights: torch.Tensor, labels: torch.Tensor,
                      seed) -> torch.Tensor:
    """Full fused MG iteration: ``n_rounds - 1`` K1 launches and one K2
    launch. Bit-identical to ``run_mg_plan`` + ``select_best`` on the
    plain-torch reference engine. Returns the wanted label per vertex."""
    if plan.n_nodes == 0:
        return labels
    el, ew = entry_labels, entry_weights
    for rnd in plan.rounds[:-1]:
        s_k, s_v = fused_fold_round(rnd, el, ew, k=plan.k, chunk=plan.chunk)
        el, ew = s_k.reshape(-1), s_v.reshape(-1)
    last, rv = plan.rounds[-1], plan.row_to_vertex
    n = plan.n_nodes
    real = rv >= 0
    incumbents = torch.where(real, labels[torch.clamp_min(rv, 0)], -1)
    choice = fused_select_round(last, el, ew, incumbents, seed,
                                k=plan.k, chunk=plan.chunk)
    # [N] scatter of per-row winners. A vertex owns at most one final row,
    # so real rows write distinct slots; pad rows all write -1 into the
    # dump slot n, which is sliced off. Vertices with no fold rows keep
    # their label, as choose_from_candidates does for an empty set.
    buf = torch.cat([labels, labels.new_zeros((1,))])
    buf[torch.where(real, rv, n).long()] = torch.where(real, choice, -1)
    return buf[:n]
