"""Per-bucket tile folds: the hand-written CUDA kernels K9 and K10 and
their launchers.

Kernels (``src/repro_torch/csrc/mg_tile.cu``, built by
``repro_torch.kernels.build``; one thread per row on the per-entry fold
bodies of the fused and streamed kernels, ``csrc/sketch_rows.cuh``, each
block of 128 rows staged through shared memory with coalesced
``cp.async`` copies, ``csrc/row_stage.cuh``):

  * **K9** ``mg_tile_fold`` — a dense padded [R, D] (label, weight) tile
    into [R, k] weighted MG sketches (pads: label -1, weight 0.0), its
    sketch stored as 16-byte vectors.
    Replaces the TPU kernel ``repro/kernels/mg_sketch/mg_sketch.py:_mg_kernel``.
  * **K10** ``mg_tile_bm_fold`` — the same tile into [R] weighted
    Boyer-Moore states from per-row incumbents. Replaces
    ``repro/kernels/mg_sketch/mg_sketch.py:_bm_kernel``.

The launchers here take CUDA tensors only and count each launch in
``LAUNCH_COUNTS`` (``repro_torch.kernels.launches``: ``tile_mg_fold``,
``tile_bm_fold``). The public wrappers with the reference's signatures,
which take the plain version (``kernels.mg_sketch.ref``) for a tensor on
the CPU, are in ``kernels.mg_sketch.ops``. The padded tiles come from the
bucketed plan walk (``repro_torch.core.sketch.run_mg_plan`` /
``run_bm_plan``), a plain torch gather outside the kernels, as XLA's is
outside the reference's.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.launches import LAUNCH_COUNTS

__all__ = ["SUPPORTED_K", "check_tile", "mg_fold_tile_cuda",
           "bm_fold_tile_cuda", "tile_fold_smem_bytes"]

#: sketch widths k the CUDA kernel K9 is instantiated for (K10 keeps one
#: carry and has no k)
SUPPORTED_K = (4, 8, 32)


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library("mg_tile").lib
    if not getattr(lib, "_repro_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # labels, weights, out_k, out_v, n_rows, width, k, device, stream
        lib.mg_tile_fold.argtypes = [ptr] * 4 + [i32, i32, i32, i32, ptr]
        # labels, weights, init, out_c, out_w, n_rows, width, device, stream
        lib.mg_tile_bm_fold.argtypes = [ptr] * 5 + [i32, i32, i32, ptr]
        # width, k, aligned
        lib.mg_tile_fold_smem_bytes.argtypes = [i32, i32, i32]
        lib.mg_tile_fold.restype = i32
        lib.mg_tile_bm_fold.restype = i32
        lib.mg_tile_fold_smem_bytes.restype = i32
        lib._repro_typed = True
    return lib


def check_tile(labels: torch.Tensor, weights: torch.Tensor,
               k: Optional[int] = None,
               init_label: Optional[torch.Tensor] = None) -> torch.device:
    """Device, dtype, shape and contiguity checks of a tile fold's
    operands (``k=None`` for K10, which keeps one carry); returns the
    device the fold runs on."""
    dev = labels.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if labels.dim() != 2 or weights.shape != labels.shape:
        raise ValueError(f"labels and weights must be one [R, D] shape, got "
                         f"{tuple(labels.shape)} and {tuple(weights.shape)}")
    operands = [("labels", labels, torch.int32),
                ("weights", weights, torch.float32)]
    if init_label is not None:
        if init_label.shape != labels.shape[:1]:
            raise ValueError(f"init_label must be [{labels.shape[0]}], got "
                             f"{tuple(init_label.shape)}")
        operands.append(("init_label", init_label, torch.int32))
    for name, t, dtype in operands:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, labels on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k is not None:
        if k < 1:
            raise ValueError(f"k must be positive, got {k}")
        if dev.type == "cuda" and k not in SUPPORTED_K:
            raise ValueError(f"the CUDA kernel K9 is built for k in "
                             f"{SUPPORTED_K}, got k={k}")
    return dev


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc}")


def mg_fold_tile_cuda(labels: torch.Tensor, weights: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: [R, D] padded tile on the card -> ([R, k] int32, [R, k] float32)
    MG sketches, on the current stream. An empty tile (R = 0) launches
    nothing."""
    dev = check_tile(labels, weights, k)
    if dev.type != "cuda":
        raise ValueError(f"K9 runs on a CUDA device, got {dev}")
    r, d = labels.shape
    out_k = torch.empty((r, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((r, k), dtype=torch.float32, device=dev)
    if r == 0:
        return out_k, out_v
    rc = _library().mg_tile_fold(
        labels.data_ptr(), weights.data_ptr(), out_k.data_ptr(),
        out_v.data_ptr(), r, d, k, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mg_tile_fold")
    LAUNCH_COUNTS["tile_mg_fold"] += 1
    return out_k, out_v


def bm_fold_tile_cuda(labels: torch.Tensor, weights: torch.Tensor,
                      init_label: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: [R, D] padded tile + [R] incumbents on the card -> ([R] int32
    candidate, [R] float32 vote weight), on the current stream. An empty
    tile (R = 0) launches nothing."""
    dev = check_tile(labels, weights, init_label=init_label)
    if dev.type != "cuda":
        raise ValueError(f"K10 runs on a CUDA device, got {dev}")
    r, d = labels.shape
    out_c = torch.empty((r,), dtype=torch.int32, device=dev)
    out_w = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return out_c, out_w
    rc = _library().mg_tile_bm_fold(
        labels.data_ptr(), weights.data_ptr(), init_label.data_ptr(),
        out_c.data_ptr(), out_w.data_ptr(), r, d, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mg_tile_bm_fold")
    LAUNCH_COUNTS["tile_bm_fold"] += 1
    return out_c, out_w


def tile_fold_smem_bytes(width: int, k: Optional[int],
                         aligned: bool = True) -> int:
    """Dynamic shared memory per launch, in bytes, of K9 at sketch width
    ``k`` (``k=None``: of K10) for a tile of width ``width`` whose arrays
    are 16-byte aligned (as fresh allocations are) or not: the size the
    launcher asks for."""
    n = _library().mg_tile_fold_smem_bytes(width, k or 0, int(aligned))
    if n < 0:
        raise ValueError(f"no tile kernel instantiation for width {width}, "
                         f"k {k}")
    return n
