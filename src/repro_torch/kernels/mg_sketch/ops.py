"""The per-bucket tile folds with the reference's signatures.

``mg_fold_tile_pallas`` and ``bm_fold_tile_pallas`` match
``repro_torch.core.sketch.mg_fold_tile``/``bm_fold_tile``, so either plugs
into ``run_mg_plan``/``run_bm_plan`` as ``fold_tile=``. They keep the
reference's names (``repro.kernels.mg_sketch.ops``) so that one backend
name means the same thing in both packages.

One rule, taken from the tensors: on the CPU each calls its plain version
(``kernels.mg_sketch.ref``); on CUDA it launches its kernel (K9, K10 of
``kernels.mg_sketch.mg_sketch``) on the current stream, or raises.
Nothing falls back. ``tile_r`` is accepted for the reference's signature
and not used: the reference pads the rows to a multiple of it for the
TPU's grid, while the CUDA kernels run one thread per row over the R rows
as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.mg_sketch.mg_sketch import (bm_fold_tile_cuda,
                                                     check_tile,
                                                     mg_fold_tile_cuda)
from repro_torch.kernels.mg_sketch.ref import bm_fold_ref, mg_fold_ref

__all__ = ["DEFAULT_TILE_R", "mg_fold_tile_pallas", "bm_fold_tile_pallas"]

#: the reference's rows per grid step; unused by the CUDA kernels
DEFAULT_TILE_R = 512


def mg_fold_tile_pallas(labels: torch.Tensor, weights: torch.Tensor, k: int,
                        tile_r: int = DEFAULT_TILE_R
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, D] padded neighbour tile -> ([R, k] int32, [R, k] float32)
    weighted MG sketches (K9 on CUDA)."""
    if check_tile(labels, weights, k).type == "cpu":
        return mg_fold_ref(labels, weights, k)
    return mg_fold_tile_cuda(labels, weights, k)


def bm_fold_tile_pallas(labels: torch.Tensor, weights: torch.Tensor,
                        init_label: Optional[torch.Tensor] = None,
                        tile_r: int = DEFAULT_TILE_R
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, D] padded neighbour tile + [R] incumbents (None: -1 for every
    row) -> ([R] int32, [R] float32) weighted BM states (K10 on CUDA)."""
    if init_label is None:
        init_label = torch.full(labels.shape[:1], -1, dtype=torch.int32,
                                device=labels.device)
    if check_tile(labels, weights, init_label=init_label).type == "cpu":
        return bm_fold_ref(labels, weights, init_label)
    return bm_fold_tile_cuda(labels, weights, init_label)
