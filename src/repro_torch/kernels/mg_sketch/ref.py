"""Plain-torch oracles of the per-bucket tile kernels K9 and K10.

These re-export the reference tile folds of ``repro_torch.core.sketch``:
the semantics the CUDA kernels of ``kernels.mg_sketch.mg_sketch`` must
reproduce bit for bit (int32 labels, float32 weights, one row's entries
folded in entry order, so no tolerance is needed).
"""
from repro_torch.core.sketch import bm_fold_tile as bm_fold_ref
from repro_torch.core.sketch import mg_fold_tile as mg_fold_ref

__all__ = ["mg_fold_ref", "bm_fold_ref"]
