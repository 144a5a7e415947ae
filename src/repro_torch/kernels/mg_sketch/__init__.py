"""Weighted Misra-Gries sketch fold kernels (K1 fold, K2 fold + select)."""
from repro_torch.kernels.mg_sketch.fused import (run_mg_plan_fused,
                                                 select_best_fused)

__all__ = ["run_mg_plan_fused", "select_best_fused"]
