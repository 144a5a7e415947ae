"""Fused sketch fold kernels (K1 MG fold, K2 MG fold + select, K3 BM fold,
K4 rescan)."""
from repro_torch.kernels.mg_sketch.fused import (rescan_select_fused,
                                                 run_bm_plan_fused,
                                                 run_mg_plan_fused,
                                                 select_best_fused)

__all__ = ["run_mg_plan_fused", "select_best_fused", "run_bm_plan_fused",
           "rescan_select_fused"]
