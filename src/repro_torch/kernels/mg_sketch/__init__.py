"""Sketch fold kernels: fused (K1 MG fold, K2 MG fold + select, K3 BM
fold, K4 rescan), streamed over entry windows (K5 MG fold, K6 MG fold
+ select, K7 BM fold, K8 rescan) and per-bucket tiles (K9 MG fold, K10 BM
fold)."""
from repro_torch.kernels.mg_sketch.fused import (rescan_select_fused,
                                                 run_bm_plan_fused,
                                                 run_mg_plan_fused,
                                                 select_best_fused)
from repro_torch.kernels.mg_sketch.ops import (bm_fold_tile_pallas,
                                               mg_fold_tile_pallas)
from repro_torch.kernels.mg_sketch.streaming import (rescan_select_stream,
                                                     run_bm_plan_stream,
                                                     run_mg_plan_stream,
                                                     select_best_stream)

__all__ = ["run_mg_plan_fused", "select_best_fused", "run_bm_plan_fused",
           "rescan_select_fused", "run_mg_plan_stream", "select_best_stream",
           "run_bm_plan_stream", "rescan_select_stream",
           "mg_fold_tile_pallas", "bm_fold_tile_pallas"]
