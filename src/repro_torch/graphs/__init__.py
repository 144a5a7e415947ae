"""Graph substrate: CSR container, generators and fold plans on torch."""
from repro_torch.graphs.csr import (CSRGraph, FoldPlan, FusedFoldPlan,
                                    StreamedFoldPlan, build_csr,
                                    build_fold_plan, build_fused_fold_plan,
                                    build_streamed_fold_plan,
                                    graph_from_arrays)
from repro_torch.graphs import generators

__all__ = ["CSRGraph", "FoldPlan", "FusedFoldPlan", "StreamedFoldPlan",
           "build_csr", "build_fold_plan", "build_fused_fold_plan",
           "build_streamed_fold_plan", "graph_from_arrays", "generators"]
