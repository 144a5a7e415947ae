"""Sketch-based LPA on torch: the weighted Misra-Gries (νMG-LPA) and
Boyer-Moore (νBM-LPA) folds, the exact O(|E|) baseline, the fold engines,
the LPA driver and the modularity/NMI quality metrics."""
from repro_torch.core.lpa import (LPAConfig, LPAResult, LPAWorkspace,
                                  build_workspace, lpa, lpa_move,
                                  lpa_step_fn)
from repro_torch.core.fold_engine import FoldEngine, get_engine
from repro_torch.core.modularity import modularity, nmi
from repro_torch.core import sketch, exact

__all__ = [
    "LPAConfig", "LPAResult", "LPAWorkspace", "build_workspace", "lpa",
    "lpa_move", "lpa_step_fn", "FoldEngine", "get_engine", "modularity",
    "nmi", "sketch", "exact",
]
