"""νMG-LPA on torch: the sketch folds, the fold engines, the LPA driver
and the modularity/NMI quality metrics."""
from repro_torch.core.lpa import (LPAConfig, LPAResult, LPAWorkspace,
                                  build_workspace, lpa, lpa_move)
from repro_torch.core.fold_engine import FoldEngine, get_engine
from repro_torch.core.modularity import modularity, nmi
from repro_torch.core import sketch

__all__ = [
    "LPAConfig", "LPAResult", "LPAWorkspace", "build_workspace", "lpa",
    "lpa_move", "FoldEngine", "get_engine", "modularity", "nmi", "sketch",
]
