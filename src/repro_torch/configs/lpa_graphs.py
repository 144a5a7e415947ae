"""The paper's own workloads: sketch-based LPA community detection.

The production dry-run cell is a web-scale graph (uk-2005-like: 256M
vertices, 3.4B directed edges), described by its sizes only.
"""
import dataclasses

from repro_torch.configs.registry import ArchSpec, ShapeCell, register
from repro_torch.core.lpa import LPAConfig


@dataclasses.dataclass(frozen=True)
class LPAArchConfig:
    lpa: LPAConfig
    # degree-structure assumptions for the production-scale dry-run plan
    n_nodes: int = 256_000_000
    n_edges: int = 3_400_000_000   # directed slots
    frac_high_degree_edges: float = 0.3  # share of edges on deg>chunk rows


FULL = LPAArchConfig(lpa=LPAConfig(method="mg", k=8, chunk=128))
SMOKE = LPAArchConfig(lpa=LPAConfig(method="mg", k=8, chunk=32),
                      n_nodes=4096, n_edges=80000)

register(ArchSpec(
    arch_id="lpa-mg8", family="lpa", config=FULL, smoke=SMOKE,
    cells=[
        ShapeCell("web_4b", "lpa", {"n_nodes": 256_000_000,
                                    "n_edges": 3_400_000_000},
                  note="sk-2005-scale: the graph that OOMs nu-LPA on A100"),
        ShapeCell("web_560m", "lpa", {"n_nodes": 18_500_000,
                                      "n_edges": 567_000_000},
                  note="uk-2002 scale"),
        ShapeCell("web_4b_halo", "lpa", {"n_nodes": 256_000_000,
                                         "n_edges": 3_400_000_000,
                                         "halo": True, "halo_frac": 0.25,
                                         "hub_frac": 0.002},
                  note="beyond-paper hub+halo label exchange "
                       "(EXPERIMENTS.md #Perf hillclimb: LPA)"),
    ],
    notes="the paper's technique itself, distributed per DESIGN.md section 4",
))
