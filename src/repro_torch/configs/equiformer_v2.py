"""equiformer-v2 [arXiv:2306.12059]: 12L d_hidden=128 l_max=6 m_max=2
n_heads=8, SO(2)-eSCN equivariant graph attention."""
from repro_torch.configs.registry import ArchSpec, _gnn_cells, register
from repro_torch.models.gnn.equiformer_v2 import EquiformerConfig

FULL = EquiformerConfig(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                        n_heads=8)
SMOKE = EquiformerConfig(n_layers=2, d_hidden=16, l_max=2, m_max=1,
                         n_heads=4, d_in=8, d_out=4, n_rbf=8)

register(ArchSpec(arch_id="equiformer-v2", family="gnn", config=FULL,
                  smoke=SMOKE, cells=_gnn_cells(),
                  notes="exact Wigner-D edge rotations (wigner.py); SO(2) "
                        "conv O(L^3) per edge (eSCN trick)."))
