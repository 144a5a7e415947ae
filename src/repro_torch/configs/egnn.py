"""egnn [arXiv:2102.09844]: 4L d_hidden=64, E(n)-equivariant."""
from repro_torch.configs.registry import ArchSpec, _gnn_cells, register
from repro_torch.models.gnn.egnn import EGNNConfig

FULL = EGNNConfig(n_layers=4, d_hidden=64)
SMOKE = EGNNConfig(n_layers=2, d_hidden=16, d_in=8, d_out=4)

register(ArchSpec(arch_id="egnn", family="gnn", config=FULL, smoke=SMOKE,
                  cells=_gnn_cells()))
