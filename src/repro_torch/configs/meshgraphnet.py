"""meshgraphnet [arXiv:2010.03409]: 15L d_hidden=128 sum-agg mlp_layers=2."""
from repro_torch.configs.registry import ArchSpec, _gnn_cells, register
from repro_torch.models.gnn.meshgraphnet import MGNConfig

FULL = MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2)
SMOKE = MGNConfig(n_layers=3, d_hidden=16, mlp_layers=2, d_node_in=8,
                  d_edge_in=4, d_out=4)

register(ArchSpec(arch_id="meshgraphnet", family="gnn", config=FULL,
                  smoke=SMOKE, cells=_gnn_cells()))
