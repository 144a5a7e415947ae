"""pna [arXiv:2004.05718]: 4L d_hidden=75, aggregators mean-max-min-std,
scalers identity-amplification-attenuation."""
from repro_torch.configs.registry import ArchSpec, _gnn_cells, register
from repro_torch.models.gnn.pna import PNAConfig

FULL = PNAConfig(n_layers=4, d_hidden=75)
SMOKE = PNAConfig(n_layers=2, d_hidden=16, d_in=8, d_out=4)

register(ArchSpec(arch_id="pna", family="gnn", config=FULL, smoke=SMOKE,
                  cells=_gnn_cells()))
