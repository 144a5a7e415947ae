"""GNN model zoo: PNA, MeshGraphNet, EGNN, EquiformerV2 (eSCN).

A torch copy of ``repro.models.gnn``. Each model is an ``nn.Module`` whose
state-dict keys are the reference's parameter paths, built on a device by
``init_*`` and run by the module's ``forward`` (``*_forward``, the
reference's names, are aliases of it). All
message passing is edge-index scatter/segment-sum based (``index_add``,
``scatter_reduce``). Graph batches are dicts with static padded shapes:
  node_feat [N, F], edge_src [E], edge_dst [E] (pad edges point at node N,
  a dump slot), plus model-specific extras (coords, edge_feat).
"""
from repro_torch.models.gnn.pna import PNA, init_pna, pna_forward, PNAConfig
from repro_torch.models.gnn.meshgraphnet import (MGN, init_mgn, mgn_forward,
                                                 MGNConfig)
from repro_torch.models.gnn.egnn import EGNN, init_egnn, egnn_forward, EGNNConfig
from repro_torch.models.gnn.equiformer_v2 import (Equiformer, init_equiformer,
                                                  equiformer_forward,
                                                  EquiformerConfig)

__all__ = ["PNA", "init_pna", "pna_forward", "PNAConfig", "MGN", "init_mgn",
           "mgn_forward", "MGNConfig", "EGNN", "init_egnn", "egnn_forward",
           "EGNNConfig", "Equiformer", "init_equiformer",
           "equiformer_forward", "EquiformerConfig"]
