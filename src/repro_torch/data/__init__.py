"""Synthetic data pipelines (the GNN and DCN-v2 batches)."""
from repro_torch.data.synthetic import (dcn_batch, gnn_full_batch,
                                        gnn_sampled_batch, gnn_tree_batch,
                                        molecule_batch)

__all__ = ["dcn_batch", "gnn_full_batch", "gnn_sampled_batch",
           "gnn_tree_batch", "molecule_batch"]
