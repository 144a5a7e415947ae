"""Synthetic data pipelines (the LM, GNN and DCN-v2 batches)."""
from repro_torch.data.synthetic import (dcn_batch, gnn_full_batch,
                                        gnn_sampled_batch, gnn_tree_batch,
                                        molecule_batch, token_batch)

__all__ = ["token_batch", "dcn_batch", "gnn_full_batch",
           "gnn_sampled_batch", "gnn_tree_batch", "molecule_batch"]
