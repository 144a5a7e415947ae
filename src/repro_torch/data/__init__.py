"""Synthetic data pipelines (the GNN batches)."""
from repro_torch.data.synthetic import (gnn_full_batch, gnn_sampled_batch,
                                        molecule_batch)

__all__ = ["gnn_full_batch", "gnn_sampled_batch", "molecule_batch"]
