"""Launch-side dispatch of the ported architectures (the GNN cells)."""
