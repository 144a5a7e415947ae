"""Checkpoints in the JAX package's layout on disk."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
