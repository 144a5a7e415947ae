"""Train steps and the fault-tolerant training loop (torch)."""
from repro_torch.train.steps import make_dp_train_step, make_train_step

__all__ = ["make_train_step", "make_dp_train_step"]
