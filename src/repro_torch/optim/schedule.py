"""LR schedules (a torch copy of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to floor*peak, as a float32 scalar on
    ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, peak_lr * cos)
