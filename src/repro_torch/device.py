"""The port's one device rule.

Every entry point that creates tensors (``build_csr``, the generators,
the plan builders, ``lpa``) takes ``device=None``, which means CUDA. With
no CUDA device that raises: a caller that wants the CPU says so with
``device="cpu"`` (as the tests do). No code path moves work to the CPU on
its own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_same_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def check_same_device(expected: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on ``expected``'s device type
    (and index, where ``expected`` names one)."""
    for name, t in tensors.items():
        d = t.device
        if d.type != expected.type or (expected.index is not None
                                       and d.index != expected.index):
            raise ValueError(f"{name} is on {d}, expected {expected}")
