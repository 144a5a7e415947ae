"""Test helpers around ``repro_torch.launch.live_bytes.LiveBytes`` (the
bytes torch ops hold, on any device): ``kernel_outputs`` makes a plain
fold hold memory as a kernel launch does. Used to hold
``launch.dryrun``'s step byte model to the step the port runs."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.launch.live_bytes import LiveBytes  # noqa: F401 (re-exported)

__all__ = ["LiveBytes", "kernel_outputs"]


def kernel_outputs(fold):
    """``fold`` as a kernel launch holds memory: its result computed
    outside the mode, then copied into fresh tensors made under it (a
    launch allocates its outputs and nothing else)."""
    def run(*args, **kwargs):
        with _disable_current_modes():
            result = fold(*args, **kwargs)
        return tuple(torch.empty_like(r).copy_(r) for r in result)

    return run
