"""``LiveBytes``: the bytes of the tensors that torch ops made and that
are still referenced, and their peak, on any device (the CPU has no
allocator statistics). A ``TorchDispatchMode``: every op's new output
storage is counted, rounded up to the CUDA caching allocator's 512 B
blocks, until the last tensor viewing it is gone. Storages that an op
only views or writes in place (its inputs', or those made before the
mode) are not counted. Used to hold ``launch.dryrun``'s step byte model
to the step the port runs."""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

GRAIN = 512


class LiveBytes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.refs: dict = {}
        self.size: dict = {}
        self.live = self.peak = 0

    def _drop(self, key):
        self.refs[key] -= 1
        if self.refs[key] == 0:
            del self.refs[key]
            self.live -= self.size.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {a.untyped_storage().data_ptr()
                  for a in tree_flatten((args, kwargs))[0]
                  if isinstance(a, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage().data_ptr()
            if key not in self.refs:
                if key in inputs:
                    continue
                self.refs[key] = 0
                self.size[key] = (-(-t.untyped_storage().nbytes() // GRAIN)
                                  * GRAIN)
                self.live += self.size[key]
                self.peak = max(self.peak, self.live)
            self.refs[key] += 1
            weakref.finalize(t, self._drop, key)
        return out


def kernel_outputs(fold):
    """``fold`` as a kernel launch holds memory: its result computed
    outside the mode, then copied into fresh tensors made under it (a
    launch allocates its outputs and nothing else)."""
    def run(*args, **kwargs):
        with _disable_current_modes():
            result = fold(*args, **kwargs)
        return tuple(torch.empty_like(r).copy_(r) for r in result)

    return run
