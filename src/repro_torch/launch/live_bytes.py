"""``LiveBytes``: the bytes of the tensors that torch ops made and that
are still referenced, and their peak, on any device (the CPU and meta
have no allocator statistics). A ``TorchDispatchMode``: every op's new
output storage is counted, rounded up to the CUDA caching allocator's
512 B blocks, until the last tensor viewing it is gone. Storages that an
op only views or writes in place (its inputs', or those made before the
mode) are not counted. A storage is known by its ``StorageImpl``
(every view of it shares one; meta storages have no address).

``launch.dryrun`` reads its peak over one call of an LM cell's step on
meta tensors as the step's temporaries (the counterpart of XLA's temp
size); the tests hold the LPA step's byte model to it."""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.cost import tensors_of

__all__ = ["GRAIN", "LiveBytes"]

#: the CUDA caching allocator rounds every block up to a multiple of this
GRAIN = 512


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class LiveBytes(TorchDispatchMode):
    """``live``: the bytes held now; ``peak``: the most held at once."""

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
        inputs = {_key(a) for a in tensors_of((args, kwargs))}
        for t in tensors_of(out):
            key = _key(t)
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
