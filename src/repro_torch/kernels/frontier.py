"""Frontier marks: the neighbours of the vertices that changed label.

Kernel (``src/repro_torch/csrc/frontier_marks.cu``, built by
``repro_torch.kernels.build``): ``frontier_marks`` stores ``True`` at
``marked[indices[e]]`` for every slot e of every changed vertex's CSR row,
into a freshly zeroed [N] bool. It replaces no Pallas kernel: the
reference's ``mark_frontier`` is a plain ``jax.ops.segment_max``. The
stores all write the same value, so no atomics are needed and the bits
are the reference's in any order.

One rule, taken from the tensors: on the CPU :func:`frontier_marks` calls
:func:`frontier_marks_plain`; on CUDA it launches the kernel on the
current stream, or raises. Nothing falls back. ``LAUNCH_COUNTS
["frontier_marks"]`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.launches import LAUNCH_COUNTS

__all__ = ["frontier_marks", "frontier_marks_plain"]

_INT32_MAX = 2**31 - 1


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load_library
    lib = load_library("frontier_marks").lib
    if not getattr(lib, "_repro_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.frontier_marks.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
        lib.frontier_marks.restype = i32
        lib._repro_typed = True
    return lib


def _check(changed: torch.Tensor, offsets: torch.Tensor,
           indices: torch.Tensor) -> torch.device:
    dev = changed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n = changed.shape[0]
    for name, t, dtype, shape in (("changed", changed, torch.bool, (n,)),
                                  ("offsets", offsets, torch.int32, (n + 1,)),
                                  ("indices", indices, torch.int32,
                                   indices.shape[:1])):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, changed on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(shape)} "
                             f"tensor, got {list(t.shape)}")
    if n > _INT32_MAX or indices.shape[0] > _INT32_MAX:
        raise ValueError("the kernel indexes vertices and slots with int32")
    return dev


def frontier_marks_plain(changed: torch.Tensor, offsets: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, the reference's
    ``segment_max(changed[edge_src], indices) > 0``: each slot's source
    flag, then a per-destination ``scatter_reduce`` amax of ints, which is
    exact in any order."""
    n = changed.shape[0]
    degrees = (offsets[1:] - offsets[:-1]).long()
    src_changed = torch.repeat_interleave(
        changed, degrees, output_size=indices.shape[0]).to(torch.int32)
    marked = torch.zeros(n, dtype=torch.int32, device=changed.device)
    marked.scatter_reduce_(0, indices.long(), src_changed, "amax")
    return marked > 0


def frontier_marks(changed: torch.Tensor, offsets: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
    """[N] bool: True at every neighbour of a vertex with ``changed`` set,
    over the CSR rows ``offsets`` ([N+1] int32) / ``indices`` ([M]
    int32). On CUDA one kernel launch into a zeroed [N] bool, the only
    allocation; no [M] temporary and no host read."""
    if _check(changed, offsets, indices).type == "cpu":
        return frontier_marks_plain(changed, offsets, indices)
    dev = changed.device
    marked = torch.zeros(changed.shape[0], dtype=torch.bool, device=dev)
    rc = _library().frontier_marks(
        changed.data_ptr(), offsets.data_ptr(), indices.data_ptr(),
        marked.data_ptr(), changed.shape[0], dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"frontier_marks launch failed with CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["frontier_marks"] += 1
    return marked
