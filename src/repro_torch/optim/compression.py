"""Int8 error-feedback gradient compression for data-parallel all-reduce.

A torch copy of ``repro.optim.compression``. Each replica adds its
carried error to its local gradient, quantizes it to int8 with a
per-tensor scale (the largest over the replicas, so all dequantize
alike), sums the payload across replicas as int32 (no overflow) and
dequantizes the mean; the quantization residual is carried to the next
step (error feedback). ``torch.round`` rounds half to even, as
``jnp.round`` does.

``compressed_psum`` runs over a ``ShardComm``
(``repro_torch.core.distributed``): one all-reduce (max) of every leaf's
scale and one (sum) of every leaf's int32 payload, concatenated. Maxima
and integer sums are exact, so batching the leaves changes no bit.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["compress_int8", "decompress_int8", "compressed_psum"]


def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Returns (q int8, scale f32, new_err)."""
    g = g.to(torch.float32) + err
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_err = g - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compressed_psum(grads, errors, comm):
    """Error-feedback int8 all-reduce of a gradient tree over ``comm``'s
    ranks. Returns (mean_grads, new_errors)."""
    n = comm.world_size
    flat_g = tree_leaves(grads)
    g32 = [g.to(torch.float32) + e
           for g, e in zip(flat_g, tree_leaves(errors))]
    local = torch.stack([torch.max(torch.abs(g)) / 127.0 + 1e-12
                         for g in g32])
    scales = comm.all_reduce(local, "max")
    qs = [torch.clamp(torch.round(g / s), -127, 127).to(torch.int32)
          for g, s in zip(g32, scales)]
    new_e = [g - q.to(torch.float32) * s for g, q, s in zip(g32, qs, scales)]
    total = comm.all_reduce(torch.cat([q.reshape(-1) for q in qs]), "sum")
    out, at = [], 0
    for g, q, s in zip(flat_g, qs, scales):
        t = total[at:at + q.numel()].reshape(q.shape)
        at += q.numel()
        out.append((t.to(torch.float32) * s / n).to(g.dtype))
    return tree_unflatten(grads, out), tree_unflatten(errors, new_e)
