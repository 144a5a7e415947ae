"""Shared model building blocks: initializers, norms, RoPE, FFN, loss.

A torch copy of ``repro.models.common``. ``dense_init`` draws from an
explicit ``torch.Generator`` on the generator's device and then moves the
weight to its own: from a CPU generator, one seed gives the same weights
on the CPU and on the card; a CUDA generator draws large tables on the
card (other bits). The law is the reference's (a standard normal
truncated to [-2, 2], times the fan-in scale); the bits are not, as
JAX's PRNG is another generator.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Params", "dense_init", "rms_norm", "rope_angles", "apply_rope",
           "swiglu", "cross_entropy", "hint"]


class Params(nn.Module):
    """Named parameters and sub-trees built from a nested dict, read as
    the reference reads its parameter dicts (``p["wq"]``, ``"k" in p``):
    ``tree["layers"]["moe"]["router"]`` becomes the state-dict key
    ``layers.moe.router``, the reference's parameter path."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            elif isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def items(self):
        """(name, parameter or sub-module) pairs, this level only."""
        return [*self._parameters.items(), *self._modules.items()]


def dense_init(generator: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (params stay f32; compute may cast).
    On ``device="meta"`` nothing is drawn: the tensor has a shape only."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / max(fan_in, 1) ** 0.5
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale).to(device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with f32 reduction (bf16-safe)."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * gamma.to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for rotary embeddings; positions [...]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs  # [..., dim/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate pairs (x0, x1) -> (x0 c - x1 s, x1 c + x0 s).

    x: [..., S, H, D]; cos/sin: [..., S, D/2] (broadcast over heads).
    """
    x0 = x[..., 0::2]
    x1 = x[..., 1::2]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    r0 = x0 * cos - x1 * sin
    r1 = x1 * cos + x0 * sin
    out = torch.stack([r0, r1], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN (LLaMA/Qwen family)."""
    g = torch.einsum("...d,df->...f", x, w_gate.to(x.dtype))
    u = torch.einsum("...d,df->...f", x, w_up.to(x.dtype))
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down.to(x.dtype))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy with f32 logsumexp.

    The gold logit is a masked sum over the vocab axis (not a gather), as
    in the reference: under a vocab-sharded head it partitions into a
    local masked reduce and a scalar all-reduce.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab == labels[..., None]
    gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    return torch.mean(lse - gold)


def hint(x, *spec):
    """The reference's sharding hint: entries are ``None``, an axis name
    or a tuple of names. One card has no mesh to place ``x`` on, so every
    spec is the identity, as the reference's all-empty spec is."""
    return x
