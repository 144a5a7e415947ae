"""What every generator shares: symmetric CSR arrays from an edge list,
and symmetric edge weights drawn from the seed, on the device.

A graph here is the triple the program's ``CSRGraph`` holds: int32
offsets [N+1], int32 neighbour ids [M] and float32 weights [M], every
undirected edge stored in both directions, no self-loops, no duplicate
slot. A weight is a hash of the edge's two end points and the seed, so
w_ij == w_ji without a second pass.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
#: slots hashed per block (bounds the int64 temporaries of the weights)
_BLOCK = 1 << 26


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32): 16-bit halves
    keep every partial product below 2**48, so nothing overflows."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seed_words(seed: int) -> tuple[int, int]:
    """Two 32-bit words of a seed of any size (the low and the high half,
    the high one folded so that seeds past 2**64 still differ)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return seed & _M32, (seed >> 32) % 0xFFFFFFFB


def edge_weights(src: torch.Tensor, dst: torch.Tensor,
                 seed: int) -> torch.Tensor:
    """float32 weights in (0, 1], each a multiple of 2**-24 (exact in
    float32), from a hash of (min(i, j), max(i, j), seed): symmetric."""
    s0, s1 = seed_words(seed)
    out = torch.empty(src.shape, dtype=torch.float32, device=src.device)
    for lo in range(0, src.numel(), _BLOCK):
        a = src[lo:lo + _BLOCK].to(torch.int64)
        b = dst[lo:lo + _BLOCK].to(torch.int64)
        u, v = torch.minimum(a, b), torch.maximum(a, b)
        h = fmix32(u ^ fmix32(v ^ s0) ^ s1)
        out[lo:lo + _BLOCK] = ((h >> 8) + 1).to(torch.float32) * 2.0 ** -24
    return out


def csr_from_edges(src: torch.Tensor, dst: torch.Tensor, n: int,
                   seed: int) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Symmetrise, drop self-loops and duplicates, sort by (source,
    neighbour): (offsets int32 [n+1], indices int32 [M], weights float32
    [M]) on the edges' device. ``src``/``dst`` are int64 and are
    consumed."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = torch.cat([src * n + dst, dst * n + src])
    del src, dst, keep
    keys = torch.unique(keys, sorted=True)
    src = torch.div(keys, n, rounding_mode="floor")
    dst = keys - src * n
    del keys
    counts = torch.bincount(src, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=counts.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    if int(offsets[-1]) >= 2**31:
        raise ValueError("more than 2**31 slots do not fit int32 offsets")
    weights = edge_weights(src, dst, seed)
    return (offsets.to(torch.int32), dst.to(torch.int32), weights)


def generator_for(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the whole seed."""
    g = torch.Generator(device=device)
    s0, s1 = seed_words(seed)
    g.manual_seed((s1 << 32) | s0)
    return g
