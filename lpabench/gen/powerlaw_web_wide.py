"""Web-graph stand-in past 2**31 slots: ``powerlaw_web``'s family with the
cap on a vertex's edges inside its community as a parameter, and int64
offsets.

The draws are ``powerlaw_web``'s, call for call (the same community sizes
and hub degrees from ``size_seed``, the same generator calls in the same
order and shapes), with one change: a community of size s gets
``max(int(p_in * s * min(s - 1, intra_deg_cap) / 2), s - 1)`` edges, so
``intra_deg_cap`` 40 makes ``powerlaw_web``'s graph, slot for slot.

What differs is how the arrays are held, so that a graph of more than
2**31 slots is made on one card:

  * end points are kept as int32 vertex ids (a vertex count below 2**31),
    and each community's draws are mapped to vertex ids in blocks;
  * the CSR is built in blocks of source vertices: each block's slots in
    both directions are sorted and made unique on their own (a block's
    keys stay far below the 2**31 elements a CUDA sort takes), then the
    blocks are joined in order, which is the order ``csr_from_edges``
    sorts all of them into;
  * offsets are int64 whatever the slot count: the port takes the wide
    path for such a graph.
"""
from __future__ import annotations

import numpy as np
import torch

from lpabench.gen.csr import edge_weights, generator_for
from lpabench.gen.powerlaw_web import size_multisets

#: directed slots (both directions of each drawn edge) sorted per CSR block
BLOCK_SLOTS = 1 << 28
#: draws mapped from community to vertex id per step
_MAP_BLOCK = 1 << 26


def intra_counts(sizes: torch.Tensor, p: dict) -> torch.Tensor:
    """Edges drawn inside each community of ``sizes`` (int64), as
    ``powerlaw_web`` computes them (float64, truncated) with the cap on
    ``min(s - 1, cap)`` taken from ``p["intra_deg_cap"]``."""
    cnt = torch.clamp_max(sizes - 1, int(p["intra_deg_cap"]))
    cnt = (float(p["p_in"]) * sizes.to(torch.float64)
           * cnt.to(torch.float64) / 2).floor()
    cnt = torch.maximum(cnt.to(torch.int64), sizes - 1)
    return torch.where(sizes >= 2, cnt, 0)


def expected_slots(p: dict) -> float:
    """The expected slot count of the configuration ``p``, from its size
    multisets alone (host numpy; nothing is drawn): each community's
    distinct pairs among its uniform draws and its path, the inter-community
    edges less their self-loops, each hub's distinct end points, both
    directions. Duplicates across these groups are left out (their share is
    below 1e-4 at the benchmark's sizes)."""
    n = int(p["n_nodes"])
    sizes, hub_deg = size_multisets(p)
    s = sizes.astype(np.float64)
    cnt = intra_counts(torch.as_tensor(sizes), p).numpy().astype(np.float64)
    pairs = s * (s - 1) / 2
    # a draw hits a given pair of distinct vertices with probability 2/s^2
    missed = np.exp(cnt * np.log1p(-2 / np.maximum(s, 2) ** 2))
    inside = np.where(s >= 2, (s - 1) + (pairs - (s - 1)) * (1 - missed), 0)
    n_inter = int((cnt.sum() + n - len(sizes)) * float(p["mix"]))
    hubs = n * -np.expm1(hub_deg.astype(np.float64) * np.log1p(-1 / n))
    return 2 * (inside.sum() + n_inter * (1 - 1 / n) + hubs.sum())


def _inside(comm: torch.Tensor, sizes: torch.Tensor, starts: torch.Tensor,
            g: torch.Generator) -> torch.Tensor:
    """One uniform end point inside each draw's community: [E] int32, from
    one [E] float64 draw (``powerlaw_web``'s call), mapped in blocks."""
    u = torch.rand(comm.shape, generator=g, device=comm.device,
                   dtype=torch.float64)
    out = torch.empty(comm.shape, dtype=torch.int32, device=comm.device)
    for lo in range(0, comm.numel(), _MAP_BLOCK):
        c = comm[lo:lo + _MAP_BLOCK]
        sz, st = sizes[c], starts[c]
        pick = torch.minimum((u[lo:lo + _MAP_BLOCK] * sz).to(torch.int64),
                             sz - 1)
        out[lo:lo + _MAP_BLOCK] = (st + pick).to(torch.int32)
    return out


def edges(p: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The drawn edges (src, dst), int32, duplicates and self-loops
    included, in ``powerlaw_web``'s order."""
    n = int(p["n_nodes"])
    g = generator_for(seed, device)
    sizes_np, hub_deg_np = size_multisets(p)
    c = len(sizes_np)
    sizes = torch.as_tensor(sizes_np, device=device)[
        torch.randperm(c, generator=g, device=device)]
    starts = torch.cumsum(sizes, 0) - sizes
    comm = torch.repeat_interleave(
        torch.arange(c, dtype=torch.int32, device=device),
        intra_counts(sizes, p))
    intra_s = _inside(comm, sizes, starts, g)
    intra_d = _inside(comm, sizes, starts, g)
    n_intra = comm.numel()
    del comm
    # a path through every community: (v, v + 1) unless v ends one
    last = torch.zeros(n, dtype=torch.bool, device=device)
    last[starts + sizes - 1] = True
    path_s = torch.nonzero(~last).squeeze(1)
    del last
    n_intra += path_s.numel()
    n_inter = int(n_intra * float(p["mix"]))
    inter = torch.randint(0, n, (2, n_inter), generator=g, device=device)
    hub_deg = torch.as_tensor(hub_deg_np, device=device)
    hubs = torch.randint(0, n, (hub_deg.numel(),), generator=g,
                         device=device)
    h_src = torch.repeat_interleave(hubs, hub_deg)
    h_dst = torch.randint(0, n, (h_src.numel(),), generator=g,
                          device=device)
    src = torch.cat([intra_s, path_s.to(torch.int32),
                     inter[0].to(torch.int32), h_src.to(torch.int32)])
    del intra_s
    dst = torch.cat([intra_d, (path_s + 1).to(torch.int32),
                     inter[1].to(torch.int32), h_dst.to(torch.int32)])
    return src, dst


def csr_blocks(src: torch.Tensor, dst: torch.Tensor, n: int, seed: int
               ) -> tuple[list, list, list]:
    """``csr_from_edges`` of int32 edges, a block of source vertices at a
    time: per block, in order, its vertices' slot counts, neighbour ids
    (int32) and weights. ``src``/``dst`` are read, not consumed."""
    blocks = max(1, -(-2 * src.numel() // BLOCK_SLOTS))
    bounds = [n * b // blocks for b in range(blocks + 1)]
    keep = src != dst
    counts, nbrs, wgts = [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        fwd = keep & (src >= lo) & (src < hi)
        bwd = keep & (dst >= lo) & (dst < hi)
        keys = torch.cat([(src[fwd].to(torch.int64) - lo) * n + dst[fwd],
                          (dst[bwd].to(torch.int64) - lo) * n + src[bwd]])
        del fwd, bwd
        keys = torch.unique(keys, sorted=True)
        s = torch.div(keys, n, rounding_mode="floor")
        d = keys - s * n
        del keys
        counts.append(torch.bincount(s, minlength=hi - lo))
        wgts.append(edge_weights(s + lo, d, seed))
        nbrs.append(d.to(torch.int32))
        del s, d
    return counts, nbrs, wgts


def make(p: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(offsets int64 [N+1], indices int32 [M], weights float32 [M]) of
    the configuration ``p`` for ``seed``, on ``device``: ``powerlaw_web``'s
    arrays at ``intra_deg_cap`` 40, with int64 offsets."""
    n = int(p["n_nodes"])
    src, dst = edges(p, seed, device)
    counts, nbrs, wgts = csr_blocks(src, dst, n, seed)
    del src, dst
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.cat(counts), 0, out=offsets[1:])
    indices = torch.cat(nbrs)
    del nbrs
    return offsets, indices, torch.cat(wgts)
