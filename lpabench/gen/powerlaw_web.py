"""Web-graph stand-in: planted communities of Zipf sizes with a power-law
hub overlay, made on the device.

The structure of the program's ``graphs.generators.powerlaw_communities``
(the repository's uk-2002 analogue), rewritten in torch so that a graph
of hundreds of millions of slots is made on the card in seconds:

  * community sizes ``min(zipf(a_comm) * (avg_comm // 4) + 3,
    8 * avg_comm)``, cut to sum to ``n``;
  * ``max(int(p_in * s * min(s - 1, 40) / 2), s - 1)`` edges inside a
    community of size s, end points uniform in it, plus a path through
    it;
  * ``int(mix * intra)`` edges between uniform end points;
  * ``int(n * hub_frac)`` hubs, each with ``zipf(a_hub) * hub_unit``
    edges to uniform end points, the degree clipped at ``n // 4`` units
    and at ``hub_deg_max`` (the program's generator has no such cap: one
    hub there may reach half of the graph).

The community sizes and the hub degrees are one fixed multiset, drawn
once on the host from ``size_seed`` (a parameter of the configuration),
so every ``--seed`` makes a graph of the same sizes: the seed orders the
communities, places the hubs and draws every end point and weight.
"""
from __future__ import annotations

import numpy as np
import torch

from lpabench.gen.csr import csr_from_edges, generator_for


def size_multisets(p: dict) -> tuple[np.ndarray, np.ndarray]:
    """(community sizes, hub degrees) of the configuration: host numpy
    from ``size_seed`` alone (a few hundred thousand draws)."""
    n = int(p["n_nodes"])
    avg = int(p["avg_comm"])
    rng = np.random.default_rng(int(p["size_seed"]))
    draws = []
    total = 0
    while total < n:
        z = rng.zipf(float(p["a_comm"]), max(n // avg, 1024))
        s = np.minimum(z * (avg // 4) + 3, 8 * avg)
        draws.append(s)
        total += int(s.sum())
    s = np.concatenate(draws)
    cut = int(np.searchsorted(np.cumsum(s), n)) + 1
    sizes = s[:cut].astype(np.int64)
    sizes[-1] -= int(sizes.sum()) - n
    n_hubs = max(int(n * float(p["hub_frac"])), 1)
    unit = int(p["hub_unit"])
    cap = min(n // 4, int(p["hub_deg_max"]) // unit)
    hub_deg = (rng.zipf(float(p["a_hub"]), n_hubs).clip(1, cap)
               * unit).astype(np.int64)
    return sizes, hub_deg


def make(p: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(offsets, indices, weights) of the configuration ``p`` for
    ``seed``, on ``device``."""
    n = int(p["n_nodes"])
    g = generator_for(seed, device)
    sizes_np, hub_deg_np = size_multisets(p)
    c = len(sizes_np)
    sizes = torch.as_tensor(sizes_np, device=device)[
        torch.randperm(c, generator=g, device=device)]
    starts = torch.cumsum(sizes, 0) - sizes
    # intra-community edge counts, as the program's generator computes
    # them (float64, truncated)
    cnt = torch.clamp_max(sizes - 1, 40).to(torch.float64)
    cnt = (float(p["p_in"]) * sizes.to(torch.float64) * cnt / 2).floor()
    cnt = torch.maximum(cnt.to(torch.int64), sizes - 1)
    cnt = torch.where(sizes >= 2, cnt, 0)
    comm = torch.repeat_interleave(torch.arange(c, device=device), cnt)
    sz, st = sizes[comm], starts[comm]
    del comm

    def inside(sz, st):
        u = torch.rand(sz.shape, generator=g, device=device,
                       dtype=torch.float64)
        return st + torch.minimum((u * sz).to(torch.int64), sz - 1)

    intra_s = inside(sz, st)
    intra_d = inside(sz, st)
    del sz, st
    # a path through every community: (v, v + 1) unless v ends one
    last = torch.zeros(n, dtype=torch.bool, device=device)
    last[starts + sizes - 1] = True
    path_s = torch.nonzero(~last).squeeze(1)
    del last
    n_intra = intra_s.numel() + path_s.numel()
    n_inter = int(n_intra * float(p["mix"]))
    inter = torch.randint(0, n, (2, n_inter), generator=g, device=device)
    hub_deg = torch.as_tensor(hub_deg_np, device=device)
    hubs = torch.randint(0, n, (hub_deg.numel(),), generator=g,
                         device=device)
    h_src = torch.repeat_interleave(hubs, hub_deg)
    h_dst = torch.randint(0, n, (h_src.numel(),), generator=g,
                          device=device)
    src = torch.cat([intra_s, path_s, inter[0], h_src])
    dst = torch.cat([intra_d, path_s + 1, inter[1], h_dst])
    del intra_s, intra_d, path_s, inter, h_src, h_dst
    return csr_from_edges(src, dst, n, seed)
