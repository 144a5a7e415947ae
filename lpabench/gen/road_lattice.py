"""Road-network stand-in: a 2-D lattice of intersections whose streets are
chains of degree-2 vertices, made on the device to the published vertex
and slot counts.

An R x C lattice has R * C intersections and R(C-1) + (R-1)C streets.
Subdividing a street by c vertices adds c vertices and c edges, so
``edges - vertices = streets - intersections`` whatever the chains are:
the generator keeps ``S = n_slots / 2 - (n_nodes - R * C)`` streets (it
drops the rest, chosen by the seed, as dead ends and missing links), and
spreads the ``n_nodes - R * C`` chain vertices over the kept streets
uniformly at random. Both counts then land exactly, every intersection
has degree at most 4 and every chain vertex degree 2.

Vertex ids follow the lattice in row order: lattice row r lists its
intersections with the chain of the street to the east after each, then
the chains of its streets to the south, so ids near each other are near
each other on the map, as in an OSM export.
"""
from __future__ import annotations

import torch

from lpabench.gen.csr import csr_from_edges, generator_for


def street_counts(p: dict) -> tuple[int, int, int, int]:
    """(intersections, streets of the full lattice, streets kept, chain
    vertices) of the configuration; raises if the counts cannot land."""
    n, slots = int(p["n_nodes"]), int(p["n_slots"])
    r, c = int(p["lattice_rows"]), int(p["lattice_cols"])
    if slots % 2:
        raise ValueError("a symmetric graph has an even slot count")
    inter = r * c
    full = r * (c - 1) + (r - 1) * c
    chain = n - inter
    kept = slots // 2 - chain
    if chain < 0 or not 0 < kept <= full:
        raise ValueError(f"a {r} x {c} lattice cannot carry {n} vertices "
                         f"and {slots} slots")
    return inter, full, kept, chain


def make(p: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(offsets, indices, weights) of the configuration ``p`` for
    ``seed``, on ``device``."""
    rows, cols = int(p["lattice_rows"]), int(p["lattice_cols"])
    _, full, kept, chain = street_counts(p)
    g = generator_for(seed, device)
    n_h = rows * (cols - 1)  # horizontal streets first, then vertical
    kept_ids = torch.sort(torch.randperm(full, generator=g,
                                         device=device)[:kept]).values
    length = torch.zeros(full, dtype=torch.int64, device=device)
    length[kept_ids] = torch.bincount(
        torch.randint(0, kept, (chain,), generator=g, device=device),
        minlength=kept)
    # block sizes in id order: per lattice row, intersection and east
    # chain interleaved (2C - 1 blocks), then the C south chains
    sizes = torch.zeros((rows, 3 * cols - 1), dtype=torch.int64,
                        device=device)
    sizes[:, 0:2 * cols - 1:2] = 1
    sizes[:, 1:2 * cols - 1:2] = length[:n_h].reshape(rows, cols - 1)
    sizes[:rows - 1, 2 * cols - 1:] = length[n_h:].reshape(rows - 1, cols)
    start = (torch.cumsum(sizes.reshape(-1), 0)
             - sizes.reshape(-1)).reshape(sizes.shape)
    node = start[:, 0:2 * cols - 1:2]  # [R, C] intersection ids
    a = torch.cat([node[:, :-1].reshape(-1), node[:-1, :].reshape(-1)])
    b = torch.cat([node[:, 1:].reshape(-1), node[1:, :].reshape(-1)])
    first = torch.cat([start[:, 1:2 * cols - 1:2].reshape(-1),
                       start[:rows - 1, 2 * cols - 1:].reshape(-1)])
    a, b, first, length = (a[kept_ids], b[kept_ids], first[kept_ids],
                           length[kept_ids])
    # street s is the path a, first, ..., first + length - 1, b
    n_edges = length + 1
    street = torch.repeat_interleave(torch.arange(kept, device=device),
                                     n_edges)
    j = torch.arange(street.numel(), device=device) - torch.repeat_interleave(
        torch.cumsum(n_edges, 0) - n_edges, n_edges)
    base = first[street] + j
    src = torch.where(j == 0, a[street], base - 1)
    dst = torch.where(j == length[street], b[street], base)
    return csr_from_edges(src, dst, int(p["n_nodes"]), seed)
