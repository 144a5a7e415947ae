"""Synthetic graph generators matching the paper's Table-1 dataset families.

A numpy copy of ``repro.graphs.generators``: the same seed draws the same
random numbers in the same order, so each generator gives the reference's
arrays exactly; only the final ``build_csr`` puts them on ``device``.

  web/social  -> R-MAT power-law (a=0.57,b=0.19,c=0.19) / denser R-MAT
  road        -> 2-D grid (avg degree ~= 2.1-4, huge diameter)
  k-mer       -> branching chains (avg degree ~= 2.1)
  planted     -> SBM planted partition (ground truth for NMI validation)
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import CSRGraph, build_csr


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, device=None) -> CSRGraph:
    """R-MAT power-law generator (Graph500 parameters by default)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        right = r >= ab                     # lands in lower half (c or d quadrant)
        go_d = right & (r >= abc)
        go_b = (~right) & (r >= a)
        src |= (right.astype(np.int64) << bit)
        dst |= ((go_b | go_d).astype(np.int64) << bit)
    edges = np.stack([src, dst], axis=1)
    return build_csr(edges, n, device=device)


def grid2d(rows: int, cols: int, device=None) -> CSRGraph:
    """Road-network stand-in: 4-connected 2-D grid."""
    idx = np.arange(rows * cols, dtype=np.int64).reshape(rows, cols)
    e_h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    e_v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return build_csr(np.concatenate([e_h, e_v]), rows * cols, device=device)


def chain_kmer(n: int, branch_prob: float = 0.05, seed: int = 0,
               device=None) -> CSRGraph:
    """Protein k-mer stand-in: long chains with occasional branches (deg ~2.1)."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(n - 1, dtype=np.int64),
                      np.arange(1, n, dtype=np.int64)], axis=1)
    n_branch = int(n * branch_prob)
    b_src = rng.integers(0, n, n_branch)
    b_dst = np.minimum(b_src + rng.integers(2, 50, n_branch), n - 1)
    edges = np.concatenate([chain, np.stack([b_src, b_dst], axis=1)])
    return build_csr(edges, n, device=device)


def sbm(n_comm: int, comm_size: int, p_in: float, p_out: float,
        seed: int = 0, device=None) -> tuple[CSRGraph, np.ndarray]:
    """Stochastic block model with planted disjoint communities.

    Returns (graph, ground_truth_labels). Sampled sparsely by drawing a
    binomial edge count per block pair, then uniform endpoints.
    """
    rng = np.random.default_rng(seed)
    n = n_comm * comm_size
    truth = np.repeat(np.arange(n_comm), comm_size)
    chunks = []
    for ci in range(n_comm):
        base_i = ci * comm_size
        # intra-community edges
        possible = comm_size * (comm_size - 1) // 2
        cnt = rng.binomial(possible, p_in)
        s = rng.integers(0, comm_size, cnt) + base_i
        d = rng.integers(0, comm_size, cnt) + base_i
        chunks.append(np.stack([s, d], axis=1))
        # inter-community edges to later communities
        for cj in range(ci + 1, n_comm):
            cnt = rng.binomial(comm_size * comm_size, p_out)
            if cnt == 0:
                continue
            s = rng.integers(0, comm_size, cnt) + base_i
            d = rng.integers(0, comm_size, cnt) + cj * comm_size
            chunks.append(np.stack([s, d], axis=1))
    edges = np.concatenate(chunks) if chunks else np.zeros((0, 2), dtype=np.int64)
    return build_csr(edges, n, device=device), truth


def powerlaw_communities(n: int, avg_comm: int = 50, p_in: float = 0.3,
                         mix: float = 0.05, hub_frac: float = 0.002,
                         seed: int = 0, device=None
                         ) -> tuple[CSRGraph, np.ndarray]:
    """Planted communities with Zipf-ish sizes + power-law hub overlay.

    Structural stand-in for web crawl / social graphs: strong clustered
    locality plus a heavy-tailed degree distribution from hub vertices.
    ``mix`` controls the fraction of inter-community edges.
    """
    rng = np.random.default_rng(seed)
    # community sizes ~ shifted Zipf, truncated
    sizes = []
    total = 0  # running sum(sizes): the reference re-sums the list per draw
    while total < n:
        s = int(min(rng.zipf(1.6) * (avg_comm // 4) + 3, 8 * avg_comm))
        sizes.append(min(s, n - total))
        total += sizes[-1]
    sizes = np.asarray(sizes)
    truth = np.repeat(np.arange(len(sizes)), sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    chunks = []
    for sz, st in zip(sizes, starts):
        if sz < 2:
            continue
        # intra edges: sz*p_in*(sz-1)/2 expected, sampled with replacement
        cnt = max(int(p_in * sz * min(sz - 1, 40) / 2), sz - 1)
        s = rng.integers(0, sz, cnt) + st
        d = rng.integers(0, sz, cnt) + st
        chunks.append(np.stack([s, d], axis=1))
        # ensure connectivity: a path through the community
        path = np.stack([np.arange(st, st + sz - 1),
                         np.arange(st + 1, st + sz)], axis=1)
        chunks.append(path)
    intra = np.concatenate(chunks)
    n_inter = int(len(intra) * mix)
    inter = rng.integers(0, n, (n_inter, 2))
    # hub overlay: a few vertices connect to many random others
    n_hubs = max(int(n * hub_frac), 1)
    hubs = rng.integers(0, n, n_hubs)
    hub_deg = rng.zipf(1.8, n_hubs).clip(1, n // 4) * 16
    h_src = np.repeat(hubs, hub_deg)
    h_dst = rng.integers(0, n, len(h_src))
    edges = np.concatenate([intra, inter, np.stack([h_src, h_dst], axis=1)])
    return build_csr(edges, n, device=device), truth


def ring_of_cliques(n_cliques: int, clique_size: int,
                    device=None) -> tuple[CSRGraph, np.ndarray]:
    """Deterministic planted structure: cliques joined in a ring (classic
    modularity test case with unambiguous communities)."""
    n = n_cliques * clique_size
    truth = np.repeat(np.arange(n_cliques), clique_size)
    edges = []
    for c in range(n_cliques):
        base = c * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((base + i, base + j))
        nxt = ((c + 1) % n_cliques) * clique_size
        edges.append((base, nxt))  # one bridge to the next clique
    return build_csr(np.asarray(edges, dtype=np.int64), n, device=device), truth


# Family-matched small-scale stand-ins for the paper's Table 1 (benchmark set).
def paper_suite(scale: str = "small", device=None) -> dict[str, CSRGraph]:
    """Benchmark suite keyed like the paper's dataset families."""
    if scale == "tiny":
        return {
            "web": powerlaw_communities(4096, p_in=0.5, mix=0.02, seed=1,
                                        device=device)[0],
            "social": powerlaw_communities(3072, p_in=0.25, mix=0.15, seed=2,
                                           device=device)[0],
            "road": grid2d(64, 64, device=device),
            "kmer": chain_kmer(4096, seed=3, device=device),
        }
    return {
        "web": powerlaw_communities(65536, p_in=0.5, mix=0.02, seed=1,
                                    device=device)[0],   # uk-2002 analogue
        "social": powerlaw_communities(32768, p_in=0.25, mix=0.15, seed=2,
                                       device=device)[0],  # livejournal-ish
        "road": grid2d(256, 256, device=device),              # asia_osm analogue
        "kmer": chain_kmer(65536, seed=3, device=device),     # kmer_A2a analogue
    }
