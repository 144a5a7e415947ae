"""Community quality metrics: modularity (paper Eq. 1) and NMI.

A copy of ``repro.core.modularity``. The segment sums are ``index_add_``
in float32, whose order of addition differs from the reference's (and,
on CUDA, from run to run), so modularity agrees with the reference within
a tolerance, not bit for bit. NMI is numpy on the host, as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.csr import CSRGraph


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, segments.long(), values)


def modularity(graph: CSRGraph, labels: torch.Tensor,
               edge_src: torch.Tensor | None = None) -> torch.Tensor:
    """Q = sum_c [ sigma_c / 2m - (Sigma_c / 2m)^2 ]  (paper Eq. 1).

    sigma_c counts both directions of every intra-community edge, matching
    2*sigma_c of the undirected formulation — the CSR stores both
    directions. Returns a 0-d float32 tensor on the graph's device.
    """
    n = graph.n_nodes
    if edge_src is None:
        edge_src = graph.sources()
    two_m = torch.sum(graph.weights)  # = 2m (both directions stored)
    src_labels = labels[edge_src]
    same = src_labels == labels[graph.indices]
    # per-community internal weight (counted with both directions = 2*sigma_c)
    intra2 = _segment_sum(torch.where(same, graph.weights, 0.0), src_labels, n)
    k_i = _segment_sum(graph.weights, edge_src, n)  # weighted degree
    sigma_tot = _segment_sum(k_i, labels, n)        # Sigma_c
    return torch.sum(intra2 / two_m) - torch.sum((sigma_tot / two_m) ** 2)


def nmi(labels_a, labels_b) -> float:
    """Normalized mutual information between two disjoint partitions.

    The reference fills a dense [|A|, |B|] contingency table; with ~10^5
    communities on each side (the 2^22-vertex smoke graph) that table
    would need ~80 GB, so this keeps only its non-zero cells. The sums
    run over the same terms in another order (float64, within ~1e-12).
    """
    if isinstance(labels_a, torch.Tensor):
        labels_a = labels_a.cpu().numpy()
    if isinstance(labels_b, torch.Tensor):
        labels_b = labels_b.cpu().numpy()
    a = np.asarray(labels_a)
    b = np.asarray(labels_b)
    n = len(a)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    nb = int(bi.max()) + 1
    cells, counts = np.unique(ai.astype(np.int64) * nb + bi,
                              return_counts=True)
    pa = np.bincount(ai) / n  # every class is non-empty: no 0·log 0 terms
    pb = np.bincount(bi) / n
    pab = counts / n
    mi = np.sum(pab * np.log(pab / (pa[cells // nb] * pb[cells % nb])))
    ha = -np.sum(pa * np.log(pa))
    hb = -np.sum(pb * np.log(pb))
    denom = np.sqrt(ha * hb)
    return float(mi / denom) if denom > 0 else 1.0
