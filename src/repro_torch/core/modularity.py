"""Community quality metrics: modularity (paper Eq. 1) and NMI.

A copy of ``repro.core.modularity``. Every per-segment sum adds its
segment's values in index order, from 0: the values are put in segment
order with a stable sort (the weighted degrees' segments, the CSR rows,
are in order already) and summed by ``core.exact._group_sums``, whose
order is fixed on every device. So two calls on the same labels give the
same bits on the card, and the segment sums are the reference's
``jax.ops.segment_sum`` left folds; the final sums over the segments are
``torch.sum``'s, whose order differs from XLA's, so modularity agrees with
the reference within a tolerance, not bit for bit. NMI is numpy on the
host, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exact import _group_sums
from repro_torch.graphs.csr import CSRGraph


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    """[n] sums of ``values`` per segment id in [0, n), each segment in
    index order (a stable sort keeps equal ids in index order)."""
    order = torch.argsort(segments, stable=True)
    return _group_sums(values[order], segments[order].long(), n)


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
    # weighted degree; edge_src is ascending (CSR rows): no sort
    k_i = _group_sums(graph.weights, edge_src.long(), n)
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


def community_sizes(labels) -> np.ndarray:
    """Sorted community sizes (descending) of a label tensor or array, as
    a numpy int64 array."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    _, counts = np.unique(np.asarray(labels), return_counts=True)
    return np.sort(counts)[::-1]
