"""Exact per-vertex label-weight aggregation — the ν-LPA / GVE-LPA analogue.

A copy of ``repro.core.exact``. The GPU baselines resolve each vertex's
vote with per-vertex hashtables (O(|E|) memory); the reference does it
with a sort by (vertex, label) and segmented reductions, which
materialises O(|E|) intermediates — the memory behaviour the paper
contrasts its sketches against. It is also the quality oracle for the
sketch methods. Plain torch on any device; no kernel of its own.

Float order. The weight of a (vertex, label) group is the reference's
``segment_sum`` over the sorted edges: a left fold in sorted order, which
is edge order inside a group because the sort is stable. The max/min
reductions are exact in any order; the group sum is not, so it goes
through :func:`_group_sums`, whose order is fixed on every device.

Width. The sort by (vertex, label) is PyTorch's stable sort of the [M]
slots, whose CUDA kernel refuses a dimension of more than 2**31 - 1
elements; so ``build_workspace`` refuses a graph past that many slots, up
front, with a ``ValueError``.
"""
from __future__ import annotations

import torch

from repro_torch.core.sketch import INT_MAX, UINT_MAX, hash_mix

__all__ = ["exact_choose", "exact_linking_weights"]


def _lexsort_order(primary: torch.Tensor, secondary: torch.Tensor
                   ) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))``: the permutation sorting by
    ``primary``, then ``secondary``, equal keys in index order. Two stable
    sorts, the secondary key first."""
    order = torch.argsort(secondary, stable=True)
    return order[torch.argsort(primary[order], stable=True)]


def _group_sums(values: torch.Tensor, group: torch.Tensor,
                n_groups: int) -> torch.Tensor:
    """Per-group sums of ``values`` [M] float32, ``group`` [M] sorted
    ascending, each group summed as a left fold ``((0 + v0) + v1) + ...``
    in index order.

    CUDA ``index_add_`` uses atomics, whose order is free, and a 1-D
    ``segment_reduce`` a tree reduction. So the sum goes through
    ``segment_reduce`` over a two-column copy: for a tensor of more than
    one dimension, PyTorch's CUDA kernel gives each (segment, column) one
    thread that adds the segment's values in order from 0, and its CPU
    kernel loops the same way. ``tests/test_torch_cuda_kernels.py`` holds
    the CUDA result to the CPU's bits on groups of up to 10^5 values.
    """
    lengths = torch.bincount(group, minlength=n_groups)
    two = torch.stack([values, values], dim=1)
    return torch.segment_reduce(two, "sum", lengths=lengths, axis=0,
                                unsafe=True)[:, 0]


def exact_choose(edge_src: torch.Tensor, nbr_labels: torch.Tensor,
                 edge_weights: torch.Tensor, n_nodes: int,
                 labels: torch.Tensor, seed) -> torch.Tensor:
    """Choose each vertex's new label by exact linking-weight argmax.

    Ties (including with the incumbent label, an ordinary group in the
    exact table) break by the per-iteration hash, then the smaller label
    — the sketch paths' ``choose_from_candidates`` rule. Vertices with no
    edges keep their label.

    Args:
      edge_src: [M] int32 source vertex per directed edge (CSR-expanded).
      nbr_labels: [M] int32 current label of each edge's destination.
      edge_weights: [M] float32.
      n_nodes: vertex count N.
      labels: [N] int32 current labels.
      seed: per-iteration tie-break seed (int).
    """
    m = edge_src.shape[0]
    dev = edge_src.device
    if m == 0:
        return labels
    order = _lexsort_order(edge_src, nbr_labels)
    s = edge_src[order]
    c = nbr_labels[order]
    w = edge_weights[order]
    # groups = runs of equal (vertex, label)
    new_group = torch.ones((m,), dtype=torch.bool, device=dev)
    new_group[1:] = (s[1:] != s[:-1]) | (c[1:] != c[:-1])
    gid = torch.cumsum(new_group, 0) - 1
    n_groups = int(gid[-1]) + 1
    gw = _group_sums(w, gid, n_groups)
    first = torch.nonzero(new_group).squeeze(1)
    rep_v = s[first].long()  # a group's vertex and label are constant
    rep_c = c[first]

    # pass 1: best weight per vertex
    best_w = torch.zeros((n_nodes,), dtype=torch.float32, device=dev)
    best_w.scatter_reduce_(0, rep_v, gw, "amax")
    tied = (gw >= best_w[rep_v]) & (gw > 0)
    # pass 2: min hash among tied groups
    h = torch.where(tied, hash_mix(rep_c, seed), UINT_MAX)
    h_best = torch.full((n_nodes,), UINT_MAX, dtype=torch.int64, device=dev)
    h_best.scatter_reduce_(0, rep_v, h, "amin")
    # pass 3: min label among hash winners (hash-collision dedupe)
    win = tied & (h <= h_best[rep_v])
    best_c = torch.full((n_nodes,), INT_MAX, dtype=torch.int32, device=dev)
    best_c.scatter_reduce_(0, rep_v, torch.where(win, rep_c, INT_MAX), "amin")
    return torch.where(best_c == INT_MAX, labels, best_c)


def exact_linking_weights(edge_src: torch.Tensor, nbr_labels: torch.Tensor,
                          edge_weights: torch.Tensor, n_nodes: int,
                          query_labels: torch.Tensor) -> torch.Tensor:
    """K_{i->c} for c = query_labels[i]: exact total linking weight between
    each vertex and a queried label (test/verification utility), each
    vertex's edges summed in edge order."""
    src = edge_src.long()
    order = torch.argsort(src, stable=True)  # identity on CSR-expanded src
    hit = nbr_labels == query_labels[src]
    return _group_sums(torch.where(hit, edge_weights, 0.0)[order],
                       src[order], n_nodes)
