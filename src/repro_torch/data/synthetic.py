"""Deterministic synthetic GNN batches with skip-ahead resume.

A copy of the GNN half of ``repro.data.synthetic``: every batch is a pure
function of (seed, step), drawn with numpy in the reference's order, so
the arrays equal the reference's exactly; they then go to the graph's
device. ``molecule_batch`` builds the registry's ``molecule`` cell as
the reference's tests do. The LM and recsys batches (``token_batch``,
``dcn_batch``) draw from JAX's PRNG in the reference and come with those
model families.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph

__all__ = ["gnn_full_batch", "gnn_sampled_batch", "molecule_batch"]


def _on(x: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


def gnn_full_batch(seed: int, graph: CSRGraph, d_feat: int,
                   n_classes: int = 16) -> dict:
    """Full-graph node features/labels with community-correlated signal,
    as tensors on the graph's device."""
    dev = graph.device
    rng = np.random.default_rng(seed)
    n = graph.n_nodes
    base = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    feat = base[labels] + 0.5 * rng.normal(size=(n, d_feat)).astype(np.float32)
    return {
        "node_feat": _on(feat, dev),
        "labels": _on(labels, dev, torch.int32),
        "edge_src": graph.sources(),
        "edge_dst": graph.indices,
        "coords": _on(rng.normal(size=(n, 3)).astype(np.float32), dev),
        "edge_feat": _on(
            rng.normal(size=(graph.n_edges, 4)).astype(np.float32), dev),
    }


def molecule_batch(seed: int, n_mol: int, n_per: int, e_per: int,
                   d_feat: int, device=None) -> dict:
    """``n_mol`` disjoint molecules of ``n_per`` nodes and ``e_per`` random
    edges each in one batch (the registry's ``molecule`` cell is 128 of
    30 and 64), drawn in the order of the reference's molecule test
    (sources, destinations, features), then coordinates. ``device=None``
    means CUDA."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, e = n_mol * n_per, n_mol * e_per
    offset = np.repeat(np.arange(n_mol) * n_per, e_per)
    src = rng.integers(0, n_per, e) + offset
    dst = rng.integers(0, n_per, e) + offset
    feat = rng.normal(size=(n, d_feat)).astype(np.float32)
    coords = rng.normal(size=(n, 3)).astype(np.float32)
    return {"node_feat": _on(feat, dev), "coords": _on(coords, dev),
            "edge_src": _on(src, dev, torch.int32),
            "edge_dst": _on(dst, dev, torch.int32)}


def gnn_sampled_batch(seed: int, step: int, graph: CSRGraph, sampler_fn,
                      batch_nodes: int, fanouts, d_feat: int,
                      n_classes: int = 16) -> dict:
    """Minibatch via the fanout sampler + feature gather, as tensors on
    the graph's device (the sampling itself runs on the host)."""
    dev = graph.device
    rng = np.random.default_rng((seed << 20) ^ step)
    seeds = rng.integers(0, graph.n_nodes, batch_nodes)
    sub = sampler_fn(graph, seeds, fanouts, rng)
    feat_rng = np.random.default_rng(seed)
    base = feat_rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    labels_all = feat_rng.integers(0, n_classes, graph.n_nodes)
    feat = base[labels_all[sub.node_ids]] + 0.5 * rng.normal(
        size=(sub.n_nodes, d_feat)).astype(np.float32)
    return {
        "node_feat": _on(feat, dev),
        "labels": _on(labels_all[sub.node_ids], dev, torch.int32),
        "edge_src": _on(sub.edge_src, dev),
        "edge_dst": _on(sub.edge_dst, dev),
        "seed_mask": _on(sub.seed_mask, dev),
        "coords": _on(rng.normal(size=(sub.n_nodes, 3)).astype(np.float32),
                      dev),
        "edge_feat": _on(rng.normal(
            size=(len(sub.edge_src), 4)).astype(np.float32), dev),
    }
