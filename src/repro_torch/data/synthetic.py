"""Deterministic synthetic batches with skip-ahead resume.

A copy of ``repro.data.synthetic``: every batch is a pure function of
(seed, step), so a restarted job resumes exactly where it left off. The GNN batches are
drawn with numpy in the reference's order, so the arrays equal the
reference's exactly; they then go to the graph's device.
``molecule_batch`` builds the registry's ``molecule`` cell as the
reference's tests do, and ``gnn_tree_batch`` the tree layout of the
``minibatch_lg`` train step. ``dcn_batch`` draws from JAX's PRNG in the
reference, whose bits torch cannot reproduce: here it draws the same law
from ``torch.Generator``s seeded from (seed, step), the planted rule from
the seed alone; ``token_batch`` likewise.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.sampler import sample_fanout_trees

__all__ = ["token_batch", "dcn_batch", "gnn_full_batch", "gnn_sampled_batch",
           "gnn_tree_batch", "molecule_batch"]


def _generator(seed: int, *key: int) -> torch.Generator:
    """A CPU generator seeded from ``seed`` and the spawn ``key``."""
    state = np.random.SeedSequence(seed, spawn_key=key).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & ((1 << 63) - 1))


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                device=None) -> dict:
    """LM batch ``step``: noisy arithmetic progressions, so a model can
    learn next-token structure. Each row starts uniform in [0, vocab)
    with a stride uniform in [1, 7), mod ``vocab``; 5% of the tokens
    move by +13 mod ``vocab``; ``targets`` are the tokens shifted by one
    (int32 [batch, seq] each). ``device=None`` means CUDA."""
    dev = resolve_device(device)
    gen = _generator(seed, step)
    start = torch.randint(0, vocab, (batch, 1), generator=gen)
    stride = torch.randint(1, 7, (batch, 1), generator=gen)
    toks = (start + stride * torch.arange(seq + 1)[None]) % vocab
    noise = torch.rand(toks.shape, generator=gen) < 0.05
    toks = torch.where(noise, (toks + 13) % vocab, toks)
    return {"tokens": toks[:, :-1].to(dev, torch.int32),
            "targets": toks[:, 1:].to(dev, torch.int32)}


def dcn_batch(seed: int, step: int, batch: int, n_dense: int, n_sparse: int,
              vocab_sizes: Sequence[int], device=None) -> dict:
    """DCN-v2 batch ``step``: standard-normal dense features, uniform ids
    per field, and labels from a planted rule (a normal weight vector on
    the dense features plus 0.3 (id_0 mod 5 - 2)) that depends on
    ``seed`` only, so the loss can fall. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    gen = _generator(seed, step)
    dense = torch.randn(batch, n_dense, generator=gen)
    sparse = torch.stack([torch.randint(0, v, (batch,), generator=gen)
                          for v in vocab_sizes], dim=1)
    w = torch.randn(n_dense, generator=_generator(seed))
    logit = dense @ w + 0.3 * (sparse[:, 0] % 5 - 2)
    labels = (logit > 0).to(torch.float32)
    return {"dense": dense.to(dev), "sparse": sparse.to(dev, torch.int32),
            "labels": labels.to(dev)}


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
                   d_feat: int, device=None, n_classes: int = 16) -> dict:
    """``n_mol`` disjoint molecules of ``n_per`` nodes and ``e_per`` random
    edges each in one batch (the registry's ``molecule`` cell is 128 of
    30 and 64), drawn in the order of the reference's molecule test
    (sources, destinations, features), then coordinates, then the train
    steps' node labels in [0, n_classes) and 4 edge features. ``device=None``
    means CUDA."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, e = n_mol * n_per, n_mol * e_per
    offset = np.repeat(np.arange(n_mol) * n_per, e_per)
    src = rng.integers(0, n_per, e) + offset
    dst = rng.integers(0, n_per, e) + offset
    feat = rng.normal(size=(n, d_feat)).astype(np.float32)
    coords = rng.normal(size=(n, 3)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    edge_feat = rng.normal(size=(e, 4)).astype(np.float32)
    return {"node_feat": _on(feat, dev), "coords": _on(coords, dev),
            "edge_src": _on(src, dev, torch.int32),
            "edge_dst": _on(dst, dev, torch.int32),
            "labels": _on(labels, dev, torch.int32),
            "edge_feat": _on(edge_feat, dev)}


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


def gnn_tree_batch(seed: int, step: int, graph: CSRGraph, batch_nodes: int,
                   fanouts, d_feat: int, n_classes: int = 16) -> dict:
    """``minibatch_lg`` in the tree layout: ``sample_fanout_trees`` of
    ``batch_nodes`` seeds, features and labels drawn as
    ``gnn_sampled_batch`` draws them, as [B, v_t, ...] node and [B, e_t]
    edge tensors on the graph's device. Every tree's edges use local ids
    in [0, v_t); an edge the sampler marks invalid (its parent has no
    neighbour) points at the tree's dump row v_t at both ends."""
    dev = graph.device
    rng = np.random.default_rng((seed << 20) ^ step)
    seeds = rng.integers(0, graph.n_nodes, batch_nodes)
    trees = sample_fanout_trees(graph, seeds, fanouts, rng)
    feat_rng = np.random.default_rng(seed)
    base = feat_rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    labels_all = feat_rng.integers(0, n_classes, graph.n_nodes)
    ids = trees["node_ids"]
    b, v_t = ids.shape
    e_t = trees["edge_src"].shape[1]
    feat = base[labels_all[ids]] + 0.5 * rng.normal(
        size=(b, v_t, d_feat)).astype(np.float32)
    valid = trees["edge_valid"]
    return {
        "node_feat": _on(feat, dev),
        "labels": _on(labels_all[ids], dev, torch.int32),
        "edge_src": _on(np.where(valid, trees["edge_src"], v_t), dev,
                        torch.int32),
        "edge_dst": _on(np.where(valid, trees["edge_dst"], v_t), dev,
                        torch.int32),
        "coords": _on(rng.normal(size=(b, v_t, 3)).astype(np.float32), dev),
        "edge_feat": _on(rng.normal(size=(b, e_t, 4)).astype(np.float32),
                         dev),
    }
