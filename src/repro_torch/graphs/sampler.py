"""Fanout neighbor sampler for minibatch GNN training (GraphSAGE-style).

A numpy copy of ``repro.graphs.sampler``: given the same ``rng`` it draws
the same numbers in the same order, so a batch equals the reference's
array for array. Sampling stays on the host, as in the reference; the
graph's CSR arrays are read through ``.cpu()``, so the graph may lie on
the card.

Host-side numpy sampling from CSR; emits statically-shaped padded batches
(tree-structured: every sampled neighbor is its own node instance, so
shapes are batch-size × fanout products regardless of the graph).

Batch layout (node count V = B·(1 + f1 + f1·f2 + ...)):
  node_ids  [V]  global vertex ids (gathered features come from these)
  edge_src  [E]  local child index   (E = B·(f1 + f1·f2 + ...))
  edge_dst  [E]  local parent index
  seed_mask [V]  True for the B seed rows (loss is computed on these)
Non-existent neighbors (degree-0 vertices) self-point and are marked in
``edge_valid`` so message passing can drop them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.graphs.csr import CSRGraph

__all__ = ["SampledBatch", "sampled_shape", "sample_fanout", "tree_shape",
           "sample_fanout_trees"]


@dataclasses.dataclass
class SampledBatch:
    node_ids: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_valid: np.ndarray
    seed_mask: np.ndarray

    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)


def sampled_shape(batch_size: int, fanouts: Sequence[int]):
    """(n_nodes, n_edges) of a sampled batch — used by dry-run input_specs."""
    v, e, layer = batch_size, 0, batch_size
    for f in fanouts:
        layer *= f
        v += layer
        e += layer
    return v, e


def sample_fanout(graph: CSRGraph, seeds: np.ndarray,
                  fanouts: Sequence[int], rng: np.random.Generator
                  ) -> SampledBatch:
    offsets = graph.offsets.cpu().numpy().astype(np.int64)
    # int32 as stored: only the sampled entries are widened below
    indices = graph.indices.cpu().numpy()
    b = len(seeds)
    frontier = np.asarray(seeds, dtype=np.int64)
    node_ids: List[np.ndarray] = [frontier]
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    valids: List[np.ndarray] = []
    base = 0  # local index offset of the current frontier
    for f in fanouts:
        deg = offsets[frontier + 1] - offsets[frontier]
        # sample f neighbors per frontier node (with replacement)
        r = rng.integers(0, np.maximum(deg, 1)[:, None], (len(frontier), f))
        nbr = indices[np.minimum(offsets[frontier][:, None] + r,
                                 len(indices) - 1)].astype(np.int64)
        valid = np.broadcast_to((deg > 0)[:, None], nbr.shape).copy()
        nbr = np.where(valid, nbr, frontier[:, None])  # degenerate: self
        child_base = base + len(frontier)
        src_local = child_base + np.arange(len(frontier) * f)
        dst_local = base + np.repeat(np.arange(len(frontier)), f)
        node_ids.append(nbr.reshape(-1))
        srcs.append(src_local)
        dsts.append(dst_local)
        valids.append(valid.reshape(-1))
        base = child_base
        frontier = nbr.reshape(-1)
    nodes = np.concatenate(node_ids)
    seed_mask = np.zeros(len(nodes), dtype=bool)
    seed_mask[:b] = True
    return SampledBatch(
        node_ids=nodes.astype(np.int32),
        edge_src=np.concatenate(srcs).astype(np.int32),
        edge_dst=np.concatenate(dsts).astype(np.int32),
        edge_valid=np.concatenate(valids),
        seed_mask=seed_mask,
    )


def tree_shape(fanouts: Sequence[int]):
    """(nodes, edges) of ONE sampled tree (batch=1)."""
    return sampled_shape(1, fanouts)


def sample_fanout_trees(graph: CSRGraph, seeds: np.ndarray,
                        fanouts: Sequence[int], rng: np.random.Generator):
    """Tree-contiguous layout: per-seed arrays for per-tree message passing.

    Returns a dict of [B, ...] arrays where every tree's edges use
    LOCAL indices in [0, nodes_per_tree). Trees are independent, so a
    sharded batch axis makes distributed minibatch GNN training collective-
    free except for the gradient all-reduce.
    """
    b = len(seeds)
    flat = sample_fanout(graph, seeds, fanouts, rng)
    v_t, e_t = tree_shape(fanouts)
    # positions of tree t's nodes in the flat frontier layout
    node_ids = np.empty((b, v_t), dtype=np.int32)
    edge_valid = np.empty((b, e_t), dtype=bool)
    pos = 0          # flat offset of the current layer
    local = 0        # local offset within a tree
    layer = 1        # nodes per tree in the current layer
    spans = []
    for f in (1,) + tuple(fanouts):
        layer *= f
        spans.append((pos, local, layer))
        pos += b * layer
        local += layer
    for t in range(b):
        for (p0, l0, width) in spans:
            node_ids[t, l0:l0 + width] = flat.node_ids[p0 + t * width:
                                                       p0 + (t + 1) * width]
    # local edges replicate the same tree topology for every seed
    src_l = np.empty(e_t, dtype=np.int32)
    dst_l = np.empty(e_t, dtype=np.int32)
    ei = 0
    for li in range(len(fanouts)):
        p0, l0, width = spans[li]
        f = fanouts[li]
        child_l0 = spans[li + 1][1]
        for parent in range(width):
            for c in range(f):
                src_l[ei] = child_l0 + parent * f + c
                dst_l[ei] = l0 + parent
                ei += 1
    # per-tree edge validity from the flat batch
    ei = 0
    for li in range(len(fanouts)):
        p0, l0, width = spans[li]
        f = fanouts[li]
        base = sum(b * spans[j + 1][2] for j in range(li))  # flat edge offset
        n_layer = width * f
        for t in range(b):
            edge_valid[t, ei:ei + n_layer] = flat.edge_valid[
                base + t * n_layer: base + (t + 1) * n_layer]
        ei += n_layer
    seed_mask = np.zeros((b, v_t), dtype=bool)
    seed_mask[:, 0] = True
    return {
        "node_ids": node_ids,
        "edge_src": np.broadcast_to(src_l, (b, e_t)).copy(),
        "edge_dst": np.broadcast_to(dst_l, (b, e_t)).copy(),
        "edge_valid": edge_valid,
        "seed_mask": seed_mask,
    }
