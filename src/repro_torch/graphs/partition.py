"""LPA-community-driven graph partitioning.

A copy of ``repro.graphs.partition``. νMG-LPA (the port's ``lpa``, on
the graph's device) detects communities; a greedy balanced bin-packer
assigns whole communities to devices and emits a locality-preserving
contiguous vertex order, which cuts fewer edges (cross-device
neighbour-label traffic) than the naive contiguous split. The labels come
to the host once; the packing is the reference's numpy, so equal labels
give the same order, parts and bounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.lpa import LPAConfig, lpa
from repro_torch.graphs.csr import CSRGraph

__all__ = ["PartitionResult", "edge_cut_fraction", "contiguous_parts",
           "lpa_partition"]


@dataclasses.dataclass
class PartitionResult:
    order: np.ndarray        # new_id = order[old_id]
    parts: np.ndarray        # device id per (old) vertex
    bounds: np.ndarray       # [P+1] new-id range boundaries per device
    edge_cut: float          # fraction of edges crossing devices
    n_communities: int


def edge_cut_fraction(graph: CSRGraph, parts: np.ndarray) -> float:
    """The fraction of the CSR's directed edge slots whose ends lie in
    different parts. The comparison runs on the graph's device; the
    quotient is the reference's ``np.mean`` of the same booleans (an exact
    count over the slot count)."""
    n_edges = graph.indices.shape[0]
    if n_edges == 0:
        return 0.0
    p = torch.from_numpy(np.ascontiguousarray(parts)).to(graph.device)
    cut = p[graph.sources().long()] != p[graph.indices.long()]
    return int(cut.sum()) / n_edges


def contiguous_parts(graph: CSRGraph, n_parts: int) -> np.ndarray:
    """Baseline: contiguous edge-balanced split in the original order."""
    degrees = graph.degrees.cpu().numpy().astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(degrees)])
    targets = np.linspace(0, cum[-1], n_parts + 1)
    bounds = np.concatenate([[0], np.searchsorted(cum, targets[1:-1]),
                             [graph.n_nodes]])
    parts = np.zeros(graph.n_nodes, dtype=np.int32)
    for p in range(n_parts):
        parts[bounds[p]:bounds[p + 1]] = p
    return parts


def lpa_partition(graph: CSRGraph, n_parts: int,
                  config: LPAConfig | None = None) -> PartitionResult:
    """Detect communities with νMG-LPA on the graph's device, pack them
    onto devices, and emit a locality-preserving contiguous renumbering."""
    config = config or LPAConfig(method="mg")
    result = lpa(graph, config, device=graph.device)
    labels = result.labels.cpu().numpy()
    comm_ids, comm_inverse = np.unique(labels, return_inverse=True)
    n_comm = len(comm_ids)
    degrees = graph.degrees.cpu().numpy().astype(np.int64)
    comm_load = np.bincount(comm_inverse, weights=degrees + 1,
                            minlength=n_comm)

    # greedy: biggest community first onto the least-loaded device
    device_load = np.zeros(n_parts)
    comm_device = np.zeros(n_comm, dtype=np.int32)
    for ci in np.argsort(comm_load)[::-1]:
        d = int(np.argmin(device_load))
        comm_device[ci] = d
        device_load[d] += comm_load[ci]

    parts = comm_device[comm_inverse]
    # new order: sort vertices by (device, community, old id)
    key = parts.astype(np.int64) * n_comm + comm_inverse
    new_of_old = np.argsort(np.argsort(key, kind="stable"), kind="stable")
    order = new_of_old.astype(np.int64)
    counts = np.bincount(parts, minlength=n_parts)
    bounds = np.zeros(n_parts + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    return PartitionResult(order=order, parts=parts, bounds=bounds,
                           edge_cut=edge_cut_fraction(graph, parts),
                           n_communities=n_comm)
