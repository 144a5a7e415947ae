"""The training cells on the card, and their timed train steps.

One definition of the train-step cells that ``chip_smoke.py`` phase 8
drives and ``scripts/gnn_profile.py --train`` profiles: the cells'
plans (``launch.cells``: the arch's FULL config at the cell's width),
their batches, and ``train_steps``, which times steps between CUDA events
and reads the peak device memory. The serving cells' sizes and graphs
are ``launch.serve``'s.

- ``example``: the full-graph batch of ``powerlaw_communities(2^18)``
  (100 features, 16 classes), the example's path after
  ``lpa_partition``;
- ``minibatch_lg``: the registry's cell in the tree layout (1,024 trees,
  fanouts (15, 10), 602 features) sampled from the 2^22 graph;
- ``molecule``: the registry's cell (128 molecules of 30 nodes and 64
  edges, 16 features);
- ``full_graph_sm``: the registry's Cora-sized cell (2,708 nodes, 10,556
  edges, 1,433 features), one random graph of that size;
- DCN-v2 at FULL: ``train_batch`` (65,536 rows), ``serve_p99``,
  ``serve_bulk`` and ``retrieval_cand`` (1 query, 1,000,000 candidates).
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import torch

from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.data.synthetic import gnn_tree_batch, molecule_batch
from repro_torch.launch.cells import build_cell
from repro_torch.launch.serve import CLASSES, EXAMPLE, MINIBATCH

__all__ = ["TRAIN_STEPS", "registry_cell", "train_plan", "example_plan",
           "tree_batch", "full_graph_sm_batch", "train_steps"]

#: train steps a cell takes (the first a warm-up)
TRAIN_STEPS = 5


def registry_cell(arch: str, name: str) -> ShapeCell:
    """The registry's cell ``name`` of ``arch``."""
    return next(c for c in get_arch(arch).cells if c.name == name)


def train_plan(arch: str, cell: str, smoke: bool = False):
    """The plan of ``arch`` on its registry cell ``cell`` (FULL, or the
    SMOKE config with ``smoke``)."""
    spec = get_arch(arch)
    if smoke:
        spec = dataclasses.replace(spec, config=spec.smoke)
    return build_cell(spec, registry_cell(arch, cell))


def example_plan(arch: str, graph):
    """The full-graph train step of ``arch`` FULL on the example's graph
    (``ogb_products``' 100 features on the 2^18 graph)."""
    cell = ShapeCell("example", "gnn_full",
                     {"n_nodes": graph.n_nodes, "n_edges": graph.n_edges,
                      "d_feat": EXAMPLE["d_feat"]})
    return build_cell(get_arch(arch), cell)


def tree_batch(graph, step: int, batch_nodes: int | None = None,
               rank: int = 0, world: int = 1) -> dict:
    """Step ``step``'s ``minibatch_lg`` batch of ``graph`` in the tree
    layout; with ``world`` > 1, rank ``rank``'s own ``batch_nodes`` trees
    (its draws are step ``step * world + rank``'s)."""
    mb = MINIBATCH
    return gnn_tree_batch(0, step * world + rank, graph,
                          batch_nodes or mb["batch_nodes"], mb["fanouts"],
                          mb["d_feat"], n_classes=CLASSES)


def full_graph_sm_batch(device=None) -> dict:
    """``full_graph_sm``: one random graph of the cell's node and edge
    counts (uniform endpoints), with features, labels, coordinates and
    edge features (``molecule_batch`` of one "molecule" that size)."""
    p = registry_cell("pna", "full_graph_sm").params
    return molecule_batch(0, 1, p["n_nodes"], p["n_edges"], p["d_feat"],
                          device=device, n_classes=CLASSES)


def train_steps(step, model, opt, batches: list, *, warmup: int = 1) -> dict:
    """Run one train step per batch on the card, each between its own
    CUDA events (host launch work included). Returns the model, its
    optimizer state, each step's ms and loss, the median ms after
    ``warmup`` steps, the peak device memory over the steps (after
    ``reset_peak_memory_stats``) and the memory resident before them; a
    non-finite loss raises."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ms, losses = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model, opt, metrics = step(model, opt, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a train step gave a non-finite loss: {losses}")
    return {"model": model, "opt": opt, "ms": ms, "losses": losses,
            "median_ms": statistics.median(ms[warmup:] or ms),
            "peak_bytes": peak, "resident_bytes": resident,
            "working_bytes": peak - resident}
