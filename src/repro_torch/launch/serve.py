"""The GNN serving cells on the card, and their timed forwards.

One definition of the GNN cells that ``chip_smoke.py`` phase 7 drives and
``scripts/gnn_profile.py`` profiles: their sizes, the model of an arch
at a cell's config, the cells' batches, and ``serve``, which times
forwards under ``torch.inference_mode()`` between CUDA events and reads
the peak device memory.

- ``example``: the full-graph batch of ``powerlaw_communities(2^18)``
  (the example's path), ``d_feat`` = the ``ogb_products`` cell's 100;
- ``minibatch_lg``: ``sample_fanout`` batches of 1,024 seeds with fanouts
  (15, 10) from the 2^22 graph, ``d_feat`` 602;
- ``molecule``: 128 disjoint molecules of 30 nodes and 64 edges,
  ``d_feat`` 16, with coordinates.
"""
from __future__ import annotations

import statistics

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import (gnn_full_batch, gnn_sampled_batch,
                                        molecule_batch)
from repro_torch.graphs.generators import powerlaw_communities
from repro_torch.graphs.sampler import sample_fanout
from repro_torch.launch.cells import _gnn_apply, _gnn_cell_config, _gnn_init

__all__ = ["CLASSES", "EXAMPLE", "MINIBATCH", "MOLECULE", "gnn_model",
           "cell_config", "example_graph", "example_batch",
           "minibatch_batch", "molecule_cell_batch", "serve"]

#: output classes of every cell (``_gnn_cell_config``'s default)
CLASSES = 16
#: the example's full graph: log2 vertices, feature width
EXAMPLE = {"scale": 18, "d_feat": 100}
#: the minibatch_lg cell, sampled from the 2^22 graph
MINIBATCH = {"scale": 22, "batch_nodes": 1024, "fanouts": (15, 10),
             "d_feat": 602, "steps": 3}
#: the molecule cell (128 molecules of 30 nodes and 64 edges)
MOLECULE = {"n_mol": 128, "n_per": 30, "e_per": 64, "d_feat": 16}


def gnn_model(arch: str, cfg, device=None, seed: int = 0):
    """``(model, apply)``: the arch at ``cfg``, its weights drawn from a
    CPU generator seeded with ``seed``, on ``device`` (``None``: CUDA)."""
    spec = get_arch(arch)
    model = _gnn_init(spec, cfg)(torch.Generator().manual_seed(seed),
                                 device=device)
    return model, _gnn_apply(spec, cfg)


def cell_config(arch: str, d_feat: int):
    """The arch's FULL config at a cell's feature width."""
    return _gnn_cell_config(get_arch(arch), d_feat, CLASSES)


def example_graph(device=None):
    """The example's graph, ``powerlaw_communities(2^18)``."""
    g, _ = powerlaw_communities(1 << EXAMPLE["scale"], p_in=0.5, mix=0.02,
                                seed=1, device=device)
    return g


def example_batch(graph) -> dict:
    """The full-graph batch of ``graph`` at the example's width."""
    return gnn_full_batch(0, graph, d_feat=EXAMPLE["d_feat"],
                          n_classes=CLASSES)


def minibatch_batch(graph, step: int, sampler=sample_fanout) -> dict:
    """Step ``step``'s ``minibatch_lg`` batch of ``graph``."""
    mb = MINIBATCH
    return gnn_sampled_batch(0, step, graph, sampler, mb["batch_nodes"],
                             mb["fanouts"], d_feat=mb["d_feat"],
                             n_classes=CLASSES)


def molecule_cell_batch(device=None) -> dict:
    """The molecule cell's batch."""
    mc = MOLECULE
    return molecule_batch(0, mc["n_mol"], mc["n_per"], mc["e_per"],
                          mc["d_feat"], device=device)


def serve(apply, model, batches: list, *, warmup: int = 2,
          reps: int = 5) -> dict:
    """Forward ``model`` (on the card) under ``torch.inference_mode()``:
    ``warmup`` calls on the first batch, then ``reps`` calls on each batch,
    each between its own CUDA events (host launch work included: a
    serving call pays it). Returns the median ms of each batch, the peak
    device memory over all of it (after ``reset_peak_memory_stats``), the
    memory resident before it, and the first output's shape and
    finiteness; a non-finite output raises."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = apply(model, batches[0])
        for _ in range(warmup - 1):
            apply(model, batches[0])
        ms = []
        for batch in batches:
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                apply(model, batch)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms.append(statistics.median(times))
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(out).all())
    if not finite:
        raise AssertionError("a forward gave a non-finite value")
    return {"ms": ms, "peak_bytes": peak, "resident_bytes": resident,
            "working_bytes": peak - resident, "shape": list(out.shape),
            "finite": finite}
