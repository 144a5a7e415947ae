"""Per-architecture dispatch of the GNN cells.

A copy of the GNN dispatch of ``repro.launch.cells`` (``_gnn_apply``,
``_gnn_init``, ``_gnn_cell_config``). The rest of the reference's module
builds XLA shardings for the dry-run cells and is not part of the port.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.gnn import (init_egnn, init_equiformer, init_mgn,
                                    init_pna)

__all__ = ["_gnn_apply", "_gnn_init", "_gnn_cell_config"]

#: ``init_*(generator, cfg, device=None)`` by arch id
_INIT = {"pna": init_pna, "meshgraphnet": init_mgn, "egnn": init_egnn,
         "equiformer-v2": init_equiformer}


def _gnn_apply(spec: ArchSpec, cfg):
    """``fn(model, batch) -> node outputs`` of the arch (EGNN: its h); the
    model runs with the config it was built with."""
    if spec.arch_id not in _INIT:
        raise KeyError(spec.arch_id)
    if spec.arch_id == "egnn":
        return lambda m, b: m(b)[0]
    return lambda m, b: m(b)


def _gnn_init(spec: ArchSpec, cfg):
    """``fn(generator, device=None) -> model`` of the arch."""
    return functools.partial(_INIT[spec.arch_id], cfg=cfg)


def _gnn_cell_config(spec: ArchSpec, d_feat: int, n_out: int):
    """The arch's full config at a cell's feature width and output count.

    MeshGraphNet has no ``d_in``: it takes ``d_node_in``, with 4 edge
    features, as the reference's cell builders set it (the reference's
    own ``_gnn_cell_config`` passes ``d_in`` to it twice and raises).
    """
    if spec.arch_id == "meshgraphnet":
        return dataclasses.replace(spec.config, d_node_in=d_feat,
                                   d_edge_in=4, d_out=n_out)
    return dataclasses.replace(spec.config, d_in=d_feat, d_out=n_out)
