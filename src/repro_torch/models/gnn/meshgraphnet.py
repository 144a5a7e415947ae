"""MeshGraphNet [arXiv:2010.03409]: encode-process-decode with edge/node MLPs.

A torch copy of ``repro.models.gnn.meshgraphnet`` (``MGN`` module, state-
dict keys = the reference's parameter paths).

Processor step (×15): e' = e + MLP_e([e, h_src, h_dst]);
                      h' = h + MLP_v([h, sum_{e in N(v)} e']).
All MLPs are 2 hidden layers with LayerNorm (paper setup).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import (forward_with, init_mlp,
                                           mlp_apply, segment_agg)
from repro_torch.models.sharding import n_nodes, node_table

__all__ = ["MGNConfig", "MGN", "init_mgn", "mgn_forward"]


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 0
    d_edge_in: int = 0
    d_out: int = 0


def _mlp_dims(cfg, d_in):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [cfg.d_hidden]


class MGN(nn.Module):
    """MeshGraphNet parameters (``enc_node``, ``enc_edge``,
    ``layers[i].edge/node``, ``decode``)."""

    def __init__(self, cfg: MGNConfig, enc_node, enc_edge, layers, decode):
        super().__init__()
        self.cfg = cfg
        self.enc_node = enc_node
        self.enc_edge = enc_edge
        self.layers = nn.ModuleList(nn.ModuleDict(lp) for lp in layers)
        self.decode = decode

    def forward(self, batch):
        """batch: node_feat [N, Fn], edge_feat [E, Fe], edge_src/dst [E]."""
        h = mlp_apply(self.enc_node, batch["node_feat"], layer_norm=True)
        e = mlp_apply(self.enc_edge, batch["edge_feat"], layer_norm=True)
        n = n_nodes(h)
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        pad = src >= n
        s_src = src.clamp_max(n - 1)
        s_dst = dst.clamp_max(n - 1)
        seg_dst = torch.where(pad, n, dst)
        for lp in self.layers:
            table = node_table(h)
            e_in = torch.cat([e, table[s_src], table[s_dst]], dim=-1)
            e = e + mlp_apply(lp["edge"], e_in, layer_norm=True)
            e = torch.where(pad[:, None], 0.0, e)
            agg = segment_agg(e, seg_dst, n, ("sum",))["sum"]
            h = h + mlp_apply(lp["node"], torch.cat([h, agg], dim=-1),
                              layer_norm=True)
        return mlp_apply(self.decode, h)


def init_mgn(generator: torch.Generator, cfg: MGNConfig, device=None) -> MGN:
    """Random MeshGraphNet on ``device`` (``None``: CUDA), drawn from the
    CPU ``generator``."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    layers = [{"edge": init_mlp(generator, _mlp_dims(cfg, 3 * d), device=dev),
               "node": init_mlp(generator, _mlp_dims(cfg, 2 * d), device=dev)}
              for _ in range(cfg.n_layers)]
    enc_node = init_mlp(generator, _mlp_dims(cfg, cfg.d_node_in or d),
                        device=dev)
    enc_edge = init_mlp(generator, _mlp_dims(cfg, cfg.d_edge_in or d),
                        device=dev)
    decode = init_mlp(generator, [d, d, cfg.d_out or d], device=dev)
    return MGN(cfg, enc_node, enc_edge, layers, decode)


def mgn_forward(params: MGN, batch, cfg: MGNConfig | None = None):
    """The reference's ``mgn_forward``: ``params(batch)``, whose config is
    the module's own (``cfg``, if given, must equal it)."""
    return forward_with(params, batch, cfg)
