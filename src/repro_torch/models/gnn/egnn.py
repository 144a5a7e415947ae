"""E(n)-equivariant GNN (EGNN) [arXiv:2102.09844].

A torch copy of ``repro.models.gnn.egnn`` (``EGNN`` module, state-dict
keys = the reference's parameter paths).

m_ij   = phi_e(h_i, h_j, ||x_i-x_j||^2)
x_i'   = x_i + (1/deg) sum_j (x_i - x_j) * phi_x(m_ij)
h_i'   = phi_h(h_i, sum_j m_ij)

Scalar features are E(n)-invariant; coordinates transform equivariantly.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import (forward_with, init_mlp,
                                           mlp_apply, segment_agg)
from repro_torch.models.sharding import (n_nodes, node_table, own_rows,
                                         reduce_nodes)

__all__ = ["EGNNConfig", "EGNN", "init_egnn", "egnn_forward"]


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 0
    d_out: int = 0


class EGNN(nn.Module):
    """EGNN parameters (``encode``, ``layers[i].phi_e/phi_x/phi_h``,
    ``decode``)."""

    def __init__(self, cfg: EGNNConfig, encode, layers, decode):
        super().__init__()
        self.cfg = cfg
        self.encode = encode
        self.layers = nn.ModuleList(nn.ModuleDict(lp) for lp in layers)
        self.decode = decode

    def forward(self, batch):
        """batch: node_feat [N, F], coords [N, 3], edge_src/dst [E] (pad -> N).

        Returns (node_out [N, d_out], coords' [N, 3]).
        """
        h = mlp_apply(self.encode, batch["node_feat"])
        x = batch["coords"].to(h.dtype)
        n = n_nodes(h)
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        pad = src >= n
        s_src = src.clamp_max(n - 1)
        s_dst = dst.clamp_max(n - 1)
        seg_dst = torch.where(pad, n, dst)
        deg = own_rows(reduce_nodes(h.new_zeros(n + 1).index_add_(
            0, seg_dst, (~pad).to(h.dtype)))[:n])
        inv_deg = (1.0 / torch.clamp_min(deg, 1.0))[:, None]

        for lp in self.layers:
            x_table, h_table = node_table(x), node_table(h)
            diff = x_table[s_dst] - x_table[s_src]           # x_i - x_j (i=dst)
            dist2 = torch.sum(diff * diff, dim=-1, keepdim=True)
            m = mlp_apply(lp["phi_e"], torch.cat(
                [h_table[s_dst], h_table[s_src], dist2], dim=-1),
                final_act=True)
            m = torch.where(pad[:, None], 0.0, m)
            coef = torch.tanh(mlp_apply(lp["phi_x"], m))     # bounded step
            xmsg = torch.where(pad[:, None], 0.0, diff * coef)
            x = x + segment_agg(xmsg, seg_dst, n, ("sum",))["sum"] * inv_deg
            magg = segment_agg(m, seg_dst, n, ("sum",))["sum"]
            h = h + mlp_apply(lp["phi_h"], torch.cat([h, magg], dim=-1))
        return mlp_apply(self.decode, h), x


def init_egnn(generator: torch.Generator, cfg: EGNNConfig,
              device=None) -> EGNN:
    """Random EGNN on ``device`` (``None``: CUDA), drawn from the CPU
    ``generator``."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    layers = [{"phi_e": init_mlp(generator, [2 * d + 1, d, d], device=dev),
               "phi_x": init_mlp(generator, [d, d, 1], device=dev),
               "phi_h": init_mlp(generator, [2 * d, d, d], device=dev)}
              for _ in range(cfg.n_layers)]
    encode = init_mlp(generator, [cfg.d_in or d, d], device=dev)
    decode = init_mlp(generator, [d, cfg.d_out or d], device=dev)
    return EGNN(cfg, encode, layers, decode)


def egnn_forward(params: EGNN, batch, cfg: EGNNConfig | None = None):
    """The reference's ``egnn_forward``: ``params(batch)``, whose config is
    the module's own (``cfg``, if given, must equal it)."""
    return forward_with(params, batch, cfg)
