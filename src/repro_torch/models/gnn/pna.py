"""Principal Neighbourhood Aggregation (PNA) [arXiv:2004.05718].

A torch copy of ``repro.models.gnn.pna``: ``init_pna`` builds a ``PNA``
module whose state-dict keys are the reference's parameter paths
(``layers.0.msg.1.w`` for ``params["layers"][0]["msg"][1]["w"]``), and
its ``forward`` is the reference's ``pna_forward`` (kept as an alias).

Message = MLP([h_src, h_dst]); aggregation = {mean, max, min, std} ×
degree scalers {identity, amplification, attenuation}; update MLP.
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

__all__ = ["PNAConfig", "PNA", "init_pna", "pna_forward"]


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 0              # input feature dim (0 => d_hidden)
    d_out: int = 0             # output dim (0 => d_hidden)
    avg_log_degree: float = 3.0  # delta normalizer (dataset statistic)
    aggregators = ("mean", "max", "min", "std")
    n_scalers: int = 3


class PNA(nn.Module):
    """PNA parameters (``encode``, ``layers[i].msg/upd``, ``decode``)."""

    def __init__(self, cfg: PNAConfig, encode, layers, decode):
        super().__init__()
        self.cfg = cfg
        self.encode = encode
        self.layers = nn.ModuleList(nn.ModuleDict(lp) for lp in layers)
        self.decode = decode

    def forward(self, batch):
        """batch: node_feat [N, F], edge_src [E], edge_dst [E] (pad -> N)."""
        cfg = self.cfg
        h = mlp_apply(self.encode, batch["node_feat"])
        n = n_nodes(h)
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        pad = src >= n
        safe_src = src.clamp_max(n - 1)
        safe_dst = dst.clamp_max(n - 1)
        seg_dst = torch.where(pad, n, dst)
        deg = own_rows(reduce_nodes(h.new_zeros(n + 1).index_add_(
            0, dst.clamp_max(n), (~pad).to(h.dtype)))[:n])
        logd = torch.log(deg + 1.0)
        amp = (logd / cfg.avg_log_degree)[:, None]
        att = (cfg.avg_log_degree / torch.clamp_min(logd, 1e-3))[:, None]

        for lp in self.layers:
            table = node_table(h)
            m_in = torch.cat([table[safe_src], table[safe_dst]], dim=-1)
            m = mlp_apply(lp["msg"], m_in)
            m = torch.where(pad[:, None], 0.0, m)
            aggs = segment_agg(m, seg_dst, n, reductions=cfg.aggregators)
            feats = []
            for name in cfg.aggregators:
                a = aggs[name]
                feats += [a, a * amp, a * att]
            h_new = mlp_apply(lp["upd"], torch.cat([h] + feats, dim=-1))
            h = h + h_new
        return mlp_apply(self.decode, h)


def init_pna(generator: torch.Generator, cfg: PNAConfig, device=None) -> PNA:
    """Random PNA on ``device`` (``None``: CUDA, raising without a card),
    drawn from the CPU ``generator``."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    n_agg = len(cfg.aggregators) * cfg.n_scalers
    layers = [{"msg": init_mlp(generator, [2 * d, d, d], device=dev),
               "upd": init_mlp(generator, [(n_agg + 1) * d, d, d],
                               device=dev)}
              for _ in range(cfg.n_layers)]
    encode = init_mlp(generator, [cfg.d_in or d, d], device=dev)
    decode = init_mlp(generator, [d, cfg.d_out or d], device=dev)
    return PNA(cfg, encode, layers, decode)


def pna_forward(params: PNA, batch, cfg: PNAConfig | None = None):
    """The reference's ``pna_forward``: ``params(batch)``, whose config is
    the module's own (``cfg``, if given, must equal it)."""
    return forward_with(params, batch, cfg)
