"""EquiformerV2 [arXiv:2306.12059]: equivariant graph attention via eSCN.

A torch copy of ``repro.models.gnn.equiformer_v2`` (``Equiformer`` module,
state-dict keys = the reference's parameter paths, e.g. ``layers.0.wr1``).

Structure (faithful to the paper's compute pattern; uniform channel
multiplicity across l as in EquiformerV2):

  node irreps f in R^[N, (L+1)^2, C]  (real spherical harmonics, l <= l_max)
  per edge:   rotate source irreps into the edge frame with block-diagonal
              Wigner D^l(R_e) (exact, wigner.py) -> SO(2) linear conv mixing
              l-channels within each |m| <= m_max (the eSCN O(L^3) trick;
              higher-m components skip-connect) -> rotate back with D^T
  attention:  per-head scalars from the m=0 part -> segment softmax over
              incoming edges -> weighted aggregation
  ffn:        equivariant gate (l=0 scalars gate l>0 channels)
  norm:       per-l RMS norm over (m, C)

Radial dependence: Gaussian RBF of edge length -> MLP -> per-(m, l) scales
modulating the SO(2) weights.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init
from repro_torch.models.gnn.common import forward_with, init_mlp, mlp_apply
from repro_torch.models.gnn.wigner import edge_rotations
from repro_torch.models.sharding import (n_nodes, node_table, own_rows,
                                         reduce_nodes)

__all__ = ["EquiformerConfig", "Equiformer", "init_equiformer",
           "equiformer_forward"]


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    n_layers: int = 12
    d_hidden: int = 128      # channels per irrep degree
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    d_in: int = 0            # scalar input feature dim
    d_out: int = 0
    r_cut: float = 5.0

    @property
    def n_sph(self) -> int:
        return (self.l_max + 1) ** 2


def _m_indices(l_max: int, m: int, device=None):
    """Flat irrep indices of the (+m, -m) components for all l >= m."""
    plus = [l * l + l + m for l in range(max(m, 0), l_max + 1)]
    minus = [l * l + l - m for l in range(max(m, 0), l_max + 1)]
    return (torch.as_tensor(plus, device=device),
            torch.as_tensor(minus, device=device))


class EquiformerLayer(nn.Module):
    """One layer's parameters, read as ``lp["w0"]`` like the reference's
    dict: ``w0``, ``radial``, ``attn``, ``ffn_gate``, ``ffn_w1``,
    ``ffn_w2``, ``ln_scale``, ``ln_scale2`` and ``wr{m}``/``wi{m}`` for
    m = 1..m_max."""

    def __init__(self, params: dict):
        super().__init__()
        for name, value in params.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


class Equiformer(nn.Module):
    """EquiformerV2 parameters (``embed``, ``layers``, ``out``)."""

    def __init__(self, cfg: EquiformerConfig, embed, layers, out):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(EquiformerLayer(lp) for lp in layers)
        self.out = out

    def forward(self, batch):
        """batch: node_feat [N, F], coords [N, 3], edge_src/dst [E] (pad -> N).

        Returns scalar node outputs [N, d_out].
        """
        cfg = self.cfg
        rows = batch["node_feat"].shape[0]   # this rank's (one card: N)
        n = n_nodes(batch["node_feat"])
        c, lm = cfg.d_hidden, cfg.l_max
        scal = mlp_apply(self.embed, batch["node_feat"])  # [N, C]
        f = torch.cat([scal[:, None],
                       scal.new_zeros((rows, cfg.n_sph - 1, c))], dim=1)

        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        s_src = src.clamp_max(n - 1)
        s_dst = dst.clamp_max(n - 1)
        coords = node_table(batch["coords"])
        evec = coords[s_src] - coords[s_dst]
        dist = torch.sqrt(torch.sum(evec ** 2, dim=-1) + 1e-12)
        # pad edges and degenerate (zero-length / self-loop) edges carry no message
        pad = (src >= n) | (dist < 1e-5)
        seg_dst = torch.where(pad, n, dst)
        blocks = edge_rotations(evec, lm)
        blocks = [torch.where(pad[:, None, None],
                              torch.eye(2 * l + 1, device=b.device)[None], b)
                  for l, b in enumerate(blocks)]
        # Gaussian RBF
        centers = torch.linspace(0.0, cfg.r_cut, cfg.n_rbf, device=dist.device)
        rbf = torch.exp(-((dist[:, None] - centers[None]) ** 2)
                        * (cfg.n_rbf / cfg.r_cut) ** 2 * 0.5)

        for lp in self.layers:
            fn = _irrep_norm(f, lp["ln_scale"], lm)
            msg_in = node_table(fn)[s_src]
            rot = _apply_wigner(blocks, msg_in, lm)
            rad = mlp_apply(lp["radial"], rbf).reshape(-1, cfg.m_max + 1, lm + 1)
            conv = _so2_conv(lp, rot, rad, cfg)
            msg = _apply_wigner(blocks, conv, lm, transpose=True)
            msg = torch.where(pad[:, None, None], 0.0, msg)
            # attention from scalar part
            a = F.leaky_relu(msg[:, 0] @ lp["attn"].to(msg.dtype), 0.2)  # [E, H]
            a = torch.where(pad[:, None], float("-inf"), a.float())
            alpha = _segment_softmax(a, seg_dst, n + 1)               # [E, H]
            hsz = c // cfg.n_heads
            msg_h = msg.reshape(-1, cfg.n_sph, cfg.n_heads, hsz)
            msg_h = msg_h * alpha[:, None, :, None].to(msg.dtype)
            msg = msg_h.reshape(-1, cfg.n_sph, c)
            agg = own_rows(reduce_nodes(msg.new_zeros(
                (n + 1, cfg.n_sph, c)).index_add(0, seg_dst, msg))[:n])
            f = f + agg
            # equivariant gated FFN
            fn2 = _irrep_norm(f, lp["ln_scale2"], lm)
            s0 = fn2[:, 0]
            h = F.silu(s0 @ lp["ffn_w1"].to(s0.dtype))
            s_out = h @ lp["ffn_w2"].to(s0.dtype)
            gates = torch.sigmoid(mlp_apply(lp["ffn_gate"], s0)).reshape(
                rows, lm, c)
            upd = [s_out[:, None]]
            for l in range(1, lm + 1):
                blk = fn2[:, l * l:(l + 1) * (l + 1)]
                upd.append(blk * gates[:, l - 1][:, None, :])
            f = f + torch.cat(upd, dim=1)
        return mlp_apply(self.out, f[:, 0])


def init_equiformer(generator: torch.Generator, cfg: EquiformerConfig,
                    device=None) -> Equiformer:
    """Random EquiformerV2 on ``device`` (``None``: CUDA), drawn from the
    CPU ``generator``."""
    dev = resolve_device(device)
    c, lm = cfg.d_hidden, cfg.l_max

    def dense(shape):
        return dense_init(generator, shape, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            "w0": dense(((lm + 1) * c, (lm + 1) * c)),
            "radial": init_mlp(generator, [cfg.n_rbf, 64,
                                           (cfg.m_max + 1) * (lm + 1)],
                               device=dev),
            "attn": dense((c, cfg.n_heads)),
            "ffn_gate": init_mlp(generator, [c, c, lm * c], device=dev),
            "ffn_w1": dense((c, c)),
            "ffn_w2": dense((c, c)),
            "ln_scale": torch.ones((lm + 1, c), device=dev),
            "ln_scale2": torch.ones((lm + 1, c), device=dev),
        }
        for m in range(1, cfg.m_max + 1):
            n = (lm + 1 - m) * c
            lp[f"wr{m}"] = dense((n, n))
            lp[f"wi{m}"] = dense((n, n))
        layers.append(lp)
    embed = init_mlp(generator, [cfg.d_in or c, c], device=dev)
    out = init_mlp(generator, [c, c, cfg.d_out or c], device=dev)
    return Equiformer(cfg, embed, layers, out)


def _irrep_norm(f, scale, l_max):
    """Per-degree RMS norm over (m, C): f [N, (L+1)^2, C]."""
    outs = []
    for l in range(l_max + 1):
        blk = f[:, l * l:(l + 1) * (l + 1)]
        rms = torch.sqrt(torch.mean(blk.float() ** 2, dim=(1, 2),
                                    keepdim=True) + 1e-6)
        outs.append((blk / rms.to(blk.dtype)) * scale[l].to(blk.dtype))
    return torch.cat(outs, dim=1)


def _so2_conv(lp, f_rot, rad, cfg: EquiformerConfig):
    """SO(2) linear conv in the edge frame: f_rot [E, (L+1)^2, C]."""
    e, _, c = f_rot.shape
    lm = cfg.l_max
    dev = f_rot.device
    # skip path carries m > m_max components through unchanged; a copy,
    # so that the writes below leave the caller's tensor as it was
    out = f_rot.clone()
    # rad: [E, (m_max+1), (L+1)] per-(m, l) radial scales
    # m = 0
    idx0 = torch.as_tensor([l * l + l for l in range(lm + 1)], device=dev)
    x0 = f_rot[:, idx0].reshape(e, (lm + 1) * c)
    y0 = (x0 @ lp["w0"].to(x0.dtype)).reshape(e, lm + 1, c)
    y0 = y0 * rad[:, 0, :, None].to(x0.dtype)
    out[:, idx0] = y0
    for m in range(1, cfg.m_max + 1):
        ip, im = _m_indices(lm, m, dev)
        nl = lm + 1 - m
        xp = f_rot[:, ip].reshape(e, nl * c)
        xm = f_rot[:, im].reshape(e, nl * c)
        wr = lp[f"wr{m}"].to(xp.dtype)
        wi = lp[f"wi{m}"].to(xp.dtype)
        yp = (xp @ wr - xm @ wi).reshape(e, nl, c)
        ym = (xp @ wi + xm @ wr).reshape(e, nl, c)
        scale = rad[:, m, m:, None].to(xp.dtype)
        out[:, ip] = yp * scale
        out[:, im] = ym * scale
    return out


def _apply_wigner(blocks: List[torch.Tensor], f, l_max: int,
                  transpose: bool = False):
    """Block-diagonal rotate: f [E, (L+1)^2, C] by per-edge D^l blocks."""
    outs = []
    eq = "eji,ejc->eic" if transpose else "eij,ejc->eic"
    for l in range(l_max + 1):
        blk = f[:, l * l:(l + 1) * (l + 1)]
        outs.append(torch.einsum(eq, blocks[l].to(blk.dtype), blk))
    return torch.cat(outs, dim=1)


def _segment_softmax(scores, seg, n_segments):
    """Softmax of ``scores`` [E, H] over the edges of each segment, per
    head (the reference maps its 1-D version over the head axis)."""
    idx = seg.long()[:, None].expand_as(scores)
    smax = scores.new_full((n_segments, scores.shape[1]), float("-inf"))
    smax = reduce_nodes(smax.scatter_reduce(0, idx, scores, "amax",
                                            include_self=True), "max")
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - smax[seg])
    den = reduce_nodes(scores.new_zeros((n_segments, scores.shape[1])
                                        ).index_add(0, seg, ex))
    return ex / torch.clamp_min(den[seg], 1e-9)


def equiformer_forward(params: Equiformer, batch, cfg: EquiformerConfig | None = None):
    """The reference's ``equiformer_forward``: ``params(batch)``, whose config is
    the module's own (``cfg``, if given, must equal it)."""
    return forward_with(params, batch, cfg)
