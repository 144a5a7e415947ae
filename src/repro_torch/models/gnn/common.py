"""Shared GNN building blocks: MLPs and padded segment aggregations.

A torch copy of ``repro.models.gnn.common``. An ``MLP`` is a list of
``Dense`` layers, each holding ``w`` as [in, out] (the reference's
layout, ``x @ w``) and an optional ``b``, so the reference's parameter
path ``[i]["w"]`` is the state-dict key ``i.w``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from repro_torch.models.common import dense_init
from repro_torch.models.sharding import own_rows, reduce_nodes

__all__ = ["Dense", "MLP", "init_mlp", "mlp_apply", "segment_agg",
           "forward_with"]


class Dense(nn.Module):
    """One affine layer: ``x @ w (+ b)``, ``w`` [in, out]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)


class MLP(nn.ModuleList):
    """Dense layers with an activation between them (``mlp_apply``)."""

    def forward(self, x, act=torch.relu, final_act: bool = False,
                layer_norm: bool = False):
        return mlp_apply(self, x, act, final_act, layer_norm)


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             bias: bool = True, device=None) -> MLP:
    """dims = [d_in, h1, ..., d_out]."""
    layers = []
    for i in range(len(dims) - 1):
        w = dense_init(generator, (dims[i], dims[i + 1]), device=device)
        b = (torch.zeros(dims[i + 1], dtype=torch.float32, device=device)
             if bias else None)
        layers.append(Dense(w, b))
    return MLP(layers)


def mlp_apply(layers: MLP, x, act=torch.relu, final_act: bool = False,
              layer_norm: bool = False):
    for i, p in enumerate(layers):
        x = x @ p.w.to(x.dtype)
        if p.b is not None:
            x = x + p.b.to(x.dtype)
        if i < len(layers) - 1 or final_act:
            x = act(x)
    if layer_norm:
        # no affine term; the variance has ddof 0, as jnp.var's
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        x = (x - mu) * torch.rsqrt(var + 1e-6)
    return x


def _segment_extreme(messages: torch.Tensor, dst: torch.Tensor, ns: int,
                     reduce: str) -> torch.Tensor:
    """segment max ("amax") or min ("amin") over ``ns`` segments; an empty
    segment reads ∓inf, as ``jax.ops.segment_max``/``segment_min`` give."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = torch.full((ns,) + messages.shape[1:], fill, dtype=messages.dtype,
                     device=messages.device)
    idx = dst.view((-1,) + (1,) * (messages.dim() - 1)).expand_as(messages)
    return out.scatter_reduce(0, idx, messages, reduce, include_self=True)


def segment_agg(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                reductions=("sum",)) -> dict:
    """Aggregate edge messages [E, F] to nodes [N, F] per reduction.

    ``dst`` may contain the dump index ``n_nodes`` for padded edges; the
    extra row is sliced off. Returns a dict {name: [N, F]}. As a rank's
    share of a sharded graph (``models.sharding``): each reduction over
    the rank's edges, all-reduced over the ranks, then the rank's rows.
    """
    out = {}
    ns = n_nodes + 1
    dst = dst.long()
    zeros = messages.new_zeros((ns,) + messages.shape[1:])
    if "sum" in reductions or "mean" in reductions or "std" in reductions:
        out["sum"] = reduce_nodes(zeros.index_add(0, dst, messages))[:n_nodes]
    if "mean" in reductions or "std" in reductions:
        cnt = reduce_nodes(messages.new_zeros(ns).index_add_(
            0, dst, messages.new_ones(dst.shape)))[:n_nodes]
        denom = torch.clamp_min(cnt, 1.0)[:, None]
        out["count"] = cnt
        out["mean"] = out["sum"] / denom
    if "std" in reductions:
        sq = reduce_nodes(zeros.index_add(0, dst, messages * messages)
                          )[:n_nodes]
        var = sq / denom - out["mean"] ** 2
        out["std"] = torch.sqrt(torch.clamp_min(var, 0.0) + 1e-5)
    for name, reduce in (("max", "amax"), ("min", "amin")):
        if name in reductions:
            x = reduce_nodes(_segment_extreme(messages, dst, ns, reduce),
                             name)[:n_nodes]
            out[name] = torch.where(torch.isfinite(x), x, 0.0)
    return {k: own_rows(v) for k, v in out.items()}


def forward_with(model: nn.Module, batch, cfg=None):
    """``model(batch)`` for the reference-named ``*_forward(params, batch,
    cfg)``: the config is the one the module was built with, and a
    ``cfg`` whose fields differ from it raises."""
    if cfg is not None and (dataclasses.asdict(cfg)
                            != dataclasses.asdict(model.cfg)):
        raise ValueError(f"cfg {cfg} is not the model's {model.cfg}")
    return model(batch)
