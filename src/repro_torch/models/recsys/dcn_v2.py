"""DCN-v2 [arXiv:2008.13535]: cross network v2 + deep MLP over
dense features and sparse embedding-bag lookups (Criteo layout:
13 dense + 26 categorical fields).

A torch copy of ``repro.models.recsys.dcn_v2``: ``init_dcn`` builds a
``DCN`` module whose state-dict keys are the reference's parameter paths
(``tables.table_3``, ``cross.0.w``, ``mlp.2.b``, ``head``), so
``models.convert.load_jax_params`` carries the reference's weights.

Cross layer: x_{l+1} = x_0 * (W_l x_l + b_l) + x_l  (full-rank W).
``dcn_retrieval_scores`` scores one query against a large candidate-item
embedding matrix with one matrix product (the retrieval_cand shape).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init
from repro_torch.models.gnn.common import Dense
from repro_torch.models.recsys.embedding import (embedding_bag,
                                                 init_embedding_bag)

__all__ = ["DCNConfig", "DCN", "init_dcn", "dcn_forward", "dcn_loss",
           "dcn_retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp_dims: Tuple[int, ...] = (1024, 1024, 512)
    vocab_sizes: Tuple[int, ...] = ()   # len == n_sparse

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


class DCN(nn.Module):
    """DCN-v2 parameters (``tables``, ``cross``, ``mlp``, ``head``)."""

    def __init__(self, cfg: DCNConfig, tables: dict, cross, mlp,
                 head: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in tables.items()})
        self.cross = nn.ModuleList(cross)
        self.mlp = nn.ModuleList(mlp)
        self.head = nn.Parameter(head)

    def query(self, dense: torch.Tensor, sparse_ids: torch.Tensor):
        """The cross + MLP trunk's features [B, d_interact + mlp_dims[-1]].

        dense [B, n_dense] f32; sparse_ids [B, n_sparse] int (single-hot).
        """
        embs = [embedding_bag(self.tables[f"table_{i}"], sparse_ids[:, i])
                for i in range(self.cfg.n_sparse)]
        x0 = torch.cat([dense] + embs, dim=-1)  # [B, d_interact]
        x = x0
        for lp in self.cross:
            x = x0 * (x @ lp.w.to(x.dtype) + lp.b.to(x.dtype)) + x
        h = x0
        for lp in self.mlp:
            h = torch.relu(h @ lp.w.to(h.dtype) + lp.b.to(h.dtype))
        return torch.cat([x, h], dim=-1)

    def forward(self, dense: torch.Tensor, sparse_ids: torch.Tensor):
        """Returns logits [B]."""
        feat = self.query(dense, sparse_ids)
        return (feat @ self.head.to(feat.dtype))[:, 0]


def init_dcn(generator: torch.Generator, cfg: DCNConfig, device=None) -> DCN:
    """Random DCN-v2 on ``device`` (``None``: CUDA), drawn from
    ``generator`` on the generator's device (a CPU generator gives the
    same weights on any device)."""
    dev = resolve_device(device)
    d = cfg.d_interact
    cross = [Dense(dense_init(generator, (d, d), device=dev),
                   torch.zeros(d, dtype=torch.float32, device=dev))
             for _ in range(cfg.n_cross_layers)]
    mlp, prev = [], d
    for h in cfg.mlp_dims:
        mlp.append(Dense(dense_init(generator, (prev, h), device=dev),
                         torch.zeros(h, dtype=torch.float32, device=dev)))
        prev = h
    tables = init_embedding_bag(generator, cfg.vocab_sizes, cfg.embed_dim,
                                device=dev)
    head = dense_init(generator, (prev + d, 1), device=dev)
    return DCN(cfg, tables, cross, mlp, head)


def _check_cfg(model: DCN, cfg) -> None:
    if cfg is not None and cfg != model.cfg:
        raise ValueError(f"cfg {cfg} is not the model's {model.cfg}")


def dcn_forward(params: DCN, dense, sparse_ids, cfg: DCNConfig | None = None):
    """The reference's ``dcn_forward``: logits [B]."""
    _check_cfg(params, cfg)
    return params(dense, sparse_ids)


def dcn_loss(params: DCN, dense, sparse_ids, labels,
             cfg: DCNConfig | None = None):
    """Mean binary cross-entropy of the logits, in the reference's stable
    form max(z, 0) - z y + log1p(exp(-|z|))."""
    z = dcn_forward(params, dense, sparse_ids, cfg).to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def dcn_retrieval_scores(params: DCN, dense, sparse_ids, cand_emb,
                         cfg: DCNConfig | None = None):
    """Score one (or few) query context(s) against N candidate embeddings
    [N, D_q]: the L2-normalised trunk features times the candidates."""
    _check_cfg(params, cfg)
    q = params.query(dense, sparse_ids)                # [B, Dq]
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-6)
    return q @ cand_emb.to(q.dtype).T
