"""EmbeddingBag: the lookup of one row per id, or a bag reduction.

A torch copy of ``repro.models.recsys.embedding``. A single-hot lookup
(no ``offsets``) is ``index_select``, whose backward on the card is
deterministic under ``torch.use_deterministic_algorithms(True)``. Bags
have ``torch.nn.EmbeddingBag`` semantics (bag i covers
``ids[offsets[i]:offsets[i+1]]``, the last to the end, ``offsets[0] ==
0``): ``F.embedding_bag``'s weighted sum, divided for ``"mean"`` by the
bag's length (at least 1), as the reference divides its segment sum.
As rank of a "model" group holding a row shard of the table
(``models.sharding.table_shard``), a single-hot lookup reads the rows
it holds and sums over the group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.sharding import lookup

__all__ = ["init_embedding_bag", "embedding_bag"]


def init_embedding_bag(generator: torch.Generator, vocab_sizes,
                       embed_dim: int, device=None) -> dict:
    """One table per sparse field, {``table_i``: [V_i, D]}, drawn from
    ``generator`` (on its device) and placed on ``device``."""
    return {f"table_{i}": dense_init(generator, (v, embed_dim), scale=0.02,
                                     device=device)
            for i, v in enumerate(vocab_sizes)}


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor | None = None,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """ids [T] (flat indices); offsets [B] bag starts (None => single-hot
    ids of shape [B] -> pure gather). Returns [B, D]."""
    if offsets is None:
        sharded = lookup(table, ids)
        if sharded is not None:
            return sharded
        return torch.index_select(table, 0, ids.long())
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode {mode!r}; expected sum or mean")
    ids, offsets = ids.long(), offsets.long()
    out = F.embedding_bag(ids, table, offsets, mode="sum",
                          per_sample_weights=weights)
    if mode == "mean":
        ends = torch.cat([offsets[1:], offsets.new_tensor([ids.shape[0]])])
        cnt = (ends - offsets).to(out.dtype)
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out
