"""Per-architecture cells: the LM, GNN and recsys cells' step functions.

A copy of the cell builders of ``repro.launch.cells`` (the LM family's,
the GNN dispatch ``_gnn_apply``, ``_gnn_init``, ``_gnn_cell_config`` and
the GNN and recsys builders). A ``CellPlan`` here holds the cell's step
function, the model config it runs at and ``init(generator,
device=None) -> model``. The reference's plans also carry abstract
inputs, XLA shardings and the context-parallel hints of its dry runs;
one card holds everything, so those are not ported.

- ``build_lm_train``: the loss-and-AdamW train step of the arch's config
  on ``{"tokens", "targets"}`` batches;
- ``build_lm_prefill``: the forward, then the logits of the last
  position only (next-token sampling);
- ``build_lm_decode``: ``decode_step`` against a cache of the cell's
  length (``models.transformer.init_cache``), which it updates in place;

- ``build_gnn_cell``: the full-graph train step (mean cross-entropy,
  weighted by ``seed_mask`` when the batch has one);
- ``build_gnn_sampled_cell``: the ``minibatch_lg`` train step on the tree
  layout ([B, v_t, ...], ``data.synthetic.gnn_tree_batch``): the
  cross-entropy at each tree's node 0, averaged over the trees. The
  reference maps the model over the trees (``jax.vmap``); here the trees
  run as one block-diagonal graph whose tree t takes ids [t v_t, (t+1)
  v_t), and an edge at a tree's dump row v_t goes to the flat batch's
  dump row B v_t (not t v_t + v_t, the next tree's seed);
- ``build_recsys_cell``: DCN-v2's train step, its serving forward, and
  the retrieval scores of one query against the candidates;
- ``build_lpa_cell``: the paper's own cells (``configs/lpa_graphs.py``),
  distributed LPA on ``n_shards`` ranks: the workspace of
  ``lpa_dist_spec`` as meta tensors (shapes and dtypes, nothing
  allocated: the counterpart of the reference's ``ShapeDtypeStruct`` values)
  and the step builder of ``core.distributed``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.registry import ArchSpec, ShapeCell
from repro_torch.core.distributed import DistLPAWorkspace, dist_lpa_step
from repro_torch.graphs.sampler import tree_shape
from repro_torch.models.gnn import (init_egnn, init_equiformer, init_mgn,
                                    init_pna)
from repro_torch.train.steps import make_train_step

__all__ = ["CellPlan", "build_lm_train", "build_lm_prefill",
           "build_lm_decode", "_gnn_apply", "_gnn_init", "_gnn_cell_config",
           "build_gnn_cell", "build_gnn_sampled_cell", "flatten_trees",
           "build_recsys_cell", "lpa_dist_spec", "lpa_cell_engine",
           "build_lpa_cell", "build_cell"]

#: ``init_*(generator, cfg, device=None)`` by arch id
_INIT = {"pna": init_pna, "meshgraphnet": init_mgn, "egnn": init_egnn,
         "equiformer-v2": init_equiformer}


@dataclasses.dataclass
class CellPlan:
    fn: Callable       # the cell's step: train step, forward or LPA step
    config: Any        # the model config the cell runs at
    init: Optional[Callable]  # init(generator, device=None) -> model
                              # (None: an LPA cell has no model)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    loss: Optional[Callable] = None  # a train cell's loss(model, batch)
    workspace: Optional[DistLPAWorkspace] = None  # an LPA cell's, on meta


def _lm_meta(cfg, cell: ShapeCell, kind: str) -> dict:
    b, s = cell.params["batch"], cell.params["seq"]
    return {"kind": kind, "tokens": b if kind == "decode" else b * s,
            "layers": cfg.n_layers, "batch": b, "seq": s}


def build_lm_train(spec: ArchSpec, cell: ShapeCell) -> CellPlan:
    """Train-step cell: step(model, opt_state, batch) -> (model,
    opt_state, metrics) on ``{"tokens", "targets"}`` [B, S] batches."""
    from repro_torch.models.transformer import init_params, loss_fn
    cfg = spec.config

    def loss(params, batch):
        return loss_fn(params, batch["tokens"], batch["targets"], cfg)

    _, step = make_train_step(loss)
    return CellPlan(fn=step, config=cfg,
                    init=functools.partial(init_params, cfg=cfg),
                    meta=_lm_meta(cfg, cell, "train"), loss=loss)


def build_lm_prefill(spec: ArchSpec, cell: ShapeCell) -> CellPlan:
    """Prefill cell: fn(model, tokens [B, S]) -> logits [B, V] of the
    last position."""
    from repro_torch.models.transformer import forward, init_params
    cfg = spec.config

    def prefill(params, tokens):
        h = forward(params, tokens, cfg)
        return torch.einsum("bd,dv->bv", h[:, -1],
                            params["lm_head"].to(h.dtype))

    return CellPlan(fn=prefill, config=cfg,
                    init=functools.partial(init_params, cfg=cfg),
                    meta=_lm_meta(cfg, cell, "prefill"))


def build_lm_decode(spec: ArchSpec, cell: ShapeCell) -> CellPlan:
    """Decode cell: fn(model, cache, tokens [B], cur_len [B]) ->
    (logits [B, V], cache), the cache ``init_cache(cfg, B, S)``."""
    from repro_torch.models.transformer import decode_step, init_params
    cfg = spec.config

    def serve_step(params, cache, tokens, cur_len):
        return decode_step(params, cache, tokens, cur_len, cfg)

    meta = _lm_meta(cfg, cell, "decode")
    meta["kv_len"] = cell.params["seq"]
    return CellPlan(fn=serve_step, config=cfg,
                    init=functools.partial(init_params, cfg=cfg), meta=meta)


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


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Per-row logsumexp(logits) - logits[label], in float32."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def build_gnn_cell(spec: ArchSpec, cell: ShapeCell,
                   n_classes: int = 16) -> CellPlan:
    """The full-graph train step of ``spec.config`` at the cell's width
    (a ``gnn_sampled`` cell goes to ``build_gnn_sampled_cell``)."""
    if cell.kind == "gnn_sampled":
        return build_gnn_sampled_cell(spec, cell, n_classes)
    cfg = _gnn_cell_config(spec, cell.params["d_feat"], n_classes)
    apply_fn = _gnn_apply(spec, cfg)

    def loss(model, batch):
        ce = _cross_entropy(apply_fn(model, batch), batch["labels"])
        if "seed_mask" in batch:
            w = batch["seed_mask"].to(torch.float32)
            return torch.sum(ce * w) / torch.clamp_min(torch.sum(w), 1.0)
        return torch.mean(ce)

    _, step = make_train_step(loss)
    return CellPlan(fn=step, config=cfg, init=_gnn_init(spec, cfg),
                    meta={"kind": "gnn_train",
                          "n_nodes": cell.params["n_nodes"],
                          "n_edges": cell.params["n_edges"]}, loss=loss)


def flatten_trees(batch: dict) -> dict:
    """A tree-layout batch ([B, v_t, ...] nodes, [B, e_t] local edges) as
    one block-diagonal graph of B v_t nodes; edges at a tree's dump row
    v_t go to the flat dump row B v_t."""
    b, v_t = batch["labels"].shape
    n = b * v_t
    offset = (torch.arange(b, device=batch["labels"].device) * v_t)[:, None]

    def edges(local):
        local = local.long()
        return torch.where(local >= v_t, n, local + offset).reshape(-1)

    flat = {"node_feat": batch["node_feat"].reshape(n, -1),
            "labels": batch["labels"].reshape(n),
            "edge_src": edges(batch["edge_src"]),
            "edge_dst": edges(batch["edge_dst"])}
    if "coords" in batch:
        flat["coords"] = batch["coords"].reshape(n, 3)
    if "edge_feat" in batch:
        flat["edge_feat"] = batch["edge_feat"].reshape(
            -1, batch["edge_feat"].shape[-1])
    return flat


def build_gnn_sampled_cell(spec: ArchSpec, cell: ShapeCell,
                           n_classes: int = 16) -> CellPlan:
    """``minibatch_lg`` in the tree layout: the train step of
    ``spec.config`` on [B, v_t, ...] tree batches."""
    b = cell.params["batch_nodes"]
    v_t, e_t = tree_shape(cell.params["fanouts"])
    cfg = _gnn_cell_config(spec, cell.params.get("d_feat", 602), n_classes)
    apply_fn = _gnn_apply(spec, cfg)

    def loss(model, batch):
        trees, v = batch["labels"].shape
        out = apply_fn(model, flatten_trees(batch))
        seed_logits = out.reshape(trees, v, -1)[:, 0]  # seed: local index 0
        return torch.mean(_cross_entropy(seed_logits, batch["labels"][:, 0]))

    _, step = make_train_step(loss)
    return CellPlan(fn=step, config=cfg, init=_gnn_init(spec, cfg),
                    meta={"kind": "gnn_train", "n_nodes": b * v_t,
                          "n_edges": b * e_t, "layout": "tree"}, loss=loss)


def build_recsys_cell(spec: ArchSpec, cell: ShapeCell) -> CellPlan:
    """DCN-v2 at ``spec.config``: ``recsys_train`` -> step(model, opt,
    batch); ``recsys_serve`` -> fn(model, dense, sparse) logits;
    ``retrieval`` -> fn(model, dense, sparse, cand_emb) scores."""
    from repro_torch.models.recsys.dcn_v2 import (dcn_forward, dcn_loss,
                                                  dcn_retrieval_scores,
                                                  init_dcn)
    cfg = spec.config
    init = functools.partial(init_dcn, cfg=cfg)
    meta = {"kind": cell.kind, "batch": cell.params["batch"]}
    if cell.kind == "recsys_train":
        def loss(model, batch):
            return dcn_loss(model, batch["dense"], batch["sparse"],
                            batch["labels"], cfg)

        _, step = make_train_step(loss)
        return CellPlan(fn=step, config=cfg, init=init, meta=meta, loss=loss)
    if cell.kind == "recsys_serve":
        def serve(model, dense, sparse):
            return dcn_forward(model, dense, sparse, cfg)

        return CellPlan(fn=serve, config=cfg, init=init, meta=meta)

    def retrieve(model, dense, sparse, cand_emb):
        return dcn_retrieval_scores(model, dense, sparse, cand_emb, cfg)

    meta["candidates"] = cell.params["n_candidates"]
    return CellPlan(fn=retrieve, config=cfg, init=init, meta=meta)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def lpa_dist_spec(n_nodes: int, n_edges: int, n_shards: int, k: int,
                  chunk: int, frac_high: float = 0.3) -> DistLPAWorkspace:
    """Analytic workspace for a production-scale graph, every array a
    meta tensor (plan shapes depend only on the degree structure; we
    assume a power-law with ``frac_high`` of edges on high-degree rows).
    The reference's round loop line for line: its shapes and dtypes, the
    bucketed layout (``round_gathers``) of the reference's cell step."""
    v_pad = math.ceil(n_nodes / n_shards)
    m_pad = math.ceil(n_edges / n_shards)
    rounds = []
    rows = v_pad + math.ceil(m_pad * frac_high / chunk)
    entries = m_pad
    while True:
        rounds.append((rows, chunk))
        nxt_entries = rows * k
        nxt_rows = v_pad + math.ceil(nxt_entries * frac_high / chunk)
        if nxt_entries <= v_pad * k * 1.05 or len(rounds) > 6:
            break
        rows, entries = nxt_rows, nxt_entries
    return DistLPAWorkspace(
        nbr_pos=_meta((n_shards, m_pad), torch.int32),
        weights=_meta((n_shards, m_pad), torch.float32),
        n_rounds=len(rounds),
        round_gathers=tuple(_meta((n_shards, r, chunk), torch.int32)
                            for r, _ in rounds),
        final_row_vertex=_meta((n_shards, rounds[-1][0]), torch.int32),
        init_labels=_meta((n_shards, v_pad), torch.int32),
        n_nodes=n_nodes, v_pad=v_pad, k=k, chunk=chunk)


def lpa_cell_engine(ws: DistLPAWorkspace) -> str:
    """The fold engine an LPA cell's step runs on ``ws``: the fused
    kernel (K1) where the fused layout is built, else the tile kernel
    (K9) on the bucketed round gathers."""
    return "pallas_fused" if ws.fused_starts is not None else "pallas"


def build_lpa_cell(spec: ArchSpec, cell: ShapeCell,
                   n_shards: int = 1) -> CellPlan:
    """The paper's cell on ``n_shards`` ranks.

    ``workspace`` is ``lpa_dist_spec``'s at the cell's sizes, with the
    halo exchange's tables where the cell asks for them (the reference's
    boundary fraction and hub density, per cell). ``fn(comm, ws, **kw)``
    builds a rank's step over a workspace of that layout (the spec's, or
    one ``build_dist_workspace`` builds from a graph): ``dist_lpa_step``
    with the config's method. The reference's cell step folds with the
    plain fold (``dist_lpa_step(mesh, ws)``'s default engine); here the
    step runs a hand-written kernel on the card, never the plain fold:
    ``engine="pallas"`` (K9) on the bucketed layout the spec gives, and
    ``engine="pallas_fused"`` (K1) where the fused layout is built
    (``lpa_cell_engine``). ``kw`` goes to ``dist_lpa_step`` (a
    ``fold_tile`` that records K9's launches, say).
    """
    cfg = spec.config
    halo = bool(cell.params.get("halo", False))
    ws = lpa_dist_spec(cell.params["n_nodes"], cell.params["n_edges"],
                       n_shards, cfg.lpa.k, cfg.lpa.chunk,
                       cfg.frac_high_degree_edges)
    if halo:
        # beyond-paper label exchange: boundary fraction and hub density
        # parameterised per cell, as the reference's cells give them
        h_pad = math.ceil(ws.v_pad * cell.params.get("halo_frac", 0.25)
                          / n_shards) * 8
        hub_pad = max(1, math.ceil(cell.params.get("hub_frac", 0.002)
                                   * ws.v_pad))
        ws = dataclasses.replace(
            ws, send_idx=_meta((n_shards, n_shards, h_pad), torch.int32),
            h_pad=h_pad, hub_idx=_meta((n_shards, hub_pad), torch.int32),
            hub_pad=hub_pad)

    def step(comm, rank_ws: DistLPAWorkspace, **kw):
        return dist_lpa_step(comm, rank_ws, engine=lpa_cell_engine(rank_ws),
                             method=cfg.lpa.method, rescan=cfg.lpa.rescan,
                             **kw)

    return CellPlan(fn=step, config=cfg, init=None, workspace=ws,
                    meta={"kind": "lpa", "n_nodes": cell.params["n_nodes"],
                          "n_edges": cell.params["n_edges"],
                          "n_rounds": ws.n_rounds, "halo": halo})


BUILDERS = {
    "train": build_lm_train,
    "prefill": build_lm_prefill,
    "decode": build_lm_decode,
    "gnn_full": build_gnn_cell,
    "gnn_sampled": build_gnn_cell,
    "recsys_train": build_recsys_cell,
    "recsys_serve": build_recsys_cell,
    "retrieval": build_recsys_cell,
    "lpa": build_lpa_cell,
}


def build_cell(spec: ArchSpec, cell: ShapeCell, *args) -> CellPlan:
    """The cell's plan; an LPA cell takes its rank count after ``cell``."""
    return BUILDERS[cell.kind](spec, cell, *args)
