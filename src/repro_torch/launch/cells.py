"""Per-architecture cells: the LM, GNN and recsys cells' step functions.

A copy of the cell builders of ``repro.launch.cells`` (the LM family's,
the GNN dispatch ``_gnn_apply``, ``_gnn_init``, ``_gnn_cell_config``
and the GNN and recsys builders, each with its mesh layout). A
``CellPlan`` here holds the cell's step function, the model config it
runs at and ``init(generator, device=None) -> model``.

The LM, GNN and recsys builders take an optional ``mesh``
(``launch.mesh.Mesh`` or anything with ``axis_names`` and
``devices.shape``). Without one, the plan is the one-card step the
serving and training paths run. With one, it is the reference's plan on
that mesh: its ``meta`` (the config rewrite of the LM's context-parallel
train cell, ``mode``, ``probe_model``, ``probe_data`` and ``kv_len``;
the GNN and recsys cells' counts padded to the rank count), ``args``
(the step's inputs as meta tensors: the counterpart of the reference's
``ShapeDtypeStruct`` arguments) and ``specs`` (a spec per input leaf, in
the tuple form ``train.elastic`` takes: per dim ``None``, an axis name
or a tuple of names; the reference's ``PartitionSpec`` values).
``rank_step`` runs one rank's share of a GNN or recsys step on such a
plan.

- ``lm_param_specs``: the LM parameter tree's specs in the reference's
  four layouts, ``tp``, ``fsdp``, ``ep_fsdp`` and ``cp``;
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
  the retrieval scores of one query against the candidates
  (``dcn_param_specs``: its tables row-sharded on 'model');
- ``rank_step``: a GNN or DCN-v2 step as one rank of a mesh runs it, on
  its shards, through ``models.sharding``'s collectives;
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
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import ArchSpec, ShapeCell
from repro_torch.core.distributed import DistLPAWorkspace, dist_lpa_step
from repro_torch.graphs.sampler import tree_shape
from repro_torch.launch.mesh import all_axes, batch_axes
from repro_torch.models.gnn import (init_egnn, init_equiformer, init_mgn,
                                    init_pna)
from repro_torch.train.elastic import mesh_sizes
from repro_torch.train.steps import make_train_step
from repro_torch.models.sharding import current_graph
from repro_torch.tree import param_tree, tree_map

__all__ = ["CellPlan", "meta_tensor", "mesh_extents", "lm_param_specs",
           "build_lm_train", "build_lm_prefill", "decode_layout",
           "build_lm_decode",
           "_gnn_apply", "_gnn_init", "_gnn_cell_config", "build_gnn_cell",
           "build_gnn_sampled_cell", "flatten_trees", "dcn_param_specs",
           "build_recsys_cell", "rank_step", "lpa_dist_spec", "lpa_cell_engine",
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
    args: Optional[tuple] = None   # the cell's inputs on a mesh, on meta
    specs: Optional[tuple] = None  # a spec tree per input of ``args``


def _data_axes(mesh) -> Tuple[str, ...]:
    """FSDP axes: everything except 'model'."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _spec(*entries) -> tuple:
    """A spec in ``PartitionSpec``'s normal form: an entry that is a
    tuple of one axis is that axis, an empty tuple ``None``."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 None if e == () else e for e in entries)


def _leaves_with_names(tree, fn, name: str = ""):
    """``tree``'s structure with ``fn(name, leaf)`` at each leaf (``name``
    the key of the leaf, or of the list that holds it); a module is read
    as its ``param_tree``."""
    if isinstance(tree, torch.nn.Module):
        tree = param_tree(tree)
    if isinstance(tree, dict):
        return {k: _leaves_with_names(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves_with_names(v, fn, name) for v in tree]
    return fn(name, tree)


def lm_param_specs(cfg, params, mesh, mode: str = "tp") -> dict:
    """Specs for the LM param tree (``models.transformer.init_params``'
    paths and stacked shapes, or ``param_structs``), the reference's
    ``PartitionSpec`` of every leaf.

    mode:
      "tp"      — Megatron tensor parallel on 'model', replicated on data
                  axes (the paper-faithful baseline layout).
      "fsdp"    — ZeRO-3: every tensor sharded over ALL mesh axes
                  flattened, on its largest divisible dim. No TP: per-layer
                  param all-gathers are the only weight collectives.
      "ep_fsdp" — MoE: attention/lm_head TP on 'model' + FSDP on the data
                  axes; routed experts expert-parallel on 'model' with
                  their ff dim FSDP-sharded on the data axes.
      "cp"      — context parallel: weights 2-D sharded [data-dims x
                  model-dim] for storage (gathered per layer),
                  activations batch->data / sequence->model, experts EP
                  on 'model'. A single mesh axis per tensor dim
                  everywhere.
    """
    m = "model"
    sizes = mesh_sizes(mesh)
    dfs = _data_axes(mesh)
    dfs_extent = math.prod(sizes[a] for a in dfs)
    all_ax = tuple(mesh.axis_names)
    total = int(mesh.devices.size)
    msize = sizes.get("model", 1)
    dfs_one = dfs if len(dfs) > 1 else dfs[0] if dfs else ()

    def fsdp_spec(shape):
        # largest-last dim divisible by the full flatten, else by the data
        # flatten, else replicate
        for axes, extent in ((all_ax, total), (dfs, dfs_extent)):
            dims = sorted(range(len(shape)), key=lambda i: shape[i],
                          reverse=True)
            for i in dims:
                if shape[i] % extent == 0 and shape[i] >= extent:
                    spec = [None] * len(shape)
                    spec[i] = axes
                    return _spec(*spec)
        return _spec(*([None] * len(shape)))

    def with_dfs(spec_list, free_dim, size):
        """Add FSDP sharding on ``free_dim`` if it divides."""
        if dfs and size % dfs_extent == 0:
            spec_list[free_dim] = dfs_one
        return _spec(*spec_list)

    def cp_spec(shape):
        """2-D storage sharding: data axes on the largest divisible dim,
        'model' on the largest remaining divisible dim."""
        nd = len(shape)
        spec = [None] * nd
        dims = sorted(range(nd), key=lambda i: shape[i], reverse=True)
        used = -1
        for i in dims:
            if shape[i] % dfs_extent == 0 and shape[i] >= dfs_extent:
                spec[i] = dfs_one
                used = i
                break
        for i in dims:
            if i != used and shape[i] % msize == 0 and shape[i] >= msize:
                spec[i] = m
                break
        return _spec(*spec)

    def spec_for(name, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if mode == "fsdp":
            return fsdp_spec(shape)
        if mode == "cp":
            # vocab-carrying tensors: V must land on 'model'
            if name == "lm_head" and shape[1] % msize == 0:
                return _spec(None, m)
            if name == "embed" and shape[0] % msize == 0:
                return _spec(m, None)
            # routed experts: the reference's shard_map EP layouts
            if nd == 4 and name in ("w_gate", "w_up"):
                return _spec(None, m, None, dfs_one)
            if nd == 4 and name == "w_down":
                return _spec(None, m, dfs_one, None)
            # shared experts: storage on the data axes only
            if name in ("shared_gate", "shared_up", "shared_down"):
                spec = [None] * nd
                dims = sorted(range(nd), key=lambda i: shape[i],
                              reverse=True)
                for i in dims:
                    if shape[i] % dfs_extent == 0:
                        spec[i] = dfs_one
                        break
                return _spec(*spec)
            return cp_spec(shape)
        col = {"wq", "wk", "wv", "w_gate", "w_up", "w_uk", "w_uv", "w_dkv"}
        row = {"wo", "w_down"}
        fsdp_on = mode == "ep_fsdp"
        if name in ("shared_gate", "shared_up", "shared_down"):
            # shared experts: no TP (the model axis is busy with S) — pure
            # FSDP storage
            return fsdp_spec(shape) if fsdp_on else (
                _spec(None, None, m) if name != "shared_down"
                else _spec(None, m, None))
        if name == "embed":
            sl = [m, None]
            return with_dfs(sl, 1, shape[1]) if fsdp_on else _spec(*sl)
        if name == "lm_head":
            sl = [None, m]
            return with_dfs(sl, 0, shape[0]) if fsdp_on else _spec(*sl)
        if name in col:
            # [L, d, out] (dense/stacked) or [L, E, d, f] (moe experts)
            if nd == 4:
                sl = [None, m, None, None]  # expert parallel on E
                return with_dfs(sl, 3, shape[3]) if fsdp_on else _spec(*sl)
            sl = [None, None, m]
            return with_dfs(sl, 1, shape[1]) if fsdp_on else _spec(*sl)
        if name in row:
            if nd == 4:
                sl = [None, m, None, None]
                return with_dfs(sl, 2, shape[2]) if fsdp_on else _spec(*sl)
            sl = [None, m, None]
            return with_dfs(sl, 2, shape[2]) if fsdp_on else _spec(*sl)
        return _spec(*([None] * nd))  # norms, router, small projections

    return _leaves_with_names(params, spec_for)


def _best_batch_axes(mesh, b: int) -> Tuple[str, ...]:
    """Longest prefix-flatten of the mesh axes that divides the batch."""
    sizes = mesh_sizes(mesh)
    axes = tuple(mesh.axis_names)
    for end in range(len(axes), 0, -1):
        if b % math.prod(sizes[a] for a in axes[:end]) == 0:
            return axes[:end]
    return ()


def meta_tensor(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on meta: shapes only, nothing
    allocated."""
    return torch.empty(shape, dtype=dtype, device="meta")


def mesh_extents(mesh) -> Tuple[int, int]:
    """(data extent, model extent): the ranks of the batch axes and of
    'model' (1 where the mesh has none)."""
    sizes = mesh_sizes(mesh)
    return (math.prod(sizes[a] for a in batch_axes(mesh)),
            sizes.get("model", 1))


def _opt_state(params: dict, pspecs) -> tuple:
    """AdamW's state of ``params`` on meta and its specs: the moments
    shaped and sharded like the parameters, ``step`` replicated."""
    opt = {"m": tree_map(lambda t: meta_tensor(t.shape, t.dtype), params),
           "v": tree_map(lambda t: meta_tensor(t.shape, t.dtype), params),
           "step": meta_tensor((), torch.int32)}
    return opt, {"m": pspecs, "v": pspecs, "step": ()}


def _meta_params(init) -> dict:
    """``init``'s parameter tree on meta: nothing drawn or allocated."""
    return param_tree(init(torch.Generator(), device="meta"))


def _pad_to(n: int, p: int) -> int:
    return -(-n // p) * p


def _lm_meta(cfg, cell: ShapeCell, kind: str) -> dict:
    b, s = cell.params["batch"], cell.params["seq"]
    return {"kind": kind, "tokens": b if kind == "decode" else b * s,
            "layers": cfg.n_layers, "batch": b, "seq": s}


def _lm_train_mode(cfg, mesh):
    """The reference's train layout on ``mesh``: ``(mode, cfg, tok_spec,
    probe_model, probe_data)``. Dense and MoE LMs both run context
    parallel (``cp``: tokens batch on the data axes, sequence on 'model';
    the config rewritten to direct attention over an S-sharded residual
    stream, MoE dispatch in groups of the model extent) unless
    ``sp_mode == "none"``, which runs Megatron TP
    (``tp``). The reference's cp MoE also takes the mesh for its
    shard_map expert-parallel path (``ep_mesh``); a rank's local step is
    the same expert einsums, so the port leaves it unset."""
    data_extent, mext = mesh_extents(mesh)
    ba = batch_axes(mesh)
    if cfg.sp_mode == "none":
        return "tp", cfg, _spec(ba, None), mext, data_extent
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_groups=mext, hint_batch_axes=ba,
            hint_expert_axis="model"))
    cfg = dataclasses.replace(
        cfg, hint_batch_axes=ba, hint_model_axis="model",
        hint_model_extent=mext, seq_shard=True, attn_mode="direct")
    # tokens shard over (batch axes x model): per-chip flops match a
    # probe at (model=1, data = data extent x model extent)
    return "cp", cfg, _spec(ba, "model"), 1, data_extent * mext


def build_lm_train(spec: ArchSpec, cell: ShapeCell, mesh=None) -> CellPlan:
    """Train-step cell: step(model, opt_state, batch) -> (model,
    opt_state, metrics) on ``{"tokens", "targets"}`` [B, S] batches. On
    a mesh, the reference's layout (``_lm_train_mode``): params and the
    AdamW moments by ``lm_param_specs`` of the mode, ``step`` replicated,
    tokens and targets by the mode's token spec."""
    from repro_torch.models.transformer import (init_params, loss_fn,
                                                param_structs)
    cfg = spec.config
    meta = _lm_meta(cfg, cell, "train")
    if mesh is not None:
        mode, cfg, tok_spec, probe_model, probe_data = _lm_train_mode(
            cfg, mesh)
        meta.update(mode=mode, probe_model=probe_model,
                    probe_data=probe_data)

    def loss(params, batch):
        return loss_fn(params, batch["tokens"], batch["targets"], cfg)

    _, step = make_train_step(loss)
    plan = CellPlan(fn=step, config=cfg,
                    init=functools.partial(init_params, cfg=cfg),
                    meta=meta, loss=loss)
    if mesh is not None:
        b, s = meta["batch"], meta["seq"]
        params = param_structs(cfg)
        batch = {"tokens": meta_tensor((b, s), torch.int32),
                 "targets": meta_tensor((b, s), torch.int32)}
        pspecs = lm_param_specs(cfg, params, mesh, mode)
        opt, ospecs = _opt_state(params, pspecs)
        plan.args = (params, opt, batch)
        plan.specs = (pspecs, ospecs,
                      {"tokens": tok_spec, "targets": tok_spec})
    return plan


def build_lm_prefill(spec: ArchSpec, cell: ShapeCell, mesh=None
                     ) -> CellPlan:
    """Prefill cell: fn(model, tokens [B, S]) -> logits [B, V] of the
    last position. On a mesh: TP params, tokens batch on the data axes."""
    from repro_torch.models.transformer import (forward, init_params,
                                                param_structs)
    cfg = spec.config

    def prefill(params, tokens):
        h = forward(params, tokens, cfg)
        return torch.einsum("bd,dv->bv", h[:, -1],
                            params["lm_head"].to(h.dtype))

    plan = CellPlan(fn=prefill, config=cfg,
                    init=functools.partial(init_params, cfg=cfg),
                    meta=_lm_meta(cfg, cell, "prefill"))
    if mesh is not None:
        b, s = plan.meta["batch"], plan.meta["seq"]
        params = param_structs(cfg)
        plan.meta["mode"] = "tp"
        plan.args = (params, meta_tensor((b, s), torch.int32))
        plan.specs = (lm_param_specs(cfg, params, mesh, "tp"),
                      _spec(batch_axes(mesh), None))
    return plan


def decode_layout(mesh, batch: int) -> tuple:
    """The reference's decode layout: ``(batch axes, sequence axes,
    token spec)`` of the KV cache. The batch on the data axes and the
    sequence split on 'model' (split-KV, flash-decoding: the softmax
    partials all-reduce over 'model'); where the batch does not divide
    the data extent (``long_500k``'s batch of 1), the batch replicates
    and the KV sequence shards over all mesh axes."""
    ba = batch_axes(mesh)
    if batch % mesh_extents(mesh)[0] == 0:
        return ba, "model", _spec(ba)
    return None, all_axes(mesh), ()


def build_lm_decode(spec: ArchSpec, cell: ShapeCell, mesh=None
                    ) -> CellPlan:
    """Decode cell: fn(model, cache, tokens [B], cur_len [B]) ->
    (logits [B, V], cache), the cache ``init_cache(cfg, B, S)``. On a
    mesh: TP params and the split-KV cache of ``decode_layout``."""
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params, param_structs)
    cfg = spec.config

    def serve_step(params, cache, tokens, cur_len):
        return decode_step(params, cache, tokens, cur_len, cfg)

    meta = _lm_meta(cfg, cell, "decode")
    meta["kv_len"] = cell.params["seq"]
    plan = CellPlan(fn=serve_step, config=cfg,
                    init=functools.partial(init_params, cfg=cfg), meta=meta)
    if mesh is not None:
        b, s = meta["batch"], meta["seq"]
        params = param_structs(cfg)
        cache = init_cache(cfg, b, s, device="meta")
        b_ax, s_ax, tok_spec = decode_layout(mesh, b)
        nd = next(iter(cache.values())).dim()
        cspecs = {name: _spec(None, b_ax, s_ax, *([None] * (nd - 3)))
                  for name in cache}
        meta["mode"] = "tp"
        plan.args = (params, cache, meta_tensor((b,), torch.int32),
                     meta_tensor((b,), torch.int32))
        plan.specs = (lm_param_specs(cfg, params, mesh, "tp"), cspecs,
                      tok_spec, tok_spec)
    return plan


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


def build_gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                   n_classes: int = 16) -> CellPlan:
    """The full-graph train step of ``spec.config`` at the cell's width
    (a ``gnn_sampled`` cell goes to ``build_gnn_sampled_cell``).

    On a mesh, the reference's layout: ``n`` and ``e`` padded up to a
    multiple of the rank count, every node and edge array sharded over
    the flattened mesh (its leading dim), parameters and AdamW state
    replicated. A rank runs its N/P nodes and E/P edges against the
    node tables the all-gathers make whole (``rank_step``)."""
    if cell.kind == "gnn_sampled":
        return build_gnn_sampled_cell(spec, cell, mesh, n_classes)
    cfg = _gnn_cell_config(spec, cell.params["d_feat"], n_classes)
    apply_fn = _gnn_apply(spec, cfg)

    def loss(model, batch):
        ce = _cross_entropy(apply_fn(model, batch), batch["labels"])
        shard = current_graph()
        if shard is not None:
            # this rank's share: the ranks' mean is the whole graph's loss
            w = (batch["seed_mask"].to(torch.float32) if "seed_mask" in batch
                 else torch.ones_like(ce))
            total = shard.comm.all_reduce(torch.sum(w).reshape(1), "sum")
            return (shard.world * torch.sum(ce * w)
                    / torch.clamp_min(total[0], 1.0))
        if "seed_mask" in batch:
            w = batch["seed_mask"].to(torch.float32)
            return torch.sum(ce * w) / torch.clamp_min(torch.sum(w), 1.0)
        return torch.mean(ce)

    _, step = make_train_step(loss)
    n, e = cell.params["n_nodes"], cell.params["n_edges"]
    plan = CellPlan(fn=step, config=cfg, init=_gnn_init(spec, cfg),
                    meta={"kind": "gnn_train", "n_nodes": n, "n_edges": e},
                    loss=loss)
    if mesh is not None:
        p = int(mesh.devices.size)
        n, e = _pad_to(n, p), _pad_to(e, p)
        plan.meta.update(n_nodes=n, n_edges=e)
        _gnn_mesh_plan(plan, spec, mesh, (n,), (e,), cell.params["d_feat"])
    return plan


def _gnn_mesh_plan(plan: CellPlan, spec: ArchSpec, mesh, nodes: tuple,
                   edges: tuple, d_feat: int) -> None:
    """Set ``plan.args`` and ``plan.specs`` to the reference's GNN layout
    on ``mesh``: node arrays of leading shape ``nodes`` and edge arrays of
    ``edges``, each sharded on its first dim over the flattened mesh; the
    parameters and AdamW state replicated."""
    f32, i32 = torch.float32, torch.int32
    batch = {"node_feat": meta_tensor(nodes + (d_feat,), f32),
             "labels": meta_tensor(nodes, i32),
             "edge_src": meta_tensor(edges, i32),
             "edge_dst": meta_tensor(edges, i32)}
    if spec.arch_id in ("egnn", "equiformer-v2"):
        batch["coords"] = meta_tensor(nodes + (3,), f32)
    if spec.arch_id == "meshgraphnet":
        batch["edge_feat"] = meta_tensor(edges + (4,), f32)
    params = _meta_params(plan.init)
    pspecs = tree_map(lambda _: (), params)
    opt, ospecs = _opt_state(params, pspecs)
    fa = all_axes(mesh)
    plan.args = (params, opt, batch)
    plan.specs = (pspecs, ospecs, {k: _spec(fa, *([None] * (t.dim() - 1)))
                                   for k, t in batch.items()})


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


def build_gnn_sampled_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                           n_classes: int = 16) -> CellPlan:
    """``minibatch_lg`` in the tree layout: the train step of
    ``spec.config`` on [B, v_t, ...] tree batches.

    On a mesh, the reference's layout: ``B`` padded up to a multiple of
    the rank count and the trees sharded over the flattened mesh,
    parameters and AdamW state replicated. The trees are independent, so
    a rank trains on its B/P and the gradient all-reduce is the step's
    one collective (``rank_step``)."""
    b = cell.params["batch_nodes"]
    v_t, e_t = tree_shape(cell.params["fanouts"])
    d_feat = cell.params.get("d_feat", 602)
    cfg = _gnn_cell_config(spec, d_feat, n_classes)
    apply_fn = _gnn_apply(spec, cfg)

    def loss(model, batch):
        trees, v = batch["labels"].shape
        out = apply_fn(model, flatten_trees(batch))
        seed_logits = out.reshape(trees, v, -1)[:, 0]  # seed: local index 0
        return torch.mean(_cross_entropy(seed_logits, batch["labels"][:, 0]))

    _, step = make_train_step(loss)
    plan = CellPlan(fn=step, config=cfg, init=_gnn_init(spec, cfg),
                    meta={"kind": "gnn_train", "n_nodes": b * v_t,
                          "n_edges": b * e_t, "layout": "tree"}, loss=loss)
    if mesh is not None:
        b = _pad_to(b, int(mesh.devices.size))
        plan.meta.update(n_nodes=b * v_t, n_edges=b * e_t)
        _gnn_mesh_plan(plan, spec, mesh, (b, v_t), (b, e_t), d_feat)
    return plan


def dcn_param_specs(params: dict) -> dict:
    """The reference's DCN-v2 layout: every ``table_*`` row-sharded on
    'model', every other leaf replicated."""
    def spec_for(name, leaf):
        if name.startswith("table_"):
            return _spec("model", None)
        return _spec(*([None] * leaf.dim()))

    return _leaves_with_names(params, spec_for)


def build_recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh=None
                      ) -> CellPlan:
    """DCN-v2 at ``spec.config``: ``recsys_train`` -> step(model, opt,
    batch); ``recsys_serve`` -> fn(model, dense, sparse) logits;
    ``retrieval`` -> fn(model, dense, sparse, cand_emb) scores.

    On a mesh, the reference's layout (``dcn_param_specs``; the AdamW
    moments as the parameters): train and serve shard the batch over the
    batch axes; retrieval pads the candidates up to a multiple of the
    rank count and shards them over every axis, the query replicated."""
    from repro_torch.models.recsys.dcn_v2 import (dcn_forward, dcn_loss,
                                                  dcn_retrieval_scores,
                                                  init_dcn)
    cfg = spec.config
    init = functools.partial(init_dcn, cfg=cfg)
    b = cell.params["batch"]
    meta = {"kind": cell.kind, "batch": b}
    if cell.kind == "recsys_train":
        def loss(model, batch):
            return dcn_loss(model, batch["dense"], batch["sparse"],
                            batch["labels"], cfg)

        _, step = make_train_step(loss)
        plan = CellPlan(fn=step, config=cfg, init=init, meta=meta, loss=loss)
    elif cell.kind == "recsys_serve":
        def serve(model, dense, sparse):
            return dcn_forward(model, dense, sparse, cfg)

        plan = CellPlan(fn=serve, config=cfg, init=init, meta=meta)
    else:
        def retrieve(model, dense, sparse, cand_emb):
            return dcn_retrieval_scores(model, dense, sparse, cand_emb, cfg)

        meta["candidates"] = cell.params["n_candidates"]
        plan = CellPlan(fn=retrieve, config=cfg, init=init, meta=meta)
    if mesh is None:
        return plan
    ba = batch_axes(mesh)
    params = _meta_params(init)
    pspecs = dcn_param_specs(params)
    dense = meta_tensor((b, cfg.n_dense), torch.float32)
    sparse = meta_tensor((b, cfg.n_sparse), torch.int32)
    if cell.kind == "recsys_train":
        opt, ospecs = _opt_state(params, pspecs)
        plan.args = (params, opt, {"dense": dense, "sparse": sparse,
                                   "labels": meta_tensor((b,), torch.float32)})
        plan.specs = (pspecs, ospecs, {"dense": _spec(ba, None),
                                       "sparse": _spec(ba, None),
                                       "labels": _spec(ba)})
    elif cell.kind == "recsys_serve":
        plan.args = (params, dense, sparse)
        plan.specs = (pspecs, _spec(ba, None), _spec(ba, None))
    else:
        nc = _pad_to(cell.params["n_candidates"], int(mesh.devices.size))
        plan.meta = {"kind": "retrieval", "candidates": nc}
        d_q = cfg.d_interact + cfg.mlp_dims[-1]
        plan.args = (params, dense, sparse,
                     meta_tensor((nc, d_q), torch.float32))
        plan.specs = (pspecs, _spec(None, None), _spec(None, None),
                      _spec(all_axes(mesh), None))
    return plan


def rank_step(plan: CellPlan, mesh, comms: Optional[dict] = None,
              index: Optional[dict] = None) -> Callable:
    """A GNN or DCN-v2 cell's step as one rank of ``mesh`` runs it, on
    that rank's shards of ``plan.args`` (``train.elastic.shard_shape``
    under ``plan.specs``), with the same signature as ``plan.fn``.

    ``comms`` holds the collectives' groups: ``"all"`` (every rank: a
    GNN's node tables and segment sums, and its gradient mean),
    ``"model"`` (DCN-v2's table lookups) and ``"data"`` (DCN-v2's
    gradient mean); a group missing, or of one rank, has no collective.
    The default is a ``models.sharding.MetaComm`` of each group's extent
    (the dry run on meta tensors). ``index["model"]`` is the rank's place
    in its "model" group (default 0). On one rank this is ``plan.fn``.

      * full graph: the rank's N/P nodes and E/P edges inside
        ``models.sharding.graph_shard`` (its loss the rank's share, scaled
        so that the ranks' mean is the graph's), the data-parallel step of
        ``train.steps.make_dp_train_step`` (float32 gradient mean);
      * tree layout: the rank's B/P trees, the same data-parallel step;
      * DCN-v2: the lookups inside ``models.sharding.table_shard``; train
        adds the gradient mean over "data". AdamW's clip norm is taken
        over the rank's table rows (the reference all-reduces the tables'
        squared norms over 'model', one scalar a table).
    """
    from repro_torch.models.sharding import (MetaComm, graph_shard,
                                             table_shard)
    from repro_torch.train.steps import make_dp_train_step
    if mesh.devices.size == 1:
        return plan.fn
    data_extent, model_extent = mesh_extents(mesh)
    extents = {"all": int(mesh.devices.size), "data": data_extent,
               "model": model_extent}
    comms = {k: MetaComm(v) for k, v in extents.items()} if comms is None \
        else comms
    comm = {k: comms.get(k) if extents[k] > 1 else None for k in extents}
    if plan.meta["kind"] == "gnn_train":
        _, dp_step = make_dp_train_step(plan.loss, comm["all"],
                                        compress=False)

        def gnn_step(model, opt, batch):
            if plan.meta.get("layout") == "tree":
                params, opt, _, metrics = dp_step(model, opt, None, batch)
                return params, opt, metrics
            with graph_shard(comm["all"], plan.meta["n_nodes"]):
                params, opt, _, metrics = dp_step(model, opt, None, batch)
            return params, opt, metrics

        return gnn_step
    place = (index or {}).get("model", 0) if model_extent > 1 else 0
    if plan.meta["kind"] == "recsys_train" and comm["data"] is not None:
        _, dp_step = make_dp_train_step(plan.loss, comm["data"],
                                        compress=False)
    else:
        dp_step = None

    def dcn_step(*args):
        with table_shard(comm["model"], place, model_extent):
            if dp_step is None:
                return plan.fn(*args)
            params, opt, _, metrics = dp_step(args[0], args[1], None, args[2])
            return params, opt, metrics

    return dcn_step


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
        nbr_pos=meta_tensor((n_shards, m_pad), torch.int32),
        weights=meta_tensor((n_shards, m_pad), torch.float32),
        n_rounds=len(rounds),
        round_gathers=tuple(meta_tensor((n_shards, r, chunk), torch.int32)
                            for r, _ in rounds),
        final_row_vertex=meta_tensor((n_shards, rounds[-1][0]), torch.int32),
        init_labels=meta_tensor((n_shards, v_pad), torch.int32),
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
            ws, send_idx=meta_tensor((n_shards, n_shards, h_pad), torch.int32),
            h_pad=h_pad, hub_idx=meta_tensor((n_shards, hub_pad), torch.int32),
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
    """The cell's plan; an LPA cell takes its rank count after ``cell``,
    an LM, GNN or recsys cell an optional mesh."""
    return BUILDERS[cell.kind](spec, cell, *args)
