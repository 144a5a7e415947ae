"""Per-rank FLOP and byte probes of the LM cells.

A copy of ``repro.launch.probes``. The reference lowers ONE unscanned
layer at per-chip local shapes (heads, ffn, experts and batch divided by
their mesh extents; attention unchunked, so its inner scans disappear)
because XLA's ``cost_analysis`` counts a scan's body once, and assembles

    fwd_flops_chip   = L * probe_layer + probe_head
    train_flops_chip = 3 * fwd (+1 fwd with full remat)

Here the same layer (``models.transformer._layer``) and head run on meta
tensors (shapes only: nothing drawn, allocated or computed) under
``launch.cost.CostCounter``, which counts each aten op in XLA's
HloCostAnalysis conventions; that count stands for ``cost_analysis``.

What the probe counts, against ``launch.serve.lm_cost``: attention runs
unchunked, as the reference's probe runs it, so the probe counts the
whole S x S score square, masked half included, and every elementwise
op, convert, reduction and transcendental of the layer, in XLA's
conventions. The converts XLA's CPU backend adds around every bf16 op
are kept apart (``flops_xla_cpu``, for the comparison with the
reference's CPU figures): the card does not run them. ``lm_cost``
(phase 9's bound) counts the products of the causal pairs the port's
tiled attention runs (it skips masked KV blocks), the head at the last
position only, and no elementwise work. So, for a prefill on one card,
exactly,

    probe - lm_cost = (the masked half of the score square's two
                       products) + (the elementwise work: compares,
                       selects, the port's converts, reductions)
                      + (the head at the other S - 1 positions)

Both stay: the probe is the dry run's per-rank FLOPs in the reference's
sense (its roofline's compute term), ``lm_cost`` the least work the port
does on one card (a kernel's bound).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.launch.cells import meta_tensor
from repro_torch.launch.cost import CostCounter

__all__ = ["_local_cfg", "lm_fwd_probe", "lm_bytes_analytic",
           "lm_cell_cost", "lm_model_flops"]


def _count(fn, *args) -> Dict[str, float]:
    with CostCounter() as cc:
        fn(*args)
    return {"flops": float(cc.flops),
            "xla_cpu_flops": float(cc.xla_cpu_flops),
            "bytes": float(cc.bytes),
            "transcendentals": float(cc.transcendentals),
            "by_class": cc.totals()["by_class"]}


def _local_cfg(cfg, mesh_model: int, mesh_data: int):
    """Per-chip slice of the model config (tensor/expert parallel extents).

    MoE: routing is replicated across the model axis (router logits are
    [T, E] data-parallel), while expert *work* shards as E/mm experts each
    at the global capacity — equivalently, full E at capacity/mm. We keep
    n_experts (so top-k stays valid) and divide capacity_factor instead;
    e·cap ∝ s·k·cf/mm matches the per-chip dispatched-slot count exactly.
    """
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, capacity_factor=moe.capacity_factor / mesh_model,
            d_shared_ff=max(1, (moe.d_shared_ff or 1) // mesh_model)
            if moe.n_shared else 0)
    return dataclasses.replace(
        cfg,
        n_heads=max(1, cfg.n_heads // mesh_model),
        n_kv_heads=max(1, cfg.n_kv_heads // mesh_model),
        d_ff=max(1, cfg.d_ff // mesh_model) if cfg.d_ff else 0,
        moe=moe,
        q_chunk=1 << 30, kv_chunk=1 << 30,  # unchunked attention: no inner scan
        remat=False,
    )


def _first_layer(layers):
    """Layer 0's views of a stacked [L, ...] layer tree."""
    return {k: _first_layer(v) if isinstance(v, dict) else v[0]
            for k, v in layers.items()}


def lm_fwd_probe(cfg, batch: int, seq: int, mesh_model: int, mesh_data: int
                 ) -> Dict[str, float]:
    """Per-chip forward cost of one layer + head, local shapes. Also
    returns the forward with XLA's CPU converts (``fwd_flops_xla_cpu``)
    and each part's counter totals by class (``layer_by_class``,
    ``head_by_class``)."""
    from repro_torch.models.transformer import _layer, param_structs

    lcfg = _local_cfg(cfg, mesh_model, mesh_data)
    b_loc = max(1, batch // mesh_data)
    single = dataclasses.replace(lcfg, n_layers=1)
    layers = param_structs(single)["layers"]

    def one_layer(layers, x, positions):
        return _layer(_first_layer(layers), x, lcfg, positions)

    x = meta_tensor((b_loc, seq, cfg.d_model), cfg.dtype)
    pos = meta_tensor((b_loc, seq), torch.int32)
    layer_cost = _count(one_layer, layers, x, pos)

    def head(h, w):
        logits = torch.einsum("bsd,dv->bsv", h, w.to(h.dtype)
                              ).to(torch.float32)
        return torch.logsumexp(logits, dim=-1).sum()

    w = meta_tensor((cfg.d_model, max(1, cfg.vocab // mesh_model)), torch.float32)
    head_cost = _count(head, x, w)
    return {
        "layer_flops": layer_cost["flops"], "layer_bytes": layer_cost["bytes"],
        "head_flops": head_cost["flops"], "head_bytes": head_cost["bytes"],
        "fwd_flops": layer_cost["flops"] * cfg.n_layers + head_cost["flops"],
        "fwd_bytes": layer_cost["bytes"] * cfg.n_layers + head_cost["bytes"],
        "fwd_flops_xla_cpu": layer_cost["xla_cpu_flops"] * cfg.n_layers
        + head_cost["xla_cpu_flops"],
        "layer_by_class": layer_cost["by_class"],
        "head_by_class": head_cost["by_class"],
    }


def lm_bytes_analytic(cfg, kind: str, batch: int, seq: int, mesh_model: int,
                      mesh_data: int) -> float:
    """Per-chip HBM traffic model (documented in EXPERIMENTS.md §Roofline).

    XLA 'bytes accessed' cannot be assembled across nested scans, so the
    memory term uses an explicit model:
      weights: f32 params re-read per pass (fwd [+remat] + bwd) + optimizer
               update traffic (grad w+r, m/v r+w, param r+w ~ 20 B/param)
      activations: per layer, per pass: attention tensors ~6 x [T, d] bf16,
               FFN tensors ~(1 + 2*ff_ratio) x [T, d], norms+residual ~6,
               each read+written once; KV re-streamed once per q-chunk
      logits: [T, V/model] f32 read+written per pass (chunked loss)
    decode: params read once + full KV cache read + small vectors.
    """
    chips = mesh_model * mesh_data
    n_params = cfg.n_params
    w_chip = n_params / chips
    d = cfg.d_model
    if kind == "decode":
        cache_bytes = 0.0
        if cfg.mla is None:
            cache_bytes = (cfg.n_layers * batch * seq * cfg.n_kv_heads
                           * cfg.d_head * 2 * 2)
        else:
            cache_bytes = (cfg.n_layers * batch * seq
                           * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2)
        # active params only are touched per decode step
        return (cfg.n_active_params / chips) * 4 + cache_bytes / chips
    tokens_chip = batch * seq / mesh_data
    passes = 3.0 + (1.0 if cfg.remat else 0.0)  # fwd, bwd(2x counted in
    # flops but reads acts ~once) + remat refwd; traffic-wise use passes
    if cfg.moe is not None:
        ff_ratio = (cfg.moe.top_k * cfg.moe.d_expert_ff
                    + (cfg.moe.d_shared_ff or 0)) / d
    else:
        ff_ratio = cfg.d_ff / d * (1.5 if cfg.glu else 1.0)
    act_tensors = 6 + (1 + 2 * ff_ratio) + 6
    a = tokens_chip * d * 2  # one [T, d] bf16 tensor
    act_traffic = act_tensors * 2 * a * cfg.n_layers * passes
    nq = max(1, seq // max(cfg.q_chunk, 1))
    kv_dim = (cfg.n_kv_heads * cfg.d_head if cfg.mla is None
              else cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim)
    kv_restream = (batch / mesh_data) * seq * kv_dim * 2 * 2 * nq \
        * cfg.n_layers * passes / max(mesh_model, 1)
    weights = w_chip * 4 * passes + w_chip * 20
    logits = tokens_chip * (cfg.vocab / mesh_model) * 4 * 2 * passes
    if kind == "prefill":
        act_traffic /= passes
        kv_restream /= passes
        weights = w_chip * 4
        logits = (batch / mesh_data) * (cfg.vocab / mesh_model) * 4 * 2
    return weights + act_traffic + kv_restream + logits


def lm_cell_cost(cfg, kind: str, batch: int, seq: int, mesh_model: int,
                 mesh_data: int) -> Dict[str, float]:
    """Per-chip corrected (flops, bytes) for a train/prefill/decode cell
    (bytes: ``lm_bytes_analytic``), the FLOPs with XLA's CPU converts
    (``flops_xla_cpu``: the figure the reference's CPU probe gives) and
    the FLOPs by the counter's class (``by_class``), assembled the same
    way. ``flops`` counts the ops the port runs: the dry run's compute
    term."""
    if kind == "decode":
        from repro_torch.models.transformer import (decode_step, init_cache,
                                                    param_structs)
        lcfg = _local_cfg(cfg, mesh_model, mesh_data)
        # cache: batch/data x seq/model local slice, single layer; vocab
        # sharded on model so the lm_head inside the probe is per-chip sized
        b_loc = max(1, batch // mesh_data)
        s_loc = max(1, seq // mesh_model)
        single = dataclasses.replace(lcfg, n_layers=1,
                                     vocab=max(128, cfg.vocab // mesh_model))
        c = _count(lambda p, ca, t, cur: decode_step(p, ca, t, cur, single),
                   param_structs(single), init_cache(single, b_loc, s_loc,
                                                     device="meta"),
                   meta_tensor((b_loc,), torch.int32), meta_tensor((b_loc,), torch.int32))
        # head (counted once inside the probe) must not scale by n_layers
        head_flops = 2 * b_loc * cfg.d_model * (cfg.vocab / mesh_model)
        by_class = {k: v["flops"] * cfg.n_layers
                    for k, v in c["by_class"].items()}
        by_class["product"] -= head_flops * (cfg.n_layers - 1)
        return {"flops": (c["flops"] - head_flops) * cfg.n_layers
                + head_flops,
                "flops_xla_cpu": (c["xla_cpu_flops"] - head_flops)
                * cfg.n_layers + head_flops,
                "bytes": lm_bytes_analytic(cfg, kind, batch, seq, mesh_model,
                                           mesh_data),
                "by_class": by_class}
    probe = lm_fwd_probe(cfg, batch, seq, mesh_model, mesh_data)
    bytes_chip = lm_bytes_analytic(cfg, kind, batch, seq, mesh_model,
                                   mesh_data)
    # train: fwd + bwd (2x fwd) + remat recompute (1x fwd if remat)
    mult = 1.0 if kind == "prefill" else 4.0 if cfg.remat else 3.0
    by_class = {k: (v["flops"] * cfg.n_layers
                    + probe["head_by_class"][k]["flops"]) * mult
                for k, v in probe["layer_by_class"].items()}
    return {"flops": probe["fwd_flops"] * mult,
            "flops_xla_cpu": probe["fwd_flops_xla_cpu"] * mult,
            "bytes": bytes_chip, "by_class": by_class}


def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """Global MODEL_FLOPS = 6·N_active·D (training) / 2·N_active·D (fwd)."""
    n = cfg.n_active_params
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    per_tok = {"train": 6, "prefill": 2, "decode": 2}[kind]
    return per_tok * n * tokens
