"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

A torch copy of ``repro.models.moe``. Dispatch has a static per-expert
capacity C = ceil(T*K/E * capacity_factor) per group: token-expert
assignments are sorted by expert id (a stable sort, so an expert keeps
its first C assignments in token order), overflow goes to a dump slot
and drops (GShard semantics), and the combine adds each kept slot's
output, weighted by its router probability, in float32. Shared experts
(the DeepSeek fine-grained design) always run densely.

The groups (``n_groups`` contiguous chunks of each sequence) are part of
the function: they set the per-group capacity. The reference's
distribution knobs (``hint_*``) are kept and are the identity on one
card; its explicit expert-parallel path (``ep_mesh``, a ``shard_map``)
has no one-card meaning, and setting it raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, hint

__all__ = ["MoEConfig", "moe_shapes", "init_moe", "moe_ffn",
           "router_aux_loss"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    d_shared_ff: int = 0          # defaults to d_expert_ff * n_shared
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # normalize top-k probs (Qwen3/DeepSeek)
    # --- distribution knobs (the reference's cell builders set them from
    # a mesh; the identity on one card) ---
    n_groups: int = 1              # dispatch groups per sequence
    hint_batch_axes: tuple = ()    # mesh axes carrying the batch dim
    hint_expert_axis: object = None  # mesh axis carrying the expert dim
    ep_mesh: object = None         # the reference's shard_map EP path


def moe_shapes(cfg: MoEConfig, d_model: int) -> dict:
    """The MoE parameters' per-layer shapes in the reference's order:
    ``router``, ``w_gate``, ``w_up``, ``w_down`` and, with shared
    experts, ``shared_gate``, ``shared_up``, ``shared_down``."""
    e, f = cfg.n_experts, cfg.d_expert_ff
    shapes = {"router": (d_model, e), "w_gate": (e, d_model, f),
              "w_up": (e, d_model, f), "w_down": (e, f, d_model)}
    if cfg.n_shared:
        fs = cfg.d_shared_ff or cfg.d_expert_ff * cfg.n_shared
        shapes.update(shared_gate=(d_model, fs), shared_up=(d_model, fs),
                      shared_down=(fs, d_model))
    return shapes


def moe_tensors(generator: torch.Generator, cfg: MoEConfig, d_model: int,
                lead: tuple = (), device=None) -> dict:
    """The MoE parameters (``moe_shapes``), each with the leading dims
    ``lead`` (a stack of layers) and its per-layer fan-in scale. The
    routed experts' fan-in is the reference's ``shape[0]``, the expert
    count."""
    return {name: dense_init(generator, lead + shape,
                             scale=1.0 / shape[0] ** 0.5, device=device)
            for name, shape in moe_shapes(cfg, d_model).items()}


def init_moe(generator: torch.Generator, cfg: MoEConfig, d_model: int,
             device=None) -> Params:
    """A module with ``router`` [d, E], ``w_gate``/``w_up`` [E, d, F],
    ``w_down`` [E, F, d] (and ``shared_*`` when ``n_shared > 0``), drawn
    from ``generator`` (the reference's law, not its bits)."""
    return Params(moe_tensors(generator, cfg, d_model, device=device))


def _dispatch_group(xt: torch.Tensor, top_e: torch.Tensor,
                    top_p: torch.Tensor, e: int, cap: int):
    """Group-local sort dispatch, over any leading (group) dims:
    xt [..., T, d], top_e/top_p [..., T, k] -> (dispatched [..., e, cap,
    d], slot, keep, token, prob, each [..., T*k] in expert order).

    An assignment whose rank within its expert reaches ``cap`` goes to
    the dump slot ``e * cap``, which the dispatch buffer drops."""
    *lead, t, d = xt.shape
    k = top_e.shape[-1]
    dev = xt.device
    flat_e = top_e.reshape(*lead, t * k).long()
    flat_t = torch.arange(t, device=dev).repeat_interleave(k).expand(
        *lead, t * k)
    flat_p = top_p.reshape(*lead, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = torch.gather(flat_t, -1, order)
    sp = torch.gather(flat_p, -1, order)
    experts = torch.arange(e, device=dev).expand(*lead, e).contiguous()
    start = torch.searchsorted(se, experts, side="left")
    rank = torch.arange(t * k, device=dev) - torch.gather(start, -1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)
    buf_tok = torch.full((*lead, e * cap + 1), t, dtype=torch.long,
                         device=dev)
    buf_tok.scatter_(-1, slot, torch.where(keep, st, t))
    xt_pad = torch.cat([xt, xt.new_zeros(*lead, 1, d)], dim=-2)
    idx = buf_tok[..., :-1, None].expand(*lead, e * cap, d)
    dispatched = torch.gather(xt_pad, -2, idx).reshape(*lead, e, cap, d)
    return dispatched, slot, keep, st, sp


def _combine_group(y: torch.Tensor, slot, keep, st, sp, t: int
                   ) -> torch.Tensor:
    """Weighted scatter back: y [..., e, cap, d] -> [..., T, d], float32
    adds into T + 1 rows (dropped assignments into the last, cut off)."""
    *lead, e, cap, d = y.shape
    y_flat = y.reshape(*lead, e * cap, d)
    idx = torch.clamp_max(slot, e * cap - 1)[..., None].expand(
        *lead, slot.shape[-1], d)
    gathered = torch.gather(y_flat, -2, idx)
    gathered = torch.where(keep[..., None],
                           gathered.to(torch.float32) * sp[..., None], 0.0)
    src = torch.where(keep, st, t)[..., None].expand_as(gathered)
    out = torch.zeros(*lead, t + 1, d, dtype=torch.float32, device=y.device)
    return out.scatter_add(-2, src, gathered)[..., :t, :]


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]. Routing and dispatch run per group (a
    contiguous S/n_groups chunk of one sequence; one group when
    ``n_groups`` does not divide S); expert weights are [E, ...]-stacked
    and cast to ``x``'s dtype at each product."""
    if cfg.ep_mesh is not None:
        raise ValueError("MoEConfig.ep_mesh selects the reference's "
                         "shard_map expert-parallel path, which needs a "
                         "mesh of cards; one card runs with ep_mesh=None")
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    ng = cfg.n_groups if s % max(cfg.n_groups, 1) == 0 else 1
    sg = s // ng
    ba, ep = tuple(cfg.hint_batch_axes), cfg.hint_expert_axis

    # --- routing (f32 for numerics) ---
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)      # [B, S, k], descending
    if cfg.router_norm_topk:
        top_p = top_p / (torch.sum(top_p, dim=-1, keepdim=True) + 1e-9)

    xg = hint(x.reshape(b, ng, sg, d), ba, ep, None, None)
    te = top_e.reshape(b, ng, sg, k)
    tp = top_p.reshape(b, ng, sg, k).to(torch.float32)
    cap = max(1, math.ceil(sg * k / e * cfg.capacity_factor))
    dispatched, slot, keep, st, sp = _dispatch_group(xg, te, tp, e, cap)
    dispatched = hint(dispatched, ba, None, ep, None, None)

    wg = params["w_gate"].to(x.dtype)
    wu = params["w_up"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    g = torch.einsum("bgecd,edf->bgecf", dispatched, wg)
    u = torch.einsum("bgecd,edf->bgecf", dispatched, wu)
    y = torch.einsum("bgecf,efd->bgecd", F.silu(g) * u, wd)
    y = hint(y, ba, ep, None, None, None)

    out = _combine_group(y, slot, keep, st, sp, sg)
    out = hint(out, ba, ep, None, None).reshape(b, s, d).to(x.dtype)

    if cfg.n_shared:
        gs = torch.einsum("bsd,df->bsf", x, params["shared_gate"].to(x.dtype))
        us = torch.einsum("bsd,df->bsf", x, params["shared_up"].to(x.dtype))
        out = out + torch.einsum("bsf,fd->bsd", F.silu(gs) * us,
                                 params["shared_down"].to(x.dtype))
    return out


def router_aux_loss(params, x: torch.Tensor, cfg: MoEConfig
                    ) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean fraction * mean
    prob)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    logits = torch.einsum("td,de->te", xt.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(F.one_hot(top1, cfg.n_experts).to(torch.float32),
                      dim=0)
    mean_p = torch.mean(probs, dim=0)
    return cfg.n_experts * torch.sum(frac * mean_p)
