"""AdamW with decoupled weight decay and global-norm clipping (torch).

A copy of ``repro.optim.adamw``, written by hand because
``torch.optim.AdamW`` is another function: it decays the parameters in a
separate multiply, has no global-norm clip, and keeps its state in
another layout. Here the state is the reference's ``{"m", "v", "step"}``:
``m`` and ``v`` trees shaped like the parameters (a module's as its
``param_tree``), ``step`` an int32 scalar on the parameters' device. The
update takes the reference's order of operations: the clip scale, then
``b ** step`` in float32, then ``p - lr * delta``, with weight decay on
every leaf, biases included; each operation runs over a group of leaves
at once (``torch._foreach_*``: one launch per operation and group, not
one per leaf), with the roundings of the leaf-by-leaf form. The groups
are runs of leaves in the reference's order of at most ``GROUP_ELEMS``
elements, so the temporaries are a group's, not the whole model's.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "global_norm", "adamw_update"]

#: float32 elements a group of leaves holds at most: the update's
#: temporaries (about eight per element) stay near 8 GiB however large
#: the model
GROUP_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    """Zero moments shaped like ``params`` (a tree or a module)."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (reference order) of sum(x**2)."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_leaves(tree)))


def _groups(sizes) -> list:
    """(start, stop) of consecutive runs of leaves holding at most
    ``GROUP_ELEMS`` elements each (a larger leaf alone)."""
    out, start, held = [], 0, 0
    for i, n in enumerate(sizes):
        if i > start and held + n > GROUP_ELEMS:
            out.append((start, i))
            start, held = i, 0
        held += n
    if start < len(sizes):
        out.append((start, len(sizes)))
    return out


def _update_group(p, g, m, v, scale, bc1, bc2, lr, cfg: AdamWConfig):
    """The update of one group of leaves: (new params, m, v) lists."""
    g = torch._foreach_mul([x.to(torch.float32) for x in g], scale)
    m = torch._foreach_mul(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    v = torch._foreach_mul(v, cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(g, 1 - cfg.b2), g))
    del g
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(torch._foreach_div(m, bc1), denom)
    del denom
    torch._foreach_add_(delta, torch._foreach_mul(
        [x.to(torch.float32) for x in p], cfg.weight_decay))
    step_p = torch._foreach_mul([d.to(x.dtype) for d, x in zip(delta, p)],
                                lr)
    del delta
    new_p = [y.to(x.dtype) for x, y in zip(p, torch._foreach_sub(p, step_p))]
    return new_p, m, v


@torch.no_grad()
def adamw_update(grads, state: dict, params, lr,
                 cfg: AdamWConfig | None = None):
    """Returns (new_params, new_state, stats). ``params`` as a tree gives
    a new tree; as a module it is updated in place and returned."""
    cfg = cfg if cfg is not None else AdamWConfig()
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state["step"] + 1
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

    # one multi-tensor launch per operation and group of leaves (the
    # reference's order of operations, leaf by leaf: the same roundings)
    p, g_all = tree_leaves(params), tree_leaves(grads)
    m_all, v_all = tree_leaves(state["m"]), tree_leaves(state["v"])
    in_place = isinstance(params, nn.Module)
    new_p, m, v = [], [], []
    for i0, i1 in _groups([x.numel() for x in p]):
        gp, gm, gv = _update_group(
            p[i0:i1], g_all[i0:i1], m_all[i0:i1], v_all[i0:i1], scale,
            bc1, bc2, lr, cfg)
        if in_place:  # a module takes each group's values at once
            for x, y in zip(p[i0:i1], gp):
                x.copy_(y)
        else:
            new_p += gp
        m += gm
        v += gv
    return (params if in_place else tree_unflatten(params, new_p),
            {"m": tree_unflatten(state["m"], m),
             "v": tree_unflatten(state["v"], v), "step": step},
            {"grad_norm": gnorm})
