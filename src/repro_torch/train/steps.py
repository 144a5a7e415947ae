"""Train-step builders: loss -> grad -> (optionally compressed all-reduce)
-> AdamW, as one function.

A torch copy of ``repro.train.steps``. ``loss_fn(params, batch)`` takes
the parameters as the step was given them: an ``nn.Module`` (the port's
models), updated in place and returned, or a tree of tensors, for which
the step returns a new tree. Gradients come from ``torch.autograd`` with
respect to the leaves in the reference's order; a leaf the loss does not
reach gets a zero gradient, as ``jax.grad`` gives it.

``make_dp_train_step`` is the reference's shard_map step over a
``ShardComm``: every rank holds the parameters and optimizer state, runs
the step on its own share of the batch, averages the loss and the
gradients across the ranks (the int8 error-feedback all-reduce, or a
plain float32 mean) and applies the same update.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compressed_psum
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import param_tree, tree_leaves, tree_map, tree_unflatten

__all__ = ["value_and_grad", "make_train_step", "make_dp_train_step"]


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): the detached loss and its gradient tree, shaped like
    ``params`` (a module's as its ``param_tree``)."""
    if isinstance(params, nn.Module):
        shape = param_tree(params)
        leaves, live = tree_leaves(shape), params
    else:
        shape = params
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
    loss = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(shape, grads)


def make_train_step(loss_fn, peak_lr=3e-4, warmup=100, total=10000,
                    opt_cfg: AdamWConfig | None = None):
    """loss_fn(params, batch) -> scalar. Returns (init_fn, step_fn).

    step(params, opt_state, batch) -> (params, opt_state, metrics), with
    metrics ``{"loss", "lr", "grad_norm"}``.
    """

    def init(params):
        return adamw_init(params)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        lr = cosine_schedule(opt_state["step"], peak_lr, warmup, total)
        params, opt_state, stats = adamw_update(grads, opt_state, params, lr,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "lr": lr, **stats}

    return init, step


def make_dp_train_step(loss_fn, comm, peak_lr=3e-4, warmup=100,
                       total=10000, opt_cfg: AdamWConfig | None = None,
                       compress: bool = True):
    """Data-parallel step over ``comm``'s ranks with the int8
    error-feedback gradient all-reduce (``compress``) or a float32 mean.

    Params/opt state replicated; each rank passes its own share of the
    batch. step(params, opt_state, err, batch) -> (params, opt_state,
    err, metrics); the loss in the metrics is the mean over the ranks.
    """
    n = comm.world_size

    def init(params):
        return adamw_init(params), tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

    def step(params, opt_state, err, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        loss = comm.all_reduce(loss, "sum") / n
        if compress:
            grads, err = compressed_psum(grads, err, comm)
        else:
            flat = tree_leaves(grads)
            total_g = comm.all_reduce(
                torch.cat([g.reshape(-1) for g in flat]), "sum")
            out, at = [], 0
            for g in flat:
                out.append(total_g[at:at + g.numel()].reshape(g.shape) / n)
                at += g.numel()
            grads = tree_unflatten(grads, out)
        lr = cosine_schedule(opt_state["step"], peak_lr, warmup, total)
        params, opt_state, stats = adamw_update(grads, opt_state, params, lr,
                                                opt_cfg)
        return params, opt_state, err, {"loss": loss, "lr": lr, **stats}

    return init, step
