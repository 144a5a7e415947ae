"""Carry the JAX package's model parameters and AdamW state into the port.

The reference's parameters are a tree of dicts and lists; as nested
numpy arrays (``jax.tree.map(np.asarray, params)``) each path maps one to
one onto a state-dict key of the port's module: ``params["layers"][0]
["msg"][1]["w"]`` is ``layers.0.msg.1.w``. Weights keep the reference's
[in, out] layout, so nothing is transposed. The AdamW state
``{"m", "v", "step"}`` keeps its structure (``m`` and ``v`` shaped like
the parameters), which the port's ``repro_torch.optim.adamw`` shares.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.tree import param_tree, tree_map

__all__ = ["flatten_tree", "load_jax_params", "load_jax_opt_state"]


def flatten_tree(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(flatten_tree(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Load ``tree`` (numpy leaves) into ``module`` with ``strict=True``:
    a missing or extra path, or a shape that differs, raises."""
    state = {key: torch.from_numpy(np.array(leaf))  # a writable copy
             for key, leaf in flatten_tree(tree).items()}
    module.load_state_dict(state, strict=True)
    return module


def load_jax_opt_state(params, state) -> dict:
    """The reference's AdamW state as numpy arrays (``jax.tree.map(
    np.asarray, opt_state)``) as the port's, for ``params`` (a module or
    a tree of tensors): ``m`` and ``v`` shaped like the parameters, each
    leaf on its parameter's device and dtype, ``step`` an int32 scalar on
    the parameters' device. The paths must match, as
    ``load_jax_params`` requires."""
    shape = param_tree(params) if isinstance(params, nn.Module) else params
    want = sorted(flatten_tree(shape))

    def carry(tree):
        if sorted(flatten_tree(tree)) != want:
            raise ValueError("the optimizer state's paths differ from the "
                             "parameters'")
        return tree_map(lambda p, x: torch.from_numpy(np.array(x)).to(
            device=p.device, dtype=p.dtype), shape, tree)

    m, v = carry(state["m"]), carry(state["v"])
    device = next(iter(flatten_tree(shape).values())).device
    return {"m": m, "v": v,
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
