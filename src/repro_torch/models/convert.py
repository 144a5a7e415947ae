"""Carry the JAX package's model parameters into a port module.

The reference's parameters are a tree of dicts and lists; as nested
numpy arrays (``jax.tree.map(np.asarray, params)``) each path maps one to
one onto a state-dict key of the port's module: ``params["layers"][0]
["msg"][1]["w"]`` is ``layers.0.msg.1.w``. Weights keep the reference's
[in, out] layout, so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["flatten_tree", "load_jax_params"]


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
