"""Trees of tensors in the JAX package's leaf order.

The reference keeps parameters, optimizer state and checkpoints as JAX
pytrees: nested dicts and lists whose leaves ``jax.tree`` flattens with
each dict's keys sorted and lists in order. The port keeps the same
trees, and a model's parameters may also come as an ``nn.Module``, read
as the tree its state-dict paths spell (``param_tree``:
``layers.0.msg.1.w`` is ``tree["layers"][0]["msg"][1]["w"]``). One
order everywhere keeps the global norm's sum, the checkpoints' ``leaf_<i>``
entries and the carried JAX state in step with the reference.
"""
from __future__ import annotations

from typing import Callable, List

import torch
from torch import nn

__all__ = ["param_tree", "tree_leaves", "tree_map", "tree_unflatten"]


def param_tree(module: nn.Module):
    """The module's parameters as nested dicts and lists (a run of keys
    ``"0"``, ``"1"``, ... is a list, as an ``nn.ModuleList`` spells it);
    the leaves are the ``nn.Parameter`` objects themselves."""
    tree: dict = {}
    for name, p in module.named_parameters():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p
    return _as_lists(tree)


def _as_lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _as_lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _children(tree):
    """The children of an inner node in the reference's order, or None
    for a leaf."""
    if isinstance(tree, nn.Module):
        tree = param_tree(tree)
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_leaves(tree) -> List:
    """The leaves in the reference's order (``None`` has none)."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [tree]
    return [leaf for child in children for leaf in tree_leaves(child)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest``
    (same structure), as a new tree: a module in ``tree`` comes back in
    its ``param_tree`` shape."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(o)} leaves against "
                             f"{len(leaves)}")
    out = [fn(*args) for args in zip(leaves, *others)]
    return tree_unflatten(_plain(tree), out)


def _plain(tree):
    """``tree`` with every module in it replaced by its ``param_tree``."""
    if isinstance(tree, nn.Module):
        return param_tree(tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(t) for t in tree)
    return tree


def tree_unflatten(template, leaves: List):
    """A tree shaped like ``template`` holding ``leaves`` in order. A
    module in the template is filled in place (each parameter takes its
    leaf's values, keeping its own device and dtype) and returned."""
    n = len(tree_leaves(template))
    if len(leaves) != n:
        raise ValueError(f"tree_unflatten: {len(leaves)} leaves for a tree "
                         f"of {n}")
    return _fill(template, iter(leaves))


def _fill(template, it):
    if template is None:
        return None
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for p in tree_leaves(template):
                p.copy_(next(it))
        return template
    if isinstance(template, dict):
        filled = {k: _fill(template[k], it) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(t, it) for t in template)
    return next(it)
