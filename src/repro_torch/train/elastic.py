"""Elastic scaling: the divisibility check a resume onto another mesh
runs first.

A torch copy of ``repro.train.elastic.check_divisibility``. Checkpoints
store logical (unsharded) arrays, so a resume onto a mesh of another
size is a re-placement of each leaf, possible only where the new mesh's
extent divides every sharded dim; this check says which leaf would not
fit before anything moves. The re-placement itself (the reference's
``remesh``) needs a layout over several cards and is not ported.
"""
from __future__ import annotations

from typing import Mapping

from torch import nn

from repro_torch.tree import param_tree

__all__ = ["check_divisibility"]


def _mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a mapping, or of a mesh's ``axis_names`` and
    ``devices.shape``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _keystr(path) -> str:
    """A path as ``jax.tree_util.keystr`` spells it: ``['a'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def _walk(tree, specs, path=()):
    """(path, leaf, spec) of every leaf of ``tree``, with the spec of the
    same place in ``specs`` (a ``None`` spec covers its whole subtree)."""
    if isinstance(tree, nn.Module):
        tree = param_tree(tree)
    if isinstance(tree, dict):
        for key in sorted(tree):
            sub = None if specs is None else specs[key]
            yield from _walk(tree[key], sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, None if specs is None else specs[i],
                             path + (i,))
    elif tree is not None:
        yield path, tree, specs


def check_divisibility(tree, specs, mesh) -> None:
    """Raise ``ValueError`` naming the leaf if any sharded dim does not
    divide by its mesh extent.

    ``tree`` is a tree of tensors or arrays (or a module, read as its
    ``param_tree``); ``specs`` has the same structure, a spec per leaf: a
    tuple whose entry for each dim is ``None`` (replicated), an axis name
    or a tuple of names (their sizes multiply). ``mesh`` is anything
    with ``axis_names`` and ``devices.shape``, or a ``{axis: size}``
    mapping."""
    sizes = _mesh_sizes(mesh)
    for path, leaf, spec in _walk(tree, specs):
        if spec is None:
            continue
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = axes if isinstance(axes, tuple) else (axes,)
            total = 1
            for a in axes:
                total *= sizes[a]
            shape = tuple(leaf.shape)
            if shape[dim] % total:
                raise ValueError(
                    f"{_keystr(path)}: dim {dim} of shape {shape} not "
                    f"divisible by mesh extent {total} ({axes})")
