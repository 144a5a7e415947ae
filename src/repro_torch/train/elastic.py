"""Elastic scaling: resume a checkpoint onto a different mesh.

A torch copy of ``repro.train.elastic``. Checkpoints store logical
(unsharded) arrays, so elasticity is re-placement: ``remesh`` gives a
rank its shard of every leaf under the specs of the *new* mesh. It works
across mesh sizes (shrink after failures, grow after repairs) as long as
the new mesh divides the sharded dims, which ``check_divisibility``
checks before anything moves.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.tree import param_tree

__all__ = ["mesh_sizes", "axes_extent", "leaves_with_specs",
           "map_with_specs", "check_divisibility", "shard_shape",
           "shard_slices", "remesh"]


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a mapping, or of a mesh's ``axis_names`` and
    ``devices.shape``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _keystr(path) -> str:
    """A path as ``jax.tree_util.keystr`` spells it: ``['a'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def axes_extent(axes, sizes: Mapping) -> int:
    """The ranks a spec entry splits a dim over: 1 for ``None``, else the
    product of its axes' sizes (one axis name or a tuple of names)."""
    if axes is None:
        return 1
    axes = axes if isinstance(axes, tuple) else (axes,)
    return math.prod(sizes[a] for a in axes)


def leaves_with_specs(tree, specs, path=()):
    """(path, leaf, spec) of every leaf of ``tree`` in the reference's
    leaf order (dict keys sorted), with the spec of the same place in
    ``specs`` (a ``None`` spec covers its whole subtree)."""
    if isinstance(tree, nn.Module):
        tree = param_tree(tree)
    if isinstance(tree, dict):
        for key in sorted(tree):
            sub = None if specs is None else specs[key]
            yield from leaves_with_specs(tree[key], sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from leaves_with_specs(
                t, None if specs is None else specs[i], path + (i,))
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
    sizes = mesh_sizes(mesh)
    for path, leaf, spec in leaves_with_specs(tree, specs):
        if spec is None:
            continue
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = axes if isinstance(axes, tuple) else (axes,)
            total = axes_extent(axes, sizes)
            shape = tuple(leaf.shape)
            if shape[dim] % total:
                raise ValueError(
                    f"{_keystr(path)}: dim {dim} of shape {shape} not "
                    f"divisible by mesh extent {total} ({axes})")


def shard_shape(shape, spec, mesh) -> tuple:
    """A leaf's per-rank shape under ``spec``: each dim over the ranks
    its entry splits it over (a dim past the spec's length is whole)."""
    sizes = mesh_sizes(mesh)
    spec = tuple(spec or ())
    return tuple(-(-n // axes_extent(spec[i] if i < len(spec) else None,
                                     sizes)) for i, n in enumerate(shape))


def shard_slices(shape, spec, mesh, rank: int) -> tuple:
    """The slices of a leaf of ``shape`` that ``rank`` holds under
    ``spec``: a dim sharded over axes (a, b, ...) splits into
    prod(sizes) blocks, and the rank takes block ``c_a`` · size_b + c_b
    ... of it, its coordinates ``c`` on the axes row-major over
    ``mesh.devices.shape`` (the order in which the reference's mesh
    lays out its devices); a dim the spec leaves ``None`` (or past the
    spec's length) is whole."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(sizes, np.unravel_index(rank, tuple(sizes.values()))))
    spec = tuple(spec or ())
    out = []
    for dim, n in enumerate(shape):
        axes = spec[dim] if dim < len(spec) else None
        if axes is None:
            out.append(slice(None))
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        block = 0
        for a in axes:
            block = block * sizes[a] + int(coord[a])
        width = n // axes_extent(axes, sizes)
        out.append(slice(block * width, (block + 1) * width))
    return tuple(out)


def map_with_specs(tree, specs, fn):
    """``tree``'s structure (a module read as its ``param_tree``) with
    ``fn(leaf, spec)`` at each leaf."""
    if isinstance(tree, nn.Module):
        tree = param_tree(tree)
    if isinstance(tree, dict):
        return {k: map_with_specs(v, None if specs is None else specs[k],
                                  fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_specs(t, None if specs is None else specs[i], fn)
            for i, t in enumerate(tree))
    return fn(tree, specs)


def remesh(tree, specs, mesh, rank: int, device=None):
    """``rank``'s shard of every leaf of ``tree`` under its spec on
    ``mesh``, on ``device`` (``None``: CUDA): the counterpart of the
    reference's ``device_put(leaf, NamedSharding(mesh, spec))`` seen from
    one rank. A leaf with a ``None`` spec, or replicated dims, comes
    whole. ``check_divisibility`` runs first, so a mesh that does not
    divide raises before anything moves. Leaves may be tensors or numpy
    arrays; a memory-mapped array (``CheckpointManager.open_leaves``) is
    read only where the rank's slices lie."""
    check_divisibility(tree, specs, mesh)
    dev = resolve_device(device)

    def place(leaf, spec):
        part = leaf[shard_slices(leaf.shape, spec, mesh, rank)]
        if not isinstance(part, torch.Tensor):
            part = torch.from_numpy(np.array(part))
        return part.to(dev).contiguous()

    return map_with_specs(tree, specs, place)
