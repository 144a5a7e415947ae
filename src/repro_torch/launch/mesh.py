"""Production mesh descriptors. Functions, not module constants: importing
this module touches no device.

A copy of ``repro.launch.mesh`` for a program that places nothing by
mesh: one card holds a whole rank, so a mesh here only describes a layout
of ranks, with the attributes the port reads (``axis_names``, ``shape``,
``size``, ``devices.shape``; ``train.elastic.check_divisibility`` takes
it as it takes a JAX mesh). ``devices`` holds rank ids in the mesh's
shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "batch_axes",
           "all_axes"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an array of rank ids ([*shape] int64)."""

    axis_names: Tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``prod(shape)`` ranks, rank-major in ``shape``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    return Mesh(axis_names=axes,
                devices=np.arange(int(np.prod(shape))).reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a production mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)
