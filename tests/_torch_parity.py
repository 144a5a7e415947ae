"""Shared helpers of the parity tests between ``repro`` (JAX) and
``repro_torch``: carry a JAX graph across, compare plan dataclasses field
for field, and make fold inputs with numpy so both packages get the same
bits. Everything on the torch side runs with ``device="cpu"``."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.csr import graph_from_arrays
from test_fused_engine import FIXTURES  # noqa: F401  (re-exported)

CPU = "cpu"


def to_np(x) -> np.ndarray:
    """A JAX array or a torch tensor as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def carry_graph(g):
    """The JAX package's CSRGraph as the port's, on the CPU."""
    return graph_from_arrays(np.asarray(g.offsets), np.asarray(g.indices),
                             np.asarray(g.weights), g.n_nodes, device=CPU)


def assert_same_array(ref, got, what="array"):
    ref_np, got_np = to_np(ref), to_np(got)
    assert ref_np.dtype == got_np.dtype, (what, ref_np.dtype, got_np.dtype)
    np.testing.assert_array_equal(got_np, ref_np, err_msg=what)


def assert_same(ref, got, path="plan"):
    """Recursive field-for-field equality of a JAX-side value (dataclass,
    tuple, array, scalar) and its port counterpart."""
    if dataclasses.is_dataclass(ref):
        for f in dataclasses.fields(ref):
            assert_same(getattr(ref, f.name), getattr(got, f.name),
                        f"{path}.{f.name}")
    elif isinstance(ref, (tuple, list)):
        assert len(ref) == len(got), (path, len(ref), len(got))
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_same(a, b, f"{path}[{i}]")
    elif ref is None:
        assert got is None, path
    elif isinstance(ref, (int, float, str, bool, np.integer)):
        assert ref == got, (path, ref, got)
    else:
        assert_same_array(ref, got, path)


def random_entries(n_nodes: int, n_entries: int, rng):
    """Round-0 entry arrays (labels int32, weights float32) made with numpy:
    labels in [0, max(n, 2)), weights in [0.25, 3.25)."""
    labels = rng.integers(0, max(n_nodes, 2), n_entries).astype(np.int32)
    weights = (rng.random(n_entries) * 3 + 0.25).astype(np.float32)
    return labels, weights
