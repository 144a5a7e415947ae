"""Rank functions of the distributed tests (``tests/test_torch_distributed.py``).

They run in processes that ``repro_torch.core.distributed.spawn_ranks``
starts, so they live in an importable module, and they import numpy and
torch only (never jax). Each builds the port's distributed workspaces
from the CSR arrays the test hands it, runs ``dist_lpa`` on the CPU and
raises ``AssertionError`` when a run differs from the expected labels and
iteration count, which fails the spawning test.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import build_dist_workspace, dist_lpa
from repro_torch.graphs.csr import graph_from_arrays

#: exchange mode -> build_dist_workspace flag
HALO = {"full": False, "halo": True}
#: engine key -> (engine name, workspace flags)
ENGINES = {
    "jnp": ("jnp", {}),
    "pallas": ("pallas", {}),
    "fused": ("pallas_fused", {"fused": True, "tile_r": 32}),
    "stream": ("pallas_stream", {"stream": True, "tile_r": 32,
                                 "window_entries": 512}),
    "stream_aligned": ("pallas_stream", {"stream": True, "tile_r": 32,
                                         "window_entries": 512,
                                         "aligned": True}),
}


def _graph(arrays):
    offsets, indices, weights, n = arrays
    return graph_from_arrays(offsets, indices, weights, n, device="cpu")


def run_matrix(comm, arrays, runs, expected, rho, k, chunk, order=None):
    """``runs``: (tag, engine key, exchange, method, rescan, gated) tuples;
    ``expected[tag]``: (labels [N] int32 numpy, iterations)."""
    graph = _graph(arrays)
    built = {}
    for tag, ekey, exchange, method, rescan, gated in runs:
        engine, flags = ENGINES[ekey]
        key = (ekey, exchange)
        if key not in built:
            built[key] = build_dist_workspace(graph, comm.world_size, k=k,
                                              chunk=chunk, order=order,
                                              halo=HALO[exchange], **flags)
        labels, iters = dist_lpa(comm, built[key], rho=rho, engine=engine,
                                 method=method, rescan=rescan,
                                 frontier_gate=gated)
        want_labels, want_iters = expected[tag]
        assert labels.device == comm.device, (tag, labels.device)
        assert labels.dtype == torch.int32, (tag, labels.dtype)
        assert iters == want_iters, (tag, comm.rank, iters, want_iters)
        assert np.array_equal(labels.numpy(), want_labels), (tag, comm.rank)
