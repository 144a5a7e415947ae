"""The port's frontier marks (``repro_torch.core.lpa.mark_frontier``, on the
CPU the plain version of ``kernels.frontier.frontier_marks``) against the
reference's ``repro.core.lpa.mark_frontier`` (``segment_max`` over the
CSR-expanded edge sources), bit for bit: isolated vertices, self-loops, a
hub row that spans many 128-slot chunks, no vertex changed, every vertex
changed, and a drawn ``changed`` on the power-law and chain fixtures. The
workspace builds ``edge_src`` for the exact method alone.

The kernel itself runs on the card only: ``test_torch_frontier_marks_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lpa import LPAWorkspace as JWorkspace
from repro.core.lpa import mark_frontier as j_mark_frontier
from repro.graphs.csr import CSRGraph as JGraph
from repro.graphs.csr import build_csr
from repro_torch.core.lpa import LPAConfig, build_workspace, lpa_move
from repro_torch.core.lpa import mark_frontier
from repro_torch.kernels import frontier, launches
from _torch_parity import FIXTURES, assert_same_array, carry_graph


def _raw_graph(offsets, indices) -> JGraph:
    """A CSR graph from its arrays as they are (``build_csr`` drops
    self-loops)."""
    indices = np.asarray(indices, np.int32)
    return JGraph(offsets=jnp.asarray(np.asarray(offsets, np.int32)),
                  indices=jnp.asarray(indices),
                  weights=jnp.ones(indices.shape, jnp.float32),
                  n_nodes=len(offsets) - 1, n_edges=len(indices))


def _hub_graph(n_leaves=3000):
    """One hub over ~24 chunks of 128 slots, its leaves, and a path among
    the leaves."""
    leaves = np.arange(1, n_leaves + 1)
    edges = np.concatenate([
        np.stack([np.zeros(n_leaves, np.int64), leaves], axis=1),
        np.stack([leaves[:-1], leaves[1:]], axis=1)])
    return build_csr(edges, n_leaves + 1)


GRAPHS = {
    "zero_degree": FIXTURES["zero_degree"],
    "empty": FIXTURES["empty"],
    # vertex 1 lists itself twice, vertex 3 once among others; vertex 4
    # is isolated
    "self_loops": lambda: _raw_graph([0, 2, 5, 6, 9, 9],
                                     [1, 2, 1, 1, 3, 3, 0, 3, 1]),
    "hub": _hub_graph,
    "powerlaw": FIXTURES["powerlaw"],
    "chain": FIXTURES["road_deg2"],
}

CHANGED = {
    "none": lambda n, rng: np.zeros(n, bool),
    "every": lambda n, rng: np.ones(n, bool),
    "drawn": lambda n, rng: rng.random(n) < 0.3,
    "hub_only": lambda n, rng: np.arange(n) == 0,
}


@pytest.mark.parametrize("changed_by", sorted(CHANGED))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_marks_match_reference(graph, changed_by):
    g = GRAPHS[graph]()
    changed = CHANGED[changed_by](g.n_nodes, np.random.default_rng(
        g.n_nodes))
    jws = JWorkspace(graph=g, bundle=None, edge_src=g.sources())
    ref = j_mark_frontier(jws, jnp.asarray(changed))
    ws = build_workspace(carry_graph(g), LPAConfig(fold_backend="jnp"))
    launches.reset_launch_counts()
    got = mark_frontier(ws, torch.from_numpy(changed))
    assert_same_array(ref, got, f"{graph}, {changed_by}")
    assert not any(launches.LAUNCH_COUNTS.values())  # CPU: plain version


@pytest.mark.parametrize("method,built", [("mg", False), ("bm", False),
                                          ("exact", True)])
def test_workspace_builds_edge_src_for_exact_alone(method, built):
    g = carry_graph(FIXTURES["powerlaw"]())
    ws = build_workspace(g, LPAConfig(method=method, fold_backend="jnp"))
    if built:
        assert torch.equal(ws.edge_src, g.sources())
    else:
        assert ws.edge_src is None


def test_exact_move_refuses_a_workspace_without_edge_src():
    g = carry_graph(FIXTURES["powerlaw"]())
    ws = build_workspace(g, LPAConfig(method="mg", fold_backend="jnp"))
    labels = torch.arange(g.n_nodes, dtype=torch.int32)
    with pytest.raises(ValueError, match="edge_src"):
        lpa_move(ws, labels, True, 1, LPAConfig(method="exact",
                                                fold_backend="jnp"))


def test_wrapper_checks_its_inputs():
    g = carry_graph(FIXTURES["powerlaw"]())
    changed = torch.ones(g.n_nodes, dtype=torch.bool)
    with pytest.raises(TypeError):
        frontier.frontier_marks(changed.to(torch.uint8), g.offsets,
                                g.indices)
    with pytest.raises(TypeError):
        frontier.frontier_marks(changed, g.offsets.long(), g.indices)
    with pytest.raises(ValueError):
        frontier.frontier_marks(changed[:-1], g.offsets, g.indices)
    with pytest.raises(ValueError):
        frontier.frontier_marks(changed, g.offsets, g.indices[::2])
