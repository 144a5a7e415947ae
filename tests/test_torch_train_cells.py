"""The port's GNN train steps (``repro_torch.launch.cells``) against the
JAX package's own: ``build_gnn_cell(...).fn`` (full graph) and
``build_gnn_sampled_cell(...).fn`` (``minibatch_lg``'s tree layout,
``jax.vmap`` over the trees) on a one-device mesh, at each arch's SMOKE
config, from one state (the JAX init carried by ``load_jax_params`` and
``load_jax_opt_state``) and one batch made with numpy.

Three steps of the reference's schedule (peak 3e-4, warm-up 100: lr 0,
3e-6, 6e-6). Tolerances: losses rtol 1e-5; the grad norm rtol 1e-4;
parameters rtol 1e-5 and atol 2 Σ lr_t (an element whose gradient is
near 0 can flip the sign of its Adam step); Equiformer-v2 10x each.

The tree batch is ``data.synthetic.gnn_tree_batch`` of a graph with
isolated vertices, so some trees have invalid edges, routed to each
tree's dump row (the port's block-diagonal graph sends them to the flat
batch's dump row B v_t, which the last case checks on its own).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.launch import cells as jcells
from repro.launch.mesh import make_mesh
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.data.synthetic import gnn_tree_batch
from repro_torch.graphs.csr import build_csr
from repro_torch.graphs.sampler import tree_shape
from repro_torch.launch import cells
from repro_torch.models.convert import load_jax_opt_state, load_jax_params
from repro_torch.tree import tree_leaves
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["pna", "meshgraphnet", "egnn", "equiformer-v2"]
D_FEAT, N, E, N_PAD = 8, 24, 80, 4
TREES, FANOUTS = 6, (3, 2)


def _specs(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    return (dataclasses.replace(j, config=j.smoke),
            dataclasses.replace(t, config=t.smoke))


def _full_batch(rng, seed_mask: bool):
    b = {"node_feat": rng.normal(size=(N, D_FEAT)).astype(np.float32),
         "labels": rng.integers(0, 16, N).astype(np.int32),
         "coords": rng.normal(size=(N, 3)).astype(np.float32),
         "edge_src": rng.integers(0, N, E).astype(np.int32),
         "edge_dst": rng.integers(0, N, E).astype(np.int32),
         "edge_feat": rng.normal(size=(E, 4)).astype(np.float32)}
    b["edge_src"][-N_PAD:] = N
    b["edge_dst"][-N_PAD:] = N
    if seed_mask:
        b["seed_mask"] = rng.random(N) < 0.5
    return b


def _graph():
    """64 vertices, the last 20 isolated (their trees' edges invalid)."""
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 44, (200, 2))
    return build_csr(edges, 64, device="cpu")


def _tree_batch(step):
    b = gnn_tree_batch(0, step, _graph(), TREES, FANOUTS, D_FEAT)
    return {k: v.numpy() for k, v in b.items()}


def _run_both(arch, jplan, tplan, batches):
    jspec, _ = _specs(arch)
    jparams = jcells._gnn_init(jspec, _jax_config(jspec))(
        jax.random.PRNGKey(11))
    model = tplan.init(torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    jopt = j_adamw_init(jparams)
    topt = load_jax_opt_state(model, jax.tree.map(np.asarray, jopt))
    scale = 10.0 if arch == "equiformer-v2" else 1.0
    jstep = jax.jit(jplan.fn)
    lr_sum = 0.0
    for i, batch in enumerate(batches):
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
        model, topt, tm = tplan.fn(model, topt, {
            k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
        lr_sum += float(tm["lr"])
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 * scale, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4 * scale,
                                   err_msg=f"step {i}")
        ref, got = jax.tree.leaves(jparams), tree_leaves(model)
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=1e-5 * scale,
                                       atol=2 * lr_sum * scale,
                                       err_msg=f"step {i}")
    assert int(topt["step"]) == int(jopt["step"]) == len(batches)
    assert lr_sum > 0


def _jax_config(jspec):
    """The model config the reference's cell builders run ``jspec`` at
    (their plans carry only parameter shapes)."""
    if jspec.arch_id == "meshgraphnet":
        return dataclasses.replace(jspec.config, d_node_in=D_FEAT,
                                   d_edge_in=4, d_out=16)
    return dataclasses.replace(jspec.config, d_in=D_FEAT, d_out=16)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_graph_step_equals_the_reference(arch):
    jspec, tspec = _specs(arch)
    params = {"n_nodes": N, "n_edges": E, "d_feat": D_FEAT}
    mesh = make_mesh((1, 1), ("data", "model"))
    jplan = jcells.build_gnn_cell(jspec, ShapeCell("small", "gnn_full",
                                                   params), mesh)
    tplan = cells.build_gnn_cell(tspec, ShapeCell("small", "gnn_full",
                                                  params))
    assert dataclasses.asdict(tplan.config) == \
        dataclasses.asdict(_jax_config(jspec))
    rng = np.random.default_rng(ARCHS.index(arch))
    # seed_mask weights the loss for two of the archs
    masked = arch in ("pna", "egnn")
    _run_both(arch, jplan, tplan, [_full_batch(rng, masked)
                                   for _ in range(3)])


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_step_equals_the_reference(arch):
    jspec, tspec = _specs(arch)
    params = {"batch_nodes": TREES, "fanouts": FANOUTS, "d_feat": D_FEAT}
    mesh = make_mesh((1, 1), ("data", "model"))
    jplan = jcells.build_gnn_sampled_cell(
        jspec, ShapeCell("mb", "gnn_sampled", params), mesh)
    tplan = cells.build_gnn_sampled_cell(
        tspec, ShapeCell("mb", "gnn_sampled", params))
    assert tplan.meta["layout"] == "tree"
    batches = [_tree_batch(s) for s in range(3)]
    v_t, _ = tree_shape(FANOUTS)
    # some trees carry invalid edges, at their dump row
    assert any((b["edge_src"] == v_t).any() for b in batches)
    _run_both(arch, jplan, tplan, batches)


def test_tree_batch_and_flattening():
    """The tree batch's shapes, and its block-diagonal graph: tree t's
    local ids shifted by t v_t, every dump-row edge at B v_t (never the
    next tree's seed), node arrays flattened in tree order."""
    v_t, e_t = tree_shape(FANOUTS)
    b = gnn_tree_batch(0, 1, _graph(), TREES, FANOUTS, D_FEAT)
    assert tuple(b["node_feat"].shape) == (TREES, v_t, D_FEAT)
    assert tuple(b["edge_src"].shape) == (TREES, e_t)
    assert tuple(b["coords"].shape) == (TREES, v_t, 3)
    assert tuple(b["edge_feat"].shape) == (TREES, e_t, 4)
    assert b["labels"].dtype == b["edge_src"].dtype == torch.int32
    assert torch.equal(b["edge_src"] == v_t, b["edge_dst"] == v_t)
    flat = cells.flatten_trees(b)
    n = TREES * v_t
    assert tuple(flat["node_feat"].shape) == (n, D_FEAT)
    dump = b["edge_src"].reshape(-1) == v_t
    assert bool(dump.any()) and bool((flat["edge_src"][dump] == n).all())
    assert bool((flat["edge_dst"][dump] == n).all())
    t = torch.arange(TREES).repeat_interleave(e_t)
    live = ~dump
    assert torch.equal(flat["edge_src"][live] // v_t, t[live])
    assert torch.equal(flat["edge_dst"][live] // v_t, t[live])
    assert torch.equal(flat["labels"][::v_t], b["labels"][:, 0])
    again = gnn_tree_batch(0, 1, _graph(), TREES, FANOUTS, D_FEAT)
    assert all(torch.equal(b[k], again[k]) for k in b)
