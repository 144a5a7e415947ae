"""repro_torch.graphs against repro.graphs: the generators and build_csr
give the same arrays from the same seed, and both fold plans match field
for field on the fused-engine fixtures."""
import numpy as np
import pytest
import torch

import repro.graphs.generators as jgen
import repro_torch.graphs.generators as tgen
from repro.graphs import csr as jcsr
from repro_torch.graphs import csr as tcsr
from _torch_parity import (CPU, FIXTURES, assert_same, assert_same_array,
                           carry_graph)

GENERATORS = {
    "rmat": lambda m, **kw: m.rmat(8, edge_factor=4, seed=3, **kw),
    "grid2d": lambda m, **kw: m.grid2d(12, 9, **kw),
    "chain_kmer": lambda m, **kw: m.chain_kmer(600, seed=3, **kw),
    "sbm": lambda m, **kw: m.sbm(4, 20, 0.3, 0.02, seed=5, **kw),
    "powerlaw": lambda m, **kw: m.powerlaw_communities(
        1024, p_in=0.4, mix=0.05, seed=7, **kw),
    "ring_of_cliques": lambda m, **kw: m.ring_of_cliques(6, 5, **kw),
}


def _assert_same_graph(gj, gt):
    assert (gj.n_nodes, gj.n_edges) == (gt.n_nodes, gt.n_edges)
    for field in ("offsets", "indices", "weights"):
        assert_same_array(getattr(gj, field), getattr(gt, field), field)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_reference(name):
    ref = GENERATORS[name](jgen)
    got = GENERATORS[name](tgen, device=CPU)
    if isinstance(ref, tuple):  # (graph, planted truth)
        np.testing.assert_array_equal(got[1], ref[1])
        ref, got = ref[0], got[0]
    _assert_same_graph(ref, got)
    assert got.offsets.device.type == "cpu"


def test_paper_suite_matches_reference():
    ref = jgen.paper_suite("tiny")
    got = tgen.paper_suite("tiny", device=CPU)
    assert sorted(ref) == sorted(got)
    for key in ref:
        _assert_same_graph(ref[key], got[key])


@pytest.mark.parametrize("symmetrize,dedupe,weighted", [
    (True, True, True), (False, True, True), (True, False, True),
    (True, True, False), (False, True, False), (True, False, False)])
def test_build_csr_matches_reference(symmetrize, dedupe, weighted):
    """Weighted or unweighted (the generators' graphs: summed multiplicities
    from the sorted keys), duplicated, self-looped edges go through the
    same symmetrize/sort/dedupe arithmetic."""
    rng = np.random.default_rng(11)
    edges = rng.integers(0, 40, (300, 2))
    weights = ((rng.random(300) * 2).astype(np.float32) if weighted
               else None)
    ref = jcsr.build_csr(edges, 45, weights, symmetrize=symmetrize,
                         dedupe=dedupe)
    got = tcsr.build_csr(edges, 45, weights, symmetrize=symmetrize,
                         dedupe=dedupe, device=CPU)
    _assert_same_graph(ref, got)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_graph_views_match_reference(name):
    """degrees, sources() and total_weight of a carried-across graph."""
    gj = FIXTURES[name]()
    gt = carry_graph(gj)
    _assert_same_graph(gj, gt)
    assert_same_array(gj.degrees, gt.degrees, "degrees")
    assert_same_array(gj.sources(), gt.sources(), "sources")
    assert float(gj.total_weight) == float(gt.total_weight)


def test_graph_from_arrays_validates():
    offsets = np.asarray([0, 1, 2], np.int32)
    idx = np.asarray([1, 0], np.int32)
    w = np.ones(2, np.float32)
    g = tcsr.graph_from_arrays(offsets, idx, w, 2, device=CPU)
    assert g.offsets.dtype == torch.int32 and g.weights.dtype == torch.float32
    with pytest.raises(ValueError):
        tcsr.graph_from_arrays(offsets, idx, w, 3, device=CPU)
    with pytest.raises(ValueError):
        tcsr.graph_from_arrays(offsets, idx[:1], w, 2, device=CPU)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,chunk,tile_r", [(8, 128, 128), (4, 16, 8)])
def test_fold_plans_match_reference(name, k, chunk, tile_r):
    """Bucketed and fused plans, every field, plus the derived counts."""
    degrees = np.asarray(FIXTURES[name]().degrees)
    ref = jcsr.build_fold_plan(degrees, k=k, chunk=chunk)
    got = tcsr.build_fold_plan(degrees, k=k, chunk=chunk, device=CPU)
    assert_same(ref, got, "fold_plan")
    fref = jcsr.build_fused_fold_plan(degrees, k=k, chunk=chunk,
                                      tile_r=tile_r)
    fgot = tcsr.build_fused_fold_plan(degrees, k=k, chunk=chunk,
                                      tile_r=tile_r, device=CPU)
    assert_same(fref, fgot, "fused_plan")
    assert tcsr.fused_work_rows(fgot) == jcsr.fused_work_rows(fref)
    assert tcsr.fused_dispatches(fgot) == jcsr.fused_dispatches(fref)


def test_plans_reject_chunk_not_above_k():
    with pytest.raises(ValueError):
        tcsr.build_fold_plan(np.asarray([3, 1]), k=8, chunk=8, device=CPU)
    with pytest.raises(ValueError):
        tcsr.build_fused_fold_plan(np.asarray([3, 1]), k=8, chunk=8,
                                   device=CPU)
