"""The port's fanout sampler and GNN batches against the JAX package's.

Both sides draw with numpy from the same seeds, so every array must be
equal exactly (``np.array_equal``, dtypes too): the flat and the
tree-contiguous samplers and their shapes on a ``powerlaw_communities``
graph and on a graph with isolated vertices, and ``gnn_full_batch`` /
``gnn_sampled_batch`` field for field."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data.synthetic import gnn_full_batch as j_full_batch
from repro.data.synthetic import gnn_sampled_batch as j_sampled_batch
from repro.graphs import sampler as jsampler
from repro.graphs.csr import build_csr as j_build_csr
from repro.graphs.generators import powerlaw_communities
from repro_torch.data.synthetic import gnn_full_batch, gnn_sampled_batch
from repro_torch.graphs import sampler
from _torch_parity import carry_graph, to_np


def _graphs():
    web, _ = powerlaw_communities(1024, p_in=0.5, mix=0.02, seed=3)
    # vertices 0..3 joined, 4..9 isolated (degree 0: self-pointing samples)
    edges = np.asarray([[0, 1], [1, 2], [2, 3]])
    isolated = j_build_csr(edges, 10)
    return {"web": web, "isolated": isolated}


GRAPHS = _graphs()


def _assert_equal(ref, got, what):
    ref, got = to_np(ref), to_np(got)
    assert ref.dtype == got.dtype, (what, ref.dtype, got.dtype)
    assert np.array_equal(ref, got), what


@pytest.mark.parametrize("fanouts", [(1,), (5, 3), (15, 10)])
def test_shapes_equal_the_reference(fanouts):
    for b in (1, 16, 1024):
        assert sampler.sampled_shape(b, fanouts) == \
            jsampler.sampled_shape(b, fanouts)
    assert sampler.tree_shape(fanouts) == jsampler.tree_shape(fanouts)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sample_fanout_equals_the_reference(name):
    g = GRAPHS[name]
    seeds = np.random.default_rng(7).integers(0, g.n_nodes, 24)
    fanouts = (5, 3)
    ref = jsampler.sample_fanout(g, seeds, fanouts,
                                 np.random.default_rng(11))
    got = sampler.sample_fanout(carry_graph(g), seeds, fanouts,
                                np.random.default_rng(11))
    for f in dataclasses.fields(ref):
        _assert_equal(getattr(ref, f.name), getattr(got, f.name), f.name)
    assert got.n_nodes == ref.n_nodes == sampler.sampled_shape(24, fanouts)[0]
    if name == "isolated":
        # some seeds are isolated: their samples are marked invalid
        assert not got.edge_valid.all() and got.edge_valid.any()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sample_fanout_trees_equals_the_reference(name):
    g = GRAPHS[name]
    seeds = np.random.default_rng(8).integers(0, g.n_nodes, 8)
    fanouts = (3, 2)
    ref = jsampler.sample_fanout_trees(g, seeds, fanouts,
                                       np.random.default_rng(1))
    got = sampler.sample_fanout_trees(carry_graph(g), seeds, fanouts,
                                      np.random.default_rng(1))
    assert sorted(ref) == sorted(got)
    for key in ref:
        _assert_equal(ref[key], got[key], key)


def test_gnn_full_batch_equals_the_reference():
    g = GRAPHS["web"]
    ref = j_full_batch(3, g, d_feat=8, n_classes=5)
    got = gnn_full_batch(3, carry_graph(g), d_feat=8, n_classes=5)
    assert sorted(ref) == sorted(got)
    for key in ref:
        assert got[key].device.type == "cpu"
        _assert_equal(ref[key], got[key], key)


@pytest.mark.parametrize("step", [0, 5])
def test_gnn_sampled_batch_equals_the_reference(step):
    g = GRAPHS["web"]
    args = dict(batch_nodes=32, fanouts=(4, 3), d_feat=6, n_classes=4)
    ref = j_sampled_batch(2, step, g, jsampler.sample_fanout, **args)
    got = gnn_sampled_batch(2, step, carry_graph(g), sampler.sample_fanout,
                            **args)
    assert sorted(ref) == sorted(got)
    for key in ref:
        assert isinstance(got[key], torch.Tensor)
        _assert_equal(ref[key], got[key], key)
