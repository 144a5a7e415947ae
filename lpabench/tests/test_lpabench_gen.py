"""The device-side generators, on the CPU at small sizes: vertex and slot
counts, symmetry of slots and weights, no self-loop or duplicate, degree
bounds, and one graph per seed."""
import json

import pytest
import torch

from conftest import ROOT, TINY
from lpabench.gen import make_graph
from lpabench.gen.road_lattice import street_counts

BIG_SEED = 2**33 + 12345


def _config(name):
    return json.loads((ROOT / "lpabench" / "configs" / f"{name}.json")
                      .read_text())


def _tiny(name):
    conf = _config(name)
    conf["graph"].update(TINY[name])
    return conf


def _check_csr(offsets, indices, weights, n):
    assert offsets.dtype == torch.int32 and indices.dtype == torch.int32
    assert weights.dtype == torch.float32
    assert offsets.shape == (n + 1,) and int(offsets[0]) == 0
    assert int(offsets[-1]) == indices.numel() == weights.numel()
    deg = (offsets[1:] - offsets[:-1]).long()
    src = torch.repeat_interleave(torch.arange(n), deg)
    dst = indices.long()
    assert bool((src != dst).all()), "self-loop"
    key = src * n + dst
    assert bool((key[1:] > key[:-1]).all()), "slots unsorted or duplicated"
    # every slot (i, j) has its mirror (j, i), with the same weight
    back = torch.searchsorted(key, dst * n + src)
    assert bool((key[back] == dst * n + src).all()), "asymmetric"
    assert torch.equal(weights[back], weights)
    assert bool((weights > 0).all()) and bool((weights <= 1).all())
    return deg


def test_road_lands_on_the_counts_with_degree_at_most_4():
    conf = _tiny("europe_osm")
    g = conf["graph"]
    o, i, w = make_graph("road_lattice", g, BIG_SEED, "cpu")
    deg = _check_csr(o, i, w, g["n_nodes"])
    assert i.numel() == g["n_slots"]
    assert int(deg.max()) <= 4
    inter, _, _, chain = street_counts(g)
    assert int((deg == 2).sum()) >= chain  # every chain vertex
    assert int((deg > 2).sum()) <= inter


def test_road_full_size_counts_land():
    inter, full, kept, chain = street_counts(_config("europe_osm")["graph"])
    assert inter + chain == 50_912_018
    assert 2 * (kept + chain) == 108_109_320
    assert full - kept == 4_433


def test_web_counts_and_symmetry():
    conf = _tiny("uk2002")
    g = conf["graph"]
    o, i, w = make_graph("powerlaw_web", g, BIG_SEED, "cpu")
    deg = _check_csr(o, i, w, g["n_nodes"])
    assert int(deg.min()) >= 0
    assert int(deg.max()) <= g["hub_deg_max"] + g["n_nodes"]


@pytest.mark.parametrize("name,gen", [("uk2002", "powerlaw_web"),
                                      ("europe_osm", "road_lattice")])
def test_one_graph_per_seed_same_sizes(name, gen):
    g = _tiny(name)["graph"]
    a = make_graph(gen, g, 7, "cpu")
    b = make_graph(gen, g, 7, "cpu")
    c = make_graph(gen, g, 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not (a[1].shape == c[1].shape and torch.equal(a[1], c[1]))
    # the seed moves the graph, not its size
    assert abs(a[1].numel() - c[1].numel()) <= 0.01 * a[1].numel()
