"""The GNN serving path on the card against the CPU (``repro_torch``).

Marked ``gpu``: without a CUDA device every test here skips (the decision
is taken inside the ``cuda`` fixture, never at import). On a machine with
one: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gnn_cuda.py``. Imports torch and numpy only (the card's
machine has no JAX).

Each arch's SMOKE forward on the card, from one state dict, must match
the CPU's within rtol 1e-4, atol 1e-4 (Equiformer-v2: 1e-3, 1e-3), with
TF32 off; ``index_add_`` on CUDA adds in no fixed order, so the bits may
differ. The sampler on a CUDA graph must give the CPU graph's batch
exactly, and the GNN batches land on the graph's device. ``launch.serve``
times forwards on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import (gnn_full_batch, gnn_sampled_batch,
                                        molecule_batch)
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import sampler
from repro_torch.graphs.csr import graph_from_arrays
from repro_torch.launch import serve
from repro_torch.launch.cells import _gnn_apply, _gnn_init

pytestmark = pytest.mark.gpu

ARCHS = ["pna", "meshgraphnet", "egnn", "equiformer-v2"]
TOL = {"pna": 1e-4, "meshgraphnet": 1e-4, "egnn": 1e-4,
       "equiformer-v2": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the GNN path on "
                    "the card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old[0]
    torch.set_float32_matmul_precision(old[1])


def _on_card(graph):
    return graph_from_arrays(graph.offsets.numpy(), graph.indices.numpy(),
                             graph.weights.numpy(), graph.n_nodes,
                             device="cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_on_the_card_equals_the_cpu(cuda, arch):
    spec = get_arch(arch)
    cfg = spec.smoke
    if arch == "equiformer-v2":
        cpu_batch = molecule_batch(0, 16, 30, 64, cfg.d_in, device="cpu")
        card_batch = {k: v.to(cuda) for k, v in cpu_batch.items()}
    else:
        g, _ = tgen.powerlaw_communities(1 << 10, p_in=0.5, mix=0.02,
                                         seed=1, device="cpu")
        cpu_batch = gnn_full_batch(0, g, d_feat=8)
        card_batch = gnn_full_batch(0, _on_card(g), d_feat=8)
    model = _gnn_init(spec, cfg)(torch.Generator().manual_seed(0),
                                 device="cpu")
    card = _gnn_init(spec, cfg)(torch.Generator().manual_seed(1),
                                device=cuda)
    card.load_state_dict(model.state_dict())
    apply = _gnn_apply(spec, cfg)
    with torch.inference_mode():
        ref = apply(model, cpu_batch)
        got = apply(card, card_batch)
    assert got.device.type == "cuda" and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.cpu(), ref, rtol=TOL[arch],
                               atol=TOL[arch])


def test_sampler_on_a_card_graph_equals_the_cpu_graph(cuda):
    g, _ = tgen.powerlaw_communities(1 << 12, p_in=0.5, mix=0.02, seed=1,
                                     device="cpu")
    gc = _on_card(g)
    seeds = np.random.default_rng(0).integers(0, g.n_nodes, 64)
    ref = sampler.sample_fanout(g, seeds, (15, 10),
                                np.random.default_rng(1))
    got = sampler.sample_fanout(gc, seeds, (15, 10),
                                np.random.default_rng(1))
    for f in dataclasses.fields(ref):
        assert np.array_equal(getattr(ref, f.name), getattr(got, f.name))
    args = dict(batch_nodes=64, fanouts=(15, 10), d_feat=12)
    ref = gnn_sampled_batch(0, 2, g, sampler.sample_fanout, **args)
    got = gnn_sampled_batch(0, 2, gc, sampler.sample_fanout, **args)
    for key in ref:
        assert got[key].device.type == "cuda"
        assert torch.equal(got[key].cpu(), ref[key]), key


def test_serve_times_forwards_on_the_card(cuda):
    """``launch.serve.serve``: one median per batch from CUDA events, peak
    memory at least the resident, the first output's shape, finite."""
    g, _ = tgen.powerlaw_communities(1 << 10, p_in=0.5, mix=0.02, seed=1,
                                     device="cpu")
    batch = gnn_full_batch(0, _on_card(g), d_feat=8)
    model, apply = serve.gnn_model("pna", get_arch("pna").smoke)
    r = serve.serve(apply, model, [batch, batch], warmup=1, reps=3)
    assert len(r["ms"]) == 2 and all(ms > 0 for ms in r["ms"])
    assert r["peak_bytes"] >= r["resident_bytes"] > 0
    assert r["shape"] == [g.n_nodes, get_arch("pna").smoke.d_out]
    assert r["finite"]
