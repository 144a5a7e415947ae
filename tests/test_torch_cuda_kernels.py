"""The hand-written CUDA kernels K1 (fold) and K2 (fold + select) against
their plain-torch versions on the card, bit for bit, and the whole fused
path on the card against the plain-torch reference engine.

Marked ``gpu``: without a CUDA device every test here skips (the decision
is taken inside the ``cuda`` fixture, never at import). On a machine with
a card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.lpa import LPAConfig, lpa
from repro_torch.graphs import generators as tgen
from repro_torch.graphs.csr import build_fused_fold_plan
from repro_torch.kernels.mg_sketch import fused

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests launch the CUDA kernels")
    return torch.device("cuda")


def _round_inputs(rnd, rng, dev, alphabet):
    n_in = rnd.n_entries_in
    labels = rng.integers(-1, alphabet, n_in).astype(np.int32)
    weights = (rng.integers(0, 8, n_in) * 0.375).astype(np.float32)
    return (torch.from_numpy(labels).to(dev),
            torch.from_numpy(weights).to(dev))


@pytest.mark.parametrize("k,chunk,tile_r", [(8, 128, 128), (4, 16, 8),
                                            (32, 128, 128)])
def test_fold_kernel_matches_plain(cuda, k, chunk, tile_r):
    g, _ = tgen.powerlaw_communities(4096, p_in=0.4, mix=0.05, seed=7,
                                     device="cpu")
    plan = build_fused_fold_plan(g.degrees.numpy(), k=k, chunk=chunk,
                                 tile_r=tile_r, device=cuda)
    rng = np.random.default_rng(k)
    for rnd in plan.rounds:
        el, ew = _round_inputs(rnd, rng, cuda, alphabet=3 * k)
        fused.reset_launch_counts()
        got_k, got_v = fused.fused_fold_round(rnd, el, ew, k=k, chunk=chunk)
        torch.cuda.synchronize()
        assert fused.LAUNCH_COUNTS["fused_fold"] == 1
        ref_k, ref_v = fused.fused_fold_round_plain(rnd, el, ew, k=k,
                                                    chunk=chunk)
        assert torch.equal(got_k, ref_k)
        assert torch.equal(got_v, ref_v)


@pytest.mark.parametrize("seed", [1, 2, 5, 11])
def test_select_kernel_matches_plain(cuda, seed):
    g, _ = tgen.powerlaw_communities(4096, p_in=0.4, mix=0.05, seed=7,
                                     device="cpu")
    plan = build_fused_fold_plan(g.degrees.numpy(), k=8, chunk=128,
                                 tile_r=128, device=cuda)
    rng = np.random.default_rng(seed)
    rnd = plan.rounds[-1]
    el, ew = _round_inputs(rnd, rng, cuda, alphabet=12)
    inc = torch.from_numpy(rng.integers(-1, 12, rnd.row_start.numel())
                           .astype(np.int32)).to(cuda)
    fused.reset_launch_counts()
    got = fused.fused_select_round(rnd, el, ew, inc, seed, k=8, chunk=128)
    torch.cuda.synchronize()
    assert fused.LAUNCH_COUNTS["fused_select"] == 1
    ref = fused.fused_select_round_plain(rnd, el, ew, inc, seed, k=8,
                                         chunk=128)
    assert torch.equal(got, ref)


def test_fused_path_matches_reference_engine_on_the_card(cuda):
    g, _ = tgen.powerlaw_communities(4096, p_in=0.5, mix=0.02, seed=1,
                                     device=cuda)
    ref = lpa(g, LPAConfig(method="mg", rho=2, fold_backend="jnp"))
    fused.reset_launch_counts()
    got = lpa(g, LPAConfig(method="mg", rho=2, fold_backend="pallas_fused"))
    assert torch.equal(got.labels, ref.labels)
    assert got.changed_history == ref.changed_history
    assert got.frontier_history == ref.frontier_history
    assert fused.LAUNCH_COUNTS["fused_select"] == got.iterations


def test_unsupported_k_raises_on_the_card(cuda):
    g, _ = tgen.powerlaw_communities(1024, seed=7, device="cpu")
    plan = build_fused_fold_plan(g.degrees.numpy(), k=3, chunk=16,
                                 tile_r=8, device=cuda)
    rnd = plan.rounds[0]
    el = torch.zeros(rnd.n_entries_in, dtype=torch.int32, device=cuda)
    ew = torch.ones(rnd.n_entries_in, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        fused.fused_fold_round(rnd, el, ew, k=3, chunk=16)
