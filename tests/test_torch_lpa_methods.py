"""repro_torch's lpa() against repro's for the methods beside νMG: νBM
(``method="bm"``), the rescan ablation (``method="mg", rescan=True``) on
both ported backends, and exact LPA (``method="exact"``, which folds
nothing). Labels, iterations, convergence and every history are equal;
modularity agrees within 1e-5 (its final sums add in another order).
The JAX side runs the Pallas fused engine in interpret mode."""
import pytest

import repro.graphs.generators as jgen
import repro_torch.graphs.generators as tgen
from repro.core.lpa import LPAConfig as JConfig
from repro.core.lpa import lpa as jlpa
from repro.core.modularity import modularity as jmodularity
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.core.lpa import lpa as tlpa
from repro_torch.core.modularity import modularity as tmodularity
from _torch_parity import CPU
from test_torch_lpa import GRAPHS, _assert_same_run

METHODS = {
    "bm": {"method": "bm"},
    "mg+rescan": {"method": "mg", "rescan": True},
}


def _check(graph, cfg):
    gj = GRAPHS[graph](jgen)
    gt = GRAPHS[graph](tgen, device=CPU)
    ref = jlpa(gj, JConfig(**cfg))
    got = tlpa(gt, TConfig(**cfg), device=CPU)
    _assert_same_run(ref, got)
    q_ref = float(jmodularity(gj, ref.labels))
    q_got = float(tmodularity(gt, got.labels))
    assert abs(q_got - q_ref) <= 1e-5, (q_got, q_ref)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
@pytest.mark.parametrize("rho", [2, 8])
def test_lpa_sketch_methods_match_reference(graph, method, backend, rho):
    _check(graph, dict(METHODS[method], rho=rho, fold_backend=backend))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("rho", [2, 8])
def test_lpa_exact_matches_reference(graph, rho):
    _check(graph, dict(method="exact", rho=rho))


def test_lpa_bm_with_frontier_gate_matches_reference():
    _check("ring_of_cliques", dict(method="bm", rho=2, frontier_gate=True,
                                   fold_backend="pallas_fused"))
