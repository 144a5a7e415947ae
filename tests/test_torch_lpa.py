"""repro_torch's lpa() against repro's, end to end on the CPU: equal labels,
iterations, convergence and histories for νMG8-LPA on both ported
backends; modularity within 1e-5 (its segment sums add in another
order). The JAX side runs the Pallas fused engine in interpret mode."""
import numpy as np
import pytest

import repro.graphs.generators as jgen
import repro_torch.graphs.generators as tgen
from repro.core.lpa import LPAConfig as JConfig
from repro.core.lpa import lpa as jlpa
from repro.core.modularity import modularity as jmodularity
from repro.core.modularity import nmi as jnmi
from repro.core.plan_bundle import build_plan_bundle as j_build_bundle
from repro.core.plan_bundle import spec_for as j_spec_for
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.core.lpa import lpa as tlpa
from repro_torch.core.modularity import modularity as tmodularity
from repro_torch.core.modularity import nmi as tnmi
from repro_torch.core.plan_bundle import build_plan_bundle as t_build_bundle
from repro_torch.core.plan_bundle import spec_for as t_spec_for
from _torch_parity import CPU, assert_same, assert_same_array

GRAPHS = {
    "powerlaw": lambda m, **kw: m.powerlaw_communities(
        2048, p_in=0.5, mix=0.02, seed=1, **kw)[0],
    "ring_of_cliques": lambda m, **kw: m.ring_of_cliques(16, 8, **kw)[0],
    # n = 600 is not a power of two: frontier_history's float32 mean
    # rounds differently under a division and a reciprocal multiply
    "chain_kmer": lambda m, **kw: m.chain_kmer(600, seed=3, **kw),
}


def _assert_same_run(ref, got):
    assert_same_array(ref.labels, got.labels, "labels")
    assert got.iterations == ref.iterations
    assert got.converged == ref.converged
    assert got.changed_history == ref.changed_history
    assert got.frontier_history == ref.frontier_history
    assert got.work_rows_history == ref.work_rows_history


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
@pytest.mark.parametrize("rho", [2, 8])
def test_lpa_matches_reference(graph, backend, rho):
    gj = GRAPHS[graph](jgen)
    gt = GRAPHS[graph](tgen, device=CPU)
    ref = jlpa(gj, JConfig(method="mg", rho=rho, fold_backend=backend))
    got = tlpa(gt, TConfig(method="mg", rho=rho, fold_backend=backend),
               device=CPU)
    _assert_same_run(ref, got)
    q_ref = float(jmodularity(gj, ref.labels))
    q_got = float(tmodularity(gt, got.labels))
    assert abs(q_got - q_ref) <= 1e-5, (q_got, q_ref)


def test_lpa_frontier_gate_matches_reference():
    gj, truth = jgen.ring_of_cliques(16, 8)
    gt, _ = tgen.ring_of_cliques(16, 8, device=CPU)
    ref = jlpa(gj, JConfig(method="mg", rho=2, frontier_gate=True,
                           fold_backend="pallas_fused"))
    got = tlpa(gt, TConfig(method="mg", rho=2, frontier_gate=True,
                           fold_backend="pallas_fused"), device=CPU)
    _assert_same_run(ref, got)
    # NMI sums its terms in another order (sparse contingency table)
    assert abs(tnmi(got.labels, truth)
               - jnmi(np.asarray(ref.labels), truth)) <= 1e-12


def test_lpa_auto_resolves_to_fused_on_a_small_graph():
    """8·|E| fits the reference's budget: "auto" runs the fused engine
    and gives the fused engine's results."""
    gj = GRAPHS["chain_kmer"](jgen)
    gt = GRAPHS["chain_kmer"](tgen, device=CPU)
    ref = jlpa(gj, JConfig(method="mg", rho=2, fold_backend="auto"))
    got = tlpa(gt, TConfig(method="mg", rho=2, fold_backend="auto"),
               device=CPU)
    _assert_same_run(ref, got)


def test_lpa_without_frontier_tracking():
    gt = GRAPHS["ring_of_cliques"](tgen, device=CPU)
    gj = GRAPHS["ring_of_cliques"](jgen)
    ref = jlpa(gj, JConfig(method="mg", track_frontier=False))
    got = tlpa(gt, TConfig(method="mg", track_frontier=False), device=CPU)
    _assert_same_run(ref, got)
    assert got.frontier_history == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nmi_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40, 3000)
    b = np.where(rng.random(3000) < 0.7, a // 2, rng.integers(0, 25, 3000))
    assert abs(tnmi(a, b) - jnmi(a, b)) <= 1e-12
    assert tnmi(a, a) == pytest.approx(1.0)


@pytest.mark.parametrize("backend,cap", [("jnp", None), ("pallas_fused", None),
                                         ("auto", 17)])
def test_plan_bundle_matches_reference(backend, cap):
    """The bundle's resolved spec, both plans and the sizing policy."""
    gj = GRAPHS["powerlaw"](jgen)
    gt = GRAPHS["powerlaw"](tgen, device=CPU)
    jb = j_build_bundle(gj, j_spec_for(JConfig(fold_backend=backend,
                                               frontier_cap_rows=cap)))
    tb = t_build_bundle(gt, t_spec_for(TConfig(fold_backend=backend,
                                               frontier_cap_rows=cap)))
    assert tb.spec == t_spec_for(TConfig(fold_backend=jb.spec.backend,
                                         frontier_cap_rows=cap))
    assert_same(jb.plan, tb.plan, "plan")
    assert_same(jb.fused_plan, tb.fused_plan, "fused_plan")
    assert tb.dense_work_rows() == jb.dense_work_rows()
    assert tb.default_cap_rows() == jb.default_cap_rows()
    assert tb.cap_rows() == jb.cap_rows()
