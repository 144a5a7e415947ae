"""repro_torch's per-bucket ``pallas`` engine and the ``exact_weighted``
MG variant against repro's, on the CPU: the engine's executors and
launch counts, and lpa() end to end (labels, iterations, convergence and
every history equal) for νMG, νBM and the rescan ablation. On the CPU the
engine's tile folds are K9/K10's plain versions; the JAX side runs its
Pallas tile kernels in interpret mode. Every comparison is exact."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.fold_engine import get_engine as jget_engine
from repro.core.fold_program import FoldRequest as JRequest
from repro.core.lpa import LPAConfig as JConfig
from repro.core.lpa import build_workspace as jbuild_workspace
from repro.core.lpa import lpa as jlpa
from repro_torch.core.fold_engine import PallasEngine
from repro_torch.core.fold_engine import get_engine as tget_engine
from repro_torch.core.fold_program import FoldRequest as TRequest
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.core.lpa import build_workspace as tbuild_workspace
from repro_torch.core.lpa import lpa as tlpa
from repro_torch.graphs.csr import plan_dispatches, plan_round0_dispatches
from test_fused_engine import FIXTURES
from test_torch_lpa import _assert_same_run
from _torch_parity import CPU, assert_same_array, carry_graph, random_entries
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

METHODS = {"mg": dict(method="mg"), "bm": dict(method="bm"),
           "rescan": dict(method="mg", rescan=True)}


def _same_runs(g, **cfg):
    ref = jlpa(g, JConfig(**cfg))
    got = tlpa(carry_graph(g), TConfig(**cfg), device=CPU)
    _assert_same_run(ref, got)
    return got


@pytest.mark.parametrize("method", sorted(METHODS))
def test_pallas_engine_run_matches_reference(method):
    """One routed iteration through ``engine.run`` on random entries and
    random incumbents: the wanted labels (and BM's raw states) equal the
    JAX pallas engine's."""
    g = FIXTURES["powerlaw"]()
    cfg = dict(fold_backend="pallas", chunk=16, k=4, **METHODS[method])
    jws = jbuild_workspace(g, JConfig(**cfg))
    tws = tbuild_workspace(carry_graph(g), TConfig(**cfg))
    assert tws.fused_plan is None and tws.stream_plan is None
    rng = np.random.default_rng(11)
    el, ew = random_entries(g.n_nodes, g.n_edges, rng)
    cur = rng.integers(0, g.n_nodes, g.n_nodes).astype(np.int32)
    req = dict(family=cfg["method"], rescan=cfg.get("rescan", False))
    jeng = jget_engine("pallas", checked=False)
    # jitted: one compile of the interpret-mode tile kernels, not an eager
    # interpretation of every bucket
    ref = jax.jit(lambda el, ew, cur: dataclasses.astuple(jeng.run(
        jws.bundle, JRequest(seed=jnp.int32(3), **req), el, ew, cur)))(
        jnp.asarray(el), jnp.asarray(ew), jnp.asarray(cur))
    got = tget_engine("pallas").run(
        tws.bundle, TRequest(seed=3, **req), torch.from_numpy(el),
        torch.from_numpy(ew), torch.from_numpy(cur))
    assert_same_array(ref[0], got.want, "want")
    if method == "bm":
        assert_same_array(ref[1], got.bm_label, "bm_label")
        assert_same_array(ref[2], got.bm_weight, "bm_weight")


def test_pallas_engine_candidates_and_launch_counts_match_reference():
    g = FIXTURES["star_hub"]()
    cfg = dict(fold_backend="pallas", chunk=16, k=8)
    jws = jbuild_workspace(g, JConfig(**cfg))
    tws = tbuild_workspace(carry_graph(g), TConfig(**cfg))
    el, ew = random_entries(g.n_nodes, g.n_edges, np.random.default_rng(2))
    jeng, teng = jget_engine("pallas", checked=False), tget_engine("pallas")
    assert isinstance(teng, PallasEngine) and teng.name == "pallas"
    ref = jax.jit(lambda el, ew: jeng.mg_candidates(jws.plan, None, el, ew))(
        jnp.asarray(el), jnp.asarray(ew))
    got = teng.mg_candidates(tws.plan, None, torch.from_numpy(el),
                             torch.from_numpy(ew))
    assert_same_array(ref[0], got[0], "cand_c")
    assert_same_array(ref[1], got[1], "cand_w")
    frontier = torch.ones(g.n_nodes, dtype=torch.bool)
    for family, rescan in (("mg", False), ("bm", False), ("mg", True)):
        want = jeng.dispatches_per_iter(
            jws.plan, None, JRequest(family=family, rescan=rescan))
        for req in (TRequest(family=family, rescan=rescan),
                    TRequest(family=family, rescan=rescan, mode="sparse",
                             frontier=frontier, cap_rows=8)):
            assert teng.dispatches_per_iter(tws.plan, None, req) == want
    assert (teng.dispatches_per_iter(tws.plan, None, TRequest())
            == plan_dispatches(tws.plan) > plan_round0_dispatches(tws.plan))


@pytest.mark.parametrize("name,method", [
    ("powerlaw", "mg"), ("powerlaw", "bm"), ("powerlaw", "rescan"),
    ("star_hub", "mg"), ("road_deg2", "bm"), ("zero_degree", "mg"),
    ("empty", "mg")])
def test_lpa_pallas_matches_reference(name, method):
    _same_runs(FIXTURES[name](), rho=2, max_iters=8, fold_backend="pallas",
               **METHODS[method])


def test_lpa_pallas_many_rounds_matches_reference():
    """chunk 16: several merge rounds, each bucket of each through its own
    tile fold."""
    _same_runs(FIXTURES["star_hub"](), rho=2, chunk=16, max_iters=8,
               fold_backend="pallas")


def test_lpa_pallas_equals_the_plain_engine():
    """The per-bucket engine and the plain-torch engine walk one plan with
    one fold: the port's runs are equal for every method."""
    g = carry_graph(FIXTURES["powerlaw"]())
    for extra in METHODS.values():
        cfg = dict(rho=2, chunk=16, max_iters=6, **extra)
        ref = tlpa(g, TConfig(fold_backend="jnp", **cfg), device=CPU)
        got = tlpa(g, TConfig(fold_backend="pallas", **cfg), device=CPU)
        assert torch.equal(ref.labels, got.labels)
        assert ref.changed_history == got.changed_history


# ---------------------------------------------------------------------------
# the exact weighted MG variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["powerlaw", "star_hub"])
@pytest.mark.parametrize("rescan", [False, True])
def test_lpa_exact_weighted_matches_reference(name, rescan):
    got = _same_runs(FIXTURES[name](), rho=2, chunk=16, max_iters=8,
                     fold_backend="jnp", mg_variant="exact_weighted",
                     rescan=rescan)
    if name == "powerlaw":  # the variant changes this run: it really ran
        paper = tlpa(carry_graph(FIXTURES[name]()),
                     TConfig(rho=2, chunk=16, max_iters=8, rescan=rescan),
                     device=CPU)
        assert paper.changed_history != got.changed_history


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused",
                                     "pallas_stream"])
def test_kernel_engines_compute_the_paper_rule_whatever_the_variant(backend):
    """As in the reference, only the jnp engine honours
    ``mg_variant="exact_weighted"``: the kernel engines compute Alg. 2, in
    both packages."""
    g = FIXTURES["powerlaw"]()
    cfg = dict(rho=2, chunk=16, max_iters=6, fold_backend=backend)
    ref = jlpa(g, JConfig(mg_variant="exact_weighted", **cfg))
    gt = carry_graph(g)
    got = tlpa(gt, TConfig(mg_variant="exact_weighted", **cfg), device=CPU)
    paper = tlpa(gt, TConfig(**cfg), device=CPU)
    _assert_same_run(ref, got)
    assert torch.equal(got.labels, paper.labels)
    assert tget_engine(backend, mg_variant="exact_weighted").name == backend
