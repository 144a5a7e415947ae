"""The streamed engine of repro_torch against the JAX package's, bit for
bit on the CPU: the dense drivers (MG fold, MG iteration, νBM, rescan) on
aligned and unaligned plans, ``PallasStreamEngine`` through the routed
``FoldEngine.run``, its candidate sets and its launch accounting. The
JAX side runs its Pallas streaming kernels in interpret mode."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fold_engine import get_engine as j_get_engine
from repro.core.fold_program import FoldRequest as JRequest
from repro.core.lpa import LPAConfig as JConfig
from repro.core.plan_bundle import build_plan_bundle as j_build_bundle
from repro.core.plan_bundle import spec_for as j_spec_for
from repro.graphs import csr as jcsr
from repro.kernels.mg_sketch import streaming as jstream
from repro_torch.core import sketch as tsk
from repro_torch.core.fold_engine import get_engine as t_get_engine
from repro_torch.core.fold_program import FoldRequest as TRequest
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.core.plan_bundle import build_plan_bundle as t_build_bundle
from repro_torch.core.plan_bundle import spec_for as t_spec_for
from repro_torch.graphs import csr as tcsr
from repro_torch.kernels.mg_sketch import streaming as tstream
from test_stream_engine import FIXTURES
from _torch_parity import CPU, assert_same_array, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

# the reference drivers under jit, as its lpa() runs them
_j_run_mg = jax.jit(jstream.run_mg_plan_stream)
_j_select = jax.jit(jstream.select_best_stream)
_j_run_bm = jax.jit(jstream.run_bm_plan_stream)
_j_rescan = jax.jit(jstream.rescan_select_stream)

_KW = dict(k=4, chunk=16, tile_r=8, window_entries=64)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _inputs(g, aligned, rng):
    """Both packages' streamed plans and round-0 arrays for one labelling:
    CSR-order ``labels[indices]``, or the aligned window-slot gather."""
    kw = dict(_KW, indices=np.asarray(g.indices),
              weights=np.asarray(g.weights), aligned=aligned)
    degrees = np.asarray(g.degrees)
    jplan = jcsr.build_streamed_fold_plan(degrees, **kw)
    tplan = tcsr.build_streamed_fold_plan(degrees, device=CPU, **kw)
    labels = rng.integers(0, max(g.n_nodes // 8, 2), g.n_nodes
                          ).astype(np.int32)
    if aligned:
        ext = np.concatenate([labels, [-1]]).astype(np.int32)
        el = ext[np.asarray(jplan.aligned_entry_vertex)]
        ew = np.asarray(jplan.aligned_entry_weights)
    else:
        el = labels[np.asarray(g.indices)]
        ew = np.asarray(g.weights)
    return jplan, tplan, labels, el, ew


_DRIVER_CASES = [(name, False) for name in sorted(FIXTURES)] + [
    ("powerlaw", True), ("star_hub", True)]


@pytest.mark.parametrize("name,aligned", _DRIVER_CASES)
def test_stream_drivers_match_reference(name, aligned):
    g = FIXTURES[name]()
    rng = np.random.default_rng(zlib.crc32(name.encode()) + aligned)
    jplan, tplan, labels, el, ew = _inputs(g, aligned, rng)
    j_args = (jnp.asarray(el), jnp.asarray(ew))
    t_args = (_t(el), _t(ew))
    ref = _j_run_mg(jplan, *j_args)
    got = tstream.run_mg_plan_stream(tplan, *t_args)
    assert_same_array(ref[0], got[0], "final sketch labels")
    assert_same_array(ref[1], got[1], "final sketch weights")
    ref = _j_select(jplan, *j_args, jnp.asarray(labels), jnp.int32(5))
    got = tstream.select_best_stream(tplan, *t_args, _t(labels), 5)
    assert_same_array(ref, got, "MG want")
    ref = _j_rescan(jplan, *j_args, jnp.asarray(labels), jnp.int32(5))
    got = tstream.rescan_select_stream(tplan, *t_args, _t(labels), 5)
    assert_same_array(ref, got, "rescan want")
    ref = _j_run_bm(jplan, *j_args, jnp.asarray(labels))
    got = tstream.run_bm_plan_stream(tplan, *t_args, _t(labels))
    assert_same_array(ref[0], got[0], "BM labels")
    assert_same_array(ref[1], got[1], "BM weights")


_REQUESTS = {"mg": {}, "mg+rescan": {"rescan": True}, "bm": {"family": "bm"}}


def _bundles(g, aligned):
    cfg = dict(fold_backend="pallas_stream", aligned_layout=aligned,
               stream_window=256)
    jb = j_build_bundle(g, j_spec_for(JConfig(**cfg)))
    tb = t_build_bundle(carry_graph(g), t_spec_for(TConfig(**cfg)))
    return jb, tb


@pytest.mark.parametrize("req,aligned", [(req, False) for req in
                                         sorted(_REQUESTS)]
                         + [("mg", True)])
def test_engine_run_matches_reference(req, aligned):
    g = FIXTURES["powerlaw"]()
    jb, tb = _bundles(g, aligned)
    rng = np.random.default_rng(41)
    labels = rng.integers(0, 64, g.n_nodes).astype(np.int32)
    if aligned:
        ext = np.concatenate([labels, [-1]]).astype(np.int32)
        el = ext[np.asarray(jb.stream_plan.aligned_entry_vertex)]
        ew = np.asarray(jb.stream_plan.aligned_entry_weights)
    else:
        el, ew = labels[np.asarray(g.indices)], np.asarray(g.weights)
    jeng = j_get_engine("pallas_stream", checked=False)
    teng = t_get_engine("pallas_stream")
    assert teng.name == "pallas_stream" and teng.uses_stream_plan
    assert tb.aux_for(teng) is tb.stream_plan
    jout = jeng.run(jb, JRequest(seed=jnp.int32(5), aligned=aligned,
                                 **_REQUESTS[req]),
                    jnp.asarray(el), jnp.asarray(ew), jnp.asarray(labels))
    tout = teng.run(tb, TRequest(seed=5, aligned=aligned, **_REQUESTS[req]),
                    _t(el), _t(ew), _t(labels))
    assert_same_array(jout.want, tout.want, "want")
    if req == "bm":
        assert_same_array(jout.bm_label, tout.bm_label, "bm_label")
        assert_same_array(jout.bm_weight, tout.bm_weight, "bm_weight")
    else:
        assert tout.bm_label is None and tout.bm_weight is None
    if req == "mg" and not aligned:
        ref = jeng.mg_candidates(jb.plan, jb.stream_plan, jnp.asarray(el),
                                 jnp.asarray(ew))
        got = teng.mg_candidates(tb.plan, tb.stream_plan, _t(el), _t(ew))
        assert_same_array(ref[0], got[0], "candidate labels")
        assert_same_array(ref[1], got[1], "candidate weights")


@pytest.mark.parametrize("req", sorted(_REQUESTS))
@pytest.mark.parametrize("name", ["powerlaw", "star_hub"])
def test_dispatches_per_iter_match_reference(req, name):
    jb, tb = _bundles(FIXTURES[name](), aligned=False)
    jeng = j_get_engine("pallas_stream", checked=False)
    teng = t_get_engine("pallas_stream")
    want = jeng.dispatches_per_iter(jb.plan, jb.aux_for(jeng),
                                    JRequest(seed=1, **_REQUESTS[req]))
    got = teng.dispatches_per_iter(tb.plan, tb.aux_for(teng),
                                   TRequest(seed=1, **_REQUESTS[req]))
    assert got == want
    n_rounds = tb.stream_plan.n_rounds
    assert got == {"mg": n_rounds, "mg+rescan": n_rounds + 1,
                   "bm": 1}[req]


def test_stream_engine_needs_its_plan():
    g = FIXTURES["powerlaw"]()
    gt = carry_graph(g)
    tb = t_build_bundle(gt, t_spec_for(TConfig(fold_backend="pallas_fused")))
    assert tb.stream_plan is None
    assert tb.aux_for(t_get_engine("pallas_stream")) is None
    labels = torch.arange(g.n_nodes, dtype=torch.int32)
    el = labels[gt.indices.long()]
    eng = t_get_engine("pallas_stream")
    for call in (lambda: eng.mg_select(tb.plan, None, el, gt.weights,
                                       labels, 1),
                 lambda: eng.mg_rescan(tb.plan, None, el, gt.weights,
                                       labels, 1),
                 lambda: eng.bm_fold_plan(tb.plan, None, el, gt.weights,
                                          labels),
                 lambda: eng.mg_candidates(tb.plan, None, el, gt.weights)):
        with pytest.raises(ValueError, match="StreamedFoldPlan"):
            call()


def test_stream_rescan_is_kernel_routed_not_the_bucketed_walk(monkeypatch):
    """The streamed engine never calls the bucketed reference passes:
    poison them and it still gives the recorded answers."""
    g = FIXTURES["powerlaw"]()
    gt = carry_graph(g)
    _, tb = _bundles(g, aligned=False)
    labels = _t(np.random.default_rng(3).integers(0, g.n_nodes, g.n_nodes)
                .astype(np.int32))
    el = labels[gt.indices.long()]
    eng = t_get_engine("pallas_stream")
    ref = eng.mg_rescan(tb.plan, tb.stream_plan, el, gt.weights, labels, 3)

    def _poisoned(*a, **kw):
        raise AssertionError("a bucketed pass ran on the streamed engine")

    for fn in ("rescan_candidates", "run_bm_plan", "run_mg_plan",
               "select_best"):
        monkeypatch.setattr(tsk, fn, _poisoned)
    got = eng.mg_rescan(tb.plan, tb.stream_plan, el, gt.weights, labels, 3)
    assert torch.equal(got, ref)
    eng.mg_select(tb.plan, tb.stream_plan, el, gt.weights, labels, 3)
    eng.bm_fold_plan(tb.plan, tb.stream_plan, el, gt.weights, labels)
