"""The port's contract proxy (``repro_torch.core.checked``) against the
JAX package's (``repro.core.checked``), mirroring
``tests/test_checked_engines.py``: a checked engine is bit-identical to
the bare one on clean inputs, dense and sparse; each bad input of the
reference's suite (NaN weight, OOB stream gather, OOB fused row window,
the aligned plan's contract, a negative label) raises in both packages
with the same message; the ``REPRO_CHECKED`` hook turns the proxy on and
off and never reaches ``lpa_move``; dispatch accounting passes through.
Also the single-host leftovers: ``lpa_step_fn``, ``community_sizes`` and
``fused_hbm_entries`` equal the reference's. The contracts fire before
any fold, so the JAX side of the error tests runs no Pallas kernel."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from repro.core.fold_engine import get_engine as j_get_engine
from repro.core.fold_program import FoldRequest as JRequest
from repro.core.lpa import LPAConfig as JConfig
from repro.core.lpa import build_workspace as j_build_workspace
from repro.core.lpa import lpa_step_fn as j_lpa_step_fn
from repro.core.modularity import community_sizes as j_community_sizes
from repro.core.plan_bundle import PlanBundle as JBundle
from repro.core.plan_bundle import PlanSpec as JSpec
from repro.graphs import csr as jcsr
from repro.graphs.generators import ring_of_cliques as j_ring_of_cliques
from repro_torch.core import checked as tchecked
from repro_torch.core import fold_engine as tfe
from repro_torch.core.fold_program import FoldRequest as TRequest
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.core.lpa import build_workspace as t_build_workspace
from repro_torch.core.lpa import lpa as t_lpa
from repro_torch.core.lpa import lpa_step_fn as t_lpa_step_fn
from repro_torch.core.modularity import community_sizes as t_community_sizes
from repro_torch.core.plan_bundle import PlanBundle as TBundle
from repro_torch.core.plan_bundle import PlanSpec as TSpec
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs.generators import ring_of_cliques as t_ring_of_cliques
from repro_torch.kernels import launches
from _torch_parity import CPU, FIXTURES, assert_same_array, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

ENGINES = tfe.ENGINES
K, CHUNK, TILE_R, WINDOW = 4, 8, 8, 64


def _np_setup(n=5, seed=0):
    """The reference suite's fixture as numpy: degrees, entry labels,
    entry weights."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 12, size=n).astype(np.int64)
    n_entries = int(deg.sum())
    el = rng.integers(0, n, size=n_entries).astype(np.int32)
    ew = rng.random(n_entries).astype(np.float32)
    return deg, el, ew


def _t_setup(n=5, seed=0):
    deg, el, ew = _np_setup(n, seed)
    plan = tcsr.build_fold_plan(deg, k=K, chunk=CHUNK, device=CPU)
    aux = {
        "jnp": None, "pallas": None,
        "pallas_fused": tcsr.build_fused_fold_plan(
            deg, k=K, chunk=CHUNK, tile_r=TILE_R, device=CPU),
        "pallas_stream": tcsr.build_streamed_fold_plan(
            deg, k=K, chunk=CHUNK, tile_r=TILE_R, window_entries=WINDOW,
            device=CPU),
    }
    return (plan, aux, torch.from_numpy(el), torch.from_numpy(ew),
            torch.arange(n, dtype=torch.int32))


def _j_setup(n=5, seed=0):
    deg, el, ew = _np_setup(n, seed)
    plan = jcsr.build_fold_plan(deg, k=K, chunk=CHUNK)
    aux = {
        "jnp": None, "pallas": None,
        "pallas_fused": jcsr.build_fused_fold_plan(deg, k=K, chunk=CHUNK,
                                                   tile_r=TILE_R),
        "pallas_stream": jcsr.build_streamed_fold_plan(
            deg, k=K, chunk=CHUNK, tile_r=TILE_R, window_entries=WINDOW),
    }
    return (plan, aux, jnp.asarray(el), jnp.asarray(ew),
            jnp.arange(n, dtype=jnp.int32))


def _bundle(plan, aux, backend, bundle_cls, spec_cls):
    """A bundle of the fixture's plans for ``backend`` (the reference
    suite's ``_bundle``)."""
    spec = spec_cls(backend=backend, k=K, chunk=CHUNK, tile_r=TILE_R,
                    stream_window=WINDOW)
    return bundle_cls(
        plan=plan,
        fused_plan=aux[backend] if backend == "pallas_fused" else None,
        stream_plan=aux[backend] if backend == "pallas_stream" else None,
        spec=spec)


def _same_message(j_call, t_call, message):
    """Both calls raise, with ``message`` (a regex) in each; the port's
    message is the reference's text."""
    with pytest.raises(checkify.JaxRuntimeError, match=message) as j_err:
        j_call()
    with pytest.raises(tchecked.ContractError, match=message) as t_err:
        t_call()
    assert str(t_err.value) in str(j_err.value)


@pytest.mark.parametrize("backend", ENGINES)
def test_checked_engine_is_bit_identical(backend):
    plan, aux, el, ew, labels = _t_setup()
    launches.reset_launch_counts()
    plain = tfe.get_engine(backend, checked=False).mg_select(
        plan, aux[backend], el, ew, labels, 3)
    checked = tfe.get_engine(backend, checked=True).mg_select(
        plan, aux[backend], el, ew, labels, 3)
    assert torch.equal(plain, checked)
    assert not any(launches.LAUNCH_COUNTS.values())  # CPU: plain versions


@pytest.mark.parametrize("backend", ENGINES)
def test_nan_entry_weight_is_caught(backend):
    jplan, jaux, jel, jew, jlabels = _j_setup()
    tplan, taux, tel, tew, tlabels = _t_setup()
    jbad = jew.at[0].set(jnp.nan)
    tbad = tew.clone()
    tbad[0] = float("nan")
    _same_message(
        lambda: j_get_engine(backend, checked=True).mg_select(
            jplan, jaux[backend], jel, jbad, jlabels, jnp.int32(0)),
        lambda: tfe.get_engine(backend, checked=True).mg_select(
            tplan, taux[backend], tel, tbad, tlabels, 0),
        "NaN/inf entry weight")


def test_oob_stream_gather_is_caught():
    jplan, jaux, jel, jew, _ = _j_setup()
    tplan, taux, tel, tew, _ = _t_setup()
    j0 = jaux["pallas_stream"].rounds[0]
    jbad = dataclasses.replace(
        jaux["pallas_stream"],
        rounds=(dataclasses.replace(
            j0, entry_gather=j0.entry_gather.at[0].set(10**6)),)
        + jaux["pallas_stream"].rounds[1:])
    t0 = taux["pallas_stream"].rounds[0]
    gather = t0.entry_gather.clone()
    gather[0] = 10**6
    tbad = dataclasses.replace(
        taux["pallas_stream"],
        rounds=(dataclasses.replace(t0, entry_gather=gather),)
        + taux["pallas_stream"].rounds[1:])
    _same_message(
        lambda: j_get_engine("pallas_stream", checked=True).mg_candidates(
            jplan, jbad, jel, jew),
        lambda: tfe.get_engine("pallas_stream", checked=True).mg_candidates(
            tplan, tbad, tel, tew),
        "OOB")


def test_oob_fused_row_window_is_caught():
    jplan, jaux, jel, jew, _ = _j_setup()
    tplan, taux, tel, tew, _ = _t_setup()
    j0 = jaux["pallas_fused"].rounds[0]
    jbad = dataclasses.replace(
        jaux["pallas_fused"],
        rounds=(dataclasses.replace(
            j0, row_start=j0.row_start.at[0, 0].set(10**6)),)
        + jaux["pallas_fused"].rounds[1:])
    t0 = taux["pallas_fused"].rounds[0]
    start = t0.row_start.clone()
    start[0, 0] = 10**6
    tbad = dataclasses.replace(
        taux["pallas_fused"],
        rounds=(dataclasses.replace(t0, row_start=start),)
        + taux["pallas_fused"].rounds[1:])
    _same_message(
        lambda: j_get_engine("pallas_fused", checked=True).mg_candidates(
            jplan, jbad, jel, jew),
        lambda: tfe.get_engine("pallas_fused", checked=True).mg_candidates(
            tplan, tbad, tel, tew),
        "OOB")


def test_aligned_stream_plan_contract():
    """Aligned plans carry extra invariants: pad slots hold the n_nodes
    sentinel with weight 0, and every slot's vertex stays gatherable. A
    clean plan passes, bit-identical to the bare engine; a voting pad or
    an OOB vertex raises, in both packages with the same message."""
    n = 5
    rng = np.random.default_rng(1)
    deg = rng.integers(1, 12, size=n).astype(np.int64)
    n_entries = int(deg.sum())
    idx = rng.integers(0, n, size=n_entries).astype(np.int64)
    wgt = rng.random(n_entries).astype(np.float32)
    kw = dict(k=K, chunk=CHUNK, tile_r=TILE_R, window_entries=WINDOW,
              indices=idx, weights=wgt, aligned=True)
    jplan = jcsr.build_fold_plan(deg, k=K, chunk=CHUNK)
    tplan = tcsr.build_fold_plan(deg, k=K, chunk=CHUNK, device=CPU)
    japlan = jcsr.build_streamed_fold_plan(deg, **kw)
    tapln = tcsr.build_streamed_fold_plan(deg, **kw, device=CPU)
    jlabels = jnp.concatenate([jnp.arange(n, dtype=jnp.int32),
                               jnp.full((1,), -1, jnp.int32)])
    tlabels = torch.cat([torch.arange(n, dtype=torch.int32),
                         torch.full((1,), -1, dtype=torch.int32)])
    jwl = jlabels[japlan.aligned_entry_vertex]
    jww = japlan.aligned_entry_weights
    twl = tlabels[tapln.aligned_entry_vertex.long()]
    tww = tapln.aligned_entry_weights
    jeng = j_get_engine("pallas_stream", checked=True)
    teng = tfe.get_engine("pallas_stream", checked=True)
    got = teng.mg_candidates(tplan, tapln, twl, tww)  # clean plan passes
    bare = tfe.get_engine("pallas_stream", checked=False).mg_candidates(
        tplan, tapln, twl, tww)
    assert torch.equal(got[0], bare[0]) and torch.equal(got[1], bare[1])
    pads = np.nonzero(tapln.aligned_entry_vertex.numpy() == n)[0]
    assert pads.size  # the fixture really exercises pad slots
    voting = tww.clone()
    voting[int(pads[0])] = 1.0
    _same_message(
        lambda: jeng.mg_candidates(jplan, dataclasses.replace(
            japlan, aligned_entry_weights=jww.at[int(pads[0])].set(1.0)),
            jwl, jww),
        lambda: teng.mg_candidates(tplan, dataclasses.replace(
            tapln, aligned_entry_weights=voting), twl, tww),
        "non-zero weight")
    oob = tapln.aligned_entry_vertex.clone()
    oob[0] = n + 7
    _same_message(
        lambda: jeng.mg_candidates(jplan, dataclasses.replace(
            japlan,
            aligned_entry_vertex=japlan.aligned_entry_vertex.at[0].set(
                n + 7)), jwl, jww),
        lambda: teng.mg_candidates(tplan, dataclasses.replace(
            tapln, aligned_entry_vertex=oob), twl, tww),
        "aligned entry vertex")


def test_negative_input_label_is_caught():
    jplan, _, jel, jew, jlabels = _j_setup()
    tplan, _, tel, tew, tlabels = _t_setup()
    tbad = tlabels.clone()
    tbad[0] = -7
    _same_message(
        lambda: j_get_engine("jnp", checked=True).mg_select(
            jplan, None, jel, jew, jlabels.at[0].set(-7), jnp.int32(0)),
        lambda: tfe.get_engine("jnp", checked=True).mg_select(
            tplan, None, tel, tew, tbad, 0),
        "negative input label")


def test_repro_checked_env_hook(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKED", "1")
    eng = tfe.get_engine("jnp")
    assert isinstance(eng, tchecked.CheckedEngine)
    assert eng.name == "jnp"  # metadata passes through untouched
    assert type(tfe.get_engine("jnp", checked=False)) is tfe.JnpEngine
    for off in ("0", "", "false"):
        monkeypatch.setenv("REPRO_CHECKED", off)
        assert type(tfe.get_engine("jnp")) is tfe.JnpEngine  # no proxy
    monkeypatch.delenv("REPRO_CHECKED")
    assert type(tfe.get_engine("pallas_fused")) is tfe.PallasFusedEngine


def test_env_hook_never_reaches_lpa_move(monkeypatch):
    """With REPRO_CHECKED=1, lpa() still runs the bare engine (no check
    is evaluated), and its result is the unchecked one's."""
    g = carry_graph(FIXTURES["powerlaw"]())
    cfg = TConfig(method="mg", fold_backend="pallas_fused")
    ref = t_lpa(g, cfg, device=CPU)
    checks = []
    monkeypatch.setattr(tchecked, "_check",
                        lambda ok, message: checks.append(message))
    monkeypatch.setenv("REPRO_CHECKED", "1")
    got = t_lpa(g, cfg, device=CPU)
    assert not checks
    assert torch.equal(ref.labels, got.labels)
    assert ref.changed_history == got.changed_history


@pytest.mark.parametrize("backend", ENGINES)
def test_dispatch_accounting_passes_through(backend):
    plan, aux, *_ = _t_setup()
    plain = tfe.get_engine(backend, checked=False)
    checked = tfe.get_engine(backend, checked=True)
    assert checked.uses_fused_plan == plain.uses_fused_plan
    assert checked.uses_stream_plan == plain.uses_stream_plan
    assert checked.name == plain.name and checked.checked
    for req in (TRequest(family="mg"), TRequest(family="bm"),
                TRequest(family="mg", rescan=True)):
        assert checked.dispatches_per_iter(plan, aux[backend], req) \
            == plain.dispatches_per_iter(plan, aux[backend], req)


@pytest.mark.parametrize("backend", ENGINES)
@pytest.mark.parametrize("family,rescan", [("mg", False), ("bm", False),
                                           ("mg", True)])
def test_checked_run_is_bit_identical_dense_and_sparse(backend, family,
                                                       rescan):
    """run() gets one generic contract wrapper (__getattr__ would
    otherwise delegate it unchecked); dense and sparse requests of every
    family pass through it unchanged."""
    plan, aux, el, ew, labels = _t_setup()
    bundle = _bundle(plan, aux, backend, TBundle, TSpec)
    frontier = torch.tensor([True, False, True, True, False])
    for req in (TRequest(family=family, rescan=rescan, seed=3),
                TRequest(family=family, rescan=rescan, mode="sparse",
                         seed=3, frontier=frontier, cap_rows=64)):
        plain = tfe.get_engine(backend, checked=False).run(
            bundle, req, el, ew, labels)
        checked = tfe.get_engine(backend, checked=True).run(
            bundle, req, el, ew, labels)
        for field in ("want", "bm_label", "bm_weight"):
            a, b = getattr(plain, field), getattr(checked, field)
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("backend", ENGINES)
def test_checked_run_catches_bad_inputs_on_sparse_requests(backend):
    """The run() wrapper's contracts hold wherever the request routes: a
    NaN entry weight on the BM route, a negative label on the rescan
    route; same messages as the reference."""
    jplan, jaux, jel, jew, jlabels = _j_setup()
    tplan, taux, tel, tew, tlabels = _t_setup()
    jbundle = _bundle(jplan, jaux, backend, JBundle, JSpec)
    tbundle = _bundle(tplan, taux, backend, TBundle, TSpec)
    jfront = jnp.ones((5,), jnp.bool_)
    tfront = torch.ones((5,), dtype=torch.bool)
    jeng = j_get_engine(backend, checked=True)
    teng = tfe.get_engine(backend, checked=True)
    tnan = tew.clone()
    tnan[0] = float("nan")
    _same_message(
        lambda: jeng.run(jbundle, JRequest(family="bm", mode="sparse",
                                           frontier=jfront, cap_rows=64),
                         jel, jew.at[0].set(jnp.nan), jlabels),
        lambda: teng.run(tbundle, TRequest(family="bm", mode="sparse",
                                           frontier=tfront, cap_rows=64),
                         tel, tnan, tlabels),
        "NaN/inf entry weight")
    tneg = tlabels.clone()
    tneg[0] = -7
    _same_message(
        lambda: jeng.run(jbundle, JRequest(family="mg", rescan=True,
                                           mode="sparse", seed=jnp.int32(0),
                                           frontier=jfront, cap_rows=64),
                         jel, jew, jlabels.at[0].set(-7)),
        lambda: teng.run(tbundle, TRequest(family="mg", rescan=True,
                                           mode="sparse", seed=0,
                                           frontier=tfront, cap_rows=64),
                         tel, tew, tneg),
        "negative input label")


@pytest.mark.parametrize("name,message", [
    ("tile_nan", "NaN/inf entry weight"),
    ("tile_negative", "negative entry weight")])
def test_tile_folds_are_checked(name, message):
    """The tile-level folds (what the bucketed plan walk plugs in) carry
    the entry contract too, with the reference's messages."""
    rng = np.random.default_rng(5)
    labels = rng.integers(-1, 6, (7, 8)).astype(np.int32)
    weights = rng.random((7, 8)).astype(np.float32)
    weights[3, 2] = np.nan if name == "tile_nan" else -1.0
    for backend in ("jnp", "pallas"):
        _same_message(
            lambda: j_get_engine(backend, checked=True).mg_fold_tile(
                jnp.asarray(labels), jnp.asarray(weights), K),
            lambda: tfe.get_engine(backend, checked=True).mg_fold_tile(
                torch.from_numpy(labels), torch.from_numpy(weights), K),
            message)
    clean = np.abs(np.nan_to_num(weights))
    eng = tfe.get_engine("pallas", checked=True)
    got = eng.bm_fold_tile(torch.from_numpy(labels), torch.from_numpy(clean))
    ref = tfe.get_engine("pallas", checked=False).bm_fold_tile(
        torch.from_numpy(labels), torch.from_numpy(clean))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# ---------------------------------------------------------------------------
# The single-host leftovers
# ---------------------------------------------------------------------------


def test_lpa_step_fn_matches_reference():
    """The step function equals the reference's over a few iterations
    (Pick-Less on iteration 0, off on 1), and lpa_move's result."""
    jg, _ = j_ring_of_cliques(6, 6)
    tg, _ = t_ring_of_cliques(6, 6, device=CPU)
    jcfg, tcfg = JConfig(method="mg", rho=2), TConfig(method="mg", rho=2)
    jws, tws = j_build_workspace(jg, jcfg), t_build_workspace(tg, tcfg)
    jstep, tstep = j_lpa_step_fn(jcfg), t_lpa_step_fn(tcfg)
    jl = jnp.arange(jg.n_nodes, dtype=jnp.int32)
    tl = torch.arange(tg.n_nodes, dtype=torch.int32)
    for it in range(3):
        jl, jdelta = jstep(jws, jl, jnp.int32(it))
        tl, tdelta = tstep(tws, tl, torch.tensor(it, dtype=torch.int32))
        assert_same_array(jl, tl, f"labels after step {it}")
        assert tdelta.dtype == torch.int32 and tdelta.dim() == 0
        assert int(tdelta) == int(jdelta)


@pytest.mark.parametrize("seed", [0, 1])
def test_community_sizes_matches_reference(seed):
    labels = np.random.default_rng(seed).integers(0, 40, 500).astype(
        np.int32)
    for x in (labels, np.asarray([0, 0, 0, 1, 2, 2])):
        ref = j_community_sizes(x)
        assert_same_array(ref, t_community_sizes(torch.from_numpy(x)))
        assert_same_array(ref, t_community_sizes(x))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fused_hbm_entries_matches_reference(name):
    degrees = np.asarray(FIXTURES[name]().degrees)
    for k, chunk, tile_r in ((8, 128, 128), (4, 16, 8)):
        ref = jcsr.fused_hbm_entries(jcsr.build_fused_fold_plan(
            degrees, k=k, chunk=chunk, tile_r=tile_r))
        got = tcsr.fused_hbm_entries(tcsr.build_fused_fold_plan(
            degrees, k=k, chunk=chunk, tile_r=tile_r, device=CPU))
        assert isinstance(got, int) and got == ref
