"""νBM and the rescan ablation in repro_torch against the JAX package, bit
for bit on the CPU: the sketch functions (BM tile fold and merge, rescan
partials and their rank-ordered merge), the per-round fused drivers K3 and
K4 run as their plain versions (the JAX side in interpret mode), the whole
drivers, the engines' routed ``run`` and their launch accounting.

The CUDA kernels themselves are held against the same plain versions in
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from _propcheck import given, settings, st

from repro.core import sketch as jsk
from repro.core.fold_engine import get_engine as j_get_engine
from repro.core.fold_program import FoldRequest as JRequest
from repro.core.plan_bundle import build_plan_bundle as j_build_bundle
from repro.core.plan_bundle import spec_for as j_spec_for
from repro.core.lpa import LPAConfig as JConfig
from repro.graphs.csr import build_csr as j_build_csr
from repro.graphs.csr import build_fold_plan as j_build_fold_plan
from repro.graphs.csr import build_fused_fold_plan as j_build_fused
from repro.kernels.mg_sketch import fused as jfused
from repro_torch.core import sketch as tsk
from repro_torch.core.fold_engine import get_engine as t_get_engine
from repro_torch.core.fold_program import FoldRequest as TRequest
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.core.plan_bundle import build_plan_bundle as t_build_bundle
from repro_torch.core.plan_bundle import spec_for as t_spec_for
from repro_torch.graphs.csr import build_fold_plan as t_build_fold_plan
from repro_torch.graphs.csr import build_fused_fold_plan as t_build_fused
from repro_torch.kernels.mg_sketch import fused as tfused
from _torch_parity import (CPU, FIXTURES, assert_same_array, carry_graph,
                           random_entries)

SEEDS = (1, 5)

# the reference under jit, as its lpa() runs it
_j_bm_fold_tile = jax.jit(jsk.bm_fold_tile)
_j_bm_merge_rows = jax.jit(jsk.bm_merge_rows, static_argnums=0)
_j_rescan_row_partials = jax.jit(jsk.rescan_row_partials)
_j_merge = jax.jit(jsk.merge_rescan_partials, static_argnums=(0, 1, 2))
_j_run_bm_plan = jax.jit(jsk.run_bm_plan)
_j_run_bm_plan_fused = jax.jit(jfused.run_bm_plan_fused)
_j_rescan_select_fused = jax.jit(jfused.rescan_select_fused)
_j_run_mg_plan = jax.jit(jsk.run_mg_plan)
_j_rescan_candidates = jax.jit(jsk.rescan_candidates)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _star_graph(n_leaves=300):
    edges = np.stack([np.zeros(n_leaves, np.int64),
                      np.arange(1, n_leaves + 1)], axis=1)
    return j_build_csr(edges, n_leaves + 1)


def _tie_graph():
    """tests/test_rescan_engines.py's tie fixture: vertex 0 sees
    candidates 7 and 8 at exactly weight 2.0 each."""
    edges = np.asarray([[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [3, 4]])
    return j_build_csr(edges, 5)


def _bm_tile(rng, rows, width, alphabet):
    """Labels from a small alphabet with -1 pads, weights on a 0.375 grid
    (0 included): matches, decrements, replacements and ties wk == w."""
    labels = rng.integers(-1, alphabet, (rows, width)).astype(np.int32)
    weights = (rng.integers(0, 6, (rows, width)) * 0.375).astype(np.float32)
    return labels, weights


def _plans(g, k, chunk, tile_r):
    degrees = np.asarray(g.degrees)
    return (j_build_fused(degrees, k=k, chunk=chunk, tile_r=tile_r),
            t_build_fused(degrees, k=k, chunk=chunk, tile_r=tile_r,
                          device=CPU))


# ---------------------------------------------------------------------------
# 1. sketch functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("width", [1, 5, 64])
def test_bm_fold_tile_matches_reference(with_init, width):
    rng = np.random.default_rng(width + 100 * with_init)
    labels, weights = _bm_tile(rng, 256, width, alphabet=4)
    init = (rng.integers(-1, 4, 256).astype(np.int32) if with_init
            else None)
    ref = _j_bm_fold_tile(jnp.asarray(labels), jnp.asarray(weights),
                          None if init is None else jnp.asarray(init))
    got = tsk.bm_fold_tile(_t(labels), _t(weights),
                           None if init is None else _t(init))
    assert_same_array(ref[0], got[0], "BM candidates")
    assert_same_array(ref[1], got[1], "BM weights")


def test_bm_fold_tile_takes_every_branch():
    """The tiles of the parity tests reach all three BM branches and the
    tie wk == w (which replaces: the rule's test is a strict wk > w)."""
    rng = np.random.default_rng(64)
    labels, weights = _bm_tile(rng, 256, 64, alphabet=4)
    seen = {"same": 0, "bigger": 0, "replace": 0, "tie": 0}
    for row_c, row_w in zip(labels, weights):
        ck, wk = -1, np.float32(0.0)
        for c, w in zip(row_c, row_w):
            if not (w > 0 and c >= 0):
                continue
            if c == ck:
                seen["same"] += 1
                wk = wk + w
            elif wk > w:
                seen["bigger"] += 1
                wk = wk - w
            else:
                seen["replace"] += 1
                seen["tie"] += int(wk == w)
                ck, wk = c, w
    assert min(seen.values()) > 100, seen


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**20), width=st.integers(1, 40),
       alphabet=st.integers(1, 8))
def test_bm_fold_tile_property(seed, width, alphabet):
    rng = np.random.default_rng(seed)
    labels, weights = _bm_tile(rng, 16, width, alphabet)
    init = rng.integers(-1, alphabet, 16).astype(np.int32)
    ref = _j_bm_fold_tile(jnp.asarray(labels), jnp.asarray(weights),
                          jnp.asarray(init))
    got = tsk.bm_fold_tile(_t(labels), _t(weights), _t(init))
    assert_same_array(ref[0], got[0], "BM candidates")
    assert_same_array(ref[1], got[1], "BM weights")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bm_merge_rows_matches_reference(seed):
    """Many partial rows per vertex, pad rows, ties in weight and with the
    incumbent, and vertices with no rows."""
    rng = np.random.default_rng(seed)
    n, rows = 40, 300
    row_vertex = rng.integers(-1, n - 5, rows).astype(np.int32)
    ck = rng.integers(-1, 6, rows).astype(np.int32)
    wk = (rng.integers(0, 4, rows) * 0.5).astype(np.float32)
    cur = rng.integers(0, 6, n).astype(np.int32)
    ref = _j_bm_merge_rows(n, jnp.asarray(cur), jnp.asarray(row_vertex),
                           jnp.asarray(ck), jnp.asarray(wk))
    got = tsk.bm_merge_rows(n, _t(cur), _t(row_vertex), _t(ck), _t(wk))
    assert_same_array(ref[0], got[0], "merged labels")
    assert_same_array(ref[1], got[1], "merged weights")


@pytest.mark.parametrize("k", [1, 4, 8])
def test_rescan_row_partials_matches_reference(k):
    """Entries of weight <= 0 count too; duplicate and -1 candidates."""
    rng = np.random.default_rng(k)
    labels = rng.integers(-1, 2 * k, (128, 48)).astype(np.int32)
    weights = ((rng.random((128, 48)) - 0.3) * 3).astype(np.float32)
    weights[:, ::7] = 0.0
    cand = rng.integers(-1, 2 * k, (128, k)).astype(np.int32)
    ref = _j_rescan_row_partials(jnp.asarray(labels), jnp.asarray(weights),
                                 jnp.asarray(cand))
    got = tsk.rescan_row_partials(_t(labels), _t(weights), _t(cand))
    assert_same_array(ref, got, "rescan partials")
    assert (weights <= 0).any()


def _merge_case(name):
    """(n, k, max_rows, row_vertex, row_rank) of a real round-0 row set:
    the star-300 hub at chunk 16 (19 ranks, past _RANK_CHUNK) in fused and
    in canonical row order, and a graph whose vertices own one row each."""
    if name == "star_hub_fused":
        fplan = j_build_fused(np.asarray(_star_graph().degrees), k=4,
                              chunk=16, tile_r=8)
        return (fplan.n_nodes, 4, fplan.max_rows0,
                np.asarray(fplan.row_to_vertex0), np.asarray(fplan.row_rank0))
    if name == "star_hub_bucketed":
        plan = j_build_fold_plan(np.asarray(_star_graph().degrees), k=4,
                                 chunk=16)
        rows = plan.rounds[0].n_rows_total
        rv = np.full(rows, -1, np.int32)
        for b in plan.rounds[0].buckets:
            rv[np.asarray(b.out_pos)] = np.asarray(b.vertex)
        return plan.n_nodes, 4, plan.max_rows0, rv, np.asarray(plan.row_rank0)
    if name == "one_row_each":
        fplan = j_build_fused(np.asarray(FIXTURES["road_deg2"]().degrees),
                              k=8, chunk=128, tile_r=32)
        assert fplan.max_rows0 == 1
        return (fplan.n_nodes, 8, fplan.max_rows0,
                np.asarray(fplan.row_to_vertex0), np.asarray(fplan.row_rank0))
    # a shuffled row set: up to 40 ranks per vertex, pad rows mixed in
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 41, 30)
    rv = np.repeat(np.arange(30), counts)
    rank = np.concatenate([np.arange(c) for c in counts])
    rv = np.concatenate([rv, np.full(17, -1)]).astype(np.int32)
    rank = np.concatenate([rank, np.zeros(17, np.int64)]).astype(np.int32)
    perm = rng.permutation(len(rv))
    return 33, 8, int(counts.max()), rv[perm], rank[perm]


@pytest.mark.parametrize("name", ["star_hub_fused", "star_hub_bucketed",
                                  "one_row_each", "shuffled"])
def test_merge_rescan_partials_matches_reference(name):
    """Non-dyadic partials, so any other float order would show."""
    n, k, max_rows, rv, rank = _merge_case(name)
    rng = np.random.default_rng(11)
    parts = (rng.random((len(rv), k)) * 3 + 0.01).astype(np.float32)
    parts[rng.random((len(rv), k)) < 0.2] = 0.0
    ref = _j_merge(n, k, max_rows, jnp.asarray(rv), jnp.asarray(rank),
                   jnp.asarray(parts))
    got = tsk.merge_rescan_partials(n, k, max_rows, _t(rv), _t(rank),
                                    _t(parts))
    assert_same_array(ref, got, "merged rescan weights")
    if name.startswith("star_hub"):
        assert max_rows > tsk._RANK_CHUNK == jsk._RANK_CHUNK


# ---------------------------------------------------------------------------
# 2. per-round drivers (K3's and K4's plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,chunk,tile_r", [(8, 128, 128), (4, 16, 8)])
def test_bm_fold_round_matches_reference(name, k, chunk, tile_r):
    g = FIXTURES[name]()
    rng = np.random.default_rng(21)
    el, ew = random_entries(g.n_nodes, g.n_edges, rng)
    el = el % max(g.n_nodes // 16, 2)  # few labels: every branch runs
    jplan, tplan = _plans(g, k, chunk, tile_r)
    jr, tr = jplan.rounds[0], tplan.rounds[0]
    rows = tr.row_start.numel()
    init = np.where(np.asarray(jplan.row_to_vertex0) >= 0,
                    rng.integers(0, max(g.n_nodes // 16, 2), rows),
                    -1).astype(np.int32)
    ref = jfused.bm_fold_round_fused(jr, jnp.asarray(el), jnp.asarray(ew),
                                     jnp.asarray(init), chunk=chunk,
                                     interpret=True)
    got = tfused.bm_fold_round_fused(tr, _t(el), _t(ew), _t(init),
                                     chunk=chunk)
    assert_same_array(ref[0], got[0], "per-row BM candidates")
    assert_same_array(ref[1], got[1], "per-row BM weights")


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,chunk,tile_r", [(8, 128, 128), (4, 16, 8)])
def test_rescan_round_matches_reference(name, k, chunk, tile_r):
    g = FIXTURES[name]()
    rng = np.random.default_rng(22)
    el, ew = random_entries(g.n_nodes, g.n_edges, rng)
    el = el % max(g.n_nodes // 16, 2)
    ew = ew - np.float32(0.75)  # some weights <= 0: they count in K4
    jplan, tplan = _plans(g, k, chunk, tile_r)
    jr, tr = jplan.rounds[0], tplan.rounds[0]
    rows = tr.row_start.numel()
    cand = rng.integers(-1, max(g.n_nodes // 16, 2), (rows, k)
                        ).astype(np.int32)
    ref = jfused.rescan_round_fused(jr, jnp.asarray(el), jnp.asarray(ew),
                                    jnp.asarray(cand), k=k, chunk=chunk,
                                    interpret=True)
    got = tfused.rescan_round_fused(tr, _t(el), _t(ew), _t(cand), k=k,
                                    chunk=chunk)
    assert_same_array(ref, got, "per-row rescan partials")


def test_round_wrappers_check_inputs_and_count_no_cpu_launch():
    g = FIXTURES["star_hub"]()
    _, tplan = _plans(g, 8, 128, 32)
    rnd = tplan.rounds[0]
    rows = rnd.row_start.numel()
    el = torch.zeros(rnd.n_entries_in, dtype=torch.int32)
    ew = torch.ones(rnd.n_entries_in, dtype=torch.float32)
    with pytest.raises(ValueError):
        tfused.bm_fold_round_fused(rnd, el, ew,
                                   torch.zeros(rows + 1, dtype=torch.int32),
                                   chunk=128)
    with pytest.raises(ValueError):
        tfused.rescan_round_fused(rnd, el, ew,
                                  torch.zeros((rows, 4), dtype=torch.int32),
                                  k=8, chunk=128)
    with pytest.raises(TypeError):
        tfused.bm_fold_round_fused(rnd, el, ew.double(),
                                   torch.zeros(rows, dtype=torch.int32),
                                   chunk=128)
    tfused.reset_launch_counts()
    tfused.bm_fold_round_fused(rnd, el, ew,
                               torch.zeros(rows, dtype=torch.int32),
                               chunk=128)
    tfused.rescan_round_fused(rnd, el, ew,
                              torch.zeros((rows, 8), dtype=torch.int32),
                              k=8, chunk=128)
    # the CPU path runs the plain versions: no kernel launch is counted;
    # one table counts the fused and the streamed kernels
    assert set(tfused.LAUNCH_COUNTS) == {"fused_fold", "fused_select",
                                         "bm_fold", "rescan", "stream_fold",
                                         "stream_select", "stream_bm",
                                         "stream_rescan", "tile_mg_fold",
                                         "tile_bm_fold"}
    assert not any(tfused.LAUNCH_COUNTS.values())


# ---------------------------------------------------------------------------
# 3. whole drivers
# ---------------------------------------------------------------------------


def _driver_graphs():
    return dict(FIXTURES, tie=_tie_graph)


@pytest.mark.parametrize("name", sorted(_driver_graphs()))
def test_run_bm_plan_matches_reference(name):
    """The bucketed reference walk and the fused driver against JAX's."""
    g = _driver_graphs()[name]()
    rng = np.random.default_rng(31)
    el, ew = random_entries(g.n_nodes, g.n_edges, rng)
    el = el % max(g.n_nodes // 8, 2)
    labels = rng.integers(0, max(g.n_nodes // 8, 2), g.n_nodes
                          ).astype(np.int32)
    degrees = np.asarray(g.degrees)
    jplan = j_build_fold_plan(degrees, k=4, chunk=16)
    tplan = t_build_fold_plan(degrees, k=4, chunk=16, device=CPU)
    jfplan, tfplan = _plans(g, 4, 16, 8)
    args_j = (jnp.asarray(el), jnp.asarray(ew), jnp.asarray(labels))
    args_t = (_t(el), _t(ew), _t(labels))
    ref = _j_run_bm_plan(jplan, *args_j)
    got = tsk.run_bm_plan(tplan, *args_t)
    assert_same_array(ref[0], got[0], "bucketed BM labels")
    assert_same_array(ref[1], got[1], "bucketed BM weights")
    ref = _j_run_bm_plan_fused(jfplan, *args_j)
    got = tfused.run_bm_plan_fused(tfplan, *args_t)
    assert_same_array(ref[0], got[0], "fused BM labels")
    assert_same_array(ref[1], got[1], "fused BM weights")


@pytest.mark.parametrize("name", sorted(_driver_graphs()))
@pytest.mark.parametrize("seed", SEEDS)
def test_rescan_select_matches_reference(name, seed):
    """The bucketed reference double scan and the fused driver."""
    g = _driver_graphs()[name]()
    rng = np.random.default_rng(32)
    if name == "tie":
        labels = np.asarray([9, 7, 7, 8, 8], np.int32)
        el = labels[np.asarray(g.indices)]
        ew = np.asarray(g.weights)
    else:
        el, ew = random_entries(g.n_nodes, g.n_edges, rng)
        el = el % max(g.n_nodes // 8, 2)
        labels = rng.integers(0, max(g.n_nodes // 8, 2), g.n_nodes
                              ).astype(np.int32)
    degrees = np.asarray(g.degrees)
    jplan = j_build_fold_plan(degrees, k=4, chunk=16)
    tplan = t_build_fold_plan(degrees, k=4, chunk=16, device=CPU)
    jfplan, tfplan = _plans(g, 4, 16, 8)
    j_sk, _ = _j_run_mg_plan(jplan, jnp.asarray(el), jnp.asarray(ew))
    t_sk, _ = tsk.run_mg_plan(tplan, _t(el), _t(ew))
    ref = _j_rescan_candidates(jplan, j_sk, jnp.asarray(el),
                                jnp.asarray(ew), jnp.asarray(labels),
                                jnp.int32(seed))
    got = tsk.rescan_candidates(tplan, t_sk, _t(el), _t(ew), _t(labels),
                                seed)
    assert_same_array(ref, got, "bucketed rescan want")
    ref = _j_rescan_select_fused(jfplan, jnp.asarray(el), jnp.asarray(ew),
                                 jnp.asarray(labels), jnp.int32(seed))
    got = tfused.rescan_select_fused(tfplan, _t(el), _t(ew), _t(labels),
                                     seed)
    assert_same_array(ref, got, "fused rescan want")


def test_rescan_tie_resolves_by_the_hash():
    """On the tie fixture both candidates win under some seed, as in the
    reference: the tie goes through the hash, not a fixed order."""
    g = _tie_graph()
    labels = np.asarray([9, 7, 7, 8, 8], np.int32)
    el = _t(labels[np.asarray(g.indices)])
    ew = _t(np.asarray(g.weights))
    _, tfplan = _plans(g, 4, 16, 8)
    chosen = {int(tfused.rescan_select_fused(tfplan, el, ew, _t(labels),
                                             seed)[0])
              for seed in range(1, 12)}
    assert chosen == {7, 8}


# ---------------------------------------------------------------------------
# 4. engines
# ---------------------------------------------------------------------------


_REQUESTS = {"mg": {}, "mg+rescan": {"rescan": True}, "bm": {"family": "bm"}}


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
@pytest.mark.parametrize("req", ["bm", "mg+rescan"])
def test_engine_run_matches_reference(backend, req):
    g = FIXTURES["powerlaw"]()
    gt = carry_graph(g)
    rng = np.random.default_rng(41)
    labels = rng.integers(0, 64, g.n_nodes).astype(np.int32)
    el = labels[np.asarray(g.indices)]
    ew = np.asarray(g.weights)
    jb = j_build_bundle(g, j_spec_for(JConfig(fold_backend=backend)))
    tb = t_build_bundle(gt, t_spec_for(TConfig(fold_backend=backend)))
    jeng, teng = j_get_engine(backend, checked=False), t_get_engine(backend)
    for seed in SEEDS:
        jout = jeng.run(jb, JRequest(seed=jnp.int32(seed), **_REQUESTS[req]),
                        jnp.asarray(el), jnp.asarray(ew), jnp.asarray(labels))
        tout = teng.run(tb, TRequest(seed=seed, **_REQUESTS[req]), _t(el),
                        _t(ew), _t(labels))
        assert_same_array(jout.want, tout.want, "want")
        if req == "bm":
            assert_same_array(jout.bm_label, tout.bm_label, "bm_label")
            assert_same_array(jout.bm_weight, tout.bm_weight, "bm_weight")
        else:
            assert tout.bm_label is None and tout.bm_weight is None


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
@pytest.mark.parametrize("req", sorted(_REQUESTS))
def test_dispatches_per_iter_match_reference(backend, req):
    g = FIXTURES["powerlaw"]()
    gt = carry_graph(g)
    jb = j_build_bundle(g, j_spec_for(JConfig(fold_backend=backend)))
    tb = t_build_bundle(gt, t_spec_for(TConfig(fold_backend=backend)))
    jeng, teng = j_get_engine(backend, checked=False), t_get_engine(backend)
    want = jeng.dispatches_per_iter(jb.plan, jb.aux_for(jeng),
                                    JRequest(seed=1, **_REQUESTS[req]))
    got = teng.dispatches_per_iter(tb.plan, tb.aux_for(teng),
                                   TRequest(seed=1, **_REQUESTS[req]))
    assert got == want
    if backend == "pallas_fused":
        n_rounds = tb.fused_plan.n_rounds
        assert got == {"mg": n_rounds, "mg+rescan": n_rounds + 1,
                       "bm": 1}[req]


def test_fused_engine_needs_its_plan():
    g = FIXTURES["powerlaw"]()
    gt = carry_graph(g)
    tb = t_build_bundle(gt, t_spec_for(TConfig(fold_backend="jnp")))
    labels = torch.arange(g.n_nodes, dtype=torch.int32)
    el = labels[gt.indices.long()]
    eng = t_get_engine("pallas_fused")
    with pytest.raises(ValueError):
        eng.bm_fold_plan(tb.plan, None, el, gt.weights, labels)
    with pytest.raises(ValueError):
        eng.mg_rescan(tb.plan, None, el, gt.weights, labels, 1)


def test_rescan_driver_is_kernel_routed_not_the_bucketed_walk(monkeypatch):
    """The fused engine's rescan never calls the bucketed reference pass:
    poison it and the fused engine still gives the recorded answer."""
    g = FIXTURES["powerlaw"]()
    gt = carry_graph(g)
    tb = t_build_bundle(gt, t_spec_for(TConfig(fold_backend="pallas_fused")))
    rng = np.random.default_rng(3)
    labels = _t(rng.integers(0, g.n_nodes, g.n_nodes).astype(np.int32))
    el = labels[gt.indices.long()]
    eng = t_get_engine("pallas_fused")
    ref = eng.mg_rescan(tb.plan, tb.fused_plan, el, gt.weights, labels, 3)

    def _poisoned(*a, **kw):
        raise AssertionError("bucketed rescan executed on the fused engine")

    monkeypatch.setattr(tsk, "rescan_candidates", _poisoned)
    monkeypatch.setattr(tsk, "run_bm_plan", _poisoned)
    got = eng.mg_rescan(tb.plan, tb.fused_plan, el, gt.weights, labels, 3)
    assert torch.equal(got, ref)
    eng.bm_fold_plan(tb.plan, tb.fused_plan, el, gt.weights, labels)

