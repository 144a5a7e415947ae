"""Sparse frontier execution in repro_torch, on the CPU, against the
contracts of tests/test_sparse_frontier.py and against repro's own runs:

  * parity — ``frontier_sparse=True`` gives the dense
    ``frontier_gate=True`` run's labels, iterations and histories on the
    fused and the streamed engine (aligned and not), for νMG, νBM and the
    rescan ablation, at every capacity, the overflow boundary included;
  * the compaction — ``compact_active_rows`` (every real slot written
    once, sentinels elsewhere), the per-round activity counts and the
    compacted sub-rounds, field for field against the JAX package's;
  * accounting — ``work_rows_history`` equal to the JAX package's sparse
    runs, and the engines' launch counts unchanged by the mode.

Every comparison is exact."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.lpa import LPAConfig as JConfig
from repro.core.lpa import build_workspace as jbuild_workspace
from repro.core.lpa import lpa as jlpa
from repro.graphs import csr as jcsr
from repro.graphs.generators import sbm as jsbm
from repro.kernels.mg_sketch import fused as jfused
from repro.kernels.mg_sketch import streaming as jstream
from repro_torch.core.fold_engine import get_engine
from repro_torch.core.fold_program import FoldRequest
from repro_torch.core.lpa import LPAConfig, build_workspace, lpa, lpa_move
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs.csr import build_csr
from repro_torch.graphs.generators import sbm
from repro_torch.kernels.mg_sketch import fused as tfused
from repro_torch.kernels.mg_sketch import streaming as tstream
from test_torch_lpa import _assert_same_run
from _propcheck import given, settings, st
from _torch_parity import CPU, assert_same, assert_same_array, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

SPARSE_BACKENDS = ("pallas_fused", "pallas_stream")
COMBOS = (("mg", False), ("mg", True), ("bm", False))


def _graph(seed=3):
    return sbm(4, 16, 0.5, 0.02, seed=seed, device=CPU)[0]


def _config(backend, method="mg", rescan=False, **kw):
    base = dict(method=method, rescan=rescan, fold_backend=backend,
                chunk=16, max_iters=8, frontier_gate=True)
    if backend == "pallas_stream":
        base["stream_window"] = 128
    base.update(kw)
    return base


def _assert_parity(g, backend, method, rescan, cap, **kw):
    dense = lpa(g, LPAConfig(**_config(backend, method, rescan, **kw)),
                device=CPU)
    sparse = lpa(g, LPAConfig(**_config(backend, method, rescan,
                                        frontier_sparse=True,
                                        frontier_cap_rows=cap, **kw)),
                 device=CPU)
    assert torch.equal(dense.labels, sparse.labels), (backend, method,
                                                      rescan, cap)
    assert dense.changed_history == sparse.changed_history
    assert dense.frontier_history == sparse.frontier_history
    assert dense.iterations == sparse.iterations
    return dense, sparse


# ---------------------------------------------------------------------------
# parity: sparse equals dense-gated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", SPARSE_BACKENDS + ("jnp", "pallas"))
@pytest.mark.parametrize("method,rescan", COMBOS)
def test_sparse_matches_dense_gated(backend, method, rescan):
    g = _graph()
    for cap in (10**9, 7):
        _assert_parity(g, backend, method, rescan, cap)


@pytest.mark.parametrize("method,rescan", COMBOS)
def test_sparse_matches_dense_gated_aligned(method, rescan):
    """The aligned layout composes with the sparse path: its compacted
    sub-rounds re-gather from the aligned arrays, and the rows folded are
    those of the unaligned run."""
    g = _graph()
    _, sparse_a = _assert_parity(g, "pallas_stream", method, rescan, 10**9,
                                 aligned_layout=True)
    _, sparse_u = _assert_parity(g, "pallas_stream", method, rescan, 10**9)
    assert torch.equal(sparse_a.labels, sparse_u.labels)
    assert sparse_a.work_rows_history == sparse_u.work_rows_history


@pytest.mark.parametrize("backend", SPARSE_BACKENDS)
def test_overflow_fallback_at_cap_boundaries(backend):
    """cap = the largest mid-run frontier - 1 / itself / + 1: the fit
    flips between the sparse and the dense fold; results never move."""
    g = _graph()
    probe = lpa(g, LPAConfig(**_config(backend)), device=CPU)
    counts = [int(round(f * g.n_nodes)) for f in probe.frontier_history[1:]]
    pivot = max(counts) if counts else 1
    for cap in (max(pivot - 1, 1), pivot, pivot + 1):
        _assert_parity(g, backend, "mg", False, cap)


def test_sparse_folds_fewer_rows_than_dense():
    """Disconnected cliques converge fast and the frontier collapses:
    from iteration 2 on the compacted engines fold fewer rows."""
    g = sbm(8, 8, 0.9, 0.0, seed=1, device=CPU)[0]
    for backend in SPARSE_BACKENDS:
        extra = {"stream_window": 32} if backend == "pallas_stream" else {}
        base = dict(method="mg", fold_backend=backend, chunk=16,
                    max_iters=8, tau=0.0, frontier_gate=True, **extra)
        dense = lpa(g, LPAConfig(**base), device=CPU)
        sparse = lpa(g, LPAConfig(frontier_sparse=True,
                                  frontier_cap_rows=10**9, **base),
                     device=CPU)
        assert torch.equal(dense.labels, sparse.labels)
        tail_d = dense.work_rows_history[2:]
        tail_s = sparse.work_rows_history[2:]
        assert sum(tail_s) < sum(tail_d), backend
        assert all(s <= d for s, d in zip(tail_s, tail_d))


def test_bucketed_backends_fold_densely():
    """jnp and pallas have no compacted path: a sparse request folds
    densely, and every iteration records the full plan rows."""
    g = _graph()
    for backend in ("jnp", "pallas"):
        res = lpa(g, LPAConfig(**_config(backend, frontier_sparse=True,
                                         frontier_cap_rows=10**9)),
                  device=CPU)
        assert len(set(res.work_rows_history)) == 1


def test_work_rows_match_frontier_history():
    """One row per vertex (degrees <= chunk, one round): the fused sparse
    path's folded rows ARE the frontier counts."""
    g = _graph()
    assert int(g.degrees.max()) <= 64
    res = lpa(g, LPAConfig(**_config("pallas_fused", chunk=64,
                                     frontier_sparse=True,
                                     frontier_cap_rows=10**9)), device=CPU)
    assert len(res.work_rows_history) == res.iterations
    for frac, rows in zip(res.frontier_history, res.work_rows_history):
        assert rows == int(round(frac * g.n_nodes))


def test_pick_less_deferred_vertex_is_not_frozen():
    """Vertex 0 wants a larger label in the PL iteration (blocked) while
    its only neighbour is quiet: the PL union keeps it queued, sparse or
    not."""
    edges = np.asarray([[0, 1], [1, 2], [1, 3], [2, 3]])
    weights = np.asarray([5.0, 20.0, 20.0, 1.0], np.float32)
    g = build_csr(edges, 4, weights=weights, device=CPU)
    ref = lpa(g, LPAConfig(method="mg", chunk=16, rho=8, max_iters=8),
              device=CPU)
    for backend in SPARSE_BACKENDS:
        for sparse in (False, True):
            got = lpa(g, LPAConfig(
                method="mg", chunk=16, rho=8, max_iters=8,
                fold_backend=backend, frontier_gate=True,
                frontier_sparse=sparse,
                frontier_cap_rows=10**9 if sparse else None), device=CPU)
            assert torch.equal(got.labels, ref.labels)
            assert got.labels.tolist() == [1, 1, 1, 1]
            assert got.frontier_history[1] == 1.0


def test_sparse_requires_gate_frontier_and_a_fold_plan():
    g = _graph()
    with pytest.raises(ValueError, match="frontier_gate"):
        lpa(g, LPAConfig(frontier_sparse=True), device=CPU)
    with pytest.raises(ValueError, match="exact"):
        lpa(g, LPAConfig(method="exact", frontier_gate=True,
                         frontier_sparse=True), device=CPU)
    cfg = LPAConfig(**_config("pallas_fused", frontier_sparse=True))
    ws = build_workspace(g, cfg)
    with pytest.raises(ValueError, match="needs a frontier"):
        lpa_move(ws, torch.arange(g.n_nodes, dtype=torch.int32), False, 1,
                 cfg, frontier=None, sparse=True, cap_rows=8)


# ---------------------------------------------------------------------------
# against the JAX package's sparse runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,method,rescan,aligned,cap", [
    ("pallas_fused", "mg", False, False, 24),
    ("pallas_stream", "mg", True, True, 8),
    ("pallas_stream", "bm", False, False, None)])
def test_sparse_run_matches_reference(backend, method, rescan, aligned, cap):
    """Labels and every history, ``work_rows_history`` included, equal the
    JAX package's sparse run, on disconnected cliques whose frontier
    thins: the caps 24 (fused rows) and 8 (streamed windows) overflow on
    the early iterations, which fall back to the dense fold, and fit on
    the last ones."""
    gj = jsbm(8, 8, 0.9, 0.0, seed=1)[0]
    cfg = _config(backend, method, rescan, tau=0.0, stream_window=32,
                  frontier_sparse=True, frontier_cap_rows=cap,
                  aligned_layout=aligned)
    ref = jlpa(gj, JConfig(**cfg))
    got = lpa(carry_graph(gj), LPAConfig(**cfg), device=CPU)
    _assert_same_run(ref, got)
    if cap is not None:  # some iterations fell back, some did not
        dense_rows = got.work_rows_history[0]  # iteration 0: all queued
        assert dense_rows in got.work_rows_history[2:]
        assert got.work_rows_history[-1] < dense_rows


# ---------------------------------------------------------------------------
# the compaction
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None, database=None)
@given(rows=st.integers(min_value=0, max_value=50),
       cap=st.integers(min_value=1, max_value=60),
       seed=st.integers(min_value=0, max_value=10**6))
def test_compact_active_rows_properties(rows, cap, seed):
    rng = np.random.default_rng(seed)
    active = rng.random(rows) < 0.4
    idx = tcsr.compact_active_rows(torch.from_numpy(active), cap)
    assert idx.shape == (cap,) and idx.dtype == torch.int32
    want = np.nonzero(active)[0][:cap]
    got = idx.numpy()
    assert (got[:len(want)] == want).all()      # active rows, in order
    assert (got[len(want):] == rows).all()      # sentinel padding
    # every real row lands in one slot: no real slot is written twice
    assert len(set(got[:len(want)].tolist())) == len(want)


def test_compact_active_rows_all_empty_and_exactly_full():
    assert tcsr.compact_active_rows(torch.zeros(7, dtype=torch.bool),
                                    4).tolist() == [7] * 4
    assert tcsr.compact_active_rows(torch.ones(5, dtype=torch.bool),
                                    5).tolist() == [0, 1, 2, 3, 4]
    assert tcsr.compact_active_rows(torch.zeros(0, dtype=torch.bool),
                                    3).tolist() == [0] * 3


def test_compact_active_rows_matches_reference_on_overflow():
    active = np.random.default_rng(5).random(40) < 0.6
    for cap in (1, 9, 40, 41):
        ref = jcsr.compact_active_rows(jnp.asarray(active), cap)
        got = tcsr.compact_active_rows(torch.from_numpy(active), cap)
        assert_same_array(ref, got, f"cap {cap}")


def test_scatters_write_each_real_row_once():
    """The scatter-backs put each compacted row at its dense row and the
    sentinels into the dump row only: the dense rows never written keep
    the fill."""
    ws = build_workspace(_graph(), LPAConfig(**_config("pallas_fused")))
    rnd = ws.fused_plan.rounds[0]
    rows = rnd.row_start.numel()
    idx = torch.tensor([3, 0, rows, 5, rows], dtype=torch.int32)
    vals = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    out = tfused.scatter_sparse_rows(rnd, idx, vals, -1.0)
    assert out.shape == (rows, 2)
    assert out[3].tolist() == [0, 1] and out[0].tolist() == [2, 3]
    assert out[5].tolist() == [6, 7]
    keep = torch.ones(rows, dtype=torch.bool)
    keep[[0, 3, 5]] = False
    assert (out[keep] == -1).all()


@pytest.mark.parametrize("backend", SPARSE_BACKENDS)
def test_active_counts_and_sub_rounds_match_reference(backend):
    """Per-round activity counts (the fit check) and the compacted
    sub-rounds, field for field, on random frontiers of several
    densities and caps."""
    gj = jsbm(4, 16, 0.5, 0.02, seed=3)[0]
    cfg = _config(backend, aligned_layout=backend == "pallas_stream")
    jws = jbuild_workspace(gj, JConfig(**cfg))
    tws = build_workspace(carry_graph(gj), LPAConfig(**cfg))
    rng = np.random.default_rng(9)
    for density in (0.0, 0.3, 1.0):
        front = rng.random(gj.n_nodes) < density
        tfront = torch.from_numpy(front)
        if backend == "pallas_fused":
            jplan, tplan = jws.fused_plan, tws.fused_plan
            assert (tcsr.fused_active_rows(tplan, tfront)
                    == jcsr.fused_active_rows(jplan, front))
            jsparse, tsparse = (jfused._sparse_fused_round,
                                tfused.sparse_fused_round)
        else:
            jplan, tplan = jws.stream_plan, tws.stream_plan
            assert (tcsr.streamed_active_windows(tplan, tfront)
                    == jcsr.streamed_active_windows(jplan, front))
            jsparse, tsparse = (jstream._sparse_stream_round,
                                tstream.sparse_stream_round)
        for cap in (1, 5, 10**9):
            for jrnd, trnd in zip(jplan.rounds, tplan.rounds):
                ref = jsparse(jrnd, jnp.asarray(front), cap)
                got = tsparse(trnd, tfront, cap)
                assert_same(ref, got, f"{backend} cap {cap}")
    assert (tws.bundle.sparse_fit(torch.ones(gj.n_nodes, dtype=torch.bool),
                                  10**9)
            == (True, tws.bundle.dense_work_rows()))


def test_request_dispatch_table_is_golden():
    """One ``dispatches_per_iter(plan, aux, request)`` per engine, for
    every (backend, family, rescan) cell and both modes: sparse shrinks
    the launches' rows, never their number."""
    g = _graph()
    ws_f = build_workspace(g, LPAConfig(**_config("pallas_fused")))
    ws_s = build_workspace(g, LPAConfig(**_config("pallas_stream")))
    frontier = torch.ones(g.n_nodes, dtype=torch.bool)
    # fused and streamed bundles hold no bucketed plan: the bucketed
    # engines' rows read the one a jnp workspace builds
    plan = build_workspace(g, LPAConfig(**_config("jnp"))).plan
    assert ws_f.plan is None and ws_s.plan is None
    plans = {"jnp": (plan, None), "pallas": (plan, None),
             "pallas_fused": (ws_f.plan, ws_f.fused_plan),
             "pallas_stream": (ws_s.plan, ws_s.stream_plan)}
    r_fused = tcsr.fused_dispatches(ws_f.fused_plan)
    r_stream = tcsr.streamed_dispatches(ws_s.stream_plan)
    golden = {
        ("jnp", "mg", False): 0, ("jnp", "bm", False): 0,
        ("jnp", "mg", True): 0,
        ("pallas", "mg", False): tcsr.plan_dispatches(plan),
        ("pallas", "bm", False): tcsr.plan_round0_dispatches(plan),
        ("pallas", "mg", True): tcsr.plan_dispatches(plan),
        ("pallas_fused", "mg", False): r_fused,
        ("pallas_fused", "bm", False): 1,
        ("pallas_fused", "mg", True): r_fused + 1,
        ("pallas_stream", "mg", False): r_stream,
        ("pallas_stream", "bm", False): 1,
        ("pallas_stream", "mg", True): r_stream + 1,
    }
    for (backend, family, rescan), want in golden.items():
        eng = get_engine(backend)
        plan, aux = plans[backend]
        for req in (FoldRequest(family=family, rescan=rescan),
                    FoldRequest(family=family, rescan=rescan, mode="sparse",
                                frontier=frontier, cap_rows=8)):
            assert eng.dispatches_per_iter(plan, aux, req) == want, (
                backend, family, rescan, req.mode)
