"""Graphs past 2**31 - 1 slots: int64 offsets through the port's main path.

On the CPU: the fused plan built from a degree sequence that sums past
2**31 keeps exact int64 round-0 starts and int32 later rounds (degrees
only: no slot is allocated); the bucketed and streamed plans and the exact
method refuse such a graph with a ``ValueError``; the port's CSR constructors
give int64 offsets only past 2**31 - 1 slots; and a graph given with int64
offsets gives ``lpa()`` the same labels, histories and iterations as the
same graph with int32 offsets, dense, gated with the sparse compaction, νBM
and rescan on ``pallas_fused``, and (the νMG ones) as the benchmark's plain
reference, on seeded random weights.

Marked ``gpu`` (they skip without a CUDA device, decided inside the
``cuda`` fixture): K1-K4 and the frontier marks' int64 instantiations
equal their plain versions on the card, on a small graph and on rows that
start past 2**31 in entry arrays of more than 2**31 entries (17 GB on the
card). On a machine with a card: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_wide_offsets.py``.
"""
import numpy as np
import pytest
import torch

from lpabench.gen import make_graph
from lpabench.reference.lpa import detect
from repro_torch.core.lpa import LPAConfig, build_workspace, lpa
from repro_torch.graphs import csr
from repro_torch.graphs.csr import (CSRGraph, FusedRound, build_csr,
                                    build_fold_plan, build_fused_fold_plan,
                                    build_streamed_fold_plan,
                                    graph_from_arrays, offsets_dtype)
from repro_torch.kernels import frontier
from repro_torch.kernels.mg_sketch import fused

WIDE = 2**31  # the first slot count past int32

#: a web graph of the benchmark's wide family, small: int64 offsets,
#: drawn symmetric float32 weights, hubs of several rows at chunk 16
WEB = {"n_nodes": 1500, "avg_comm": 50, "a_comm": 1.6, "p_in": 0.8,
       "intra_deg_cap": 80, "mix": 0.02, "hub_frac": 0.004, "a_hub": 1.8,
       "hub_unit": 16, "hub_deg_max": 4000, "size_seed": 0}
BASE = dict(fold_backend="pallas_fused", k=8, chunk=16, rho=8, tau=0.05,
            max_iters=20)
CASES = {"mg": dict(method="mg"),
         # a capacity every frontier fits: every iteration is compacted
         "gated_sparse": dict(method="mg", frontier_gate=True,
                              frontier_sparse=True, frontier_cap_rows=2**30),
         "bm": dict(method="bm"),
         "rescan": dict(method="mg", rescan=True)}


def _graphs(seed=2**33 + 7):
    """The same graph with int64 and with int32 offsets."""
    o, i, w = make_graph("powerlaw_web_wide", WEB, seed, "cpu")
    assert o.dtype == torch.int64
    n = o.numel() - 1
    return (CSRGraph(offsets=o, indices=i, weights=w, n_nodes=n,
                     n_edges=i.numel()),
            CSRGraph(offsets=o.to(torch.int32), indices=i, weights=w,
                     n_nodes=n, n_edges=i.numel()))


def _run_key(res):
    return (res.iterations, res.changed_history, res.frontier_history,
            res.work_rows_history)


# -- plans of a degree sequence past 2**31 (no slot allocated) ------------


def test_fused_plan_keeps_wide_round0_starts_exact():
    degrees = np.array([2**30 + 5, 0, 3, 2**30 + 7, 17, 2**30], np.int64)
    assert degrees.sum() > WIDE
    chunk = 2**20  # few rows: 3,075 round-0 rows, one round-1 row a vertex
    plan = build_fused_fold_plan(degrees, k=8, chunk=chunk, tile_r=8,
                                 device="cpu")
    r0, r1 = plan.rounds
    assert r0.row_start.dtype == torch.int64
    assert r1.row_start.dtype == torch.int32
    assert r0.n_entries_in == int(degrees.sum())
    # every real row's start, worked out again from the offsets in int64
    offsets = np.concatenate([[0], np.cumsum(degrees)])
    rv = plan.row_to_vertex0.numpy()
    rank = plan.row_rank0.numpy()
    real = rv >= 0
    want = offsets[rv[real]] + rank[real].astype(np.int64) * chunk
    starts = r0.row_start.reshape(-1).numpy()
    np.testing.assert_array_equal(starts[real], want)
    assert starts.max() > WIDE
    counts = r0.row_count.reshape(-1).numpy()
    assert int(counts.sum()) == int(degrees.sum())
    # later rounds index the k-slot sketches, as on the narrow path
    assert int((r1.row_start.long() + r1.row_count).max()) <= r1.n_entries_in
    # int32 starts cannot hold this sequence
    with pytest.raises(ValueError, match="int32"):
        build_fused_fold_plan(degrees, k=8, chunk=chunk, tile_r=8,
                              device="cpu", starts_dtype=torch.int32)


def test_wide_fused_plan_equals_narrow_but_for_the_dtype():
    degrees = np.random.default_rng(1).integers(0, 300, 400)
    narrow = build_fused_fold_plan(degrees, k=8, chunk=16, tile_r=8,
                                   device="cpu")
    wide = build_fused_fold_plan(degrees, k=8, chunk=16, tile_r=8,
                                 device="cpu", starts_dtype=torch.int64)
    assert narrow.rounds[0].row_start.dtype == torch.int32
    assert wide.rounds[0].row_start.dtype == torch.int64
    assert torch.equal(wide.rounds[0].row_start.int(),
                       narrow.rounds[0].row_start)
    for a, b in zip(narrow.rounds[1:], wide.rounds[1:]):
        assert a.row_start.dtype == b.row_start.dtype == torch.int32
        assert torch.equal(a.row_start, b.row_start)
    for a, b in zip(narrow.rounds, wide.rounds):
        assert torch.equal(a.row_count, b.row_count)
        assert torch.equal(a.row_vertex, b.row_vertex)


@pytest.mark.parametrize("build,what", [
    (lambda d: build_fold_plan(d, device="cpu"), "bucketed"),
    (lambda d: build_streamed_fold_plan(d, device="cpu"), "streamed"),
    (lambda d: build_workspace(_broadcast_graph(d), LPAConfig(
        method="exact")), "exact")],
    ids=["bucketed", "streamed", "exact"])
def test_int32_plans_refuse_a_sequence_past_2_31(build, what):
    degrees = np.array([2**30, 2**30, 1], np.int64)
    with pytest.raises(ValueError, match=what):
        build(degrees)


def test_2_31_minus_1_slots_still_fit():
    csr.refuse_wide(WIDE - 1, "an int32 plan")
    with pytest.raises(ValueError, match="an int32 plan"):
        csr.refuse_wide(WIDE, "an int32 plan")


def _broadcast_graph(degrees):
    """A graph of ``degrees`` whose indices and weights are one element
    each, broadcast (nothing of size M is allocated): for the refusals,
    which must come before any slot is read."""
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(degrees)]))
    m = int(offsets[-1])
    return CSRGraph(offsets=offsets,
                    indices=torch.zeros(1, dtype=torch.int32).expand(m),
                    weights=torch.ones(1).expand(m), n_nodes=len(degrees),
                    n_edges=m)


def _huge_graph():
    """A graph of 2**31 + 1 slots, broadcast (:func:`_broadcast_graph`)."""
    return _broadcast_graph(np.array([2**30, WIDE + 1 - 2**30], np.int64))


@pytest.mark.parametrize("backend,method,what", [
    ("jnp", "mg", "bucketed"), ("pallas", "bm", "bucketed"),
    ("pallas_stream", "mg", "streamed"), ("auto", "mg", "streamed"),
    ("pallas_fused", "exact", "exact")])
def test_workspace_refuses_a_graph_past_2_31(backend, method, what):
    config = LPAConfig(method=method, fold_backend=backend)
    with pytest.raises(ValueError, match=what):
        build_workspace(_huge_graph(), config)


def test_csr_constructors_widen_offsets_only_past_2_31():
    assert offsets_dtype(WIDE - 1) == torch.int32
    assert offsets_dtype(WIDE) == torch.int64
    edges = np.array([[0, 1], [1, 2], [2, 0]])
    g = build_csr(edges, 3, device="cpu")
    assert g.offsets.dtype == torch.int32
    g64 = graph_from_arrays(np.array([0, 1, 2], np.int64),
                            np.array([1, 0], np.int64),
                            np.ones(2, np.float32), 2, device="cpu")
    assert g64.offsets.dtype == torch.int32


# -- lpa() with int64 offsets, on the CPU ----------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_offsets_give_the_narrow_run(case):
    wide, narrow = _graphs()
    config = LPAConfig(**BASE, **CASES[case])
    ws = build_workspace(wide, config)
    assert ws.fused_plan.rounds[0].row_start.dtype == torch.int64
    assert ws.fused_plan.n_rounds > 1
    got = lpa(wide, config, ws=ws, device="cpu")
    want = lpa(narrow, config, device="cpu")
    assert torch.equal(got.labels, want.labels)
    assert _run_key(got) == _run_key(want)
    if case == "gated_sparse":
        assert min(got.work_rows_history) < got.work_rows_history[0]


@pytest.mark.parametrize("case", ["mg", "gated_sparse"])
def test_wide_offsets_give_the_plain_reference(case):
    wide, _ = _graphs(seed=11)
    fields = {**BASE, **CASES[case]}
    got = lpa(wide, LPAConfig(**fields), device="cpu")
    ref = detect(wide.offsets, wide.indices, wide.weights, k=fields["k"],
                 chunk=fields["chunk"], rho=fields["rho"], tau=fields["tau"],
                 max_iters=fields["max_iters"],
                 gate=fields.get("frontier_gate", False), track_frontier=True)
    assert torch.equal(got.labels, ref.labels)
    assert (got.iterations, got.changed_history, got.frontier_history) == (
        ref.iterations, ref.changed_history, ref.frontier_history)


# -- the int64 instantiations on the card ----------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests launch the CUDA kernels")
    return torch.device("cuda")


def _shifted(rnd: FusedRound, base: int) -> FusedRound:
    """``rnd`` with every start moved down by ``base``, in int32."""
    return FusedRound(row_start=(rnd.row_start - base).to(torch.int32),
                      row_count=rnd.row_count, step_dmax=rnd.step_dmax,
                      n_entries_in=rnd.n_entries_in - base,
                      row_vertex=rnd.row_vertex)


def _round_ops(rnd, plain_rnd, el, ew, plain_el, plain_ew, k, chunk, seed):
    """(kernel, plain) output pairs of K1-K4 on one round."""
    rows = rnd.row_start.numel()
    dev = el.device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    inc = torch.randint(0, 1000, (rows,), generator=gen,
                        dtype=torch.int32).to(dev)
    cand = torch.randint(-1, 1000, (rows, k), generator=gen,
                         dtype=torch.int32).to(dev)
    return [
        (fused.fused_fold_round(rnd, el, ew, k=k, chunk=chunk),
         fused.fused_fold_round_plain(plain_rnd, plain_el, plain_ew, k=k,
                                      chunk=chunk)),
        (fused.fused_select_round(rnd, el, ew, inc, 5, k=k, chunk=chunk),
         fused.fused_select_round_plain(plain_rnd, plain_el, plain_ew, inc,
                                        5, k=k, chunk=chunk)),
        (fused.bm_fold_round_fused(rnd, el, ew, inc, chunk=chunk),
         fused.bm_fold_round_plain(plain_rnd, plain_el, plain_ew, inc,
                                   chunk=chunk)),
        (fused.rescan_round_fused(rnd, el, ew, cand, k=k, chunk=chunk),
         fused.rescan_round_plain(plain_rnd, plain_el, plain_ew, cand,
                                  chunk=chunk)),
    ]


def _assert_pairs(pairs):
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_wide_kernels_equal_their_plain_versions(cuda):
    """On a small graph with int64 offsets: K1-K4 on round 0 (int64
    starts) equal the plain versions, and the frontier marks' int64
    instantiation equals the plain marks and the int32 one."""
    wide, _ = _graphs()
    g = CSRGraph(offsets=wide.offsets.to(cuda), indices=wide.indices.to(cuda),
                 weights=wide.weights.to(cuda), n_nodes=wide.n_nodes,
                 n_edges=wide.n_edges)
    plan = build_fused_fold_plan(g.degrees.cpu().numpy(), k=8, chunk=16,
                                 tile_r=128, device=cuda,
                                 starts_dtype=torch.int64)
    rnd = plan.rounds[0]
    assert rnd.row_start.dtype == torch.int64
    labels = torch.randint(0, 500, (g.n_nodes,), device=cuda,
                           dtype=torch.int32)
    el = labels[g.indices.long()]
    _assert_pairs(_round_ops(rnd, rnd, el, g.weights, el, g.weights, 8, 16,
                             1))
    for p in (0.0, 0.3, 1.0):
        changed = torch.rand(g.n_nodes, device=cuda) < p
        got = frontier.frontier_marks(changed, g.offsets, g.indices)
        assert torch.equal(got, frontier.frontier_marks_plain(
            changed, g.offsets, g.indices))
        assert torch.equal(got, frontier.frontier_marks(
            changed, g.offsets.to(torch.int32), g.indices))


@pytest.mark.gpu
def test_wide_kernels_address_past_2_31(cuda):
    """Rows that start past 2**31 (and one that straddles it) in entry
    arrays of 2**31 + 2**20 entries: K1-K4 equal their plain versions run
    on the same entries through int32 starts moved down, and the marks
    equal the marks worked out row by row."""
    k, chunk = 8, 128
    m = WIDE + 2**20
    base = WIDE - 3000  # the region the rows read: [base, m)
    el = torch.empty(m, dtype=torch.int32, device=cuda)
    ew = torch.empty(m, dtype=torch.float32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    span = m - base
    el[base:] = torch.randint(0, 64, (span,), device=cuda, generator=gen,
                              dtype=torch.int32)
    ew[base:] = torch.rand(span, device=cuda, generator=gen) + 2.0**-24
    # rows: vertex 0 holds the first `base` slots (never read); then rows
    # of 1 to 128 entries, the first straddling 2**31
    rng = np.random.default_rng(4)
    deg = np.concatenate([[base], rng.integers(1, 129, 6000)])
    deg[-1] += m - int(deg.sum())
    plan = build_fused_fold_plan(deg, k=k, chunk=chunk, tile_r=128,
                                 device=cuda)
    rnd = plan.rounds[0]
    assert rnd.row_start.dtype == torch.int64
    # vertex 0's rows go: only the rows at or past `base` are launched
    keep = rnd.row_start.reshape(-1) >= base
    idx = torch.nonzero(keep).squeeze(1)
    rows = idx.numel() - idx.numel() % 128
    idx = idx[:rows]
    sub = FusedRound(row_start=rnd.row_start.reshape(-1)[idx].reshape(-1, 128),
                     row_count=rnd.row_count.reshape(-1)[idx].reshape(-1, 128),
                     step_dmax=rnd.step_dmax[:rows // 128],
                     n_entries_in=m)
    assert int(sub.row_start.max()) > WIDE
    assert bool((sub.row_start < WIDE).any())
    _assert_pairs(_round_ops(sub, _shifted(sub, base), el, ew, el[base:],
                             ew[base:], k, chunk, 2))
    # marks: the same entries read as neighbour ids of 64 vertices
    n = deg.size
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(deg)]),
                              device=cuda)
    changed = torch.rand(n, device=cuda, generator=gen) < 0.5
    changed[0] = False  # its row is the unread 2**31 - 3000 slots
    want = torch.zeros(n, dtype=torch.bool, device=cuda)
    off = offsets.cpu().numpy()
    for v in torch.nonzero(changed).squeeze(1).tolist():
        want[el[off[v]:off[v + 1]].long()] = True
    assert torch.equal(frontier.frontier_marks(changed, offsets, el), want)
    assert csr.INT32_SLOTS < m
