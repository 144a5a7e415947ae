"""The hand-written CUDA kernels K1 (MG fold), K2 (MG fold + select), K3
(BM fold) and K4 (rescan), their streamed counterparts K5–K8 over the
windowed plan and the per-bucket tile folds K9 (MG) and K10 (BM), against
their plain-torch versions on the card, bit for bit; the whole fused,
streamed and per-bucket paths (νMG, νBM, rescan; aligned and not) on the
card against the plain-torch reference engine; the sparse frontier runs
on the card against their dense gated runs; ``exact_choose``'s group
sums on the card against the CPU's; K1 and K5, whose group fold takes a
warp's lanes k to a row, K4, whose rescan does too, K9 and K10, which
stage their tiles through shared memory, K3, which stages its rows'
segments, and K8, whose streamed rescan takes a warp's lanes k to a row
slot, on the adversarial cases of ``tests/_fold_cases.py``; and
modularity, whose repeated calls give the same bits on the card; and
K5, K7 and K8 on the shards of a stacked distributed workspace whose
windows the stacking padded (appended all-pad windows, widened strides).

Marked ``gpu``: without a CUDA device every test here skips (the decision
is taken inside the ``cuda`` fixture, never at import). On a machine with
a card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda_kernels.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import exact, sketch
from repro_torch.core.lpa import LPAConfig, lpa
from repro_torch.core.modularity import modularity
from repro_torch.graphs import generators as tgen
from repro_torch.core.lpa import build_workspace
from repro_torch.core.distributed import _stream_round, build_dist_workspace
from repro_torch.graphs.csr import (FusedRound, StreamedRound, build_csr,
                                    build_fused_fold_plan,
                                    build_streamed_fold_plan,
                                    plan_dispatches, plan_round0_dispatches)
from repro_torch.kernels import launches
from repro_torch.kernels.mg_sketch import fused, ops, streaming
from _fold_cases import (TILE_SHAPES, UNALIGNED_OFFSET, bm_case,
                         bm_tile_case, embed_at, fused_case, rescan_case,
                         stream_case, stream_rescan_case, tile_case)

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


def _case_round(case, dev, kind):
    """A ``tests/_fold_cases.py`` case as the port's round on ``dev``, with
    its (labels, weights) there."""
    t = {f: torch.from_numpy(case[f]).to(dev)
         for f in ("row_start", "row_count", "step_dmax")}
    if kind == "fused":
        rnd = FusedRound(**t, n_entries_in=case["n_entries_in"])
    else:
        rnd = StreamedRound(
            entry_gather=torch.from_numpy(case["entry_gather"]).to(dev), **t,
            n_entries_in=case["n_entries_in"],
            window_entries=case["window_entries"], aligned=True)
    return (rnd, torch.from_numpy(case["labels"]).to(dev),
            torch.from_numpy(case["weights"]).to(dev))


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("tile_r,n_random", [(13, 91), (128, 3000)])
def test_fold_kernel_on_group_cases(cuda, k, tile_r, n_random):
    """K1 (a group of k lanes per row) against plain, bit for bit, on the
    rows that stress the group fold (tests/_fold_cases.py): counts around
    k and the chunk, every start mod 8, shuffled rows, slots freed and
    reclaimed mid-row, no-op entries, equal weights, a ragged last block;
    the larger case spans a few hundred blocks."""
    rnd, el, ew = _case_round(
        fused_case(k, seed=k, tile_r=tile_r, n_random=n_random), cuda,
        "fused")
    fused.reset_launch_counts()
    got = fused.fused_fold_round(rnd, el, ew, k=k, chunk=128)
    torch.cuda.synchronize()
    assert fused.LAUNCH_COUNTS["fused_fold"] == 1
    ref = fused.fused_fold_round_plain(rnd, el, ew, k=k, chunk=128)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("tile_r,fill", [(6, (6, 2, 0, 5, 1)),
                                         (128, (128, 3, 0, 77, 128, 1))])
def test_stream_fold_kernel_on_group_cases(cuda, k, tile_r, fill):
    """K5 against plain, bit for bit, on the same rows laid out in windows
    whose row slots differ in count (one window holds no row); at
    tile_r = 128 and k = 32 a block takes 32 passes over its row slots."""
    case = stream_case(k, seed=100 + k, tile_r=tile_r, fill=fill,
                       n_random=sum(fill) - 14)
    rnd, el, ew = _case_round(case, cuda, "stream")
    streaming.reset_launch_counts()
    got = streaming.stream_fold_round(rnd, el, ew, k=k, chunk=128)
    torch.cuda.synchronize()
    assert streaming.LAUNCH_COUNTS["stream_fold"] == 1
    ref = streaming.stream_fold_round_plain(rnd, el, ew, k=k, chunk=128)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _same_bits(a, b):
    """Equal values and, for float32, equal bits (-0.0 is not +0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("tile_r,n_random", [(13, 91), (128, 3000)])
def test_rescan_kernel_on_rescan_cases(cuda, k, tile_r, n_random):
    """K4 (a group of k lanes per row) against plain, bit for bit, on
    the rescan cases: counts around k and the chunk, shuffled rows,
    duplicate and -1 candidates, signed zeros mid-row, and gap entries
    that carry the neighbouring rows' candidates."""
    case = rescan_case(k, seed=200 + k, tile_r=tile_r, n_random=n_random)
    rnd, el, ew = _case_round(case, cuda, "fused")
    cand = torch.from_numpy(case["cand"]).to(cuda)
    fused.reset_launch_counts()
    got = fused.rescan_round_fused(rnd, el, ew, cand, k=k, chunk=128)
    torch.cuda.synchronize()
    assert fused.LAUNCH_COUNTS["rescan"] == 1
    ref = fused.rescan_round_plain(rnd, el, ew, cand, chunk=128)
    assert _same_bits(got, ref)


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("offset", [0, UNALIGNED_OFFSET])
@pytest.mark.parametrize("tile_r,fill,n_random", [
    (6, (6, 2, 0, 5, 1), 7), (100, (100, 3, 0, 77, 1), 174)])
def test_stream_rescan_kernel_on_rescan_cases(cuda, k, offset, tile_r, fill,
                                              n_random):
    """K8 (a group of k lanes per row slot) against plain, bit for bit, on
    the rescan cases laid out in windows whose row slots differ in count
    (one window holds no row), pad slots storing zeros; tile_r 100 is no
    multiple of the row slots a pass of 256 threads takes (64, 32 and 8
    at k = 4, 8 and 32), nor is 6 of the 8 a block of 32 or 64 threads
    takes at k = 4 and 8, so a pass has groups past tile_r; at offset 1
    the windowed arrays start 4 bytes past a 16-byte boundary."""
    case = stream_rescan_case(k, seed=300 + k, tile_r=tile_r, fill=fill,
                              n_random=n_random)
    rnd, _, _ = _case_round(case, cuda, "stream")
    el = torch.from_numpy(embed_at(case["labels"], offset)).to(cuda)[offset:]
    ew = torch.from_numpy(embed_at(case["weights"], offset)).to(cuda)[offset:]
    assert (el.data_ptr() % 16 == 0) == (offset == 0)
    cand = torch.from_numpy(case["cand"]).to(cuda)
    streaming.reset_launch_counts()
    got = streaming.rescan_round_stream(rnd, el, ew, cand, k=k, chunk=128)
    torch.cuda.synchronize()
    assert streaming.LAUNCH_COUNTS["stream_rescan"] == 1
    ref = streaming.rescan_round_stream_plain(rnd, el, ew, cand, chunk=128)
    assert _same_bits(got, ref)
    pads = torch.from_numpy(case["row_count"].reshape(-1) == 0).to(cuda)
    assert pads.any() and not got[pads].any()


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("offset", [0, UNALIGNED_OFFSET])
def test_tile_kernel_on_tile_cases(cuda, k, offset):
    """K9 against plain, bit for bit, on the tile cases: every width
    class of its stage (16-byte copies where D % 4 == 0, 4-byte ones
    where D is odd; one chunk, or four at D = 128), R = 1, odd, past one
    block and past many; at offset 1 the same tiles as contiguous slices
    4 bytes past a 16-byte boundary, which take the 4-byte copies at
    every width."""
    for width, n_rows in TILE_SHAPES + ((8, 5000), (32, 3001)):
        labels, weights = tile_case(k, width, n_rows, seed=width + k)
        flat_l = torch.from_numpy(embed_at(labels, offset)).to(cuda)
        flat_w = torch.from_numpy(embed_at(weights, offset)).to(cuda)
        gl = flat_l[offset:].view(n_rows, width)
        gw = flat_w[offset:].view(n_rows, width)
        assert (gl.data_ptr() % 16 == 0) == (offset == 0)
        launches.reset_launch_counts()
        got = ops.mg_fold_tile_pallas(gl, gw, k)
        torch.cuda.synchronize()
        assert launches.LAUNCH_COUNTS["tile_mg_fold"] == 1
        ref = sketch.mg_fold_tile(gl, gw, k)
        assert _same_bits(got[0], ref[0]) and _same_bits(got[1], ref[1]), \
            (width, n_rows)


@pytest.mark.parametrize("offset", [0, UNALIGNED_OFFSET])
@pytest.mark.parametrize("tile_r,n_random", [(13, 91), (128, 3000)])
def test_bm_fold_kernel_on_bm_cases(cuda, offset, tile_r, n_random):
    """K3 against plain, bit for bit, on the BM cases:
    ties, runs, a decrement to just above the next weight, no-ops
    mid-row, incumbents -1 and equal to the first label, counts around
    every stage chunk width, shuffled rows at every start mod 8 with junk
    in the gaps; the larger case spans a few dozen blocks; at offset 1 the
    entry arrays are slices 4 bytes past a 16-byte boundary."""
    case = bm_case(400 + tile_r, tile_r=tile_r, n_random=n_random)
    rnd, _, _ = _case_round(case, cuda, "fused")
    el = torch.from_numpy(embed_at(case["labels"], offset)).to(cuda)[offset:]
    ew = torch.from_numpy(embed_at(case["weights"], offset)).to(cuda)[offset:]
    init = torch.from_numpy(case["init"]).to(cuda)
    fused.reset_launch_counts()
    got = fused.bm_fold_round_fused(rnd, el, ew, init, chunk=128)
    torch.cuda.synchronize()
    assert fused.LAUNCH_COUNTS["bm_fold"] == 1
    ref = fused.bm_fold_round_plain(rnd, el, ew, init, chunk=128)
    assert _same_bits(got[0], ref[0]) and _same_bits(got[1], ref[1])


@pytest.mark.parametrize("offset", [0, UNALIGNED_OFFSET])
def test_tile_bm_kernel_on_bm_tile_cases(cuda, offset):
    """K10 against plain, bit for bit, on the BM tile cases at every
    width class of the stage it shares with K9 (16-byte copies where
    D % 4 == 0, 4-byte ones where D is odd or, at offset 1, everywhere;
    one chunk, two, or four at D = 128), R = 1, odd, past one block and
    past many; one launch each."""
    for width, n_rows in TILE_SHAPES + ((8, 5000), (64, 300), (32, 3001)):
        labels, weights, init = bm_tile_case(width, n_rows, seed=300 + width)
        flat_l = torch.from_numpy(embed_at(labels, offset)).to(cuda)
        flat_w = torch.from_numpy(embed_at(weights, offset)).to(cuda)
        gl = flat_l[offset:].view(n_rows, width)
        gw = flat_w[offset:].view(n_rows, width)
        gi = torch.from_numpy(init).to(cuda)
        assert (gl.data_ptr() % 16 == 0) == (offset == 0)
        launches.reset_launch_counts()
        got = ops.bm_fold_tile_pallas(gl, gw, gi)
        torch.cuda.synchronize()
        assert launches.LAUNCH_COUNTS["tile_bm_fold"] == 1
        ref = sketch.bm_fold_tile(gl, gw, gi)
        assert _same_bits(got[0], ref[0]) and _same_bits(got[1], ref[1]), \
            (width, n_rows)


def test_tile_kernels_share_one_stage_size(cuda):
    """K9 and K10 size their launches with one function: the stage (two
    buffers at most) for both, K9's sketch store where it is larger."""
    from repro_torch.kernels.mg_sketch import mg_sketch
    # width, aligned -> stage bytes (C = 8 or 32, 16-byte or 4-byte rows)
    stages = {(4, True): 12_288, (7, True): 9_216, (32, True): 36_864,
              (33, True): 67_584, (128, True): 73_728,
              (128, False): 67_584, (0, True): 0}
    for (width, aligned), stage in stages.items():
        assert mg_sketch.tile_fold_smem_bytes(width, None, aligned) == stage
        for k in (4, 8, 32):
            sketch_bytes = 2 * 128 * (k + 1) * 4
            assert mg_sketch.tile_fold_smem_bytes(width, k, aligned) == max(
                stage, sketch_bytes)
    with pytest.raises(ValueError):
        mg_sketch.tile_fold_smem_bytes(8, 3)


def test_modularity_is_reproducible_on_the_card(cuda):
    """Three calls on the same νBM labels of a 2^16-vertex graph give
    the same bits: every segment sum adds in a fixed order."""
    g, _ = tgen.powerlaw_communities(1 << 16, p_in=0.5, mix=0.02, seed=1,
                                     device=cuda)
    labels = lpa(g, LPAConfig(method="bm")).labels
    bits = {modularity(g, labels).reshape(1).view(torch.int32).item()
            for _ in range(3)}
    assert len(bits) == 1


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


@pytest.mark.parametrize("k,chunk,tile_r", [(8, 128, 128), (4, 16, 8),
                                            (32, 128, 128)])
def test_bm_fold_kernel_matches_plain(cuda, k, chunk, tile_r):
    """K3 on round 0, from random incumbents over a small alphabet (all
    three BM branches and ties wk == w run) and from vertex-id
    incumbents."""
    g, _ = tgen.powerlaw_communities(4096, p_in=0.4, mix=0.05, seed=7,
                                     device="cpu")
    plan = build_fused_fold_plan(g.degrees.numpy(), k=k, chunk=chunk,
                                 tile_r=tile_r, device=cuda)
    rng = np.random.default_rng(30 + k)
    rnd = plan.rounds[0]
    rv = plan.row_to_vertex0
    el, ew = _round_inputs(rnd, rng, cuda, alphabet=6)
    rand_init = torch.from_numpy(rng.integers(-1, 6, rv.numel())
                                 .astype(np.int32)).to(cuda)
    ids = torch.arange(g.n_nodes, dtype=torch.int32, device=cuda)
    for init in (torch.where(rv >= 0, rand_init, -1),
                 sketch.bm_init_rows(rv, ids)):
        fused.reset_launch_counts()
        got_c, got_w = fused.bm_fold_round_fused(rnd, el, ew, init,
                                                 chunk=chunk)
        torch.cuda.synchronize()
        assert fused.LAUNCH_COUNTS["bm_fold"] == 1
        ref_c, ref_w = fused.bm_fold_round_plain(rnd, el, ew, init,
                                                 chunk=chunk)
        assert torch.equal(got_c, ref_c)
        assert torch.equal(got_w, ref_w)


@pytest.mark.parametrize("k", [4, 8, 32])
def test_rescan_kernel_matches_plain(cuda, k):
    """K4 on round 0 with random candidates (duplicates and -1 empties
    included) over random entries whose weights include 0 and negatives."""
    g, _ = tgen.powerlaw_communities(4096, p_in=0.4, mix=0.05, seed=7,
                                     device="cpu")
    chunk = 4 * k  # a plan's chunk must exceed k; rows of up to 4k entries
    plan = build_fused_fold_plan(g.degrees.numpy(), k=k, chunk=chunk,
                                 tile_r=32, device=cuda)
    rng = np.random.default_rng(40 + k)
    rnd = plan.rounds[0]
    n_in = rnd.n_entries_in
    el = torch.from_numpy(rng.integers(-1, 2 * k, n_in).astype(np.int32))
    ew = torch.from_numpy(((rng.random(n_in) - 0.2) * 3).astype(np.float32))
    rows = rnd.row_start.numel()
    cand = torch.from_numpy(rng.integers(-1, 2 * k, (rows, k))
                            .astype(np.int32))
    el, ew, cand = el.to(cuda), ew.to(cuda), cand.to(cuda)
    fused.reset_launch_counts()
    got = fused.rescan_round_fused(rnd, el, ew, cand, k=k, chunk=chunk)
    torch.cuda.synchronize()
    assert fused.LAUNCH_COUNTS["rescan"] == 1
    ref = fused.rescan_round_plain(rnd, el, ew, cand, chunk=chunk)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("method,rescan", [("bm", False), ("mg", True)])
def test_bm_and_rescan_paths_match_reference_engine_on_the_card(
        cuda, method, rescan):
    g, _ = tgen.powerlaw_communities(4096, p_in=0.5, mix=0.02, seed=1,
                                     device=cuda)
    cfg = dict(method=method, rescan=rescan, rho=2)
    ref = lpa(g, LPAConfig(fold_backend="jnp", **cfg))
    fused.reset_launch_counts()
    got = lpa(g, LPAConfig(fold_backend="pallas_fused", **cfg))
    assert torch.equal(got.labels, ref.labels)
    assert got.changed_history == ref.changed_history
    key = "rescan" if rescan else "bm_fold"
    assert fused.LAUNCH_COUNTS[key] == got.iterations


def test_exact_group_sums_on_the_card_equal_the_cpu(cuda):
    """Non-dyadic weights in groups of 1 to 10^5 values: the card's group
    sums and exact_choose's choices equal the CPU's bit for bit."""
    rng = np.random.default_rng(3)
    sizes = np.asarray([1, 2, 5, 31, 32, 33, 64, 100, 1000, 4097, 100_000])
    group = np.repeat(np.arange(len(sizes)), sizes)
    values = (rng.random(group.size) * 3 + 0.1).astype(np.float32)
    cpu = exact._group_sums(torch.from_numpy(values),
                            torch.from_numpy(group), len(sizes))
    gpu = exact._group_sums(torch.from_numpy(values).to(cuda),
                            torch.from_numpy(group).to(cuda), len(sizes))
    assert torch.equal(gpu.cpu(), cpu)
    n, m = 3000, 400_000
    src = np.sort(rng.integers(0, n, m)).astype(np.int32)
    src[: m // 4] = 7  # one hub with 10^5 edges
    src.sort()
    nbr = rng.integers(0, 5, m).astype(np.int32)
    w = (rng.random(m) * 3 + 0.1).astype(np.float32)
    labels = rng.integers(0, n, n).astype(np.int32)
    args = [torch.from_numpy(x) for x in (src, nbr, w)]
    for seed in (1, 5):
        cpu = exact.exact_choose(*args, n, torch.from_numpy(labels), seed)
        gpu = exact.exact_choose(*[a.to(cuda) for a in args], n,
                                 torch.from_numpy(labels).to(cuda), seed)
        assert torch.equal(gpu.cpu(), cpu)


def test_unsupported_k_raises_on_the_card(cuda):
    g, _ = tgen.powerlaw_communities(1024, seed=7, device="cpu")
    plan = build_fused_fold_plan(g.degrees.numpy(), k=3, chunk=16,
                                 tile_r=8, device=cuda)
    rnd = plan.rounds[0]
    el = torch.zeros(rnd.n_entries_in, dtype=torch.int32, device=cuda)
    ew = torch.ones(rnd.n_entries_in, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        fused.fused_fold_round(rnd, el, ew, k=3, chunk=16)


# ---------------------------------------------------------------------------
# K5–K8: the streamed kernels over the windowed plan
# ---------------------------------------------------------------------------


def _stream_plan(g, dev, *, k, chunk, tile_r, window, aligned):
    return build_streamed_fold_plan(g.degrees.numpy(), k=k, chunk=chunk,
                                    tile_r=tile_r, window_entries=window,
                                    indices=g.indices.numpy(),
                                    weights=g.weights.numpy(),
                                    aligned=aligned, device=dev)


def _stream_rounds_match_plain(plan, rng, dev):
    """K5 on every round, K6 on the last, K7 and K8 on round 0, each
    against its plain version with torch.equal; one launch each."""
    k, chunk = plan.k, plan.chunk
    for r, rnd in enumerate(plan.rounds):
        el, ew = _round_inputs(rnd, rng, dev, alphabet=3 * k)
        rows = rnd.row_start.numel()
        streaming.reset_launch_counts()
        got = streaming.stream_fold_round(rnd, el, ew, k=k, chunk=chunk)
        torch.cuda.synchronize()
        ref = streaming.stream_fold_round_plain(rnd, el, ew, k=k,
                                                chunk=chunk)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        if r == plan.n_rounds - 1:
            inc = torch.from_numpy(rng.integers(-1, 3 * k, rows)
                                   .astype(np.int32)).to(dev)
            for seed in (1, 5):
                got = streaming.stream_select_round(rnd, el, ew, inc, seed,
                                                    k=k, chunk=chunk)
                torch.cuda.synchronize()
                ref = streaming.stream_select_round_plain(
                    rnd, el, ew, inc, seed, k=k, chunk=chunk)
                assert torch.equal(got, ref)
        if r == 0:
            init = torch.from_numpy(rng.integers(-1, 6, rows)
                                    .astype(np.int32)).to(dev)
            el6 = torch.remainder(el, 6)  # few labels: every BM branch
            got = streaming.bm_fold_round_stream(rnd, el6, ew, init,
                                                 chunk=chunk)
            torch.cuda.synchronize()
            ref = streaming.bm_fold_round_stream_plain(rnd, el6, ew, init,
                                                       chunk=chunk)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            cand = torch.from_numpy(rng.integers(-1, 3 * k, (rows, k))
                                    .astype(np.int32)).to(dev)
            ew4 = ew - 0.5  # K8 counts weights <= 0 too
            got = streaming.rescan_round_stream(rnd, el, ew4, cand, k=k,
                                                chunk=chunk)
            torch.cuda.synchronize()
            ref = streaming.rescan_round_stream_plain(rnd, el, ew4, cand,
                                                      chunk=chunk)
            assert torch.equal(got, ref)
        counts = streaming.LAUNCH_COUNTS
        assert counts["stream_fold"] == 1
        assert counts["stream_select"] == (2 if r == plan.n_rounds - 1
                                           else 0)
        assert counts["stream_bm"] == counts["stream_rescan"] == int(r == 0)
        assert not any(counts[key] for key in ("fused_fold", "fused_select",
                                               "bm_fold", "rescan"))


@pytest.mark.parametrize("k,chunk,tile_r,window", [
    (8, 128, 128, 8192), (4, 16, 8, 64), (32, 128, 128, 8192),
    (8, 128, 256, 8192)])  # 256 row slots: two per thread
@pytest.mark.parametrize("aligned", [False, True])
def test_stream_kernels_match_plain(cuda, k, chunk, tile_r, window,
                                    aligned):
    g, _ = tgen.powerlaw_communities(4096, p_in=0.4, mix=0.05, seed=7,
                                     device="cpu")
    plan = _stream_plan(g, cuda, k=k, chunk=chunk, tile_r=tile_r,
                        window=window, aligned=aligned)
    assert plan.n_rounds > 1 and plan.aligned == aligned
    _stream_rounds_match_plain(plan, np.random.default_rng(50 + k), cuda)


def test_stream_kernels_on_window_edges(cuda):
    """Rows of exactly ``chunk`` entries pack two to a 256-slot window, so
    every window's last row ends exactly at W and the last one at the end
    of the windowed array; then one window of a real round turned all
    pads."""
    degrees = np.full(8, 128)
    edges = np.stack([np.repeat(np.arange(8), 128),
                      np.arange(8 * 128) % 1000 + 8], axis=1)
    g = build_csr(edges, 1008, symmetrize=False, device="cpu")
    assert np.array_equal(g.degrees.numpy()[:8], degrees)
    plan = _stream_plan(g, cuda, k=8, chunk=128, tile_r=4, window=256,
                        aligned=False)
    rnd = plan.rounds[0]
    assert rnd.window_entries == 256
    ends = (rnd.row_start + rnd.row_count).cpu().numpy()
    assert (ends.max(axis=1) == 256).all()
    _stream_rounds_match_plain(plan, np.random.default_rng(60), cuda)
    # window 1's row slots all pads: the kernels must fold nothing there
    rc = rnd.row_count.clone()
    rc[1] = 0
    rs = rnd.row_start.clone()
    rs[1] = 0
    hollow = dataclasses.replace(rnd, row_start=rs, row_count=rc)
    rng = np.random.default_rng(61)
    el, ew = _round_inputs(hollow, rng, cuda, alphabet=24)
    got = streaming.stream_fold_round(hollow, el, ew, k=8, chunk=128)
    ref = streaming.stream_fold_round_plain(hollow, el, ew, k=8, chunk=128)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool((got[0][4:8] == -1).all()) and bool((got[1][4:8] == 0).all())


@pytest.mark.parametrize("aligned", [False, True])
def test_stream_kernels_on_the_empty_graph(cuda, aligned):
    g = build_csr(np.zeros((0, 2), np.int64), 5, device="cpu")
    plan = _stream_plan(g, cuda, k=8, chunk=128, tile_r=128, window=8192,
                        aligned=aligned)
    _stream_rounds_match_plain(plan, np.random.default_rng(70), cuda)
    gc = build_csr(np.zeros((0, 2), np.int64), 5, device=cuda)
    for method in ("mg", "bm"):
        res = lpa(gc, LPAConfig(method=method, fold_backend="pallas_stream",
                                aligned_layout=aligned))
        assert torch.equal(res.labels.cpu(), torch.arange(5,
                                                          dtype=torch.int32))


@pytest.mark.parametrize("method,rescan", [("mg", False), ("bm", False),
                                           ("mg", True)])
@pytest.mark.parametrize("aligned", [False, True])
def test_stream_paths_match_reference_engine_on_the_card(cuda, method,
                                                         rescan, aligned):
    g, _ = tgen.powerlaw_communities(4096, p_in=0.5, mix=0.02, seed=1,
                                     device=cuda)
    cfg = dict(method=method, rescan=rescan, rho=2, stream_window=1024)
    ref = lpa(g, LPAConfig(fold_backend="jnp", **cfg))
    streaming.reset_launch_counts()
    got = lpa(g, LPAConfig(fold_backend="pallas_stream",
                           aligned_layout=aligned, **cfg))
    assert torch.equal(got.labels, ref.labels)
    assert got.changed_history == ref.changed_history
    assert got.frontier_history == ref.frontier_history
    it = got.iterations
    want = dict.fromkeys(streaming.LAUNCH_COUNTS, 0)
    if method == "bm":
        want["stream_bm"] = it
    else:
        from repro_torch.core.lpa import build_workspace
        n_rounds = build_workspace(g, LPAConfig(
            fold_backend="pallas_stream", **cfg)).stream_plan.n_rounds
        if rescan:
            want.update(stream_fold=n_rounds * it, stream_rescan=it)
        else:
            want.update(stream_fold=(n_rounds - 1) * it, stream_select=it)
    want["frontier_marks"] = it  # one an iteration (track_frontier)
    assert streaming.LAUNCH_COUNTS == want


# ---------------------------------------------------------------------------
# K9/K10: the per-bucket tile folds
# ---------------------------------------------------------------------------


def _tile(rng, r, d, dev, n_labels, pad_rows=()):
    labels = rng.integers(0, n_labels, (r, d)).astype(np.int32)
    weights = (rng.integers(1, 8, (r, d)) * 0.375).astype(np.float32)
    pad = rng.random((r, d)) < 0.2
    pad[list(pad_rows)] = True
    labels[pad] = -1
    weights[pad] = 0.0
    return (torch.from_numpy(labels).to(dev),
            torch.from_numpy(weights).to(dev))


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("r,d,pad_rows", [(1, 4, ()), (127, 16, (0, 126)),
                                          (1000, 128, (5,)),
                                          (4099, 8, ())])
def test_tile_kernels_match_plain(cuda, k, r, d, pad_rows):
    """K9 at each k and K10 (no k) on R = 1, odd R, all-pad rows, against
    their plain versions; one launch each."""
    rng = np.random.default_rng(r + d + k)
    gl, gw = _tile(rng, r, d, cuda, n_labels=2 * k, pad_rows=pad_rows)
    init = torch.from_numpy(rng.integers(-1, 2 * k, r).astype(np.int32)
                            ).to(cuda)
    launches.reset_launch_counts()
    got = ops.mg_fold_tile_pallas(gl, gw, k)
    got_bm = ops.bm_fold_tile_pallas(gl, gw, init)
    torch.cuda.synchronize()
    want = dict.fromkeys(launches.LAUNCH_COUNTS, 0)
    want.update(tile_mg_fold=1, tile_bm_fold=1)
    assert launches.LAUNCH_COUNTS == want
    ref = sketch.mg_fold_tile(gl, gw, k)
    ref_bm = sketch.bm_fold_tile(gl, gw, init)
    for a, b in zip(got + got_bm, ref + ref_bm):
        assert torch.equal(a, b)
    for row in pad_rows:
        assert bool((got[0][row] == -1).all()) and float(got_bm[1][row]) == 0


def test_tile_kernels_on_an_empty_tile_and_unsupported_k(cuda):
    """R = 0 launches nothing (a zero-size grid is refused) and returns
    empty outputs; a k without an instantiation raises, never running the
    plain version."""
    gl = torch.zeros((0, 16), dtype=torch.int32, device=cuda)
    gw = torch.zeros((0, 16), dtype=torch.float32, device=cuda)
    launches.reset_launch_counts()
    s_k, s_v = ops.mg_fold_tile_pallas(gl, gw, 8)
    ck, wk = ops.bm_fold_tile_pallas(gl, gw)
    torch.cuda.synchronize()
    assert s_k.shape == (0, 8) and ck.shape == (0,)
    assert not any(launches.LAUNCH_COUNTS.values())
    gl, gw = _tile(np.random.default_rng(1), 8, 16, cuda, n_labels=4)
    with pytest.raises(ValueError):
        ops.mg_fold_tile_pallas(gl, gw, 3)


@pytest.mark.parametrize("method,rescan", [("mg", False), ("bm", False),
                                           ("mg", True)])
def test_pallas_paths_match_reference_engine_on_the_card(cuda, method,
                                                         rescan):
    """The per-bucket engine on the card: the plain engine's run, with one
    K9 launch per bucket per round (mg, rescan) or one K10 launch per
    round-0 bucket (bm) per iteration, one frontier_marks launch per
    iteration, and no other kernel."""
    g, _ = tgen.powerlaw_communities(4096, p_in=0.5, mix=0.02, seed=1,
                                     device=cuda)
    cfg = dict(method=method, rescan=rescan, rho=2, chunk=16)
    ref = lpa(g, LPAConfig(fold_backend="jnp", **cfg))
    launches.reset_launch_counts()
    got = lpa(g, LPAConfig(fold_backend="pallas", **cfg))
    assert torch.equal(got.labels, ref.labels)
    assert got.changed_history == ref.changed_history
    assert got.frontier_history == ref.frontier_history
    plan = build_workspace(g, LPAConfig(fold_backend="pallas",
                                        **cfg)).plan
    want = dict.fromkeys(launches.LAUNCH_COUNTS, 0)
    if method == "bm":
        want["tile_bm_fold"] = got.iterations * plan_round0_dispatches(plan)
    else:
        want["tile_mg_fold"] = got.iterations * plan_dispatches(plan)
    want["frontier_marks"] = got.iterations  # one an iteration
    assert launches.LAUNCH_COUNTS == want


@pytest.mark.parametrize("backend,aligned", [("pallas_fused", False),
                                             ("pallas_stream", False),
                                             ("pallas_stream", True)])
@pytest.mark.parametrize("method,rescan", [("mg", False), ("bm", False),
                                           ("mg", True)])
def test_sparse_paths_match_dense_gated_on_the_card(cuda, backend, aligned,
                                                    method, rescan):
    """Sparse frontier runs on the card equal their dense gated runs, at
    the default capacity and at one small enough to fall back to the
    dense fold on some iterations."""
    g, _ = tgen.sbm(8, 64, 0.3, 0.002, seed=1, device=cuda)
    cfg = dict(method=method, rescan=rescan, chunk=16, tau=0.0,
               max_iters=8, frontier_gate=True, fold_backend=backend,
               aligned_layout=aligned, stream_window=256)
    dense = lpa(g, LPAConfig(**cfg))
    for cap in (None, 40):
        sparse = lpa(g, LPAConfig(frontier_sparse=True,
                                  frontier_cap_rows=cap, **cfg))
        assert torch.equal(sparse.labels, dense.labels)
        assert sparse.changed_history == dense.changed_history
        assert sparse.frontier_history == dense.frontier_history
        assert sparse.iterations == dense.iterations


def _skewed_graph():
    """32 hubs of 64 random neighbours each, and a ring over the other 480
    vertices: the edge-balanced shards of 4 differ in window count and
    window stride (k=4, chunk=16, tile_r=32, 1,024-entry windows)."""
    rng = np.random.default_rng(0)
    n, hubs, fan = 512, 32, 64
    hub_edges = np.stack([np.repeat(np.arange(hubs), fan),
                          rng.integers(hubs, n, hubs * fan)], 1)
    ring = np.stack([np.arange(hubs, n),
                     np.r_[np.arange(hubs + 1, n), hubs]], 1)
    edges = np.concatenate([hub_edges, ring])
    w = (rng.integers(1, 8, len(edges)) * 0.5).astype(np.float32)
    return build_csr(edges, n, weights=w, device="cpu")


@pytest.mark.parametrize("aligned", [False, True])
def test_stream_kernels_on_padded_shards_match_plain(cuda, aligned):
    """Each shard's blocks of a stacked streamed workspace whose shards
    differ in window count and stride, so the stacking appended all-pad
    windows to the shorter shards and widened the narrower strides: K5 on
    every round (each fed the previous round's sketches), K7 and K8 on
    round 0, equal to their plain versions bit for bit."""
    k, chunk = 4, 16
    ws = build_dist_workspace(_skewed_graph(), 4, k=k, chunk=chunk,
                              tile_r=32, window_entries=1024, stream=True,
                              aligned=aligned)
    for counts, gathers in zip(ws.stream_counts, ws.stream_gathers):
        real = (counts > 0).any(dim=2).sum(dim=1)
        used = torch.stack([(g >= 0).any(dim=0).nonzero().max() + 1
                            for g in gathers])
        # windows appended to some shard, a 128-entry block of the stride
        # added to another
        assert int(real.min()) < counts.shape[1] == int(real.max())
        assert int(used.min()) <= gathers.shape[2] - 128
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.integers(
        -1, 24, 4 * ws.v_pad).astype(np.int32)).to(cuda)
    for p in range(4):
        sh = ws.shard(p, cuda)
        valid = sh.nbr_pos >= 0
        el = torch.where(valid, table[sh.nbr_pos.clamp_min(0).long()], -1)
        ew = sh.weights
        if aligned:
            sap = sh.stream_aligned_pos
            el = torch.where(sap >= 0, table[sap.clamp_min(0).long()], -1)
            ew = sh.stream_aligned_w
        el0, ew0 = el, ew
        launches.reset_launch_counts()
        for r in range(ws.n_rounds):
            rnd = _stream_round(sh, r, el, aligned and r == 0)
            got = streaming.stream_fold_round(rnd, el, ew, k=k, chunk=chunk)
            ref = streaming.stream_fold_round_plain(rnd, el, ew, k=k,
                                                    chunk=chunk)
            assert torch.equal(got[0], ref[0]), (p, r)
            assert _same_bits(got[1], ref[1]), (p, r)
            el, ew = got[0].reshape(-1), got[1].reshape(-1)
        rnd0 = _stream_round(sh, 0, el0, aligned)
        init = sketch.bm_init_rows(sh.stream_rv0, sh.init_labels)
        got = streaming.bm_fold_round_stream(rnd0, el0, ew0, init,
                                             chunk=chunk)
        ref = streaming.bm_fold_round_stream_plain(rnd0, el0, ew0, init,
                                                   chunk=chunk)
        assert torch.equal(got[0], ref[0]) and _same_bits(got[1], ref[1])
        cand = torch.from_numpy(rng.integers(
            -1, 24, (init.shape[0], k)).astype(np.int32)).to(cuda)
        got = streaming.rescan_round_stream(rnd0, el0, ew0, cand, k=k,
                                            chunk=chunk)
        ref = streaming.rescan_round_stream_plain(rnd0, el0, ew0, cand,
                                                  chunk=chunk)
        assert _same_bits(got, ref), p
        assert launches.LAUNCH_COUNTS["stream_fold"] == ws.n_rounds
        assert launches.LAUNCH_COUNTS["stream_bm"] == 1
        assert launches.LAUNCH_COUNTS["stream_rescan"] == 1
