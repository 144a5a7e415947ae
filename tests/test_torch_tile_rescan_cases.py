"""The port's plain versions of K9 (the per-bucket MG tile fold, through
``kernels.mg_sketch.ops.mg_fold_tile_pallas``), K4 (the rescan, through
``kernels.mg_sketch.fused.rescan_round_fused``) and K8 (the streamed
rescan, through ``kernels.mg_sketch.streaming.rescan_round_stream``)
against the JAX package on the CPU, on the cases that stress the CUDA
kernels' designs (``tests/_fold_cases.py``): K9's tiles at every width
class of its shared-memory stage, row counts around a block, all-pad rows
and a tile that is an unaligned slice; K4's rows around k and the chunk,
shuffled, with duplicate and -1 candidates, signed zeros mid-row and gap
entries that carry the neighbouring rows' candidates; K8's the same rows
in windows whose row slots differ in count. Bit for bit (float32
outputs compared as int32 bits, so -0.0 is not +0.0). The references are
the JAX Pallas kernels in interpret mode, one call per shape. The same
cases run through the CUDA kernels in ``tests/test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import csr as jcsr
from repro.kernels.mg_sketch import fused as jfused
from repro.kernels.mg_sketch import ops as jops
from repro.kernels.mg_sketch import streaming as jstream
from repro_torch.graphs import csr as tcsr
from repro_torch.kernels import launches
from repro_torch.kernels.mg_sketch import fused as tfused
from repro_torch.kernels.mg_sketch import ops as tops
from repro_torch.kernels.mg_sketch import streaming as tstream
from _fold_cases import (CHUNK, JUNK_LABEL, TILE_SHAPES, UNALIGNED_OFFSET,
                         embed_at, rescan_case, stream_rescan_case,
                         tile_case)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from _torch_parity import to_np


def assert_same_bits(ref, got, what):
    ref_np, got_np = to_np(ref), to_np(got)
    assert ref_np.dtype == got_np.dtype and ref_np.shape == got_np.shape
    np.testing.assert_array_equal(got_np.view(np.int32),
                                  ref_np.view(np.int32), err_msg=what)


#: (k, width, rows): every shape of TILE_SHAPES at k = 8, the wide and odd
#: widths at k = 4 and 32 too
TILE_CASES = ([(8, d, r) for d, r in TILE_SHAPES]
              + [(4, 33, 133), (32, 128, 131), (32, 7, 130)])


@pytest.mark.parametrize("k,width,n_rows", TILE_CASES)
def test_tile_cases_match_reference(k, width, n_rows):
    labels, weights = tile_case(k, width, n_rows, seed=width + k)
    ref = jops.mg_fold_tile_pallas(jnp.asarray(labels), jnp.asarray(weights),
                                   k, interpret=True)
    # the tile as it is, and as a contiguous slice 4 bytes past the start
    # of a longer array (the CUDA kernel's 4-byte copies)
    flat_l = torch.from_numpy(embed_at(labels))
    flat_w = torch.from_numpy(embed_at(weights))
    sliced = (flat_l[UNALIGNED_OFFSET:].view(n_rows, width),
              flat_w[UNALIGNED_OFFSET:].view(n_rows, width))
    assert sliced[0].is_contiguous() and sliced[1].is_contiguous()
    launches.reset_launch_counts()
    for tl, tw in ((torch.from_numpy(labels), torch.from_numpy(weights)),
                   sliced):
        got = tops.mg_fold_tile_pallas(tl, tw, k)
        assert_same_bits(ref[0], got[0], "sketch labels")
        assert_same_bits(ref[1], got[1], "sketch weights")
    assert not any(launches.LAUNCH_COUNTS.values())  # CPU: plain versions


def test_tile_cases_cover_the_hazards():
    """The tiles hold what they are for: all-pad rows, the hand-made rows
    where they fit, shuffled row kinds, R around a 128-row block; the
    slice really is off a 16-byte boundary."""
    rows = [r for _, r in TILE_SHAPES]
    assert 1 in rows and any(r % 2 for r in rows)
    assert any(r > 128 and r % 128 for r in rows) and 0 not in rows
    widths = [d for d, _ in TILE_SHAPES]
    assert {1, 4, 7, 8, 32, 33, 128} <= set(widths)
    for k in (4, 8, 32):
        labels, weights = tile_case(k, 128, 131, seed=128 + k)
        pad = (labels == -1).all(axis=1) & (weights == 0).all(axis=1)
        assert 1 <= pad.sum() < 131
        firsts = [tuple(r[:k + 1]) for r in labels.tolist()]
        assert tuple(range(k)) + (k,) in firsts  # freed_then_claimed
    assert (UNALIGNED_OFFSET * 4) % 16 != 0
    assert embed_at(np.zeros((2, 3), np.int32))[0] == JUNK_LABEL


def _rounds(case):
    j = {f: jnp.asarray(case[f]) for f in ("row_start", "row_count",
                                           "step_dmax")}
    t = {f: torch.from_numpy(case[f]) for f in j}
    return (jcsr.FusedRound(**j, n_entries_in=case["n_entries_in"]),
            tcsr.FusedRound(**t, n_entries_in=case["n_entries_in"]))


@pytest.mark.parametrize("k", [4, 8, 32])
def test_rescan_cases_match_reference(k):
    case = rescan_case(k, seed=200 + k)
    jr, tr = _rounds(case)
    el, ew, cand = case["labels"], case["weights"], case["cand"]
    ref = jfused.rescan_round_fused(jr, jnp.asarray(el), jnp.asarray(ew),
                                    jnp.asarray(cand), k=k, chunk=CHUNK,
                                    interpret=True)
    args = (tr, torch.from_numpy(el), torch.from_numpy(ew),
            torch.from_numpy(cand))
    launches.reset_launch_counts()
    assert_same_bits(ref, tfused.rescan_round_fused(*args, k=k, chunk=CHUNK),
                     "rescan partials")
    assert_same_bits(ref, tfused.rescan_round_plain(*args, chunk=CHUNK),
                     "rescan partials (plain)")
    assert not any(launches.LAUNCH_COUNTS.values())


@pytest.mark.parametrize("k", [4, 8, 32])
def test_rescan_cases_cover_the_hazards(k):
    """Counts around k and the chunk; shuffled rows; duplicate, -1 and
    all -1 candidates; +0.0 and -0.0 on a candidate label mid-row; every
    gap entry carries a candidate of a neighbouring row, so an over-read
    would change a partial."""
    case = rescan_case(k, seed=200 + k)
    counts = case["row_count"].reshape(-1)
    starts = case["row_start"].reshape(-1)
    cand = case["cand"]
    assert {0, 1, k - 1, k, k + 1, CHUNK - 1, CHUNK} <= set(counts.tolist())
    real = np.flatnonzero(counts > 0)
    assert np.any(np.diff(counts[real]) < 0)  # not in ascending order
    assert any(len(set(c)) < k for c in cand.tolist())
    assert (cand == -1).any(axis=1).sum() > (cand == -1).all(axis=1).sum()
    labels, weights = case["labels"], case["weights"]
    signs = [np.signbit(weights[s:s + n][weights[s:s + n] == 0])
             for s, n in zip(starts, counts)]
    assert any(s.any() for s in signs) and any((~s).any() for s in signs)
    n = case["n_rows"]  # the rows in layout order; pads follow
    assert (np.diff(starts[:n]) > 0).all()
    for a in range(n - 1):
        gap = labels[starts[a] + counts[a]:starts[a + 1]]
        near = (set(cand[a].tolist()) | set(cand[a + 1].tolist())) - {-1}
        assert set(gap.tolist()) <= near or not near


def _stream_rounds(case):
    """The aligned streamed round of a case in both packages."""
    j = {f: jnp.asarray(case[f]) for f in ("entry_gather", "row_start",
                                           "row_count", "step_dmax")}
    t = {f: torch.from_numpy(case[f]) for f in j}
    meta = dict(n_entries_in=case["n_entries_in"],
                window_entries=case["window_entries"], aligned=True)
    return jcsr.StreamedRound(**j, **meta), tcsr.StreamedRound(**t, **meta)


@pytest.mark.parametrize("k", [4, 8])
def test_stream_rescan_cases_match_reference(k):
    case = stream_rescan_case(k, seed=300 + k)
    jr, tr = _stream_rounds(case)
    el, ew, cand = case["labels"], case["weights"], case["cand"]
    ref = jstream.rescan_round_stream(jr, jnp.asarray(el), jnp.asarray(ew),
                                      jnp.asarray(cand), k=k, chunk=CHUNK,
                                      interpret=True)
    args = (tr, torch.from_numpy(el), torch.from_numpy(ew),
            torch.from_numpy(cand))
    launches.reset_launch_counts()
    assert_same_bits(ref, tstream.rescan_round_stream(*args, k=k,
                                                      chunk=CHUNK),
                     "streamed rescan partials")
    assert_same_bits(ref, tstream.rescan_round_stream_plain(*args,
                                                            chunk=CHUNK),
                     "streamed rescan partials (plain)")
    assert not any(launches.LAUNCH_COUNTS.values())


@pytest.mark.parametrize("k", [4, 8, 32])
def test_stream_rescan_cases_cover_the_hazards(k):
    """Windows whose row slots differ in count, one with no row, pad
    slots with candidates -1; the rescan case's rows and candidates;
    every row slice-safe (start + chunk <= W) and every gap entry a
    candidate of a neighbouring row of its window."""
    fill = (100, 3, 0, 77, 1)
    case = stream_rescan_case(k, seed=300 + k, tile_r=100, fill=fill,
                              n_random=174)
    counts, starts = case["row_count"], case["row_start"]
    w = case["window_entries"]
    assert {0, 1, k - 1, k, k + 1, CHUNK - 1, CHUNK} <= set(
        counts.reshape(-1).tolist())
    assert (starts + CHUNK <= w).all()
    cand = case["cand"].reshape(counts.shape + (k,))
    for win, n in enumerate(fill):
        assert (counts[win, n:] == 0).all() and (cand[win, n:] == -1).all()
    assert any(len(set(c)) < k for c in case["cand"].tolist())
    labels = case["labels"].reshape(-1, w)
    for win, n in enumerate(fill):
        for a in range(n - 1):
            gap = labels[win, starts[win, a] + counts[win, a]:
                         starts[win, a + 1]]
            near = (set(cand[win, a].tolist())
                    | set(cand[win, a + 1].tolist())) - {-1}
            assert set(gap.tolist()) <= near or not near
