"""The port's plain versions of K3 (the fused BM fold, through
``kernels.mg_sketch.fused.bm_fold_round_fused``) and K10 (the per-bucket
BM tile fold, through ``kernels.mg_sketch.ops.bm_fold_tile_pallas``)
against the JAX package on the CPU, on the Boyer-Moore cases of
``tests/_fold_cases.py``: ties ``wk == w``, runs of the carry's label, a
decrement to just above the next entry's weight, no-op entries (weight
0.0, -0.0, < 0, label -1) mid-row, incumbents -1 and equal to the row's
first label, counts around the stage's chunk widths, shuffled rows with
junk in the gaps, all-pad tile rows, R around a block and a tile that is
an unaligned slice. Bit for bit (float32 outputs compared as int32 bits,
so -0.0 is not +0.0). The references are the JAX Pallas kernels in
interpret mode, one call per shape. The same cases run through the CUDA
kernels in ``tests/test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import csr as jcsr
from repro.kernels.mg_sketch import fused as jfused
from repro.kernels.mg_sketch import ops as jops
from repro_torch.graphs import csr as tcsr
from repro_torch.kernels import launches
from repro_torch.kernels.mg_sketch import fused as tfused
from repro_torch.kernels.mg_sketch import ops as tops
from _fold_cases import (BM_CHUNKS, CHUNK, JUNK_LABEL, TILE_SHAPES,
                         UNALIGNED_OFFSET, bm_case, bm_just_above, bm_noops,
                         bm_runs, bm_tile_case, bm_ties, embed_at)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from _torch_parity import to_np


def assert_same_bits(ref, got, what):
    ref_np, got_np = to_np(ref), to_np(got)
    assert ref_np.dtype == got_np.dtype and ref_np.shape == got_np.shape
    np.testing.assert_array_equal(got_np.view(np.int32),
                                  ref_np.view(np.int32), err_msg=what)


def _rounds(case):
    j = {f: jnp.asarray(case[f]) for f in ("row_start", "row_count",
                                           "step_dmax")}
    t = {f: torch.from_numpy(case[f]) for f in j}
    return (jcsr.FusedRound(**j, n_entries_in=case["n_entries_in"]),
            tcsr.FusedRound(**t, n_entries_in=case["n_entries_in"]))


@pytest.mark.parametrize("seed", [1, 2])
def test_bm_round_cases_match_reference(seed):
    case = bm_case(seed)
    jr, tr = _rounds(case)
    el, ew, init = case["labels"], case["weights"], case["init"]
    ref = jfused.bm_fold_round_fused(jr, jnp.asarray(el), jnp.asarray(ew),
                                     jnp.asarray(init), chunk=CHUNK,
                                     interpret=True)
    args = (tr, torch.from_numpy(el), torch.from_numpy(ew),
            torch.from_numpy(init))
    launches.reset_launch_counts()
    for got in (tfused.bm_fold_round_fused(*args, chunk=CHUNK),
                tfused.bm_fold_round_plain(*args, chunk=CHUNK)):
        assert_same_bits(ref[0], got[0], "BM candidates")
        assert_same_bits(ref[1], got[1], "BM weights")
    assert not any(launches.LAUNCH_COUNTS.values())  # CPU: plain versions


@pytest.mark.parametrize("width,n_rows", TILE_SHAPES)
def test_bm_tile_cases_match_reference(width, n_rows):
    labels, weights, init = bm_tile_case(width, n_rows, seed=300 + width)
    ref = jops.bm_fold_tile_pallas(jnp.asarray(labels), jnp.asarray(weights),
                                   jnp.asarray(init), interpret=True)
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
        got = tops.bm_fold_tile_pallas(tl, tw, torch.from_numpy(init))
        assert_same_bits(ref[0], got[0], "BM candidates")
        assert_same_bits(ref[1], got[1], "BM weights")
    assert not any(launches.LAUNCH_COUNTS.values())


def _contains(row, part):
    n = len(part)
    return any(row[i:i + n] == part for i in range(len(row) - n + 1))


def _rows_of(case):
    """The real rows of a fused BM case as (label, weight) lists, in
    layout order, with their incumbents."""
    n = case["n_rows"]
    starts = case["row_start"].reshape(-1)[:n]
    counts = case["row_count"].reshape(-1)[:n]
    rows = [list(zip(case["labels"][s:s + c].tolist(),
                     case["weights"][s:s + c].tolist()))
            for s, c in zip(starts, counts)]
    return rows, case["init"][:n]


def test_bm_round_cases_cover_the_hazards():
    """Counts around every chunk width of the stages, 127 and 128;
    shuffled rows at every start mod 8 with valid junk in the gaps; the
    hand-made rows; -0.0 mid-row; incumbents -1 and equal to the row's
    first label; pad rows of init -1."""
    case = bm_case(1)
    n = case["n_rows"]
    counts = case["row_count"].reshape(-1)
    starts = case["row_start"].reshape(-1)
    want = {0, 1, CHUNK - 1, CHUNK}
    for c in BM_CHUNKS:
        want |= {c - 1, c, c + 1}
    assert want <= set(counts[:n].tolist())
    assert np.any(np.diff(counts[:n]) < 0)  # not in ascending order
    assert set((starts[:n] % 8).tolist()) == set(range(8))
    assert (case["init"][n:] == -1).all() and (counts[n:] == 0).all()
    rows, init = _rows_of(case)
    for hand in (bm_ties, bm_runs, bm_just_above, bm_noops):
        assert any(_contains(r, hand()) for r in rows), hand.__name__
    weights = case["weights"]
    signs = [np.signbit(weights[s:s + c][weights[s:s + c] == 0])
             for s, c in zip(starts[:n], counts[:n])]
    assert any(s.any() for s in signs)
    assert any(c == -1 and w > 0 for r in rows for c, w in r)
    assert (init == -1).any()
    assert any(r and r[0][0] >= 0 and i == r[0][0] for r, i in zip(rows, init))
    # every entry outside the rows would take or beat a carry if read
    inside = np.zeros(case["n_entries_in"], bool)
    for s, c in zip(starts[:n], counts[:n]):
        inside[s:s + c] = True
    assert (case["labels"][~inside] >= JUNK_LABEL).all()
    assert (case["weights"][~inside] > 0).all()


def test_bm_tile_cases_cover_the_hazards():
    """All-pad rows, the hand-made rows where they fit, R around a block,
    incumbents of both kinds; the slice really is off a 16-byte
    boundary."""
    rows = [r for _, r in TILE_SHAPES]
    assert 1 in rows and any(r % 2 for r in rows)
    assert any(r > 128 and r % 128 for r in rows)
    labels, weights, init = bm_tile_case(128, 131, seed=428)
    pad = (labels == -1).all(axis=1) & (weights == 0).all(axis=1)
    assert 1 <= pad.sum() < 131
    tile_rows = [list(zip(lab.tolist(), wgt.tolist()))
                 for lab, wgt in zip(labels, weights)]
    for hand in (bm_ties, bm_runs, bm_just_above, bm_noops):
        assert any(r[:len(hand())] == hand() for r in tile_rows)
    assert (init == -1).any()
    assert any(i >= 0 and i == lab[0] for lab, i in zip(labels, init))
    assert (UNALIGNED_OFFSET * 4) % 16 != 0
