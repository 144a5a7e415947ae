"""The port's plain MG folds of K1 (``fused_fold_round_plain``) and K5
(``stream_fold_round_plain``) against the JAX package on the rows that
stress the group-per-row fold of the CUDA kernels (``tests/_fold_cases.py``:
counts around k and the chunk, every start offset mod 8, shuffled rows,
slots freed and reclaimed mid-row, no-op entries, equal weights, ragged
row and window counts), at k = 4, 8 and 32, bit for bit. The reference is
``repro.core.sketch.mg_fold_tile`` on the gathered tile and the Pallas
kernels in interpret mode (one call per k and engine). The same cases run
through the CUDA kernels in ``tests/test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketch import mg_fold_tile as j_mg_fold_tile
from repro.graphs import csr as jcsr
from repro.kernels.mg_sketch import fused as jfused
from repro.kernels.mg_sketch import streaming as jstream
from repro_torch.core.sketch import mg_fold_tile as t_mg_fold_tile
from repro_torch.graphs import csr as tcsr
from repro_torch.kernels.mg_sketch import fused as tfused
from repro_torch.kernels.mg_sketch import streaming as tstream
from _fold_cases import (CHUNK, freed_then_claimed, middle_slot_freed,
                         fused_case, gather_tile, stream_case, stream_tile)
from _torch_parity import assert_same_array
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

KS = (4, 8, 32)


def _rounds(case, kind):
    """The case as (JAX round, port round) of a fused or streamed plan."""
    j = {f: jnp.asarray(case[f]) for f in ("row_start", "row_count",
                                           "step_dmax")}
    t = {f: torch.from_numpy(case[f]) for f in j}
    if kind == "fused":
        return (jcsr.FusedRound(**j, n_entries_in=case["n_entries_in"]),
                tcsr.FusedRound(**t, n_entries_in=case["n_entries_in"]))
    extra = dict(n_entries_in=case["n_entries_in"],
                 window_entries=case["window_entries"], aligned=True)
    return (jcsr.StreamedRound(entry_gather=jnp.asarray(case["entry_gather"]),
                               **j, **extra),
            tcsr.StreamedRound(
                entry_gather=torch.from_numpy(case["entry_gather"]), **t,
                **extra))


@pytest.mark.parametrize("k", KS)
def test_fused_group_cases_match_reference(k):
    case = fused_case(k, seed=k)
    jr, tr = _rounds(case, "fused")
    el, ew = case["labels"], case["weights"]
    tile = gather_tile(case["row_start"], case["row_count"], el, ew)
    ref = j_mg_fold_tile(jnp.asarray(tile[0]), jnp.asarray(tile[1]), k)
    kernel_ref = jfused.fused_fold_round(jr, jnp.asarray(el), jnp.asarray(ew),
                                         k=k, chunk=CHUNK, interpret=True)
    tel, tew = torch.from_numpy(el), torch.from_numpy(ew)
    for got in (tfused.fused_fold_round(tr, tel, tew, k=k, chunk=CHUNK),
                tfused.fused_fold_round_plain(tr, tel, tew, k=k,
                                              chunk=CHUNK)):
        for want in (ref, kernel_ref):
            assert_same_array(want[0], got[0], "sketch labels")
            assert_same_array(want[1], got[1], "sketch weights")


@pytest.mark.parametrize("k", KS)
def test_stream_group_cases_match_reference(k):
    case = stream_case(k, seed=100 + k)
    jr, tr = _rounds(case, "stream")
    el, ew = case["labels"], case["weights"]
    tile = stream_tile(case)
    ref = j_mg_fold_tile(jnp.asarray(tile[0]), jnp.asarray(tile[1]), k)
    kernel_ref = jstream.stream_fold_round(jr, jnp.asarray(el),
                                           jnp.asarray(ew), k=k, chunk=CHUNK,
                                           interpret=True)
    tel, tew = torch.from_numpy(el), torch.from_numpy(ew)
    for got in (tstream.stream_fold_round(tr, tel, tew, k=k, chunk=CHUNK),
                tstream.stream_fold_round_plain(tr, tel, tew, k=k,
                                                chunk=CHUNK)):
        for want in (ref, kernel_ref):
            assert_same_array(want[0], got[0], "sketch labels")
            assert_same_array(want[1], got[1], "sketch weights")
    assert not any(tstream.LAUNCH_COUNTS.values())  # CPU: plain versions


def _fold_prefix(row, n, k):
    """The port's fold of the first n entries of a hand-made row."""
    c, w = zip(*row[:n])
    lab = torch.tensor([c], dtype=torch.int32)
    wgt = torch.tensor([w], dtype=torch.float32)
    s_k, s_v = t_mg_fold_tile(lab, wgt, k)
    return s_k[0].tolist(), s_v[0].tolist()


@pytest.mark.parametrize("k", KS)
def test_group_cases_cover_the_hazards(k):
    """The cases hold what they are for: the hand-made rows free a slot
    and reclaim it while later slots stay occupied; starts take every
    offset mod 8; a warp's groups differ in count; the row and window
    counts are ragged."""
    row = freed_then_claimed(k)
    _, v = _fold_prefix(row, k + 1, k)
    assert v[0] == 0.0 and all(x > 0 for x in v[1:])
    lab, v = _fold_prefix(row, k + 5, k)
    assert lab[0] == k + 3 and all(x > 0 for x in v)
    mid = k // 2
    row = middle_slot_freed(k)
    _, v = _fold_prefix(row, k + 1, k)
    assert [j for j, x in enumerate(v) if x == 0.0] == [mid, k - 1]
    lab, _ = _fold_prefix(row, k + 2, k)
    assert lab[mid] == k + 1

    case = fused_case(k, seed=k)
    counts = case["row_count"].reshape(-1)
    starts = case["row_start"].reshape(-1)[counts > 0]
    assert {0, 1, k - 1, k, k + 1, CHUNK - 1, CHUNK} <= set(counts.tolist())
    assert set((starts % 8).tolist()) == set(range(8))
    per_warp = 32 // k
    spread = [np.ptp(counts[i:i + per_warp])
              for i in range(0, counts.size, per_warp)]
    assert max(spread) >= CHUNK // 2 or per_warp == 1
    assert counts.size % (128 // k) != 0  # a ragged last block
    scase = stream_case(k, seed=100 + k)
    scounts = scase["row_count"]
    assert {0, 1, k - 1, k, k + 1, CHUNK - 1, CHUNK} <= set(
        scounts.reshape(-1).tolist())
    real = (scounts > 0).sum(axis=1)
    assert len(set(real.tolist())) > 1 and 0 in real
