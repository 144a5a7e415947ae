"""The streamed rounds of repro_torch against the JAX package's, bit for
bit on the CPU: the windowed re-layout (``windowed_entries``, and the
aligned layout's one gather), and K5–K8's plain versions, through their
round wrappers, against the JAX round wrappers with the Pallas streaming
kernels in interpret mode, at k = 4, 8 and 32, on aligned and unaligned
plans.

The CUDA kernels themselves are held against the same plain versions in
tests/test_torch_cuda_kernels.py.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import csr as jcsr
from repro.kernels.mg_sketch import streaming as jstream
from repro_torch.graphs import csr as tcsr
from repro_torch.kernels.mg_sketch import streaming as tstream
from test_stream_engine import FIXTURES
from _torch_parity import CPU, assert_same_array
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

#: (k, chunk, tile_r, window): chunk > k; small windows so the powerlaw
#: and star fixtures run several rounds and many windows
SHAPES = {4: (16, 8, 64), 8: (32, 16, 256), 32: (128, 32, 512)}


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _plans(g, k, aligned):
    chunk, tile_r, window = SHAPES[k]
    kw = dict(k=k, chunk=chunk, tile_r=tile_r, window_entries=window,
              indices=np.asarray(g.indices), weights=np.asarray(g.weights),
              aligned=aligned)
    return (jcsr.build_streamed_fold_plan(np.asarray(g.degrees), **kw),
            tcsr.build_streamed_fold_plan(np.asarray(g.degrees), device=CPU,
                                          **kw))


def _source(rnd, rng, alphabet, shift=0.0):
    """Source entry arrays of the round's length; labels from a small
    alphabet (-1 included), weights on a 0.375 grid (0 included)."""
    n_in = rnd.n_entries_in
    labels = rng.integers(-1, alphabet, n_in).astype(np.int32)
    weights = (rng.integers(0, 8, n_in) * 0.375 - shift).astype(np.float32)
    return labels, weights


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k", sorted(SHAPES))
def test_windowed_entries_matches_reference(name, k):
    """Every round's re-layout, and the aligned layout's one gather
    ``labels_ext[aligned_entry_vertex]``, which must equal round 0's
    re-layout of ``labels[indices]``."""
    g = FIXTURES[name]()
    jplan, tplan = _plans(g, k, aligned=False)
    rng = np.random.default_rng(zlib.crc32(name.encode()) + k)
    for jr, tr in zip(jplan.rounds, tplan.rounds):
        el, ew = _source(tr, rng, 3 * k)
        ref = jstream.windowed_entries(jr.entry_gather, jnp.asarray(el),
                                       jnp.asarray(ew))
        got = tstream.windowed_entries(tr.entry_gather, _t(el), _t(ew))
        assert_same_array(ref[0], got[0], "windowed labels")
        assert_same_array(ref[1], got[1], "windowed weights")
    _, aplan = _plans(g, k, aligned=True)
    labels = rng.integers(0, max(g.n_nodes, 2), g.n_nodes).astype(np.int32)
    wl, ww = tstream.windowed_entries(tplan.rounds[0].entry_gather,
                                      _t(labels)[_t(g.indices).long()],
                                      _t(g.weights))
    labels_ext = torch.cat([_t(labels), torch.full((1,), -1,
                                                   dtype=torch.int32)])
    assert torch.equal(labels_ext[aplan.aligned_entry_vertex.long()], wl)
    assert torch.equal(aplan.aligned_entry_weights, ww)
    rnd0 = aplan.rounds[0]
    got = tstream.round_window_entries(rnd0, wl, ww)
    assert got[0] is wl and got[1] is ww  # aligned: no re-layout


#: every k unaligned; the aligned round 0 at the paper's k = 8
_ROUND_CASES = [(k, False) for k in sorted(SHAPES)] + [(8, True)]


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,aligned", _ROUND_CASES)
def test_stream_rounds_match_reference(name, k, aligned):
    """K5 on every round, K6 on the last, K7 and K8 on round 0: the
    port's round wrappers (which run the plain versions on CPU tensors)
    and the plain versions called directly, against the JAX round
    wrappers. The aligned layout changes round 0 only (later rounds are
    the unaligned plan's, field for field: test_torch_stream_plan.py), so
    the aligned case runs round 0."""
    g = FIXTURES[name]()
    jplan, tplan = _plans(g, k, aligned)
    chunk = tplan.chunk
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 7 * k + aligned)
    tstream.reset_launch_counts()
    n_rounds = 1 if aligned else tplan.n_rounds
    for r, (jr, tr) in enumerate(zip(jplan.rounds[:n_rounds],
                                     tplan.rounds[:n_rounds])):
        el, ew = _source(tr, rng, 3 * k)
        jel, jew, tel, tew = jnp.asarray(el), jnp.asarray(ew), _t(el), _t(ew)
        ref = jstream.stream_fold_round(jr, jel, jew, k=k, chunk=chunk,
                                        interpret=True)
        for got in (tstream.stream_fold_round(tr, tel, tew, k=k, chunk=chunk),
                    tstream.stream_fold_round_plain(tr, tel, tew, k=k,
                                                    chunk=chunk)):
            assert_same_array(ref[0], got[0], f"round {r} sketch labels")
            assert_same_array(ref[1], got[1], f"round {r} sketch weights")
        rows = tr.row_start.numel()
        if r == tplan.n_rounds - 1:
            inc = np.where(np.asarray(jr.row_vertex) >= 0,
                           rng.integers(0, 3 * k, rows), -1).astype(np.int32)
            ref = jstream.stream_select_round(
                jr, jel, jew, jnp.asarray(inc), jnp.int32(11), k=k,
                chunk=chunk, interpret=True)
            got = tstream.stream_select_round(tr, tel, tew, _t(inc), 11, k=k,
                                              chunk=chunk)
            assert_same_array(ref, got, f"round {r} choices")
        if r == 0:
            el6 = el % 6  # few labels: every BM branch and ties run
            init = np.where(np.asarray(jr.row_vertex) >= 0,
                            rng.integers(0, 6, rows), -1).astype(np.int32)
            ref = jstream.bm_fold_round_stream(
                jr, jnp.asarray(el6), jew, jnp.asarray(init), chunk=chunk,
                interpret=True)
            got = tstream.bm_fold_round_stream(tr, _t(el6), tew, _t(init),
                                               chunk=chunk)
            assert_same_array(ref[0], got[0], "BM candidates")
            assert_same_array(ref[1], got[1], "BM weights")
            ew4 = ew - np.float32(0.75)  # K8 counts weights <= 0 too
            cand = rng.integers(-1, 3 * k, (rows, k)).astype(np.int32)
            ref = jstream.rescan_round_stream(
                jr, jel, jnp.asarray(ew4), jnp.asarray(cand), k=k,
                chunk=chunk, interpret=True)
            got = tstream.rescan_round_stream(tr, tel, _t(ew4), _t(cand),
                                              k=k, chunk=chunk)
            assert_same_array(ref, got, "rescan partials")
    # the CPU path runs the plain versions: no kernel launch is counted
    assert not any(tstream.LAUNCH_COUNTS.values())


def test_stream_wrappers_check_their_inputs():
    g = FIXTURES["star_hub"]()
    _, tplan = _plans(g, 8, aligned=False)
    rnd = tplan.rounds[0]
    rows = rnd.row_start.numel()
    el = torch.zeros(rnd.n_entries_in, dtype=torch.int32)
    ew = torch.ones(rnd.n_entries_in, dtype=torch.float32)
    with pytest.raises(ValueError):  # the source length, not the slots
        tstream.stream_fold_round(rnd, el[1:], ew[1:], k=8, chunk=32)
    with pytest.raises(TypeError):
        tstream.stream_fold_round(rnd, el, ew.double(), k=8, chunk=32)
    with pytest.raises(ValueError):
        tstream.stream_select_round(rnd, el, ew,
                                    torch.zeros(rows + 1, dtype=torch.int32),
                                    1, k=8, chunk=32)
    with pytest.raises(ValueError):
        tstream.bm_fold_round_stream(rnd, el, ew,
                                     torch.zeros(rows - 1, dtype=torch.int32),
                                     chunk=32)
    with pytest.raises(ValueError):
        tstream.rescan_round_stream(rnd, el, ew,
                                    torch.zeros((rows, 4), dtype=torch.int32),
                                    k=8, chunk=32)
    with pytest.raises(ValueError):
        tstream.stream_select_round(rnd, el, ew,
                                    torch.zeros(rows, dtype=torch.int32),
                                    2**31, k=8, chunk=32)
    # an aligned round reads exactly its window slots
    _, aplan = _plans(g, 8, aligned=True)
    arnd = aplan.rounds[0]
    assert arnd.n_entries_in == arnd.n_windows * arnd.window_entries
    with pytest.raises(ValueError):
        tstream.stream_fold_round(arnd, el, ew, k=8, chunk=32)
