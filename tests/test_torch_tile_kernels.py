"""The per-bucket tile folds of repro_torch against repro's, on the CPU:
K9/K10's plain versions (through the port's ``ops`` wrappers, which take
them for a tensor on the CPU) against the JAX package's Pallas kernels in
interpret mode; the exact weighted MG variant against the JAX one,
argmin ties included; the wrappers' input checks; and the bucketed
plan's launch-count helpers. Every comparison is exact: the folds are
fixed sequences of float32 adds, subtracts and maxes per row."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import sketch as jsk
from repro.graphs import csr as jcsr
from repro.kernels.mg_sketch import ops as jops
from repro_torch.core import sketch as tsk
from repro_torch.core.fold_engine import get_engine
from repro_torch.graphs import csr as tcsr
from repro_torch.kernels import launches
from repro_torch.kernels.mg_sketch import mg_sketch as tmg
from repro_torch.kernels.mg_sketch import ops as tops
from repro_torch.kernels.mg_sketch import ref as tref
from test_fused_engine import FIXTURES
from _torch_parity import assert_same_array
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _tile(rng, r, d, n_labels=32, pad_frac=0.2, pad_rows=()):
    """A padded [r, d] tile made with numpy, as tests/test_kernels.py
    makes its own; ``pad_rows`` are all pad (-1, 0.0)."""
    labels = rng.integers(0, n_labels, (r, d)).astype(np.int32)
    weights = (rng.random((r, d)) * 4 + 0.1).astype(np.float32)
    pad = rng.random((r, d)) < pad_frac
    pad[list(pad_rows)] = True
    labels[pad] = -1
    weights[pad] = 0.0
    return labels, weights


def _both(labels, weights):
    return ((jnp.asarray(labels), jnp.asarray(weights)),
            (torch.from_numpy(labels), torch.from_numpy(weights)))


#: a few shapes of tests/test_kernels.py's sweep: R = 1, R not a multiple
#: of 8, all-pad rows, k = 1
@pytest.mark.parametrize("r,d,k,pad_rows", [
    (1, 4, 8, ()), (7, 32, 4, (0, 6)), (13, 16, 1, (3,)),
    (64, 128, 8, (10, 11, 63))])
def test_mg_tile_fold_matches_pallas(r, d, k, pad_rows):
    rng = np.random.default_rng(r * 1000 + d * 10 + k)
    (jl, jw), (tl, tw) = _both(*_tile(rng, r, d, pad_rows=pad_rows))
    ref_k, ref_v = jops.mg_fold_tile_pallas(jl, jw, k)
    got_k, got_v = tops.mg_fold_tile_pallas(tl, tw, k)
    assert_same_array(ref_k, got_k, "s_k")
    assert_same_array(ref_v, got_v, "s_v")
    for row in pad_rows:  # an all-pad row folds to the empty sketch
        assert (got_k[row] == -1).all() and (got_v[row] == 0).all()


@pytest.mark.parametrize("r,d,pad_rows,with_init", [
    (1, 4, (), True), (33, 16, (5, 32), True), (9, 8, (0,), False)])
def test_bm_tile_fold_matches_pallas(r, d, pad_rows, with_init):
    rng = np.random.default_rng(r * 7 + d)
    labels, weights = _tile(rng, r, d, n_labels=8, pad_rows=pad_rows)
    (jl, jw), (tl, tw) = _both(labels, weights)
    init = rng.integers(0, 8, (r,)).astype(np.int32)
    if with_init:
        ref = jops.bm_fold_tile_pallas(jl, jw, jnp.asarray(init))
        got = tops.bm_fold_tile_pallas(tl, tw, torch.from_numpy(init))
    else:  # None: -1 for every row
        ref = jops.bm_fold_tile_pallas(jl, jw)
        got = tops.bm_fold_tile_pallas(tl, tw)
    assert_same_array(ref[0], got[0], "ck")
    assert_same_array(ref[1], got[1], "wk")


def test_tile_fold_adversarial_patterns_match_reference():
    """tests/test_kernels.py's adversarial tiles through the port's plain
    versions against the JAX oracle (no Pallas call: the oracle is what
    the kernels are held to)."""
    rng0, rng1 = np.random.default_rng(0), np.random.default_rng(1)
    patterns = {
        "all_same": (np.zeros((4, 64), np.int32), np.ones((4, 64),
                                                          np.float32)),
        "all_distinct": (np.arange(256, dtype=np.int32).reshape(4, 64),
                         np.ones((4, 64), np.float32)),
        "heavy": (np.where(rng0.random((4, 64)) < 0.6, 0,
                           rng1.integers(1, 99, (4, 64))).astype(np.int32),
                  np.ones((4, 64), np.float32)),
    }
    for name, (labels, weights) in patterns.items():
        (jl, jw), (tl, tw) = _both(labels, weights)
        for ref, got in ((jsk.mg_fold_tile(jl, jw, 8),
                          tref.mg_fold_ref(tl, tw, 8)),
                         (jsk.bm_fold_tile(jl, jw),
                          tref.bm_fold_ref(tl, tw))):
            assert_same_array(ref[0], got[0], name)
            assert_same_array(ref[1], got[1], name)


def test_tile_wrappers_check_inputs_and_count_no_cpu_launch():
    labels, weights = (torch.from_numpy(a) for a in
                       _tile(np.random.default_rng(3), 5, 8))
    with pytest.raises(TypeError):
        tops.mg_fold_tile_pallas(labels.float(), weights, 8)
    with pytest.raises(ValueError):
        tops.mg_fold_tile_pallas(labels[:, :4], weights, 8)
    with pytest.raises(ValueError):
        tops.mg_fold_tile_pallas(labels.t(), weights.t(), 8)  # strided
    with pytest.raises(ValueError):
        tops.mg_fold_tile_pallas(labels, weights, 0)
    with pytest.raises(ValueError):
        tops.bm_fold_tile_pallas(labels, weights,
                                 torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):  # the launchers take CUDA tensors only
        tmg.mg_fold_tile_cuda(labels, weights, 8)
    launches.reset_launch_counts()
    tops.mg_fold_tile_pallas(labels, weights, 8)
    tops.bm_fold_tile_pallas(labels, weights)
    # the CPU path runs the plain versions: no kernel launch is counted;
    # one table counts every kernel of the port
    assert set(launches.LAUNCH_COUNTS) >= {"tile_mg_fold", "tile_bm_fold"}
    assert not any(launches.LAUNCH_COUNTS.values())
    # an empty tile (R = 0) folds to empty outputs
    s_k, s_v = tops.mg_fold_tile_pallas(labels[:0], weights[:0], 8)
    assert s_k.shape == (0, 8) and s_v.shape == (0, 8)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused",
                                     "pallas_stream"])
def test_kernel_engines_tile_hooks_are_the_tile_folds(backend):
    """Every kernel engine's tile-level hooks are K9/K10 (their plain
    versions on the CPU), as the reference's Pallas engines' are its
    per-bucket kernels; the jnp engine's are the plain folds."""
    rng = np.random.default_rng(8)
    labels, weights = (torch.from_numpy(a) for a in _tile(rng, 9, 16))
    init = torch.from_numpy(rng.integers(0, 32, 9).astype(np.int32))
    eng = get_engine(backend)
    for got, ref in ((eng.mg_fold_tile(labels, weights, 4),
                      tref.mg_fold_ref(labels, weights, 4)),
                     (eng.bm_fold_tile(labels, weights, init),
                      tref.bm_fold_ref(labels, weights, init))):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# ---------------------------------------------------------------------------
# the exact weighted MG variant (plain torch only, as in the reference)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,d,k,n_labels", [(17, 32, 4, 12), (5, 128, 8, 40),
                                            (9, 16, 1, 5)])
def test_exact_weighted_fold_matches_reference(r, d, k, n_labels):
    rng = np.random.default_rng(r + d + k)
    (jl, jw), (tl, tw) = _both(*_tile(rng, r, d, n_labels=n_labels))
    ref = jsk.mg_fold_tile_exact_weighted(jl, jw, k)
    got = tsk.mg_fold_tile_exact_weighted(tl, tw, k)
    assert_same_array(ref[0], got[0], "s_k")
    assert_same_array(ref[1], got[1], "s_v")


def test_exact_weighted_argmin_tie_takes_the_first_slot():
    """Slots 1 and 2 both fall to the least weight on the eviction: the
    leftover goes into the first of them, in both packages. Row 0: slots
    (a:5, b:2, c:2) then d:3 -> m = 2, slots (3, 0, 0), leftover 1 into
    slot 1. Row 1 is an exact fit: m = w = 1, no leftover, no insert."""
    labels = np.asarray([[10, 11, 12, 13], [10, 11, 12, 13]], np.int32)
    weights = np.asarray([[5, 2, 2, 3], [4, 3, 3, 1]], np.float32)
    (jl, jw), (tl, tw) = _both(labels, weights)
    ref = jsk.mg_fold_tile_exact_weighted(jl, jw, 3)
    got = tsk.mg_fold_tile_exact_weighted(tl, tw, 3)
    assert_same_array(ref[0], got[0], "s_k")
    assert_same_array(ref[1], got[1], "s_v")
    assert got[0][0].tolist() == [10, 13, 12]
    assert got[1][0].tolist() == [3.0, 1.0, 0.0]


def test_run_mg_plan_takes_an_injected_tile_fold():
    """``fold_tile=`` reaches every bucket: the plan walk with the exact
    weighted variant equals the JAX package's."""
    g = FIXTURES["powerlaw"]()
    degrees = np.asarray(g.degrees)
    rng = np.random.default_rng(4)
    el = rng.integers(0, 64, g.n_edges).astype(np.int32)
    ew = (rng.random(g.n_edges) * 3 + 0.25).astype(np.float32)
    jplan = jcsr.build_fold_plan(degrees, k=4, chunk=16)
    tplan = tcsr.build_fold_plan(degrees, k=4, chunk=16, device="cpu")
    ref = jsk.run_mg_plan(jplan, jnp.asarray(el), jnp.asarray(ew),
                          fold_tile=jsk.mg_fold_tile_exact_weighted)
    got = tsk.run_mg_plan(tplan, torch.from_numpy(el), torch.from_numpy(ew),
                          fold_tile=tsk.mg_fold_tile_exact_weighted)
    assert_same_array(ref[0], got[0], "s_k")
    assert_same_array(ref[1], got[1], "s_v")


# ---------------------------------------------------------------------------
# the bucketed plan's launch counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,chunk", [(8, 128), (4, 16)])
def test_bucketed_plan_counts_match_reference(name, k, chunk):
    degrees = np.asarray(FIXTURES[name]().degrees)
    jplan = jcsr.build_fold_plan(degrees, k=k, chunk=chunk)
    tplan = tcsr.build_fold_plan(degrees, k=k, chunk=chunk, device="cpu")
    for fn in ("plan_padded_entries", "plan_dispatches",
               "plan_round0_dispatches"):
        assert getattr(tcsr, fn)(tplan) == getattr(jcsr, fn)(jplan), fn
