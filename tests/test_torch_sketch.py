"""repro_torch.core.sketch against repro.core.sketch, bit for bit: the
label hash, the MG tile fold, the multi-round plan walk and the move
selection, on inputs made with numpy from a seed."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from _propcheck import given, settings, st

from repro.core import sketch as jsk
from repro.graphs.csr import build_fold_plan as j_build_fold_plan
from repro_torch.core import sketch as tsk
from repro_torch.graphs.csr import build_fold_plan as t_build_fold_plan
from _torch_parity import (CPU, FIXTURES, assert_same_array, carry_graph,
                           random_entries)

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1

# the reference under jit, as its lpa() runs it (and far faster to compile
# than op by op)
_j_mg_fold_tile = jax.jit(jsk.mg_fold_tile, static_argnums=2)
_j_run_mg_plan = jax.jit(jsk.run_mg_plan)
_j_select_best = jax.jit(jsk.select_best)


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 11, -3, INT32_MAX, INT32_MIN])
def test_hash_mix_matches_uint32_reference(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    x = np.concatenate([
        np.asarray([-1, 0, 1, INT32_MAX, INT32_MIN, 2654435761 - 2**32],
                   np.int32),
        rng.integers(INT32_MIN, INT32_MAX, 4000, dtype=np.int64
                     ).astype(np.int32)])
    ref = np.asarray(jsk.hash_mix(jnp.asarray(x), jnp.int32(seed)))
    got = tsk.hash_mix(torch.from_numpy(x), seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def _tile(rng, rows, width, alphabet):
    """A tile with a small label alphabet (matches, claims and evictions
    all happen), pad entries (-1 / 0.0) and quantised weights (ties)."""
    labels = rng.integers(-1, alphabet, (rows, width)).astype(np.int32)
    weights = (rng.integers(0, 8, (rows, width)) * 0.375).astype(np.float32)
    return labels, weights


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("width", [1, 7, 64])
def test_mg_fold_tile_matches_reference(k, width):
    rng = np.random.default_rng(100 * k + width)
    labels, weights = _tile(rng, 96, width, alphabet=3 * k)
    ref_k, ref_v = _j_mg_fold_tile(jnp.asarray(labels), jnp.asarray(weights), k)
    got_k, got_v = tsk.mg_fold_tile(torch.from_numpy(labels),
                                    torch.from_numpy(weights), k)
    assert_same_array(ref_k, got_k, "labels")
    assert_same_array(ref_v, got_v, "weights")


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**20), k=st.sampled_from([2, 4, 8]),
       width=st.integers(1, 40), alphabet=st.integers(1, 24))
def test_mg_fold_tile_property(seed, k, width, alphabet):
    rng = np.random.default_rng(seed)
    labels, weights = _tile(rng, 16, width, alphabet)
    ref_k, ref_v = _j_mg_fold_tile(jnp.asarray(labels), jnp.asarray(weights), k)
    got_k, got_v = tsk.mg_fold_tile(torch.from_numpy(labels),
                                    torch.from_numpy(weights), k)
    assert_same_array(ref_k, got_k, "labels")
    assert_same_array(ref_v, got_v, "weights")


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,chunk", [(8, 128), (4, 16)])
def test_run_mg_plan_matches_reference(name, k, chunk):
    g = FIXTURES[name]()
    rng = np.random.default_rng(7)
    el, ew = random_entries(g.n_nodes, g.n_edges, rng)
    degrees = np.asarray(g.degrees)
    jplan = j_build_fold_plan(degrees, k=k, chunk=chunk)
    tplan = t_build_fold_plan(degrees, k=k, chunk=chunk, device=CPU)
    ref_k, ref_v = _j_run_mg_plan(jplan, jnp.asarray(el), jnp.asarray(ew))
    got_k, got_v = tsk.run_mg_plan(tplan, torch.from_numpy(el),
                                   torch.from_numpy(ew))
    assert_same_array(ref_k, got_k, "final sketch labels")
    assert_same_array(ref_v, got_v, "final sketch weights")
    ref_c, ref_w = jsk.scatter_rows(jplan, ref_k, ref_v)
    got_c, got_w = tsk.scatter_rows(tplan, got_k, got_v)
    assert_same_array(ref_c, got_c, "candidates")
    assert_same_array(ref_w, got_w, "candidate weights")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_select_best_matches_reference(name):
    g = FIXTURES[name]()
    gt = carry_graph(g)
    rng = np.random.default_rng(3)
    # neighbour labels from a coarse labelling: many ties in the sketches
    cur = rng.integers(0, max(g.n_nodes // 8, 2), g.n_nodes).astype(np.int32)
    el = cur[np.asarray(g.indices)]
    ew = np.asarray(g.weights)
    degrees = np.asarray(g.degrees)
    jplan = j_build_fold_plan(degrees, k=8, chunk=128)
    tplan = t_build_fold_plan(gt.degrees.numpy(), k=8, chunk=128, device=CPU)
    s_k, s_v = _j_run_mg_plan(jplan, jnp.asarray(el), jnp.asarray(ew))
    t_k, t_v = tsk.run_mg_plan(tplan, torch.from_numpy(el),
                               torch.from_numpy(ew))
    for seed in (1, 2, 5, 11):
        ref = _j_select_best(jplan, s_k, s_v, jnp.asarray(cur),
                             jnp.int32(seed))
        got = tsk.select_best(tplan, t_k, t_v, torch.from_numpy(cur), seed)
        assert_same_array(ref, got, f"want (seed {seed})")


@pytest.mark.parametrize("seed", [1, 2, 5, 11])
def test_choose_from_candidates_ties(seed):
    """Exact weight ties everywhere: the hash and then the label decide."""
    rng = np.random.default_rng(seed)
    cand_c = rng.integers(-1, 12, (256, 6)).astype(np.int32)
    cand_w = (rng.integers(0, 3, (256, 6)) * 0.5).astype(np.float32)
    labels = rng.integers(-1, 12, 256).astype(np.int32)
    ref = jsk.choose_from_candidates(jnp.asarray(cand_c), jnp.asarray(cand_w),
                                     jnp.asarray(labels), jnp.int32(seed))
    got = tsk.choose_from_candidates(torch.from_numpy(cand_c),
                                     torch.from_numpy(cand_w),
                                     torch.from_numpy(labels), seed)
    assert_same_array(ref, got, "choice")
