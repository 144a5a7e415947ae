"""repro_torch.kernels.mg_sketch.fused against the Pallas fused engine
(interpret mode on the CPU), bit for bit: the raw padded outputs of every
round, pad rows included, and the wanted labels of a full iteration.

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against the same plain versions in tests/test_torch_cuda_kernels.py.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.fold_engine import get_engine as j_get_engine
from repro.core.fold_program import FoldRequest as JRequest
from repro.graphs.csr import build_fold_plan as j_build_fold_plan
from repro.graphs.csr import build_fused_fold_plan as j_build_fused
from repro.kernels.mg_sketch import fused as jfused
from repro_torch.core.fold_engine import get_engine as t_get_engine
from repro_torch.core.fold_program import FoldRequest as TRequest
from repro_torch.graphs.csr import build_fold_plan as t_build_fold_plan
from repro_torch.core import sketch as tsk
from repro_torch.graphs.csr import build_fused_fold_plan as t_build_fused
from repro_torch.kernels.mg_sketch import fused as tfused
from _torch_parity import CPU, FIXTURES, assert_same_array, random_entries

SEEDS = (1, 2, 5, 11)

# the reference drivers under jit (interpret-mode Pallas on the CPU)
_j_run_mg_plan_fused = jax.jit(jfused.run_mg_plan_fused)
_j_select_best_fused = jax.jit(jfused.select_best_fused)
_j_select_round = jax.jit(functools.partial(
    jfused.fused_select_round, k=8, chunk=128, interpret=True))


def _plans(g, k, chunk, tile_r):
    degrees = np.asarray(g.degrees)
    return (j_build_fused(degrees, k=k, chunk=chunk, tile_r=tile_r),
            t_build_fused(degrees, k=k, chunk=chunk, tile_r=tile_r,
                          device=CPU))


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,chunk,tile_r", [(8, 128, 128), (4, 16, 8)])
def test_run_mg_plan_fused_matches_reference(name, k, chunk, tile_r):
    g = FIXTURES[name]()
    el, ew = random_entries(g.n_nodes, g.n_edges, np.random.default_rng(5))
    jplan, tplan = _plans(g, k, chunk, tile_r)
    ref_k, ref_v = _j_run_mg_plan_fused(jplan, jnp.asarray(el),
                                        jnp.asarray(ew))
    got_k, got_v = tfused.run_mg_plan_fused(tplan, torch.from_numpy(el),
                                            torch.from_numpy(ew))
    assert_same_array(ref_k, got_k, "padded sketch labels")
    assert_same_array(ref_v, got_v, "padded sketch weights")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fold_rounds_match_reference(name):
    """Every round on its own, from the reference's own round inputs."""
    g = FIXTURES[name]()
    el, ew = random_entries(g.n_nodes, g.n_edges, np.random.default_rng(6))
    jplan, tplan = _plans(g, 4, 16, 8)
    jl, jw = jnp.asarray(el), jnp.asarray(ew)
    for jr, tr in zip(jplan.rounds, tplan.rounds):
        ref_k, ref_v = jfused.fused_fold_round(jr, jl, jw, k=4, chunk=16,
                                               interpret=True)
        got_k, got_v = tfused.fused_fold_round(
            tr, torch.from_numpy(np.asarray(jl)),
            torch.from_numpy(np.asarray(jw)), k=4, chunk=16)
        assert_same_array(ref_k, got_k, "round labels")
        assert_same_array(ref_v, got_v, "round weights")
        jl, jw = ref_k.reshape(-1), ref_v.reshape(-1)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_select_best_fused_matches_reference(name):
    g = FIXTURES[name]()
    rng = np.random.default_rng(8)
    el, ew = random_entries(g.n_nodes, g.n_edges, rng)
    labels = rng.integers(0, max(g.n_nodes, 2), g.n_nodes).astype(np.int32)
    jplan, tplan = _plans(g, 8, 128, 32)
    for seed in SEEDS:
        ref = _j_select_best_fused(jplan, jnp.asarray(el), jnp.asarray(ew),
                                   jnp.asarray(labels), jnp.int32(seed))
        got = tfused.select_best_fused(tplan, torch.from_numpy(el),
                                       torch.from_numpy(ew),
                                       torch.from_numpy(labels), seed)
        assert_same_array(ref, got, f"want (seed {seed})")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_select_round_matches_reference(name):
    """The last round's raw per-row output, pad rows included."""
    g = FIXTURES[name]()
    rng = np.random.default_rng(9)
    jplan, tplan = _plans(g, 8, 128, 32)
    last_j, last_t = jplan.rounds[-1], tplan.rounds[-1]
    n_in = last_j.n_entries_in
    el = rng.integers(-1, 6, n_in).astype(np.int32)
    ew = (rng.integers(0, 4, n_in) * 0.5).astype(np.float32)
    rows = last_t.row_start.numel()
    inc = rng.integers(-1, 6, rows).astype(np.int32)
    for seed in SEEDS:
        ref = _j_select_round(last_j, jnp.asarray(el), jnp.asarray(ew),
                              jnp.asarray(inc), jnp.int32(seed))
        got = tfused.fused_select_round(last_t, torch.from_numpy(el),
                                        torch.from_numpy(ew),
                                        torch.from_numpy(inc), seed,
                                        k=8, chunk=128)
        assert_same_array(ref, got, f"row choice (seed {seed})")


def test_plain_select_is_choose_from_candidates_over_the_fold():
    """K2's plain version is K1's plain fold + the shared selection."""
    g = FIXTURES["powerlaw"]()
    rng = np.random.default_rng(10)
    _, tplan = _plans(g, 8, 128, 32)
    el, ew = random_entries(g.n_nodes, g.n_edges, rng)
    rnd = tplan.rounds[0]
    inc = torch.from_numpy(rng.integers(0, 50, rnd.row_start.numel())
                           .astype(np.int32))
    el_t, ew_t = torch.from_numpy(el), torch.from_numpy(ew)
    s_k, s_v = tfused.fused_fold_round_plain(rnd, el_t, ew_t, k=8, chunk=128)
    want = tsk.choose_from_candidates(torch.where(s_v > 0, s_k, -1), s_v,
                                      inc, 3)
    got = tfused.fused_select_round(rnd, el_t, ew_t, inc, 3, k=8, chunk=128)
    assert torch.equal(got, want)


def test_wrappers_check_their_inputs():
    g = FIXTURES["star_hub"]()
    _, tplan = _plans(g, 8, 128, 32)
    rnd = tplan.rounds[0]
    el = torch.zeros(rnd.n_entries_in, dtype=torch.int32)
    ew = torch.ones(rnd.n_entries_in, dtype=torch.float32)
    with pytest.raises(TypeError):
        tfused.fused_fold_round(rnd, el.float(), ew, k=8, chunk=128)
    with pytest.raises(ValueError):
        tfused.fused_fold_round(rnd, el[:-1], ew[:-1], k=8, chunk=128)
    with pytest.raises(ValueError):
        tfused.fused_select_round(rnd, el, ew, torch.zeros(3, dtype=torch.int32),
                                  1, k=8, chunk=128)
    tfused.reset_launch_counts()
    tfused.fused_fold_round(rnd, el, ew, k=8, chunk=128)
    # the CPU path runs the plain version: no kernel launch is counted
    # (one table counts the fused and the streamed kernels)
    assert tfused.LAUNCH_COUNTS == {"fused_fold": 0, "fused_select": 0,
                                    "bm_fold": 0, "rescan": 0,
                                    "stream_fold": 0, "stream_select": 0,
                                    "stream_bm": 0, "stream_rescan": 0,
                                    "tile_mg_fold": 0, "tile_bm_fold": 0}


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
def test_engine_candidates_and_launch_counts_match_reference(backend):
    """mg_candidates (per-vertex [N, k] sets) and dispatches_per_iter of
    each ported engine, against the same-named reference engine."""
    g = FIXTURES["powerlaw"]()
    el, ew = random_entries(g.n_nodes, g.n_edges, np.random.default_rng(0))
    degrees = np.asarray(g.degrees)
    jplan = j_build_fold_plan(degrees, k=8, chunk=128)
    tplan = t_build_fold_plan(degrees, k=8, chunk=128, device=CPU)
    jfplan, tfplan = _plans(g, 8, 128, 128)
    jeng, teng = j_get_engine(backend, checked=False), t_get_engine(backend)
    ref_c, ref_w = jeng.mg_candidates(jplan, jfplan, jnp.asarray(el),
                                      jnp.asarray(ew))
    got_c, got_w = teng.mg_candidates(tplan, tfplan, torch.from_numpy(el),
                                      torch.from_numpy(ew))
    assert_same_array(ref_c, got_c, "candidates")
    assert_same_array(ref_w, got_w, "candidate weights")
    assert (teng.dispatches_per_iter(tplan, tfplan, TRequest(seed=1))
            == jeng.dispatches_per_iter(jplan, jfplan, JRequest(seed=1)))
