"""repro_torch.core.exact against repro.core.exact, bit for bit on the CPU:
``exact_choose`` on random weighted edge lists (unsorted and CSR-sorted
sources, isolated vertices, exact ties, non-dyadic weights whose group
sums depend on the order of the adds) and ``exact_linking_weights``.

The same group sums on the card are held to the CPU's in
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from _propcheck import given, settings, st

from repro.core import exact as jex
from repro_torch.core import exact as tex
from _torch_parity import assert_same_array

_j_choose = jax.jit(jex.exact_choose, static_argnums=3)
_j_linking = jax.jit(jex.exact_linking_weights, static_argnums=3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _edges(rng, n, m, n_labels, sort_src, dyadic):
    src = rng.integers(0, n, m).astype(np.int32)
    if sort_src:
        src.sort()
    nbr = rng.integers(0, n_labels, m).astype(np.int32)
    if dyadic:  # integral weights: exact ties between groups
        w = rng.integers(1, 4, m).astype(np.float32)
    else:       # the group sums' last bits depend on the order of the adds
        w = (rng.random(m) * 3 + 0.1).astype(np.float32)
    return src, nbr, w


@pytest.mark.parametrize("sort_src", [False, True])
@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("seed", [1, 5])
def test_exact_choose_matches_reference(sort_src, dyadic, seed):
    rng = np.random.default_rng(seed + 10 * dyadic + 20 * sort_src)
    n, m = 300, 6000  # vertices 280..299 never appear: isolated
    src, nbr, w = _edges(rng, n - 20, m, 12, sort_src, dyadic)
    labels = rng.integers(0, n, n).astype(np.int32)
    ref = _j_choose(jnp.asarray(src), jnp.asarray(nbr), jnp.asarray(w), n,
                    jnp.asarray(labels), jnp.int32(seed))
    got = tex.exact_choose(_t(src), _t(nbr), _t(w), n, _t(labels), seed)
    assert_same_array(ref, got, "exact choice")
    assert np.array_equal(got.numpy()[n - 20:], labels[n - 20:])


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 12), m=st.integers(1, 80), seed=st.integers(0, 99),
       dyadic=st.booleans())
def test_exact_choose_property(n, m, seed, dyadic):
    rng = np.random.default_rng(seed)
    src, nbr, w = _edges(rng, n, m, max(n, 2), False, dyadic)
    labels = rng.integers(0, n, n).astype(np.int32)
    # eager: a jit would compile anew for every (n, m)
    ref = jex.exact_choose(jnp.asarray(src), jnp.asarray(nbr), jnp.asarray(w), n,
                    jnp.asarray(labels), jnp.int32(seed))
    got = tex.exact_choose(_t(src), _t(nbr), _t(w), n, _t(labels), seed)
    assert_same_array(ref, got, "exact choice")


def test_exact_choose_long_groups_sum_in_edge_order():
    """Groups of thousands of non-dyadic weights: a pairwise or a reordered
    sum would change their last bits, and with them the winner of the two
    near-equal labels."""
    rng = np.random.default_rng(7)
    m = 40_000
    src = np.repeat(np.arange(4, dtype=np.int32), m // 4)
    nbr = rng.integers(0, 2, m).astype(np.int32)
    w = (rng.random(m) * 3 + 0.1).astype(np.float32)
    labels = np.arange(4, dtype=np.int32)
    q = rng.integers(0, 2, 4).astype(np.int32)
    for seed in (1, 2, 3):
        ref = _j_choose(jnp.asarray(src), jnp.asarray(nbr), jnp.asarray(w),
                        4, jnp.asarray(labels), jnp.int32(seed))
        got = tex.exact_choose(_t(src), _t(nbr), _t(w), 4, _t(labels), seed)
        assert_same_array(ref, got, "exact choice")
    ref = _j_linking(jnp.asarray(src), jnp.asarray(nbr), jnp.asarray(w), 4,
                     jnp.asarray(q))
    got = tex.exact_linking_weights(_t(src), _t(nbr), _t(w), 4, _t(q))
    assert_same_array(ref, got, "linking weights")


def test_exact_choose_without_edges_keeps_labels():
    labels = np.asarray([3, 1, 2], np.int32)
    empty_i = np.zeros(0, np.int32)
    got = tex.exact_choose(_t(empty_i), _t(empty_i),
                           _t(np.zeros(0, np.float32)), 3, _t(labels), 1)
    assert_same_array(labels, got, "labels")


@pytest.mark.parametrize("sort_src", [False, True])
def test_exact_linking_weights_matches_reference(sort_src):
    rng = np.random.default_rng(3 + sort_src)
    n = 200
    src, nbr, w = _edges(rng, n - 10, 5000, 6, sort_src, False)
    q = rng.integers(0, 6, n).astype(np.int32)
    ref = _j_linking(jnp.asarray(src), jnp.asarray(nbr), jnp.asarray(w), n,
                     jnp.asarray(q))
    got = tex.exact_linking_weights(_t(src), _t(nbr), _t(w), n, _t(q))
    assert_same_array(ref, got, "linking weights")
