"""The port's LPA partitioner (``repro_torch.graphs.partition``) against
the JAX package's, mirroring ``tests/test_graphs.py``'s partition tests:
on the same graphs and ``LPAConfig(method="mg", fold_backend="jnp")`` the
two give the same ``order``, ``parts``, ``bounds``, ``edge_cut`` and
``n_communities``; ``edge_cut_fraction`` and ``contiguous_parts`` agree
on the same inputs; and the reference suite's properties hold."""
import numpy as np
import pytest

from repro.core.lpa import LPAConfig as JConfig
from repro.graphs import partition as jpart
from repro.graphs.generators import powerlaw_communities
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.graphs import partition as tpart
from _torch_parity import assert_same_array, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

#: the graphs and part counts of tests/test_graphs.py:79 and :98
CASES = {"edge_cut": (dict(n=2048, p_in=0.5, mix=0.02, seed=1), 8),
         "balance": (dict(n=4096, seed=2), 4)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kwargs, n_parts = CASES[request.param]
    jg, _ = powerlaw_communities(**kwargs)
    tg = carry_graph(jg)
    ref = jpart.lpa_partition(jg, n_parts,
                              JConfig(method="mg", fold_backend="jnp"))
    got = tpart.lpa_partition(tg, n_parts,
                              TConfig(method="mg", fold_backend="jnp"))
    return jg, tg, n_parts, ref, got


def test_lpa_partition_matches_reference(case):
    _, _, _, ref, got = case
    for field in ("order", "parts", "bounds"):
        assert_same_array(getattr(ref, field), getattr(got, field), field)
    assert got.edge_cut == ref.edge_cut
    assert got.n_communities == ref.n_communities


def test_cut_and_baseline_match_reference(case):
    jg, tg, n_parts, ref, _ = case
    for p in (2, n_parts, 7):
        base = jpart.contiguous_parts(jg, p)
        assert_same_array(base, tpart.contiguous_parts(tg, p),
                          f"contiguous_parts({p})")
        assert tpart.edge_cut_fraction(tg, base) \
            == jpart.edge_cut_fraction(jg, base)
    assert tpart.edge_cut_fraction(tg, ref.parts) == ref.edge_cut


def test_lpa_partition_properties(case):
    """The reference suite's assertions, on the port's result."""
    jg, tg, n_parts, _, got = case
    n = tg.n_nodes
    assert sorted(got.order.tolist()) == list(range(n))
    assert got.bounds[0] == 0 and got.bounds[-1] == n
    assert got.edge_cut < 0.5
    assert got.edge_cut <= tpart.edge_cut_fraction(
        tg, tpart.contiguous_parts(tg, n_parts)) + 0.02
    deg = np.asarray(jg.degrees, dtype=np.int64)
    load = np.asarray([deg[got.parts == p].sum() for p in range(n_parts)])
    assert load.max() < 2.2 * max(load.mean(), 1)


def test_empty_graph_has_no_cut():
    from repro_torch.graphs.csr import build_csr
    g = build_csr(np.zeros((0, 2), np.int64), 5, device="cpu")
    assert tpart.edge_cut_fraction(g, np.zeros(5, np.int32)) == 0.0
    assert_same_array(np.zeros(5, np.int32), tpart.contiguous_parts(g, 1))
