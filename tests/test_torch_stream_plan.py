"""The streamed (windowed) fold plan of repro_torch against the JAX
package's, field for field on the CPU: ``build_streamed_fold_plan``
aligned and not, its window-boundary cases, its accounting helpers, and
the ``stream_plan`` slot of ``build_plan_bundle`` with the sizing policy
that reads it."""
import numpy as np
import pytest
import torch

from repro.core.plan_bundle import PlanSpec as JSpec
from repro.core.plan_bundle import build_plan_bundle as j_build_bundle
from repro.graphs import csr as jcsr
from repro.graphs.generators import powerlaw_communities as j_powerlaw
from repro_torch.core.plan_bundle import PlanSpec as TSpec
from repro_torch.core.plan_bundle import build_plan_bundle as t_build_bundle
from repro_torch.graphs import csr as tcsr
from test_stream_engine import FIXTURES
from _torch_parity import CPU, assert_same, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

#: the parametrisations of tests/test_stream_engine.py::test_stream_fold_parity
SHAPES = [(8, 128, 128, 8192),  # production shape
          (4, 16, 8, 64)]       # tiny windows, many rounds

_ACCOUNTING = ("streamed_dispatches", "streamed_window_slots",
               "streamed_gather_slots", "streamed_hbm_entries",
               "streamed_peak_window_bytes", "streamed_work_rows")


def _plans(g, k, chunk, tile_r, window, aligned):
    degrees = np.asarray(g.degrees)
    jplan = jcsr.build_streamed_fold_plan(
        degrees, k=k, chunk=chunk, tile_r=tile_r, window_entries=window,
        indices=np.asarray(g.indices), weights=np.asarray(g.weights),
        aligned=aligned)
    tplan = tcsr.build_streamed_fold_plan(
        degrees, k=k, chunk=chunk, tile_r=tile_r, window_entries=window,
        indices=np.asarray(g.indices), weights=np.asarray(g.weights),
        aligned=aligned, device=CPU)
    return jplan, tplan


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("k,chunk,tile_r,window", SHAPES)
@pytest.mark.parametrize("aligned", [False, True])
def test_streamed_plan_matches_reference(name, k, chunk, tile_r, window,
                                         aligned):
    """Every field of every round, the round-0 coordinates, the aligned
    arrays, the properties and the accounting helpers."""
    jplan, tplan = _plans(FIXTURES[name](), k, chunk, tile_r, window,
                          aligned)
    assert_same(jplan, tplan, "stream_plan")
    assert tplan.aligned == jplan.aligned == aligned
    for jr, tr in zip(jplan.rounds, tplan.rounds):
        assert (tr.n_windows, tr.tile_r) == (jr.n_windows, jr.tile_r)
        assert tr.entry_gather.dtype == torch.int32
    for helper in _ACCOUNTING:
        assert getattr(tcsr, helper)(tplan) == getattr(jcsr, helper)(jplan)


def test_window_boundary_plan_matches_reference():
    """tests/test_stream_engine.py::test_window_boundary_rows: a row that
    would straddle the cap is bumped whole into the next window, where
    the last row ends exactly on the cap."""
    degrees = np.asarray([8, 8, 5, 8])
    jplan = jcsr.build_streamed_fold_plan(degrees, k=4, chunk=8, tile_r=4,
                                          window_entries=16)
    tplan = tcsr.build_streamed_fold_plan(degrees, k=4, chunk=8, tile_r=4,
                                          window_entries=16, device=CPU)
    assert_same(jplan, tplan, "stream_plan")
    rnd = tplan.rounds[0]
    rc = rnd.row_count.numpy()
    assert rnd.n_windows == 2
    np.testing.assert_array_equal(rc[0][rc[0] > 0], [5, 8])
    np.testing.assert_array_equal(rc[1][rc[1] > 0], [8, 8])
    gather = rnd.entry_gather.numpy()
    np.testing.assert_array_equal(np.sort(gather[gather >= 0]),
                                  np.arange(int(degrees.sum())))


def test_exact_window_fill_plan_matches_reference():
    """tests/test_stream_engine.py::test_exact_window_fill_keeps_single_window:
    rows that exactly fill the cap share one window."""
    degrees = np.asarray([8, 8])
    jplan = jcsr.build_streamed_fold_plan(degrees, k=4, chunk=8, tile_r=4,
                                          window_entries=16)
    tplan = tcsr.build_streamed_fold_plan(degrees, k=4, chunk=8, tile_r=4,
                                          window_entries=16, device=CPU)
    assert_same(jplan, tplan, "stream_plan")
    assert tplan.rounds[0].n_windows == 1


def test_streamed_plan_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="aligned"):
        tcsr.build_streamed_fold_plan(np.asarray([3, 2, 1]), k=4, chunk=16,
                                      aligned=True, device=CPU)
    with pytest.raises(ValueError, match="chunk"):
        tcsr.build_streamed_fold_plan(np.asarray([3, 1]), k=8, chunk=8,
                                      device=CPU)
    with pytest.raises(ValueError, match="window_cap"):
        tcsr.build_streamed_fold_plan(np.asarray([3, 1]), k=4, chunk=16,
                                      window_entries=8, device=CPU)


# ---------------------------------------------------------------------------
# build_plan_bundle: the stream_plan slot (tests/test_plan_bundle.py sizes)
# ---------------------------------------------------------------------------

K, CHUNK, TILE_R, WINDOW = 4, 8, 8, 64

_BUNDLE_CASES = {
    "jnp": dict(backend="jnp"),
    "pallas_fused": dict(backend="pallas_fused"),
    "pallas_stream": dict(backend="pallas_stream"),
    "auto_past_budget": dict(backend="auto", vmem_budget_bytes=1024),
    "auto_within_budget": dict(backend="auto"),
}


@pytest.mark.parametrize("case", sorted(_BUNDLE_CASES))
@pytest.mark.parametrize("aligned", [False, True])
def test_bundle_matches_reference(case, aligned):
    """The bundle builds exactly the reference's plans (the streamed one
    iff the resolved backend streams), resolves "auto" to the same name
    and sizes the sparse path the same way."""
    g, _ = j_powerlaw(96, p_in=0.4, mix=0.05, seed=0)
    kw = dict(k=K, chunk=CHUNK, tile_r=TILE_R, aligned=aligned,
              stream_window=WINDOW, **_BUNDLE_CASES[case])
    jb = j_build_bundle(g, JSpec(**kw))
    tb = t_build_bundle(carry_graph(g), TSpec(**kw))
    assert tb.spec.backend == jb.spec.backend
    assert tb.spec == TSpec(**dict(kw, backend=jb.spec.backend))
    # the port builds the bucketed plan only for the engines that read it:
    # on the others it is held to the reference's through build_fold_plan
    bucketed = tb.spec.backend in ("jnp", "pallas")
    assert (tb.plan is not None) == bucketed
    assert_same(jb.plan, tb.plan if bucketed else tcsr.build_fold_plan(
        np.asarray(g.degrees), k=K, chunk=CHUNK, device=CPU), "plan")
    assert_same(jb.fused_plan, tb.fused_plan, "fused_plan")
    assert_same(jb.stream_plan, tb.stream_plan, "stream_plan")
    streams = jb.spec.backend == "pallas_stream"
    assert (tb.stream_plan is not None) == streams
    if streams:
        assert tb.stream_plan.aligned == aligned
    assert tb.dense_work_rows() == jb.dense_work_rows()
    assert tb.default_cap_rows() == jb.default_cap_rows()
    assert tb.cap_rows() == jb.cap_rows()
