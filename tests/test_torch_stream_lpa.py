"""repro_torch's lpa() on the streamed engine against repro's, end to end
on the CPU: equal labels, iterations, convergence and histories for νMG,
νBM and the rescan ablation on ``fold_backend="pallas_stream"``, aligned
and not, and on ``"auto"`` past the budget, which resolves to it. The
JAX side runs its Pallas streaming kernels in interpret mode."""
import pytest

from repro.core.lpa import LPAConfig as JConfig
from repro.core.lpa import lpa as jlpa
from repro_torch.core.lpa import LPAConfig as TConfig
from repro_torch.core.lpa import build_workspace
from repro_torch.core.lpa import lpa as tlpa
from test_stream_engine import FIXTURES
from test_torch_lpa import _assert_same_run
from _torch_parity import CPU, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

METHODS = {"mg": dict(method="mg"), "bm": dict(method="bm"),
           "rescan": dict(method="mg", rescan=True)}


def _same_runs(g, **cfg):
    """The JAX run of ``cfg`` (unaligned) against the port's run in each
    layout: the JAX package pins its own aligned runs to its unaligned
    ones (tests/test_stream_engine.py), so one reference serves both."""
    ref = jlpa(g, JConfig(**cfg))
    gt = carry_graph(g)
    for aligned in (False, True):
        got = tlpa(gt, TConfig(aligned_layout=aligned, **cfg), device=CPU)
        _assert_same_run(ref, got)


#: every fixture runs νMG; νBM and the rescan ablation run on the
#: fixtures with multi-entry rows (the others fold nothing past round 0)
_CASES = ([(name, "mg") for name in sorted(FIXTURES)]
          + [(name, method) for name in ("powerlaw", "star_hub")
             for method in ("bm", "rescan")])


@pytest.mark.parametrize("name,method", _CASES)
def test_lpa_stream_matches_reference(name, method):
    _same_runs(FIXTURES[name](), rho=2, max_iters=8,
               fold_backend="pallas_stream", **METHODS[method])


@pytest.mark.parametrize("name,method", [("powerlaw", "mg"),
                                         ("star_hub", "rescan")])
def test_lpa_stream_many_rounds_matches_reference(name, method):
    """chunk 16 and 256-entry windows: several merge rounds, each through
    its own re-layout (νBM folds round 0 only)."""
    _same_runs(FIXTURES[name](), rho=2, chunk=16, max_iters=8,
               fold_backend="pallas_stream", stream_window=256,
               **METHODS[method])


def test_lpa_auto_past_the_budget_matches_reference():
    """``vmem_budget_bytes=1024`` puts the powerlaw fixture past the
    budget: "auto" resolves to the streamed engine, with the aligned
    layout when asked, and gives the reference's run."""
    g = FIXTURES["powerlaw"]()
    cfg = dict(rho=2, fold_backend="auto", vmem_budget_bytes=1024)
    for aligned in (False, True):
        ws = build_workspace(carry_graph(g),
                             TConfig(aligned_layout=aligned, **cfg))
        assert ws.bundle.spec.backend == "pallas_stream"
        assert ws.stream_plan is not None and ws.fused_plan is None
        assert ws.stream_plan.aligned == aligned
    _same_runs(g, **cfg)
