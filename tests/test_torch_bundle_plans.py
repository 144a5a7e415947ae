"""Each backend's plan bundle holds the plan its engine reads, and no other.

On the CPU: a ``pallas_fused`` or ``pallas_stream`` bundle holds no bucketed
plan; a ``jnp`` or ``pallas`` bundle holds one equal to
``build_fold_plan(degrees)``, which the checked engine reads around its
folds; ``repro_torch.trace.PLAN_BYTES`` equals the bytes of the bundle's
tensors, by kind; and under the profiler the build is the span
``lpa.plan`` with one child span, for the plan built.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core.fold_engine import get_engine
from repro_torch.core.fold_program import FoldRequest
from repro_torch.core.lpa import LPAConfig, build_workspace
from repro_torch.graphs.csr import build_fold_plan
from repro_torch.graphs.generators import powerlaw_communities

from _torch_parity import assert_same

#: backend -> (the PlanBundle field it fills, PLAN_BYTES's key)
FILLS = {"jnp": ("plan", "bucketed"), "pallas": ("plan", "bucketed"),
         "pallas_fused": ("fused_plan", "fused"),
         "pallas_stream": ("stream_plan", "stream")}
PLANS = ("plan", "fused_plan", "stream_plan")


def _graph():
    return powerlaw_communities(600, p_in=0.4, mix=0.05, seed=2,
                                device="cpu")[0]


def _config(backend, **kw):
    return LPAConfig(fold_backend=backend, chunk=16, stream_window=128, **kw)


def _bytes(obj) -> int:
    """The bytes of every tensor in a plan, walked field by field."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(_bytes(x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return sum(_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


@pytest.mark.parametrize("backend", sorted(FILLS))
def test_a_bundle_holds_only_the_plan_its_engine_reads(backend):
    g = _graph()
    bundle = build_workspace(g, _config(backend)).bundle
    field, _ = FILLS[backend]
    for name in PLANS:
        assert (getattr(bundle, name) is not None) == (name == field), name
    if field == "plan":
        assert_same(build_fold_plan(g.degrees.numpy(), k=8, chunk=16,
                                    device="cpu"), bundle.plan, "plan")


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_fused"])
def test_the_checked_engine_runs_on_the_bundle(backend):
    """The checked engine reads the bucketed plan's gathers on ``jnp`` and
    ``pallas`` and the fused plan alone on ``pallas_fused``: the same
    wanted labels as the bare engine."""
    g = _graph()
    bundle = build_workspace(g, _config(backend)).bundle
    labels = torch.arange(g.n_nodes, dtype=torch.int32)
    nbr = labels[g.indices.long()]
    req = FoldRequest(family="mg", seed=3)
    got = get_engine(backend, checked=True).run(bundle, req, nbr, g.weights,
                                                labels).want
    want = get_engine(backend, checked=False).run(bundle, req, nbr,
                                                  g.weights, labels).want
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", sorted(FILLS))
def test_plan_bytes_counts_the_bundle(backend):
    trace.PLAN_BYTES.clear()
    bundle = build_workspace(_graph(), _config(backend)).bundle
    field, kind = FILLS[backend]
    assert trace.PLAN_BYTES == {kind: _bytes(getattr(bundle, field))}
    assert trace.PLAN_BYTES[kind] > 0


@pytest.mark.parametrize("backend", sorted(FILLS))
def test_the_plan_build_spans_appear_under_the_profiler(backend):
    g = _graph()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build_workspace(g, _config(backend))
    names = {e.key for e in prof.key_averages()}
    _, kind = FILLS[backend]
    assert {"lpa.plan", f"lpa.plan.{kind}"} <= names
    assert not {f"lpa.plan.{k}" for k in ("bucketed", "fused", "stream")
                if k != kind} & names
