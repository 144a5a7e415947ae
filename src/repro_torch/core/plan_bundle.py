"""PlanBundle: one declarative plan-build layer behind the FoldRequest IR.

A copy of the single-host half of ``repro.core.plan_bundle``. A frozen
:class:`PlanSpec` declares the backend a caller will run; ONE entry point
:func:`build_plan_bundle` builds exactly the plans its requests need::

    spec = spec_for(config)
    bundle = build_plan_bundle(graph, spec)
    outcome = engine.run(bundle, request, entry_labels, entry_weights,
                         labels)

The plans are built on the graph's device. The per-shard half (the
distributed workspace) is Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.fold_engine import ENGINES, resolve_auto, unported
from repro_torch.graphs.csr import (CSRGraph, FoldPlan, FusedFoldPlan,
                                    build_fold_plan, build_fused_fold_plan,
                                    fused_work_rows)

__all__ = ["PlanSpec", "PlanBundle", "spec_for", "build_plan_bundle"]


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static declaration of the plans a caller's FoldRequests need.

    ``build_plan_bundle`` replaces ``backend="auto"`` with the engine the
    policy picked, so a bundle's spec always names a concrete engine.
    """

    # fold backend the requests will run on: one of
    # repro_torch.core.fold_engine.ENGINES, or "auto" (resolved at build time)
    backend: str = "jnp"
    k: int = 8             # MG sketch slots (paper: 8)
    chunk: int = 128       # virtual-vertex chunk width (paper D_H: 128)
    tile_r: int = 128      # fused plan rows per step (the padding unit)
    # pallas_stream: pre-materialize round 0 window-aligned (not ported)
    aligned: bool = False
    # pallas_stream: max entries per streamed window (not ported)
    stream_window: int = 8192
    # "auto" resolution budget in bytes (None = the fold_engine default)
    vmem_budget_bytes: Optional[int] = None
    # per-round active-row capacity of the sparse frontier path
    # (None: PlanBundle.default_cap_rows's break-even half)
    frontier_cap_rows: Optional[int] = None


def spec_for(config) -> PlanSpec:
    """Derive the PlanSpec from an LPAConfig (duck-typed on the config's
    fold fields, so core.lpa can import this module and not vice versa)."""
    return PlanSpec(backend=config.fold_backend, k=config.k,
                    chunk=config.chunk, aligned=config.aligned_layout,
                    stream_window=config.stream_window,
                    vmem_budget_bytes=config.vmem_budget_bytes,
                    frontier_cap_rows=config.frontier_cap_rows)


@dataclasses.dataclass
class PlanBundle:
    """The plans one PlanSpec's requests consume, plus the sizing policy.

    The bucketed ``plan`` is always present (the jnp engine and the
    reference oracles consume it); ``fused_plan`` is built iff the
    resolved backend is ``pallas_fused``.
    """

    # canonical bucketed multi-width plan (every backend's reference)
    plan: FoldPlan
    # whole-round fused plan — built iff spec.backend == "pallas_fused"
    fused_plan: Optional[FusedFoldPlan] = None
    # the resolved (never "auto") spec this bundle was built from
    spec: PlanSpec = dataclasses.field(default_factory=PlanSpec)

    def aux_for(self, engine):
        """The aux plan ``engine`` consumes next to the bucketed plan: the
        fused plan for fused engines, None for the bucketed jnp backend."""
        return self.fused_plan if engine.uses_fused_plan else None

    def dense_work_rows(self) -> int:
        """Real (non-padding) fold rows one dense iteration computes."""
        if self.fused_plan is not None:
            return fused_work_rows(self.fused_plan)
        return sum(r.n_rows_total for r in self.plan.rounds)

    def default_cap_rows(self) -> int:
        """Half the largest round's real rows — sparse only pays off once
        the frontier has thinned below the compaction overhead's
        break-even."""
        if self.fused_plan is not None:
            worst = max(int((r.row_vertex >= 0).sum())
                        for r in self.fused_plan.rounds)
        else:
            worst = max(r.n_rows_total for r in self.plan.rounds)
        return max(1, worst // 2)

    def cap_rows(self) -> int:
        """The sparse path's row capacity: the spec's explicit cap, else
        the break-even default."""
        return (self.spec.frontier_cap_rows
                if self.spec.frontier_cap_rows is not None
                else self.default_cap_rows())


def build_plan_bundle(graph: CSRGraph, spec: PlanSpec) -> PlanBundle:
    """Build exactly the plans ``spec``'s requests need, on the graph's
    device.

    ``spec.backend == "auto"`` resolves here against the graph's |E|, and
    the returned bundle's spec carries the resolved name. A backend this
    package does not port raises before any plan is built.
    """
    degrees = graph.degrees.cpu().numpy()
    backend = spec.backend
    if backend == "auto":
        backend = resolve_auto(int(degrees.sum()), spec.vmem_budget_bytes)
        spec = dataclasses.replace(spec, backend=backend)
    if backend == "pallas":
        raise unported("the per-bucket 'pallas' backend", "Queue 1 item 9")
    if backend == "pallas_stream":
        raise unported("the streamed 'pallas_stream' backend",
                       "Queue 1 item 8")
    if backend not in ENGINES:
        raise ValueError(f"unknown fold backend {backend!r} in PlanSpec")
    plan = build_fold_plan(degrees, k=spec.k, chunk=spec.chunk,
                           device=graph.device)
    fused_plan = None
    if backend == "pallas_fused":
        fused_plan = build_fused_fold_plan(degrees, k=spec.k,
                                           chunk=spec.chunk,
                                           tile_r=spec.tile_r,
                                           device=graph.device)
    return PlanBundle(plan=plan, fused_plan=fused_plan, spec=spec)
