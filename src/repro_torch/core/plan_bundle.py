"""PlanBundle: one declarative plan-build layer behind the FoldRequest IR.

A copy of the single-host half of ``repro.core.plan_bundle``. A frozen
:class:`PlanSpec` declares the backend a caller will run; ONE entry point
:func:`build_plan_bundle` builds exactly the plans its requests need::

    spec = spec_for(config)
    bundle = build_plan_bundle(graph, spec)
    outcome = engine.run(bundle, request, entry_labels, entry_weights,
                         labels)

The plans are built on the graph's device (host numpy, then tensors).
The per-shard half (the distributed workspace) is Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.fold_engine import ENGINES, resolve_auto
from repro_torch.graphs.csr import (CSRGraph, FoldPlan, FusedFoldPlan,
                                    StreamedFoldPlan, build_fold_plan,
                                    build_fused_fold_plan,
                                    build_streamed_fold_plan,
                                    fused_active_rows, fused_work_rows,
                                    streamed_active_windows,
                                    streamed_work_rows)

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
    # pallas_stream: pre-materialize round 0 window-aligned
    aligned: bool = False
    # pallas_stream: max entries per streamed window
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

    The bucketed ``plan`` is always present (the jnp and pallas engines
    and the reference oracles consume it); at most one aux plan is built
    for the whole-round kernel engines: ``fused_plan`` iff the resolved
    backend is ``pallas_fused``, ``stream_plan`` iff it is
    ``pallas_stream``.
    """

    # canonical bucketed multi-width plan (every backend's reference)
    plan: FoldPlan
    # whole-round fused plan — built iff spec.backend == "pallas_fused"
    fused_plan: Optional[FusedFoldPlan] = None
    # windowed plan — built iff spec.backend == "pallas_stream" (carries
    # the aligned layout when spec.aligned)
    stream_plan: Optional[StreamedFoldPlan] = None
    # the resolved (never "auto") spec this bundle was built from
    spec: PlanSpec = dataclasses.field(default_factory=PlanSpec)

    def aux_for(self, engine):
        """The aux plan ``engine`` consumes next to the bucketed plan: the
        streamed plan for stream engines, the fused plan for fused ones,
        None for the bucketed jnp/pallas backends (their fused_plan slot
        is never built)."""
        return self.stream_plan if engine.uses_stream_plan \
            else self.fused_plan

    def dense_work_rows(self) -> int:
        """Real (non-padding) fold rows one dense iteration computes."""
        if self.fused_plan is not None:
            return fused_work_rows(self.fused_plan)
        if self.stream_plan is not None:
            return streamed_work_rows(self.stream_plan)
        return sum(r.n_rows_total for r in self.plan.rounds)

    def sparse_fit(self, frontier, cap_rows: int) -> tuple[bool, int]:
        """The sparse fold's overflow check.

        Returns (fits, work_rows): whether every round's active unit count
        is within ``cap_rows`` (rows on the fused plan, windows on the
        streamed one, whose launches compact whole windows), and the rows
        the sparse fold would compute. ``frontier`` is the [N] bool mask,
        on the plans' device; the counts are taken there and only the
        integers reach the host. The bucketed backends have no compacted
        path, so they always fit, at the dense cost.
        """
        if self.fused_plan is not None:
            counts = fused_active_rows(self.fused_plan, frontier)
            return all(c <= cap_rows for c in counts), sum(counts)
        if self.stream_plan is not None:
            stats = streamed_active_windows(self.stream_plan, frontier)
            return (all(w <= cap_rows for w, _ in stats),
                    sum(r for _, r in stats))
        return True, self.dense_work_rows()

    def default_cap_rows(self) -> int:
        """Half the largest round's real rows (windows, on the streamed
        plan) — sparse only pays off once the frontier has thinned below
        the compaction overhead's break-even."""
        if self.fused_plan is not None:
            worst = max(int((r.row_vertex >= 0).sum())
                        for r in self.fused_plan.rounds)
        elif self.stream_plan is not None:
            worst = max(r.row_start.shape[0]
                        for r in self.stream_plan.rounds)
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
    the returned bundle's spec carries the resolved name. The bucketed
    backends (``jnp``, ``pallas``) need the bucketed plan only.
    """
    degrees = graph.degrees.cpu().numpy()
    backend = spec.backend
    if backend == "auto":
        backend = resolve_auto(int(degrees.sum()), spec.vmem_budget_bytes)
        spec = dataclasses.replace(spec, backend=backend)
    if backend not in ENGINES:
        raise ValueError(f"unknown fold backend {backend!r} in PlanSpec")
    plan = build_fold_plan(degrees, k=spec.k, chunk=spec.chunk,
                           device=graph.device)
    fused_plan = stream_plan = None
    if backend == "pallas_fused":
        fused_plan = build_fused_fold_plan(degrees, k=spec.k,
                                           chunk=spec.chunk,
                                           tile_r=spec.tile_r,
                                           device=graph.device)
    elif backend == "pallas_stream":
        # "auto" resolved above, so budget-forced streaming takes the
        # aligned layout whenever the spec asks for it
        stream_plan = build_streamed_fold_plan(
            degrees, k=spec.k, chunk=spec.chunk, tile_r=spec.tile_r,
            window_entries=spec.stream_window,
            indices=graph.indices.cpu().numpy() if spec.aligned else None,
            weights=graph.weights.cpu().numpy() if spec.aligned else None,
            aligned=spec.aligned, device=graph.device)
    return PlanBundle(plan=plan, fused_plan=fused_plan,
                      stream_plan=stream_plan, spec=spec)
