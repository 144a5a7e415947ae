"""Label Propagation driver — νMG-LPA (the paper's Algorithms 1/2) in torch.

A copy of ``repro.core.lpa`` for the dense MG method: unique initial
labels; one synchronous move step per iteration; Pick-Less (PL) symmetry
breaking every ``rho`` iterations starting at iteration 0 (a vertex may
only adopt a *smaller* label while PL is active); convergence when the
changed fraction drops below ``tau`` in a non-PL iteration; hard cap
``max_iters``. The frontier of unprocessed vertices (paper Alg. 1 l. 31)
is tracked every iteration and, with ``frontier_gate``, masks the moves.

One iteration on ``fold_backend="pallas_fused"`` is: the neighbour-label
gather; one K1 launch per fold round but the last; one K2 launch that
folds the last round and selects; the Pick-Less/move mask; the changed
count and the frontier marks. The gathers, the scatter and the masks are
plain torch; the fold and the selection are the CUDA kernels.

``LPAConfig`` keeps every field of the reference, so a config carries
across; a method, backend or option this package does not port yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` queue item.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core.fold_engine import get_engine, unported
from repro_torch.core.fold_program import FoldRequest
from repro_torch.core.plan_bundle import PlanBundle, build_plan_bundle, spec_for
from repro_torch.device import check_same_device, resolve_device
from repro_torch.graphs.csr import CSRGraph

Method = Literal["exact", "mg", "bm"]


@dataclasses.dataclass(frozen=True)
class LPAConfig:
    method: Method = "mg"      # "exact" | "mg" | "bm" (paper §4)
    k: int = 8                 # MG sketch slots (paper: 8)
    chunk: int = 128           # virtual-vertex chunk width (paper D_H: 128)
    rho: int = 8               # Pick-Less cadence (paper: 8)
    tau: float = 0.05          # convergence tolerance (paper: 0.05)
    max_iters: int = 20        # paper: 20
    rescan: bool = False       # double-scan mode (paper Fig. 5 ablation)
    # "jnp" | "pallas" | "pallas_fused" | "pallas_stream" | "auto"
    fold_backend: str = "jnp"
    mg_variant: str = "paper"  # "paper" | "exact_weighted"
    # pallas_stream: max entries per streamed window
    stream_window: int = 8192
    # pallas_stream: materialize round 0 window-aligned at plan build time
    aligned_layout: bool = False
    # "auto" picks pallas_fused while 8 * |E| <= this budget, else
    # pallas_stream (None = fold_engine.DEFAULT_VMEM_BUDGET_BYTES)
    vmem_budget_bytes: Optional[int] = None
    frontier_gate: bool = False  # Traag & Šubelj frontier gating (opt-in)
    # fold only the frontier's rows when they fit the capacity below
    # (requires frontier_gate)
    frontier_sparse: bool = False
    # per-round active-row capacity of the sparse path (None: half the
    # largest round's real rows)
    frontier_cap_rows: Optional[int] = None
    # record frontier_history (the per-iteration frontier fraction); with
    # both this and frontier_gate off, mark_frontier is never called
    track_frontier: bool = True


def check_ported(config: LPAConfig) -> None:
    """Raise ``NotImplementedError`` for the parts of ``config`` this
    package does not run yet."""
    if config.method == "exact":
        raise unported("method='exact' (exact_choose)", "Queue 1 item 5")
    if config.method == "bm":
        raise unported("method='bm'", "Queue 1 item 6")
    if config.method != "mg":
        raise ValueError(f"unknown method {config.method!r}")
    if config.rescan:
        raise unported("rescan=True", "Queue 1 item 6")
    if config.frontier_sparse:
        raise unported("frontier_sparse=True", "Queue 1 item 7")
    if config.mg_variant != "paper":
        raise unported(f"mg_variant={config.mg_variant!r}", "Queue 1 item 9")


@dataclasses.dataclass
class LPAWorkspace:
    """Graph + its plan bundle + CSR-expanded edge sources."""

    graph: CSRGraph          # the CSR graph the plans were built from
    bundle: PlanBundle       # fold plans + resolved PlanSpec
    edge_src: torch.Tensor   # [M] int32 CSR-expanded edge source vertices

    @property
    def plan(self):
        return self.bundle.plan

    @property
    def fused_plan(self):
        return self.bundle.fused_plan


def build_workspace(graph: CSRGraph, config: LPAConfig) -> LPAWorkspace:
    """Spec the config, build the bundle on the graph's device, attach the
    driver's edge-source expansion."""
    return LPAWorkspace(graph=graph,
                        bundle=build_plan_bundle(graph, spec_for(config)),
                        edge_src=graph.sources())


def lpa_move(ws: LPAWorkspace, labels: torch.Tensor, pick_less: bool,
             seed: int, config: LPAConfig,
             frontier: Optional[torch.Tensor] = None, sparse: bool = False,
             cap_rows: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One LPA iteration: returns (new_labels, changed_mask).

    ``seed`` varies per iteration and drives the hash tie-breaking.
    ``frontier`` (optional bool [N]) gates moves to unprocessed vertices
    (config.frontier_gate). ``sparse``/``cap_rows`` are the reference's
    sparse-request switches; sparse mode is not ported.
    """
    graph, bundle = ws.graph, ws.bundle
    if sparse:
        if frontier is None:
            raise ValueError("sparse=True needs a frontier (the compacted "
                             "fold is defined by the active vertex set)")
        raise unported("sparse frontier mode", "Queue 1 item 7")
    if config.method == "exact":
        raise unported("method='exact' (exact_choose)", "Queue 1 item 5")
    if config.method not in ("mg", "bm"):
        raise ValueError(f"unknown method {config.method!r}")
    # the bundle's spec carries the RESOLVED backend ("auto" was decided
    # at plan-build time), so the engine always finds its plan
    engine = get_engine(bundle.spec.backend, mg_variant=config.mg_variant)
    nbr_labels = torch.index_select(labels, 0, graph.indices)
    request = FoldRequest(family=config.method, mode="dense",
                          rescan=config.method == "mg" and config.rescan,
                          seed=seed)
    want = engine.run(bundle, request, nbr_labels, graph.weights,
                      labels).want

    allowed = (want < labels) if pick_less else (want != labels)
    if frontier is not None:
        allowed = allowed & frontier
    new_labels = torch.where(allowed, want, labels)
    changed = new_labels != labels
    return new_labels, changed


def mark_frontier(ws: LPAWorkspace, changed: torch.Tensor) -> torch.Tensor:
    """Mark neighbors of changed vertices as unprocessed (paper Alg. 1 l. 31).

    After an iteration, exactly the neighbors of vertices that changed
    label are 'in the queue' for the next one. The per-destination max is
    a ``scatter_reduce`` of ints, which is exact in any order.
    """
    n = ws.graph.n_nodes
    src_changed = changed[ws.edge_src].to(torch.int32)
    marked = torch.zeros(n, dtype=torch.int32, device=changed.device)
    marked.scatter_reduce_(0, ws.graph.indices.long(), src_changed, "amax")
    return marked > 0


def _mean_f32(mask: torch.Tensor) -> float:
    """The reference's ``float(jnp.mean(mask))`` bit for bit: XLA lowers
    the mean to the float32 count (exact below 2**24) times the float32
    reciprocal of the length, so this does the same two roundings."""
    n = mask.shape[0]
    return float(np.float32(int(mask.sum())) * (np.float32(1) / np.float32(n)))


@dataclasses.dataclass
class LPAResult:
    labels: torch.Tensor   # [N] int32 final label per vertex
    iterations: int        # iterations actually run (<= config.max_iters)
    changed_history: list  # per-iteration count of vertices that moved
    converged: bool        # changed fraction fell below tau (non-PL iter)
    #: unprocessed-frontier fraction entering each iteration (diagnostics;
    #: the gate only acts on it when config.frontier_gate is set)
    frontier_history: list = dataclasses.field(default_factory=list)
    #: rows the fold computed each iteration (the full plan row count:
    #: every ported iteration is dense)
    work_rows_history: list = dataclasses.field(default_factory=list)


def lpa(graph: CSRGraph, config: Optional[LPAConfig] = None,
        ws: Optional[LPAWorkspace] = None, *, device=None) -> LPAResult:
    """Run LPA to convergence (host loop around ``lpa_move``).

    ``device=None`` means CUDA; the graph must already live on the device
    (build it with the same ``device``): nothing is moved.
    """
    config = config if config is not None else LPAConfig()
    if config.frontier_sparse:
        if not config.frontier_gate:
            raise ValueError("frontier_sparse requires frontier_gate: the "
                             "sparse fold is only correct when off-frontier "
                             "moves are masked")
        if config.method == "exact":
            raise ValueError("frontier_sparse does not apply to the exact "
                             "method (no fold plan to compact)")
    check_ported(config)
    dev = resolve_device(device)
    check_same_device(dev, offsets=graph.offsets, indices=graph.indices,
                      weights=graph.weights)
    ws = ws if ws is not None else build_workspace(graph, config)
    n = graph.n_nodes
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    frontier = torch.ones((n,), dtype=torch.bool, device=dev)  # all queued
    need_marks = config.frontier_gate or config.track_frontier
    history = []
    frontier_history = []
    work_rows_history = []
    dense_rows = ws.bundle.dense_work_rows()
    converged = False
    it = 0
    for it in range(config.max_iters):
        pl = (it % config.rho) == 0
        seed = it + 1
        gate = frontier if config.frontier_gate else None
        labels, changed = lpa_move(ws, labels, pl, seed, config,
                                   frontier=gate)
        work_rows_history.append(dense_rows)
        if need_marks:
            if config.track_frontier:
                frontier_history.append(_mean_f32(frontier))
            marked = mark_frontier(ws, changed)
            # A Pick-Less round blocks legal moves (want > label), so its
            # unchanged vertices are deferred, not settled — keep them
            # queued instead of letting the gate freeze them.
            frontier = (frontier | marked) if pl else marked
        delta = int(changed.sum())
        history.append(delta)
        if not pl and delta / max(n, 1) < config.tau:
            converged = True
            break
    return LPAResult(labels=labels, iterations=it + 1,
                     changed_history=history, converged=converged,
                     frontier_history=frontier_history,
                     work_rows_history=work_rows_history)
