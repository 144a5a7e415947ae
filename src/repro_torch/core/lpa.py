"""Label Propagation driver — νMG-LPA / νBM-LPA (the paper's Algorithms
1-3) and exact LPA, in torch.

A copy of the single-host ``repro.core.lpa``: unique initial labels;
one synchronous move step per iteration; Pick-Less (PL) symmetry
breaking every ``rho`` iterations starting at iteration 0 (a vertex may
only adopt a *smaller* label while PL is active); convergence when the
changed fraction drops below ``tau`` in a non-PL iteration; hard cap
``max_iters``. The frontier of unprocessed vertices (paper Alg. 1 l. 31)
is tracked every iteration and, with ``frontier_gate``, masks the moves.
``frontier_sparse`` also executes the gate: each iteration the loop
checks the frontier against a row capacity and, when it fits, sends a
``mode="sparse"`` request, whose fold launches cover only the frontier's
rows (fused) or windows (streamed); on overflow it runs the dense gated
fold. Both give the same labels.

One νMG iteration on ``fold_backend="pallas_fused"`` is: the
neighbour-label gather; one K1 launch per fold round but the last; one K2
launch that folds the last round and selects; the Pick-Less/move mask;
the changed count and the frontier marks (one ``frontier_marks`` launch,
on every backend). ``rescan=True`` folds every round with K1 and
re-scores the candidates with one K4 launch; ``method="bm"`` folds round
0 with one K3 launch. On
``fold_backend="pallas_stream"`` (and on ``"auto"`` past the budget) the
same iterations run K5/K6, K5 + K8 and K7 over the windowed plan; with
``aligned_layout=True`` the neighbour-label gather writes round 0's
windows directly. On ``fold_backend="pallas"`` each bucket of the
bucketed plan is gathered into a padded tile and folded by one K9 launch
(MG; K10 for BM's round 0). The gathers, scatters, merges and masks are
plain torch; the folds and the marks are the CUDA kernels.
``method="exact"`` and ``mg_variant="exact_weighted"`` (honoured on
``jnp`` only, as in the reference) fold in plain torch.

``LPAConfig`` keeps every field of the reference, so a config carries
across and means the same thing in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal, Optional

import numpy as np
import torch

from repro_torch.core.exact import exact_choose
from repro_torch.core.fold_engine import get_engine
from repro_torch.core.fold_program import FoldRequest
from repro_torch.core.plan_bundle import PlanBundle, build_plan_bundle, spec_for
from repro_torch.device import check_same_device, resolve_device
from repro_torch.graphs.csr import CSRGraph
from repro_torch.kernels.frontier import frontier_marks
from repro_torch.trace import Detection, host_read, span

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


@dataclasses.dataclass
class LPAWorkspace:
    """Graph + its plan bundle + CSR-expanded edge sources (exact only)."""

    graph: CSRGraph          # the CSR graph the plans were built from
    bundle: PlanBundle       # fold plans + resolved PlanSpec
    #: [M] int32 CSR-expanded edge source vertices, built for
    #: ``method="exact"`` alone (``exact_choose`` groups by them); None
    #: otherwise
    edge_src: Optional[torch.Tensor]

    @property
    def plan(self):
        return self.bundle.plan

    @property
    def fused_plan(self):
        return self.bundle.fused_plan

    @property
    def stream_plan(self):
        return self.bundle.stream_plan


def build_workspace(graph: CSRGraph, config: LPAConfig) -> LPAWorkspace:
    """Spec the config, build the bundle on the graph's device, attach the
    edge-source expansion when the exact method will read it (the frontier
    marks read the CSR rows themselves)."""
    return LPAWorkspace(graph=graph,
                        bundle=build_plan_bundle(graph, spec_for(config)),
                        edge_src=(graph.sources() if config.method == "exact"
                                  else None))


def lpa_move(ws: LPAWorkspace, labels: torch.Tensor, pick_less: bool,
             seed: int, config: LPAConfig,
             frontier: Optional[torch.Tensor] = None, sparse: bool = False,
             cap_rows: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One LPA iteration: returns (new_labels, changed_mask).

    ``seed`` varies per iteration and drives the hash tie-breaking.
    ``frontier`` (optional bool [N]) gates moves to unprocessed vertices
    (config.frontier_gate). ``sparse``/``cap_rows`` put ``mode="sparse"``
    on the request, so the engine folds only the frontier's rows; the
    caller must have checked that the frontier fits ``cap_rows``
    (``PlanBundle.sparse_fit``). Sparse wanted labels equal the dense
    ones on the frontier and the gate masks the rest, so the two modes
    give the same result.
    """
    with span("move"):
        graph, bundle = ws.graph, ws.bundle
        if config.method not in ("exact", "mg", "bm"):
            raise ValueError(f"unknown method {config.method!r}")
        if sparse and frontier is None:
            raise ValueError("sparse=True needs a frontier (the compacted "
                             "fold is defined by the active vertex set)")
        # the bundle's spec carries the RESOLVED backend ("auto" was
        # decided at plan-build time), so the engine always finds its plan;
        # the contract proxy (REPRO_CHECKED) never reaches the LPA loop
        engine = get_engine(bundle.spec.backend,
                            mg_variant=config.mg_variant, checked=False)
        aux = bundle.aux_for(engine)
        aligned = bool(engine.uses_stream_plan and aux is not None
                       and aux.aligned)
        if config.method == "exact":
            if ws.edge_src is None:
                raise ValueError("method='exact' reads the workspace's "
                                 "edge_src: build the workspace with "
                                 "method='exact'")
            with span("gather"):
                nbr_labels = torch.index_select(labels, 0, graph.indices)
            with span("fold"):
                want = exact_choose(ws.edge_src, nbr_labels, graph.weights,
                                    graph.n_nodes, labels, seed)
        else:  # "mg" or "bm"
            with span("gather"):
                if aligned:
                    # window-aligned layout: ONE gather straight into
                    # round 0's window slots replaces labels[indices] AND
                    # the round's re-layout gather; the appended -1 slot
                    # absorbs the plan's n_nodes pad sentinel
                    labels_ext = torch.cat([labels,
                                            labels.new_full((1,), -1)])
                    nbr_labels = torch.index_select(labels_ext, 0,
                                                    aux.aligned_entry_vertex)
                    nbr_weights = aux.aligned_entry_weights
                else:
                    nbr_labels = torch.index_select(labels, 0, graph.indices)
                    nbr_weights = graph.weights
            request = FoldRequest(family=config.method,
                                  mode="sparse" if sparse else "dense",
                                  rescan=(config.method == "mg"
                                          and config.rescan),
                                  aligned=aligned, seed=seed,
                                  frontier=frontier if sparse else None,
                                  cap_rows=cap_rows if sparse else 0)
            want = engine.run(bundle, request, nbr_labels, nbr_weights,
                              labels).want

        with span("mask"):
            allowed = (want < labels) if pick_less else (want != labels)
            if frontier is not None:
                allowed = allowed & frontier
            new_labels = torch.where(allowed, want, labels)
            changed = new_labels != labels
        return new_labels, changed


def mark_frontier(ws: LPAWorkspace, changed: torch.Tensor) -> torch.Tensor:
    """Mark neighbors of changed vertices as unprocessed (paper Alg. 1 l. 31).

    After an iteration, exactly the neighbors of vertices that changed
    label are 'in the queue' for the next one: the reference's
    ``segment_max(changed[edge_src], indices) > 0``, computed from the CSR
    rows by ``kernels.frontier.frontier_marks`` (one CUDA kernel on the
    card, its plain version on the CPU).
    """
    with span("marks"):
        return frontier_marks(changed, ws.graph.offsets, ws.graph.indices)


def _mean_f32(mask: torch.Tensor) -> float:
    """The reference's ``float(jnp.mean(mask))`` bit for bit: XLA lowers
    the mean to the float32 count (exact below 2**24) times the float32
    reciprocal of the length, so this does the same two roundings."""
    n = mask.shape[0]
    count = host_read(mask.sum, "mean")
    return float(np.float32(count) * (np.float32(1) / np.float32(n)))


@dataclasses.dataclass
class LPAResult:
    labels: torch.Tensor   # [N] int32 final label per vertex
    iterations: int        # iterations actually run (<= config.max_iters)
    changed_history: list  # per-iteration count of vertices that moved
    converged: bool        # changed fraction fell below tau (non-PL iter)
    #: unprocessed-frontier fraction entering each iteration (diagnostics;
    #: the gate only acts on it when config.frontier_gate is set)
    frontier_history: list = dataclasses.field(default_factory=list)
    #: rows the fold computed each iteration: the full plan row count on
    #: dense iterations, the compacted rows on sparse ones
    work_rows_history: list = dataclasses.field(default_factory=list)
    #: values the detection read back from the device, by site
    #: (``repro_torch.trace.host_read``); each read waits for the device
    host_reads: dict = dataclasses.field(default_factory=dict)


def lpa(graph: CSRGraph, config: Optional[LPAConfig] = None,
        ws: Optional[LPAWorkspace] = None, *, device=None) -> LPAResult:
    """Run LPA to convergence (host loop around ``lpa_move``).

    ``device=None`` means CUDA; the graph must already live on the device
    (build it with the same ``device``): nothing is moved.
    """
    det = Detection()
    with span("detect"):
        config = config if config is not None else LPAConfig()
        if config.frontier_sparse:
            if not config.frontier_gate:
                raise ValueError("frontier_sparse requires frontier_gate: "
                                 "the sparse fold is only correct when "
                                 "off-frontier moves are masked")
            if config.method == "exact":
                raise ValueError("frontier_sparse does not apply to the exact "
                                 "method (no fold plan to compact)")
        dev = resolve_device(device)
        check_same_device(dev, offsets=graph.offsets, indices=graph.indices,
                          weights=graph.weights)
        with span("init"):
            ws = ws if ws is not None else build_workspace(graph, config)
            n = graph.n_nodes
            labels = torch.arange(n, dtype=torch.int32, device=dev)
            frontier = torch.ones((n,), dtype=torch.bool,
                                  device=dev)  # all queued
            dense_rows = ws.bundle.dense_work_rows()
            cap_rows = ws.bundle.cap_rows()
        need_marks = config.frontier_gate or config.track_frontier
        history = []
        frontier_history = []
        work_rows_history = []
        converged = False
        it = 0
        for it in range(config.max_iters):
            pl = (it % config.rho) == 0
            with span("iter"):
                seed = it + 1
                gate = frontier if config.frontier_gate else None
                sparse, work = False, dense_rows
                if config.frontier_sparse:
                    # the fit is decided between iterations, on the host;
                    # on overflow this iteration runs the dense gated fold
                    fits, sparse_work = ws.bundle.sparse_fit(frontier,
                                                             cap_rows)
                    if fits:
                        sparse, work = True, sparse_work
                labels, changed = lpa_move(ws, labels, pl, seed, config,
                                           frontier=gate, sparse=sparse,
                                           cap_rows=cap_rows)
                work_rows_history.append(work)
                if need_marks:
                    if config.track_frontier:
                        frontier_history.append(_mean_f32(frontier))
                    marked = mark_frontier(ws, changed)
                    # A Pick-Less round blocks legal moves (want > label),
                    # so its unchanged vertices are deferred, not settled
                    # — keep them queued instead of letting the gate
                    # freeze them.
                    with span("marks"):
                        frontier = (frontier | marked) if pl else marked
                delta = host_read(changed.sum, "count")
                history.append(delta)
                if not pl and delta / max(n, 1) < config.tau:
                    converged = True
                    break
        return LPAResult(labels=labels, iterations=it + 1,
                         changed_history=history, converged=converged,
                         frontier_history=frontier_history,
                         work_rows_history=work_rows_history,
                         host_reads=det.finish(it + 1))


def lpa_step_fn(config: LPAConfig) -> Callable:
    """A ``(ws, labels, iteration) -> (labels, delta_n)`` single-step
    function: iteration ``i`` (an int or a 0-d integer tensor) runs
    ``lpa_move`` with Pick-Less on when ``i % rho == 0`` and seed ``i +
    1``, as ``lpa()``'s loop does; ``delta_n`` is the 0-d int32 count of
    vertices that moved."""

    def step(ws: LPAWorkspace, labels: torch.Tensor, iteration):
        it = int(iteration)
        new_labels, changed = lpa_move(ws, labels, it % config.rho == 0,
                                       it + 1, config)
        return new_labels, torch.sum(changed, dtype=torch.int32)

    return step
