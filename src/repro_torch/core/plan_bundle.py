"""PlanBundle: one declarative plan-build layer behind the FoldRequest IR.

A copy of the single-host half of ``repro.core.plan_bundle``. A frozen
:class:`PlanSpec` declares the backend a caller will run; ONE entry point
:func:`build_plan_bundle` builds exactly the plans its requests need::

    spec = spec_for(config)
    bundle = build_plan_bundle(graph, spec)
    outcome = engine.run(bundle, request, entry_labels, entry_weights,
                         labels)

The plans are built on the graph's device (host numpy, then tensors);
each backend builds only the plan its engine reads (the bucketed plan for
``jnp`` and ``pallas``, the fused plan for ``pallas_fused``, the streamed
one for ``pallas_stream``). While the profiler records, the build is the
span ``lpa.plan``, with one child span per plan (``lpa.plan.bucketed``,
``lpa.plan.fused``, ``lpa.plan.stream``);
:data:`repro_torch.trace.PLAN_BYTES` holds the bytes of each plan of the
newest bundle.

The same entry point builds the per-shard half of the distributed
workspace (``repro_torch.core.distributed``), a copy of the reference's:
pass a :class:`ShardSlice` instead of a graph and get a host-side
:class:`ShardPlanBundle` (numpy throughout); :func:`stack_shard_bundles`
pads the per-shard bundles into the stacked [P, ...] CPU tensors the
workspace carries, and :func:`stack_aligned_windows` applies each
bundle's :meth:`ShardPlanBundle.remap_labels` transform, the one place
aligned window positions indexing an exchanged label table are written.
Every stacked array has the reference's shape and dtype. Unlike the
reference, the bucketed [R, chunk] round gathers are built only for the
backends that read them (``jnp``, ``pallas``): on the fused and streamed
backends they are ``None`` and the stacked plans carry ``n_rounds``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fold_engine import ENGINES, resolve_auto
from repro_torch.graphs.csr import (CSRGraph, FoldPlan, FusedFoldPlan,
                                    StreamedFoldPlan, build_fold_plan,
                                    build_fused_fold_plan,
                                    build_streamed_fold_plan,
                                    build_streamed_rounds,
                                    fused_active_rows, fused_work_rows,
                                    streamed_active_windows,
                                    streamed_work_rows)
from repro_torch.trace import PLAN_BYTES, host_read, span

__all__ = ["PlanSpec", "PlanBundle", "ShardSlice", "ShardPlanBundle",
           "StackedShardPlans", "spec_for", "build_plan_bundle",
           "uniform_round_count", "stack_shard_bundles",
           "stack_aligned_windows"]

#: pad sentinel shared with the plan builders (gather slots, vertex maps)
_PAD = -1
#: the backends that fold from the bucketed [R, chunk] round gathers
BUCKETED = ("jnp", "pallas")


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

    Exactly one plan is built, the one the resolved backend's engine
    reads: the bucketed ``plan`` for ``jnp`` and ``pallas`` (and the
    checked engine wrapping either), ``fused_plan`` for ``pallas_fused``,
    ``stream_plan`` for ``pallas_stream``. The others are None.
    """

    # canonical bucketed multi-width plan — built iff spec.backend is in
    # BUCKETED ("jnp", "pallas")
    plan: Optional[FoldPlan]
    # whole-round fused plan — built iff spec.backend == "pallas_fused"
    fused_plan: Optional[FusedFoldPlan] = None
    # windowed plan — built iff spec.backend == "pallas_stream" (carries
    # the aligned layout when spec.aligned)
    stream_plan: Optional[StreamedFoldPlan] = None
    # the resolved (never "auto") spec this bundle was built from
    spec: PlanSpec = dataclasses.field(default_factory=PlanSpec)

    def aux_for(self, engine):
        """The plan ``engine`` consumes besides ``plan``: the streamed plan
        for stream engines, the fused plan for fused ones, None for the
        bucketed jnp/pallas backends (their fused_plan slot is never
        built)."""
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
        with span("fit"):
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
            worst = max(host_read((r.row_vertex >= 0).sum(), "cap_rows")
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


def build_plan_bundle(graph_or_shard, spec: PlanSpec):
    """Build exactly the plans ``spec``'s requests need.

    For a :class:`CSRGraph`: a :class:`PlanBundle` on the graph's device
    (the bucketed backends, ``jnp`` and ``pallas``, need the bucketed plan
    only). For a :class:`ShardSlice`: a host-side :class:`ShardPlanBundle`
    (single-width rounds always; streamed rounds when the backend
    streams; the fused metadata needs cross-shard padding and is derived
    from the rounds in :func:`stack_shard_bundles`).

    ``spec.backend == "auto"`` resolves here against the round-0 entry
    volume (the graph's |E|, or the shard's padded entry length), and the
    returned bundle's spec carries the resolved name.
    """
    if isinstance(graph_or_shard, ShardSlice):
        return _build_shard_bundle(graph_or_shard, spec)
    graph: CSRGraph = graph_or_shard
    with span("plan"):
        degrees = graph.degrees.cpu().numpy()
        backend = spec.backend
        if backend == "auto":
            backend = resolve_auto(int(degrees.sum()),
                                   spec.vmem_budget_bytes)
            spec = dataclasses.replace(spec, backend=backend)
        if backend not in ENGINES:
            raise ValueError(f"unknown fold backend {backend!r} in PlanSpec")
        plans = dict.fromkeys(("plan", "fused_plan", "stream_plan"))
        if backend in BUCKETED:
            with span("plan.bucketed"):
                plans["plan"] = build_fold_plan(degrees, k=spec.k,
                                                chunk=spec.chunk,
                                                device=graph.device)
        elif backend == "pallas_fused":
            with span("plan.fused"):
                plans["fused_plan"] = build_fused_fold_plan(
                    degrees, k=spec.k, chunk=spec.chunk, tile_r=spec.tile_r,
                    device=graph.device,
                    starts_dtype=graph.offsets.dtype)
        else:
            # "auto" resolved above, so budget-forced streaming takes the
            # aligned layout whenever the spec asks for it
            with span("plan.stream"):
                plans["stream_plan"] = build_streamed_fold_plan(
                    degrees, k=spec.k, chunk=spec.chunk, tile_r=spec.tile_r,
                    window_entries=spec.stream_window,
                    indices=(graph.indices.cpu().numpy() if spec.aligned
                             else None),
                    weights=(graph.weights.cpu().numpy() if spec.aligned
                             else None),
                    aligned=spec.aligned, device=graph.device)
        PLAN_BYTES.clear()
        PLAN_BYTES.update({_PLAN_KINDS[name]: _tensor_bytes(p)
                           for name, p in plans.items() if p is not None})
        return PlanBundle(spec=spec, **plans)


#: PLAN_BYTES's key of each PlanBundle plan field
_PLAN_KINDS = {"plan": "bucketed", "fused_plan": "fused",
               "stream_plan": "stream"}


def _tensor_bytes(obj) -> int:
    """Bytes of every tensor in a plan."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(_tensor_bytes(x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return sum(_tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """One shard's slice of the partitioned degree sequence — what
    ``build_plan_bundle`` needs to build that shard's plans."""

    # [V_shard] int64 per-vertex degrees (entry counts) the shard owns
    counts: np.ndarray
    # round-0 source entry-array length — the cross-shard padded M_pad,
    # so every shard's plans index one uniform flat entry layout
    n_entries: int
    # uniform round count across shards (uniform_round_count) — shards
    # with fewer real rounds pad with merge rounds so the stacked
    # [P, ...] arrays keep one shape
    n_rounds: int


def uniform_round_count(shard_counts: List[np.ndarray], *, k: int,
                        chunk: int) -> int:
    """Fold rounds until every shard's row count collapses to <= 1 chunk
    row per vertex — the uniform round count the stacked plans share."""
    n_rounds = 1
    tmp = [np.asarray(c, dtype=np.int64).copy() for c in shard_counts]
    while True:
        chunks = [np.ceil(c / chunk).astype(np.int64) for c in tmp]
        if all((ch <= 1).all() for ch in chunks):
            break
        tmp = [ch * k for ch in chunks]
        n_rounds += 1
    return n_rounds


@dataclasses.dataclass
class ShardPlanBundle:
    """One shard's host-side plans (numpy; stacked to CPU tensors by
    ``stack_shard_bundles``), in the single-width (width = chunk) round
    encoding."""

    # the resolved spec the bundle was built from (shared across shards)
    spec: PlanSpec
    # uniform cross-shard round count the rounds below are padded to
    n_rounds: int
    # round-0 source entry-array length (the cross-shard M_pad)
    n_entries: int
    # per round: (gather [R, chunk] int32 on the bucketed backends else
    # None, row_vertex [R] int32, row_start [R] int64, row_count [R]
    # int64, row_rank [R] int32)
    rounds: Tuple[tuple, ...]
    # max round-0 chunk rows any owned vertex spans (rescan rank depth)
    max_rows0: int
    # backend == "pallas_stream": one numpy dict per round with the
    # StreamedRound fields (csr.build_streamed_rounds), else None
    stream_rounds: Optional[tuple] = None
    # backend == "pallas_stream": final-round window slot -> local vertex
    # ([n_win_last * tile_r] int32, -1 pads), else None
    stream_final_rtv: Optional[np.ndarray] = None

    def remap_labels(self, table: np.ndarray, weights: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """The aligned-window transform: gather ``table`` (per-entry
        label-table positions, e.g. the halo-remapped ``nbr_pos`` row) and
        ``weights`` into round-0 window-slot order.

        Returns ([n_win, W] int32 positions with -1 pads, [n_win, W]
        float32 weights with 0.0 pads) — exactly what the streamed
        mover's per-iteration re-layout gather would produce, written
        once at build time.
        """
        rr = self.stream_rounds[0]
        nw, w_s = rr["row_start"].shape[0], rr["window_entries"]
        g0 = rr["entry_gather"].reshape(nw, w_s)
        valid = g0 >= 0
        safe = np.maximum(g0, 0)
        table = np.asarray(table)
        weights = np.asarray(weights)
        pos = np.where(valid, table[safe], _PAD).astype(np.int32)
        wts = np.where(valid, weights[safe], 0.0).astype(np.float32)
        return pos, wts


def _build_shard_bundle(shard: ShardSlice, spec: PlanSpec
                        ) -> ShardPlanBundle:
    """Per-shard plan construction (host side, numpy throughout)."""
    backend = spec.backend
    if backend == "auto":
        backend = resolve_auto(int(shard.n_entries),
                               spec.vmem_budget_bytes)
        spec = dataclasses.replace(spec, backend=backend)
    counts0 = np.asarray(shard.counts, dtype=np.int64)
    n_local = counts0.shape[0]
    starts0 = np.zeros(n_local, dtype=np.int64)
    starts0[1:] = np.cumsum(counts0)[:-1]
    chunk, k = spec.chunk, spec.k
    # only the bucketed engines read the [R, chunk] round gathers; the
    # fused and streamed ones fold from (start, count) ranges
    bucketed = backend in BUCKETED
    rounds = []
    counts, starts = counts0.copy(), starts0
    for _ in range(shard.n_rounds):
        n_chunks = np.ceil(counts / chunk).astype(np.int64)
        total_rows = int(n_chunks.sum())
        row_vertex = np.repeat(np.arange(n_local, dtype=np.int64), n_chunks)
        row_rank = np.arange(total_rows) - np.repeat(
            np.cumsum(n_chunks) - n_chunks, n_chunks)
        row_start = starts[row_vertex] + row_rank * chunk
        row_count = np.minimum(counts[row_vertex] - row_rank * chunk, chunk)
        gather = None
        if bucketed:
            # in int32 from the start (the reference casts at the end;
            # every real slot is below n_entries < 2**31)
            lane = np.arange(chunk, dtype=np.int32)
            gather = np.where(
                lane[None, :] < row_count[:, None],
                row_start.astype(np.int32)[:, None] + lane[None, :],
                np.int32(_PAD))
        rounds.append((gather, row_vertex.astype(np.int32),
                       row_start.astype(np.int64),
                       row_count.astype(np.int64),
                       row_rank.astype(np.int32)))
        counts = n_chunks * k
        starts = np.zeros(n_local, dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
    max_rows0 = (max(1, int(-(-int(counts0.max()) // chunk)))
                 if counts0.size else 1)
    stream_rounds = stream_final_rtv = None
    if backend == "pallas_stream":
        rounds_np, rtv = build_streamed_rounds(
            counts0, starts0, shard.n_entries, k=k, chunk=chunk,
            tile_r=spec.tile_r, window_cap=spec.stream_window,
            min_rounds=shard.n_rounds)
        stream_rounds, stream_final_rtv = tuple(rounds_np), rtv
    return ShardPlanBundle(spec=spec, n_rounds=shard.n_rounds,
                           n_entries=shard.n_entries,
                           rounds=tuple(rounds), max_rows0=max_rows0,
                           stream_rounds=stream_rounds,
                           stream_final_rtv=stream_final_rtv)


@dataclasses.dataclass
class StackedShardPlans:
    """Per-shard bundles padded + stacked to the uniform [P, ...] CPU
    tensors ``DistLPAWorkspace`` carries (one field per engine encoding;
    the workspace forwards them verbatim)."""

    # uniform cross-shard round count
    n_rounds: int
    # per round: [P, R_pad_r, chunk] int32 gather into the flat entries
    # (the bucketed backends only, else None)
    round_gathers: Optional[Tuple[torch.Tensor, ...]]
    # [P, R_last] int32 — local vertex per final-round row (-1 pads)
    final_row_vertex: torch.Tensor
    # [P, R_pad_0] int32 — round-0 row -> local vertex (-1 pads)
    row_vertex0: torch.Tensor
    # [P, R_pad_0] int32 — round-0 row -> chunk rank (0 on pads)
    bucket_rank0: torch.Tensor
    # max round-0 chunk rows any vertex owns across shards (rescan depth)
    max_rows0: int
    # fused metadata (backend == "pallas_fused"), per round:
    # [P, S_r, tile_r] int32 row starts
    fused_starts: Optional[Tuple[torch.Tensor, ...]] = None
    # per round [P, S_r, tile_r] int32 row entry counts
    fused_counts: Optional[Tuple[torch.Tensor, ...]] = None
    # per round [P, S_r, 1] int32 max count per step
    fused_dmax: Optional[Tuple[torch.Tensor, ...]] = None
    # per round: flat entry-array length the fused kernel reads
    fused_entries: Tuple[int, ...] = ()
    # [P, S_0 * tile_r] int32 fused round-0 row -> local vertex (-1 pads)
    fused_rv0: Optional[torch.Tensor] = None
    # [P, S_0 * tile_r] int32 fused round-0 row -> chunk rank (0 on pads)
    fused_rank0: Optional[torch.Tensor] = None
    # streamed metadata (backend == "pallas_stream"), per round:
    # [P, n_win_r, W_r] int32 windowed entry gather (-1 pads)
    stream_gathers: Optional[Tuple[torch.Tensor, ...]] = None
    # per round [P, n_win_r, tile_r] int32 in-window row starts
    stream_starts: Optional[Tuple[torch.Tensor, ...]] = None
    # per round [P, n_win_r, tile_r] int32 row entry counts
    stream_counts: Optional[Tuple[torch.Tensor, ...]] = None
    # per round [P, n_win_r, 1] int32 max count per window
    stream_dmax: Optional[Tuple[torch.Tensor, ...]] = None
    # [P, n_win_last * tile_r] int32 final window slot -> local vertex
    stream_final_rv: Optional[torch.Tensor] = None
    # [P, n_win_0 * tile_r] int32 round-0 window slot -> local vertex
    stream_rv0: Optional[torch.Tensor] = None
    # [P, n_win_0 * tile_r] int32 round-0 window slot -> chunk rank
    stream_rank0: Optional[torch.Tensor] = None


def stack_shard_bundles(bundles: List[ShardPlanBundle]
                        ) -> StackedShardPlans:
    """Pad per-shard bundles to cross-shard maxima and stack them.

    Bucketed rows pad to each round's max row count, fused metadata tiles
    those padded rows into tile_r steps, streamed metadata pads each
    round's windows to the max (window count, window stride) — widening a
    window stride / appending all-pad windows never moves a real row's
    slot, so later rounds' slot-based gathers stay valid.
    """
    n_shards = len(bundles)
    spec = bundles[0].spec
    n_rounds = bundles[0].n_rounds
    chunk, k, tile_r = spec.chunk, spec.k, spec.tile_r
    per_round_rows = np.zeros((n_shards, n_rounds), dtype=np.int64)
    for p, b in enumerate(bundles):
        for r in range(n_rounds):
            per_round_rows[p, r] = b.rounds[r][1].shape[0]
    r_pads = per_round_rows.max(axis=0).clip(min=1)
    bucketed = spec.backend in BUCKETED
    round_gathers = []
    final_row_vertex = np.full((n_shards, int(r_pads[-1])), _PAD,
                               dtype=np.int32)
    row_vertex0 = np.full((n_shards, int(r_pads[0])), _PAD, dtype=np.int32)
    bucket_rank0 = np.zeros((n_shards, int(r_pads[0])), dtype=np.int32)
    for r in range(n_rounds):
        if bucketed:
            g = np.full((n_shards, int(r_pads[r]), chunk), _PAD,
                        dtype=np.int32)
        for p, b in enumerate(bundles):
            gather, row_vertex = b.rounds[r][:2]
            if bucketed:
                g[p, :len(gather)] = gather
            if r == 0:
                row_vertex0[p, :len(row_vertex)] = row_vertex
                bucket_rank0[p, :len(row_vertex)] = b.rounds[r][4]
            if r == n_rounds - 1:
                final_row_vertex[p, :len(row_vertex)] = row_vertex
        if bucketed:
            round_gathers.append(torch.from_numpy(g))
    max_rows0 = max(b.max_rows0 for b in bundles)

    fused_starts = fused_counts = fused_dmax = None
    fused_entries: tuple = ()
    fused_rv0 = fused_rank0 = None
    if spec.backend == "pallas_fused":
        fused_starts, fused_counts, fused_dmax, entries = [], [], [], []
        n_entries = bundles[0].n_entries
        for r in range(n_rounds):
            rows = int(r_pads[r])
            n_steps = -(-rows // tile_r)
            rs = np.zeros((n_shards, n_steps * tile_r), np.int32)
            rc = np.zeros((n_shards, n_steps * tile_r), np.int32)
            if r == 0:  # fused round-0 rows share the bucketed row order
                fv = np.full((n_shards, n_steps * tile_r), _PAD, np.int32)
                fv[:, :row_vertex0.shape[1]] = row_vertex0
                fused_rv0 = torch.from_numpy(fv)
                fr = np.zeros((n_shards, n_steps * tile_r), np.int32)
                fr[:, :bucket_rank0.shape[1]] = bucket_rank0
                fused_rank0 = torch.from_numpy(fr)
            for p, b in enumerate(bundles):
                row_start, row_count = b.rounds[r][2:4]
                rs[p, :len(row_start)] = row_start
                rc[p, :len(row_count)] = row_count
            rs = rs.reshape(n_shards, n_steps, tile_r)
            rc = rc.reshape(n_shards, n_steps, tile_r)
            fused_starts.append(torch.from_numpy(rs))
            fused_counts.append(torch.from_numpy(rc))
            fused_dmax.append(torch.from_numpy(rc.max(axis=2,
                                                      keepdims=True)))
            entries.append(n_entries)
            n_entries = n_steps * tile_r * k  # next round's flat source
        fused_starts = tuple(fused_starts)
        fused_counts = tuple(fused_counts)
        fused_dmax = tuple(fused_dmax)
        fused_entries = tuple(entries)

    stream_gathers = stream_starts = stream_counts = stream_dmax = None
    stream_final_rv = stream_rv0 = stream_rank0 = None
    if spec.backend == "pallas_stream":
        sg, ss, sc, sd = [], [], [], []
        for r in range(n_rounds):
            n_win = max(b.stream_rounds[r]["row_start"].shape[0]
                        for b in bundles)
            w_max = max(b.stream_rounds[r]["window_entries"]
                        for b in bundles)
            g = np.full((n_shards, n_win, w_max), _PAD, dtype=np.int32)
            rs = np.zeros((n_shards, n_win, tile_r), dtype=np.int32)
            rc = np.zeros((n_shards, n_win, tile_r), dtype=np.int32)
            dm = np.zeros((n_shards, n_win, 1), dtype=np.int32)
            for p, b in enumerate(bundles):
                rr = b.stream_rounds[r]
                nw, w_s = rr["row_start"].shape[0], rr["window_entries"]
                # widening the window stride / appending all-pad windows
                # never moves a real row's slot, so later rounds'
                # slot-based gathers stay valid
                g[p, :nw, :w_s] = rr["entry_gather"].reshape(nw, w_s)
                rs[p, :nw] = rr["row_start"]
                rc[p, :nw] = rr["row_count"]
                dm[p, :nw] = rr["step_dmax"]
            sg.append(torch.from_numpy(g))
            ss.append(torch.from_numpy(rs))
            sc.append(torch.from_numpy(rc))
            sd.append(torch.from_numpy(dm))
        stream_gathers, stream_starts = tuple(sg), tuple(ss)
        stream_counts, stream_dmax = tuple(sc), tuple(sd)
        n_slots_last = sg[-1].shape[1] * tile_r
        frv = np.full((n_shards, n_slots_last), _PAD, dtype=np.int32)
        for p, b in enumerate(bundles):
            frv[p, :len(b.stream_final_rtv)] = b.stream_final_rtv
        stream_final_rv = torch.from_numpy(frv)
        # round-0 window slot -> local vertex + chunk rank (appending
        # all-pad windows never moves a real slot, so the per-shard slot
        # maps pad safely: vertex -1, rank 0)
        n_slots0 = sg[0].shape[1] * tile_r
        srv0 = np.full((n_shards, n_slots0), _PAD, dtype=np.int32)
        srk0 = np.zeros((n_shards, n_slots0), dtype=np.int32)
        for p, b in enumerate(bundles):
            rv = b.stream_rounds[0]["row_to_vertex"]
            srv0[p, :len(rv)] = rv
            rk = b.stream_rounds[0]["row_rank"]
            srk0[p, :len(rk)] = rk
        stream_rv0 = torch.from_numpy(srv0)
        stream_rank0 = torch.from_numpy(srk0)

    return StackedShardPlans(
        n_rounds=n_rounds,
        round_gathers=tuple(round_gathers) if bucketed else None,
        final_row_vertex=torch.from_numpy(final_row_vertex),
        row_vertex0=torch.from_numpy(row_vertex0),
        bucket_rank0=torch.from_numpy(bucket_rank0),
        max_rows0=int(max_rows0),
        fused_starts=fused_starts, fused_counts=fused_counts,
        fused_dmax=fused_dmax, fused_entries=fused_entries,
        fused_rv0=fused_rv0, fused_rank0=fused_rank0,
        stream_gathers=stream_gathers, stream_starts=stream_starts,
        stream_counts=stream_counts, stream_dmax=stream_dmax,
        stream_final_rv=stream_final_rv, stream_rv0=stream_rv0,
        stream_rank0=stream_rank0)


def stack_aligned_windows(bundles: List[ShardPlanBundle],
                          tables: np.ndarray, weight_tables: np.ndarray
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply every shard's ``remap_labels`` transform and stack the
    results to the [P, n_win_0 * W] aligned position/weight tensors.

    ``tables[p]`` is shard p's per-entry label-table positions (the
    possibly halo-remapped ``nbr_pos`` row) and ``weight_tables[p]`` its
    per-entry weights; run AFTER any halo remap so the stored positions
    index the exchange mode's actual label table.
    """
    n_shards = len(bundles)
    n_win0 = max(b.stream_rounds[0]["row_start"].shape[0] for b in bundles)
    w_max0 = max(b.stream_rounds[0]["window_entries"] for b in bundles)
    ap = np.full((n_shards, n_win0, w_max0), _PAD, dtype=np.int32)
    aw = np.zeros((n_shards, n_win0, w_max0), dtype=np.float32)
    for p, b in enumerate(bundles):
        pos, wts = b.remap_labels(tables[p], weight_tables[p])
        nw, w_s = pos.shape
        ap[p, :nw, :w_s] = pos
        aw[p, :nw, :w_s] = wts
    return (torch.from_numpy(ap.reshape(n_shards, -1)),
            torch.from_numpy(aw.reshape(n_shards, -1)))
