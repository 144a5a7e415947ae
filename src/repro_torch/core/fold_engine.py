"""FoldEngine: backend selection for the sketch folds.

A copy of the single-host half of ``repro.core.fold_engine``. Consumers
build a :class:`repro_torch.core.fold_program.FoldRequest` and call
:meth:`FoldEngine.run`, which routes it to the backend's family
executor and returns a :class:`FoldOutcome`:

  * **MG** (``mg_select``, plus ``mg_candidates`` for raw candidate sets);
  * **MG + rescan** (``mg_rescan``): the double-scan ablation, which
    re-scores the k candidates exactly against round 0 before selecting
    (paper §4.4);
  * **BM** (``bm_fold_plan``): round 0 folded into per-row weighted
    Boyer-Moore states, max-reduce-merged per vertex (paper Alg. 3 /
    §4.7).

Sparse (frontier-compacted) execution is a mode, not a family: ``run``
lowers ``mode="sparse"`` to a ``RoundSelection`` threaded into the same
executors; the fused and streamed drivers compact their launches to the
frontier's rows or windows, the bucketed engines fold densely.

Backend names are the reference's, so one ``LPAConfig`` means the same
thing in both packages:

  * ``jnp``          — the plain-torch bucketed reference engine
                       (``repro_torch.core.sketch``), on any device; the
                       only host of the ``exact_weighted`` MG variant;
  * ``pallas``       — the per-bucket engine: the bucketed plan walk of
                       ``jnp`` with each bucket's padded [R, D] tile (a
                       plain torch gather) folded by a hand-written CUDA
                       kernel (``repro_torch.kernels.mg_sketch.ops``): per
                       MG iteration one K9 launch per bucket per round,
                       per BM iteration one K10 launch per round-0 bucket;
                       the rescan's second scan is plain torch;
  * ``pallas_fused`` — the hand-written CUDA fused engine
                       (``repro_torch.kernels.mg_sketch.fused``): per MG
                       iteration one K1 launch per round but the last and
                       one K2 launch that folds the last round and selects;
                       per rescan iteration one K1 launch per round and one
                       K4 launch; per BM iteration one K3 launch.
  * ``pallas_stream`` — the hand-written CUDA streamed engine
                       (``repro_torch.kernels.mg_sketch.streaming``): the
                       same launch structure over the windowed plan, with
                       K5/K6 for the MG rounds, K7 for BM and K8 for the
                       rescan; each unaligned round first re-lays its
                       entries into windows (a plain torch gather).

``"auto"`` resolves exactly as the reference does (:func:`resolve_auto`,
whose budget constant is the reference's TPU VMEM figure, kept so that
the resolved name agrees: past 8 MiB of round-0 entries it picks
``pallas_stream``). No request falls back to another engine.

``get_engine(..., checked=True)``, or the ``REPRO_CHECKED`` environment
variable, wraps the engine in the contract proxy of
``repro_torch.core.checked``.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Optional, Tuple

import torch

if TYPE_CHECKING:  # import-time cycle guard: plan_bundle imports this module
    from repro_torch.core.plan_bundle import PlanBundle

from repro_torch.core import sketch as sketch_lib
from repro_torch.core.fold_program import (FoldOutcome, FoldRequest,
                                           RoundSelection)
from repro_torch.graphs.csr import (FoldPlan, fused_dispatches,
                                    plan_dispatches, plan_round0_dispatches,
                                    streamed_dispatches)
from repro_torch.trace import span

#: The reference's "auto" budget (bytes) for the fused engine's round-0
#: entry arrays (labels int32 + weights float32 = 8 bytes/entry). It is a
#: TPU VMEM figure; it is kept unchanged so that "auto" resolves to the
#: same backend name in both packages, and says nothing about the H100.
DEFAULT_VMEM_BUDGET_BYTES = 8 * 2**20

#: bytes per round-0 entry (int32 label + float32 weight)
_BYTES_PER_ENTRY = 8


def _require_plan(aux_plan, engine: str, plan_name: str):
    """Guard for the plan-consuming engines: the aux plan is built by
    build_workspace exactly when the config selects the engine."""
    if aux_plan is None:
        raise ValueError(f"{engine} engine needs a {plan_name} "
                         f"(build_workspace constructs one when "
                         f"fold_backend={engine!r})")
    return aux_plan


class FoldEngine:
    """Backend-neutral interface; subclasses wire the actual kernels."""

    name: str = "base"
    #: does mg_select consume the FusedFoldPlan (vs the bucketed FoldPlan)?
    uses_fused_plan: bool = False
    #: does mg_select consume the StreamedFoldPlan?
    uses_stream_plan: bool = False

    def run(self, bundle: "PlanBundle", request: FoldRequest,
            entry_labels, entry_weights, labels) -> FoldOutcome:
        """Execute one fold iteration described by ``request``:
        ``family="bm"`` -> :meth:`bm_fold_plan` (the -1 "no candidate"
        sentinel resolved to the incumbent here, once), ``rescan=True`` ->
        :meth:`mg_rescan`, otherwise :meth:`mg_select`.

        ``mode="sparse"`` lowers the request's frontier and capacity into
        a :class:`RoundSelection` threaded to the executor. The caller
        (``lpa()``'s loop) guarantees the frontier fits ``cap_rows`` and
        sends a dense request on overflow. On every engine ``want`` then
        equals the dense request's on the frontier's vertices; the gate
        masks the rest."""
        plan, aux_plan = bundle.plan, bundle.aux_for(self)
        selection = None
        if request.mode == "sparse":
            selection = RoundSelection(frontier=request.frontier,
                                       cap_rows=request.cap_rows)
        with span("fold"):
            if request.family == "bm":
                best, weight = self.bm_fold_plan(plan, aux_plan,
                                                 entry_labels, entry_weights,
                                                 labels, selection=selection)
                want = torch.where(best >= 0, best, labels)
                return FoldOutcome(want=want, bm_label=best,
                                   bm_weight=weight)
            executor = self.mg_rescan if request.rescan else self.mg_select
            want = executor(plan, aux_plan, entry_labels, entry_weights,
                            labels, request.seed, selection=selection)
        return FoldOutcome(want=want)

    # -- tile-level folds (signatures of repro_torch.core.sketch's
    #    mg_fold_tile/bm_fold_tile; the bucketed plan walk plugs them in)
    def mg_fold_tile(self, labels, weights, k):
        raise NotImplementedError

    def bm_fold_tile(self, labels, weights, init_label=None):
        raise NotImplementedError

    # -- family executors. ``selection=None`` means dense (every plan row);
    #    a RoundSelection compacts the fused and streamed launches to the
    #    frontier (the bucketed jnp/pallas layouts have no row compaction
    #    and fold densely either way)
    def mg_candidates(self, plan: FoldPlan, aux_plan,
                      entry_labels, entry_weights
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-vertex candidate sets ([N, k] labels, [N, k] weights)."""
        raise NotImplementedError

    def mg_select(self, plan: FoldPlan, aux_plan,
                  entry_labels, entry_weights, labels, seed, *,
                  selection: Optional[RoundSelection] = None
                  ) -> torch.Tensor:
        """Full iteration: fold + move selection -> wanted label per vertex
        ([N] int32)."""
        raise NotImplementedError

    def mg_rescan(self, plan: FoldPlan, aux_plan,
                  entry_labels, entry_weights, labels, seed, *,
                  selection: Optional[RoundSelection] = None
                  ) -> torch.Tensor:
        """Full double-scan iteration (paper §4.4): MG fold, then re-read
        the round-0 neighbourhood to score the k candidates exactly, then
        select -> wanted label per vertex ([N] int32)."""
        raise NotImplementedError

    def bm_fold_plan(self, plan: FoldPlan, aux_plan, entry_labels,
                     entry_weights, labels, *,
                     selection: Optional[RoundSelection] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """νBM iteration core -> per-vertex ([N] int32 majority label, -1
        when the vertex has no entries; [N] float32 vote weight)."""
        raise NotImplementedError

    def dispatches_per_iter(self, plan: FoldPlan, aux_plan,
                            request: FoldRequest) -> int:
        """Kernel launches one ``request`` iteration costs on this engine;
        ``mode`` never changes the count (sparse compacts the launches'
        rows, not their number)."""
        raise NotImplementedError


class _BucketedEngine(FoldEngine):
    """The bucketed plan walk of ``repro_torch.core.sketch`` over the
    engine's tile folds: what the ``jnp`` and ``pallas`` engines share.
    A ``selection`` is ignored: the bucketed layout has no row compaction,
    so the fold is dense and the gate in ``lpa_move`` masks the moves."""

    def mg_candidates(self, plan, aux_plan, entry_labels, entry_weights):
        s_k, s_v = sketch_lib.run_mg_plan(plan, entry_labels, entry_weights,
                                          fold_tile=self.mg_fold_tile)
        return sketch_lib.scatter_rows(plan, s_k, s_v)

    def mg_select(self, plan, aux_plan, entry_labels, entry_weights,
                  labels, seed, *, selection=None):
        s_k, s_v = sketch_lib.run_mg_plan(plan, entry_labels, entry_weights,
                                          fold_tile=self.mg_fold_tile)
        return sketch_lib.select_best(plan, s_k, s_v, labels, seed)

    def mg_rescan(self, plan, aux_plan, entry_labels, entry_weights,
                  labels, seed, *, selection=None):
        # the second (re-scoring) scan is a plain torch pass over the
        # bucketed round-0 tiles; only the MG fold uses the tile fold
        s_k, _ = sketch_lib.run_mg_plan(plan, entry_labels, entry_weights,
                                        fold_tile=self.mg_fold_tile)
        return sketch_lib.rescan_candidates(plan, s_k, entry_labels,
                                            entry_weights, labels, seed)

    def bm_fold_plan(self, plan, aux_plan, entry_labels, entry_weights,
                     labels, *, selection=None):
        return sketch_lib.run_bm_plan(plan, entry_labels, entry_weights,
                                      labels, fold_tile=self.bm_fold_tile)


class JnpEngine(_BucketedEngine):
    """Dense plain-torch reference (repro_torch.core.sketch); the
    bit-exactness oracle for the CUDA engines, and the only host of the
    ``exact_weighted`` MG variant. Named ``jnp`` after the reference
    engine it copies."""

    name = "jnp"

    def __init__(self, mg_variant: str = "paper"):
        self.mg_variant = mg_variant

    def mg_fold_tile(self, labels, weights, k):
        if self.mg_variant == "exact_weighted":
            return sketch_lib.mg_fold_tile_exact_weighted(labels, weights, k)
        return sketch_lib.mg_fold_tile(labels, weights, k)

    def bm_fold_tile(self, labels, weights, init_label=None):
        return sketch_lib.bm_fold_tile(labels, weights, init_label)

    def dispatches_per_iter(self, plan, aux_plan, request):
        return 0  # plain torch — no hand-written kernel launches


class _KernelTileFolds:
    """The per-bucket CUDA tile folds (K9, K10) as a kernel engine's
    tile-level hooks, as the reference gives its Pallas engines the
    per-bucket Pallas kernels."""

    # the kernel modules import repro_torch.core.sketch, whose package
    # imports this module: import them at call time, not at import time
    def mg_fold_tile(self, labels, weights, k):
        from repro_torch.kernels.mg_sketch import ops
        return ops.mg_fold_tile_pallas(labels, weights, k)

    def bm_fold_tile(self, labels, weights, init_label=None):
        from repro_torch.kernels.mg_sketch import ops
        return ops.bm_fold_tile_pallas(labels, weights, init_label)


class PallasEngine(_KernelTileFolds, _BucketedEngine):
    """Per-bucket CUDA tile kernels K9/K10 on the bucketed plan (the
    reference's pre-fusion baseline). Named ``pallas`` after the
    reference engine it ports."""

    name = "pallas"

    def dispatches_per_iter(self, plan, aux_plan, request):
        if request.family == "bm":
            return plan_round0_dispatches(plan)  # one K10 per round-0 bucket
        # mg, with or without rescan: one K9 per bucket per round (the
        # rescan's second scan is plain torch, not a kernel launch)
        return plan_dispatches(plan)


class PallasFusedEngine(_KernelTileFolds, FoldEngine):
    """Whole-round fused CUDA kernels — see kernels.mg_sketch.fused. Named
    ``pallas_fused`` after the reference engine it ports. MG, BM and the
    rescan run plan-level launches; the tile folds (K9/K10) serve
    tile-level callers only."""

    name = "pallas_fused"
    uses_fused_plan = True

    def mg_candidates(self, plan, fused_plan, entry_labels, entry_weights):
        from repro_torch.kernels.mg_sketch.fused import run_mg_plan_fused
        _require_plan(fused_plan, 'pallas_fused', 'FusedFoldPlan')
        s_k, s_v = run_mg_plan_fused(fused_plan, entry_labels, entry_weights)
        return _scatter_padded_rows(fused_plan.n_nodes, fused_plan.k,
                                    fused_plan.row_to_vertex, s_k, s_v)

    def mg_select(self, plan, fused_plan, entry_labels, entry_weights,
                  labels, seed, *, selection=None):
        from repro_torch.kernels.mg_sketch.fused import select_best_fused
        _require_plan(fused_plan, 'pallas_fused', 'FusedFoldPlan')
        return select_best_fused(fused_plan, entry_labels, entry_weights,
                                 labels, seed, selection=selection)

    def mg_rescan(self, plan, fused_plan, entry_labels, entry_weights,
                  labels, seed, *, selection=None):
        from repro_torch.kernels.mg_sketch.fused import rescan_select_fused
        _require_plan(fused_plan, 'pallas_fused', 'FusedFoldPlan')
        return rescan_select_fused(fused_plan, entry_labels, entry_weights,
                                   labels, seed, selection=selection)

    def bm_fold_plan(self, plan, fused_plan, entry_labels, entry_weights,
                     labels, *, selection=None):
        from repro_torch.kernels.mg_sketch.fused import run_bm_plan_fused
        _require_plan(fused_plan, 'pallas_fused', 'FusedFoldPlan')
        return run_bm_plan_fused(fused_plan, entry_labels, entry_weights,
                                 labels, selection=selection)

    def dispatches_per_iter(self, plan, fused_plan, request):
        if request.family == "bm":
            return 1  # the BM fold only ever walks round 0 (K3)
        if request.rescan:
            # all fold rounds (K1) + one rescan of round 0 (K4)
            return fused_dispatches(fused_plan) + 1
        return fused_dispatches(fused_plan)  # n_rounds (the last one selects)


class PallasStreamEngine(_KernelTileFolds, FoldEngine):
    """Windowed CUDA kernels — see kernels.mg_sketch.streaming. Named
    ``pallas_stream`` after the reference engine it ports. Same launch
    structure as ``pallas_fused`` (one launch per round, the last one
    selecting; one round-0 launch for BM and for the rescan pass), over
    the windowed plan. The tile folds (K9/K10) serve tile-level callers
    only."""

    name = "pallas_stream"
    uses_stream_plan = True

    def mg_candidates(self, plan, stream_plan, entry_labels, entry_weights):
        from repro_torch.kernels.mg_sketch.streaming import run_mg_plan_stream
        _require_plan(stream_plan, 'pallas_stream', 'StreamedFoldPlan')
        s_k, s_v = run_mg_plan_stream(stream_plan, entry_labels,
                                      entry_weights)
        return _scatter_padded_rows(stream_plan.n_nodes, stream_plan.k,
                                    stream_plan.row_to_vertex, s_k, s_v)

    def mg_select(self, plan, stream_plan, entry_labels, entry_weights,
                  labels, seed, *, selection=None):
        from repro_torch.kernels.mg_sketch.streaming import select_best_stream
        _require_plan(stream_plan, 'pallas_stream', 'StreamedFoldPlan')
        return select_best_stream(stream_plan, entry_labels, entry_weights,
                                  labels, seed, selection=selection)

    def mg_rescan(self, plan, stream_plan, entry_labels, entry_weights,
                  labels, seed, *, selection=None):
        from repro_torch.kernels.mg_sketch.streaming import (
            rescan_select_stream)
        _require_plan(stream_plan, 'pallas_stream', 'StreamedFoldPlan')
        return rescan_select_stream(stream_plan, entry_labels,
                                    entry_weights, labels, seed,
                                    selection=selection)

    def bm_fold_plan(self, plan, stream_plan, entry_labels, entry_weights,
                     labels, *, selection=None):
        from repro_torch.kernels.mg_sketch.streaming import run_bm_plan_stream
        _require_plan(stream_plan, 'pallas_stream', 'StreamedFoldPlan')
        return run_bm_plan_stream(stream_plan, entry_labels, entry_weights,
                                  labels, selection=selection)

    def dispatches_per_iter(self, plan, stream_plan, request):
        if request.family == "bm":
            return 1  # one K7 launch; the round-0 window grid lives inside
        if request.rescan:
            # all fold rounds (K5) + one rescan of round 0 (K8)
            return streamed_dispatches(stream_plan) + 1
        return streamed_dispatches(stream_plan)  # n_rounds (last: K6)


def _scatter_padded_rows(n: int, k: int, row_to_vertex, s_k, s_v
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter padded per-row sketches to per-vertex candidate sets (the
    fused and the streamed engines' shared tail).

    ``row_to_vertex`` [rows] int32 (-1 on pad rows) maps each padded row of
    ``s_k``/``s_v`` [rows, k] to its owning vertex. Real rows own distinct
    vertices; pad rows all land in the dump slot n, which is sliced off.
    Returns ([N, k] int32 candidate labels with -1 empties, [N, k]
    float32 weights).
    """
    dev = s_k.device
    safe = torch.where(row_to_vertex >= 0, row_to_vertex, n).long()
    cand_c = torch.full((n + 1, k), -1, dtype=torch.int32, device=dev)
    cand_w = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
    cand_c[safe] = s_k
    cand_w[safe] = s_v
    return cand_c[:n], cand_w[:n]


#: Fold backends, resolvable by name. ``"auto"`` additionally resolves to
#: one of the last two per graph (see :func:`resolve_auto`).
ENGINES = ("jnp", "pallas", "pallas_fused", "pallas_stream")


def resolve_auto(n_entries: int,
                 vmem_budget_bytes: Optional[int] = None) -> str:
    """Pick ``pallas_fused`` vs ``pallas_stream`` for a graph, as the
    reference does: ``pallas_fused`` while ``8 * n_entries`` bytes fit
    ``vmem_budget_bytes`` (default :data:`DEFAULT_VMEM_BUDGET_BYTES`)."""
    budget = (DEFAULT_VMEM_BUDGET_BYTES if vmem_budget_bytes is None
              else vmem_budget_bytes)
    return ("pallas_fused" if n_entries * _BYTES_PER_ENTRY <= budget
            else "pallas_stream")


def _maybe_checked(engine: FoldEngine, checked: Optional[bool]):
    """Wrap an engine in the contract proxy when asked.

    ``checked=None`` defers to the ``REPRO_CHECKED`` environment variable
    (how the parity suites opt every ``get_engine`` call in at once): on
    unless it is unset, empty, ``0`` or ``false``. Unchecked, the bare
    engine is returned.
    """
    if checked is None:
        checked = os.environ.get("REPRO_CHECKED", "0").lower() \
            not in ("", "0", "false")
    if not checked:
        return engine
    from repro_torch.core.checked import CheckedEngine
    return CheckedEngine(engine)


def get_engine(name: str, mg_variant: str = "paper", *,
               n_entries: Optional[int] = None,
               vmem_budget_bytes: Optional[int] = None,
               checked: Optional[bool] = None) -> FoldEngine:
    """Resolve a fold backend by config name.

    ``mg_variant='exact_weighted'`` is honoured on the jnp engine only;
    the kernel engines always compute the paper's Alg. 2 rule, as the
    reference's do. ``name="auto"`` picks from the round-0 entry volume
    ``n_entries`` (:func:`resolve_auto`).

    ``checked=True`` (or ``REPRO_CHECKED=1`` with ``checked=None``) wraps
    the engine in :class:`repro_torch.core.checked.CheckedEngine`, which
    checks the OOB/NaN/label contracts around every fold (one host sync
    per check on the card); ``lpa_move`` passes ``checked=False``.
    """
    if name == "auto":
        if n_entries is None:
            raise ValueError("get_engine('auto') needs n_entries (the "
                             "round-0 entry volume) to resolve the policy")
        name = resolve_auto(n_entries, vmem_budget_bytes)
    if name == "jnp":
        return _maybe_checked(JnpEngine(mg_variant=mg_variant), checked)
    if name == "pallas":
        return _maybe_checked(PallasEngine(), checked)
    if name == "pallas_fused":
        return _maybe_checked(PallasFusedEngine(), checked)
    if name == "pallas_stream":
        return _maybe_checked(PallasStreamEngine(), checked)
    raise ValueError(f"unknown fold backend {name!r}; expected one of "
                     f"{ENGINES + ('auto',)}")
