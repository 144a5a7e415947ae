"""FoldEngine: backend selection for the sketch folds.

A copy of the single-host half of ``repro.core.fold_engine``. Consumers
build a :class:`repro_torch.core.fold_program.FoldRequest` and call
:meth:`FoldEngine.run`, which routes it to the backend's executor and
returns a :class:`FoldOutcome`. Backend names are the reference's, so one
``LPAConfig`` means the same thing in both packages:

  * ``jnp``          — the plain-torch bucketed reference engine
                       (``repro_torch.core.sketch``), on any device;
  * ``pallas_fused`` — the hand-written CUDA fused engine
                       (``repro_torch.kernels.mg_sketch.fused``): one K1
                       launch per round but the last, and one K2 launch
                       that folds the last round and selects.

``"auto"`` resolves exactly as the reference does (:func:`resolve_auto`,
whose budget constant is the reference's TPU VMEM figure, kept so that
the resolved name agrees). What this package does not port yet — the
``pallas`` and ``pallas_stream`` backends, the BM family, the rescan
ablation, sparse mode and the ``exact_weighted`` variant — raises
``NotImplementedError`` naming its ``ROADMAP.md`` queue item; no request
falls back to another engine.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import torch

if TYPE_CHECKING:  # import-time cycle guard: plan_bundle imports this module
    from repro_torch.core.plan_bundle import PlanBundle

from repro_torch.core import sketch as sketch_lib
from repro_torch.core.fold_program import FoldOutcome, FoldRequest
from repro_torch.graphs.csr import FoldPlan, fused_dispatches

#: The reference's "auto" budget (bytes) for the fused engine's round-0
#: entry arrays (labels int32 + weights float32 = 8 bytes/entry). It is a
#: TPU VMEM figure; it is kept unchanged so that "auto" resolves to the
#: same backend name in both packages, and says nothing about the H100.
DEFAULT_VMEM_BUDGET_BYTES = 8 * 2**20

#: bytes per round-0 entry (int32 label + float32 weight)
_BYTES_PER_ENTRY = 8


def unported(what: str, item: str) -> NotImplementedError:
    """The error for a part of the reference this package has not ported."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


def _require_plan(aux_plan, engine: str, plan_name: str):
    """Guard for the plan-consuming engines: the aux plan is built by
    build_workspace exactly when the config selects the engine."""
    if aux_plan is None:
        raise ValueError(f"{engine} engine needs a {plan_name} "
                         f"(build_workspace constructs one when "
                         f"fold_backend={engine!r})")
    return aux_plan


def _check_request(request: FoldRequest) -> None:
    if request.family == "bm":
        raise unported("the BM family (method='bm')", "Queue 1 item 6")
    if request.rescan:
        raise unported("the rescan ablation (rescan=True)", "Queue 1 item 6")
    if request.mode == "sparse":
        raise unported("sparse frontier mode", "Queue 1 item 7")


class FoldEngine:
    """Backend-neutral interface; subclasses wire the actual kernels."""

    name: str = "base"
    #: does mg_select consume the FusedFoldPlan (vs the bucketed FoldPlan)?
    uses_fused_plan: bool = False

    def run(self, bundle: "PlanBundle", request: FoldRequest,
            entry_labels, entry_weights, labels) -> FoldOutcome:
        """Execute one fold iteration described by ``request``: the dense
        MG family goes to :meth:`mg_select`; the rest of the request space
        raises ``NotImplementedError``."""
        _check_request(request)
        want = self.mg_select(bundle.plan, bundle.aux_for(self),
                              entry_labels, entry_weights, labels,
                              request.seed)
        return FoldOutcome(want=want)

    def mg_candidates(self, plan: FoldPlan, aux_plan,
                      entry_labels, entry_weights
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-vertex candidate sets ([N, k] labels, [N, k] weights)."""
        raise NotImplementedError

    def mg_select(self, plan: FoldPlan, aux_plan,
                  entry_labels, entry_weights, labels, seed) -> torch.Tensor:
        """Full iteration: fold + move selection -> wanted label per vertex
        ([N] int32)."""
        raise NotImplementedError

    def dispatches_per_iter(self, plan: FoldPlan, aux_plan,
                            request: FoldRequest) -> int:
        """Kernel launches one ``request`` iteration costs on this engine."""
        raise NotImplementedError


class JnpEngine(FoldEngine):
    """Dense plain-torch reference (repro_torch.core.sketch); the
    bit-exactness oracle for the CUDA engine. Named ``jnp`` after the
    reference engine it copies."""

    name = "jnp"

    def __init__(self, mg_variant: str = "paper"):
        if mg_variant != "paper":
            raise unported(f"mg_variant={mg_variant!r}", "Queue 1 item 9")
        self.mg_variant = mg_variant

    def mg_candidates(self, plan, fused_plan, entry_labels, entry_weights):
        s_k, s_v = sketch_lib.run_mg_plan(plan, entry_labels, entry_weights)
        return sketch_lib.scatter_rows(plan, s_k, s_v)

    def mg_select(self, plan, fused_plan, entry_labels, entry_weights,
                  labels, seed):
        s_k, s_v = sketch_lib.run_mg_plan(plan, entry_labels, entry_weights)
        return sketch_lib.select_best(plan, s_k, s_v, labels, seed)

    def dispatches_per_iter(self, plan, fused_plan, request):
        return 0  # plain torch — no hand-written kernel launches


class PallasFusedEngine(FoldEngine):
    """Whole-round fused CUDA kernels — see kernels.mg_sketch.fused. Named
    ``pallas_fused`` after the reference engine it ports."""

    name = "pallas_fused"
    uses_fused_plan = True

    # the kernel module imports repro_torch.core.sketch, whose package
    # imports this module: import it at call time, not at import time
    def mg_candidates(self, plan, fused_plan, entry_labels, entry_weights):
        from repro_torch.kernels.mg_sketch.fused import run_mg_plan_fused
        _require_plan(fused_plan, 'pallas_fused', 'FusedFoldPlan')
        s_k, s_v = run_mg_plan_fused(fused_plan, entry_labels, entry_weights)
        return _scatter_padded_rows(fused_plan.n_nodes, fused_plan.k,
                                    fused_plan.row_to_vertex, s_k, s_v)

    def mg_select(self, plan, fused_plan, entry_labels, entry_weights,
                  labels, seed):
        from repro_torch.kernels.mg_sketch.fused import select_best_fused
        _require_plan(fused_plan, 'pallas_fused', 'FusedFoldPlan')
        return select_best_fused(fused_plan, entry_labels, entry_weights,
                                 labels, seed)

    def dispatches_per_iter(self, plan, fused_plan, request):
        _check_request(request)
        return fused_dispatches(fused_plan)  # n_rounds (the last one selects)


def _scatter_padded_rows(n: int, k: int, row_to_vertex, s_k, s_v
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter padded per-row sketches to per-vertex candidate sets.

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


def get_engine(name: str, mg_variant: str = "paper", *,
               n_entries: Optional[int] = None,
               vmem_budget_bytes: Optional[int] = None) -> FoldEngine:
    """Resolve a fold backend by config name.

    ``mg_variant='exact_weighted'`` is not ported (the reference hosts it
    on the jnp engine only; its kernel engines always compute the paper's
    Alg. 2 rule). ``name="auto"`` picks from the round-0 entry volume
    ``n_entries`` (:func:`resolve_auto`).
    """
    if name == "auto":
        if n_entries is None:
            raise ValueError("get_engine('auto') needs n_entries (the "
                             "round-0 entry volume) to resolve the policy")
        name = resolve_auto(n_entries, vmem_budget_bytes)
    if name == "jnp":
        return JnpEngine(mg_variant=mg_variant)
    if name == "pallas_fused":
        return PallasFusedEngine()
    if name == "pallas":
        raise unported("the per-bucket 'pallas' backend", "Queue 1 item 9")
    if name == "pallas_stream":
        raise unported("the streamed 'pallas_stream' backend",
                       "Queue 1 item 8")
    raise ValueError(f"unknown fold backend {name!r}; expected one of "
                     f"{ENGINES + ('auto',)}")
