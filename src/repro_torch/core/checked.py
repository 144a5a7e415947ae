"""Runtime contract checks around the fold engines.

A copy of ``repro.core.checked`` in torch. :class:`CheckedEngine` wraps
any FoldEngine and checks, at every fold entry point, the runtime
counterparts of the plans' static contracts:

  * **OOB** — every plan gather/slice index stays inside the entry array
    it reads;
  * **NaN** — entry weights are finite and non-negative going in, folded
    sketch weights are NaN-free coming out;
  * **labels** — move selections return real (non-negative) labels.

The reference asserts them through ``jax.experimental.checkify`` user
checks; here each check is an eager torch reduction whose result is read
on the host, so a check on the card synchronises once. A failed check
raises :class:`ContractError` with the reference's message. The checks
launch none of the port's kernels, so a checked run's
``LAUNCH_COUNTS`` equal an unchecked run's.

The wrapper is a validation mode: the parity suites under
``REPRO_CHECKED=1`` and ad-hoc debugging. ``lpa_move`` resolves its
engine with ``checked=False``, so the LPA loop never pays for it.
"""
from __future__ import annotations

import torch

__all__ = ["CheckedEngine", "ContractError"]


class ContractError(RuntimeError):
    """A runtime contract of a fold entry point failed."""


def _check(ok: torch.Tensor, message: str) -> None:
    """Raise :class:`ContractError` with ``message`` unless ``ok`` (a 0-d
    bool tensor) holds."""
    if not bool(ok):
        raise ContractError(message)


def _entries_contract(entry_labels, entry_weights) -> None:
    del entry_labels  # labels are opaque ids; only the weights carry NaN risk
    _check(torch.all(torch.isfinite(entry_weights)),
           "NaN/inf entry weight fed to the fold")
    _check(torch.all(entry_weights >= 0),
           "negative entry weight fed to the fold")


def _labels_contract(labels) -> None:
    _check(torch.all(labels >= 0), "negative input label")


def _bucket_plan_contract(plan) -> None:
    """FoldPlan (jnp/pallas backends): bucket gathers stay inside each
    round's flat entry array."""
    for rnd in plan.rounds:
        for bucket in rnd.buckets:
            _check(torch.all(bucket.gather < rnd.n_entries_in),
                   "bucket gather index past the round's entry array (OOB)")
            _check(torch.all(bucket.gather >= -1),
                   "bucket gather index below the -1 pad sentinel")


def _fused_plan_contract(plan) -> None:
    """FusedFoldPlan: each row's entry window stays inside the round's
    flat entry array."""
    for rnd in plan.rounds:
        _check(torch.all(rnd.row_count >= 0), "negative fused row count")
        _check(torch.all(rnd.row_start + rnd.row_count <= rnd.n_entries_in),
               "fused row window past the round's entry array (OOB)")


def _stream_plan_contract(plan) -> None:
    """StreamedFoldPlan: window gathers stay inside the source array and
    every row's full-chunk slice stays inside its window. Aligned plans
    also keep every aligned slot's vertex inside [0, n_nodes] (n_nodes is
    the pad sentinel that ``lpa_move``'s extended label gather absorbs),
    with non-negative finite weights, 0.0 on pad slots."""
    chunk = plan.chunk
    for rnd in plan.rounds:
        _check(torch.all(rnd.entry_gather < rnd.n_entries_in),
               "window gather index past the source entries (OOB)")
        _check(torch.all(rnd.entry_gather >= -1),
               "window gather index below the -1 pad sentinel")
        _check(torch.all((rnd.row_count == 0)
                         | (rnd.row_start + chunk <= rnd.window_entries)),
               "row's full-chunk slice overruns its window (OOB)")
    if plan.aligned_entry_vertex is not None:
        aev = plan.aligned_entry_vertex
        _check(torch.all((aev >= 0) & (aev <= plan.n_nodes)),
               "aligned entry vertex outside [0, n_nodes] (OOB for the "
               "driver's sentinel-extended label gather)")
        aew = plan.aligned_entry_weights
        _check(torch.all(torch.isfinite(aew) & (aew >= 0)),
               "aligned entry weight NaN/inf/negative")
        _check(torch.all((aev != plan.n_nodes) | (aew == 0.0)),
               "aligned pad slot carries a non-zero weight (would vote)")


def _candidates_contract(cand, wts) -> None:
    _check(torch.all(~torch.isnan(wts)), "NaN folded sketch weight")
    _check(torch.all(cand >= -1),
           "candidate label below the -1 empty sentinel")


def _selection_contract(out) -> None:
    _check(torch.all(out >= 0), "move selection produced a negative label")


class CheckedEngine:
    """A FoldEngine proxy asserting the OOB/NaN/label contracts around
    every fold entry point.

    Metadata (``name``, the ``uses_*_plan`` flags, dispatch accounting)
    delegates to the wrapped engine untouched, so a checked engine stands
    in for the bare one wherever an engine is consumed.
    """

    checked = True

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def __repr__(self):
        return f"CheckedEngine({self._inner!r})"

    def _pre(self, plan, aux_plan, entry_labels, entry_weights) -> None:
        _entries_contract(entry_labels, entry_weights)
        if self._inner.uses_fused_plan:
            if aux_plan is not None:  # None: the engine raises its own error
                _fused_plan_contract(aux_plan)
        elif self._inner.uses_stream_plan:
            if aux_plan is not None:
                _stream_plan_contract(aux_plan)
        elif plan is not None:
            _bucket_plan_contract(plan)

    # -- tile-level folds --------------------------------------------------

    def mg_fold_tile(self, labels, weights, k):
        _entries_contract(labels, weights)
        s_k, s_v = self._inner.mg_fold_tile(labels, weights, k)
        _candidates_contract(s_k, s_v)
        return s_k, s_v

    def bm_fold_tile(self, labels, weights, init_label=None):
        _entries_contract(labels, weights)
        ck, wk = self._inner.bm_fold_tile(labels, weights, init_label)
        _candidates_contract(ck, wk)
        return ck, wk

    # -- the routed entry point --------------------------------------------

    def run(self, bundle, request, entry_labels, entry_weights, labels):
        """One contract wrapper around the routed fold: the contracts do
        not depend on where the request routes (sparse mode only changes
        which rows fold), so it covers every family and mode. Plans are
        looked up in the bundle as the wrapped engine's ``run`` does, which
        then routes the request itself."""
        self._pre(bundle.plan, bundle.aux_for(self._inner), entry_labels,
                  entry_weights)
        _labels_contract(labels)
        outcome = self._inner.run(bundle, request, entry_labels,
                                  entry_weights, labels)
        _selection_contract(outcome.want)
        if outcome.bm_label is not None:
            _candidates_contract(outcome.bm_label, outcome.bm_weight)
        return outcome

    # -- family executors --------------------------------------------------
    # Explicit wrappers: __getattr__ would delegate these unchecked,
    # silently dropping the contracts for callers of one family.

    def mg_candidates(self, plan, aux_plan, entry_labels, entry_weights):
        self._pre(plan, aux_plan, entry_labels, entry_weights)
        cand, wts = self._inner.mg_candidates(plan, aux_plan, entry_labels,
                                              entry_weights)
        _candidates_contract(cand, wts)
        return cand, wts

    def mg_select(self, plan, aux_plan, entry_labels, entry_weights, labels,
                  seed, *, selection=None):
        self._pre(plan, aux_plan, entry_labels, entry_weights)
        _labels_contract(labels)
        out = self._inner.mg_select(plan, aux_plan, entry_labels,
                                    entry_weights, labels, seed,
                                    selection=selection)
        _selection_contract(out)
        return out

    def mg_rescan(self, plan, aux_plan, entry_labels, entry_weights, labels,
                  seed, *, selection=None):
        self._pre(plan, aux_plan, entry_labels, entry_weights)
        _labels_contract(labels)
        out = self._inner.mg_rescan(plan, aux_plan, entry_labels,
                                    entry_weights, labels, seed,
                                    selection=selection)
        _selection_contract(out)
        return out

    def bm_fold_plan(self, plan, aux_plan, entry_labels, entry_weights,
                     labels, *, selection=None):
        self._pre(plan, aux_plan, entry_labels, entry_weights)
        _labels_contract(labels)
        c, w = self._inner.bm_fold_plan(plan, aux_plan, entry_labels,
                                        entry_weights, labels,
                                        selection=selection)
        _candidates_contract(c, w)
        return c, w
