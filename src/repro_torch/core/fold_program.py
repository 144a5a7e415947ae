"""The FoldRequest IR: one declarative description of a fold iteration.

A copy of ``repro.core.fold_program``. Every consumer builds a
:class:`FoldRequest` and hands it to ``FoldEngine.run``::

    request = FoldRequest(family="mg", seed=seed)
    outcome = engine.run(bundle, request, entry_labels,
                         entry_weights, labels)

``run`` routes the request to the backend's family executor and returns a
:class:`FoldOutcome` whose ``want`` is always the per-vertex selection.
The request space is the reference's, validation included; the engines of
this package raise ``NotImplementedError`` for the parts of it that are
not ported yet (the BM family, the rescan ablation, sparse mode).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["FAMILIES", "MODES", "FoldRequest", "RoundSelection",
           "FoldOutcome"]

#: sketch families a request can name (the rescan ablation is a flag on
#: the mg family, not a family of its own — it reuses the MG fold)
FAMILIES = ("mg", "bm")

#: execution modes: dense folds every plan row, sparse folds only the
#: frontier-compacted rows/windows
MODES = ("dense", "sparse")


@dataclasses.dataclass(frozen=True)
class FoldRequest:
    """One fold iteration, declaratively: family + mode + payload.

    ``family``/``mode``/``rescan`` are routing keys — ``run`` and
    ``dispatches_per_iter`` branch on them. ``seed`` and ``frontier`` are
    the operands the selected executor consumes.
    """

    family: str = "mg"  # sketch family: "mg" | "bm" (FAMILIES)
    mode: str = "dense"  # "dense" | "sparse" (MODES): fold all rows or
    # only the frontier-compacted subset
    rescan: bool = False  # run the double-scan second pass (mg only)
    aligned: bool = False  # round-0 entries are pre-materialized
    # window-aligned (informational: the plan itself carries the layout)
    # tie-break seed for this iteration — Python int, or None for families
    # that never hash (bm)
    seed: Optional[Any] = None
    # active-vertex mask — [N] bool tensor; required in sparse mode,
    # ignored in dense mode
    frontier: Optional[Any] = None
    cap_rows: int = 0  # sparse compaction capacity: max active
    # rows/windows the compacted fold may touch

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(
                f"unknown fold family {self.family!r}; expected one of "
                f"{FAMILIES}")
        if self.mode not in MODES:
            raise ValueError(
                f"unknown fold mode {self.mode!r}; expected one of {MODES}")
        if self.rescan and self.family != "mg":
            raise ValueError(
                "rescan=True is an MG-family ablation (the double scan "
                "re-scores the MG sketch); it does not compose with "
                f"family={self.family!r}")
        if self.mode == "sparse" and self.frontier is None:
            raise ValueError(
                "sparse mode needs a frontier (the compacted fold is "
                "defined by the active vertex set)")


@dataclasses.dataclass(frozen=True)
class RoundSelection:
    """Which rows/windows a kernel driver folds this iteration.

    ``None`` in driver signatures means dense (all rows/windows); a
    selection carries the sparse half: the frontier mask the driver
    compacts into row/window indices, bounded by ``cap_rows``.
    """

    # active-vertex mask — [N] bool tensor; the driver compacts it into
    # row (fused) or window (stream) indices
    frontier: Any = None
    cap_rows: int = 0  # compaction capacity (rows for the fused driver)


@dataclasses.dataclass
class FoldOutcome:
    """What a routed fold iteration produced.

    ``want`` is always populated; ``bm_label``/``bm_weight`` belong to the
    BM family.
    """

    # per-vertex selected label — [N] int32
    want: Any = None
    # BM only: raw candidate per vertex (-1 empty sentinel) — [N] int32
    bm_label: Optional[Any] = None
    # BM only: surviving candidate weight — [N] float32
    bm_weight: Optional[Any] = None
