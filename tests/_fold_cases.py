"""Seeded fold rounds that stress the group-per-row MG fold of K1 and K5
(``csrc/sketch_rows.cuh:mg_fold_group``: a group of k lanes per row, one
sketch slot per lane), the shared-memory stage of the tile fold K9 and
the group-per-row rescan of K4 (``rescan_group``). numpy only, so the
tests on the card (no JAX there) and the CPU parity tests share them.

A case is a fused round (flat entries, ``row_start``/``row_count`` in
``[n_steps, tile_r]``) or a streamed round (``n_windows`` windows of W
entry slots, window-relative starts, aligned: the entries are already
windowed). Their rows hold:

  * counts 0, 1, k-1, k, k+1, chunk-1 and chunk;
  * starts at every offset mod 8, with junk entries (valid labels, weight
    > 0) in the gaps, so a read past a row's end changes its sketch;
  * rows in shuffled order, so a warp's groups have very different counts;
  * a slot decremented to 0 mid-row and then claimed while a later slot
    stays occupied, and a first free slot in the middle of the sketch;
  * weights <= 0 and label -1 entries mid-row;
  * equal weights (decrements that free several slots at once);
  * a row count that is no multiple of the rows a block folds, and
    streamed windows whose row slots differ in count (one holds no row).

A tile case (K9) is a padded [R, D] tile of the same kinds of rows at
the widths and row counts of :data:`TILE_SHAPES`, all-pad rows among
them; :func:`embed_at` lays it out at an offset in a longer array, so a
tile can be a contiguous slice that is not 16-byte aligned. A rescan case
(K4) is a fused round with per-row candidates (duplicates, -1 empties, a
row of -1 only), entries of weight < 0, +0.0 and -0.0 mid-row, and gap
entries whose labels are the neighbouring rows' candidates, so a read
past a row's end changes a partial.

A BM case (K3: :func:`bm_case`, a fused round 0; K10:
:func:`bm_tile_case`, a padded tile) carries per-row incumbents ``init``
(-1, the row's first label, or another) and rows of the Boyer-Moore
hazards (:func:`bm_case_rows`): ties ``wk == w`` (a replace, not a
decrement), runs of the carry's label, a decrement that leaves the carry
just above the next entry's weight, and entries of weight 0.0, -0.0, < 0
or label -1 mid-row; counts 0, 1, C-1, C and C+1 for the stage's chunk
widths C of :data:`BM_CHUNKS`, 127 and 128; shuffled rows, and junk gap
entries (valid labels, weight 2.5) that would take the carry if read.
"""
from __future__ import annotations

import numpy as np

#: the largest count a row may have: the plans' chunk, the plain gather's
#: width
CHUNK = 128
#: label of the junk entries in the gaps between rows: no row's label
JUNK_LABEL = 10_000


def freed_then_claimed(k: int) -> list[tuple[int, float]]:
    """Slot 0 decremented to 0 by a new label while every later slot stays
    occupied, invalid entries, then a claim of slot 0, a decrement and a
    match there."""
    row = [(0, 1.0)] + [(j, 5.0) for j in range(1, k)]
    row += [(k, 1.0)]                         # no free slot: all - 1.0
    row += [(-1, 2.0), (k + 1, 0.0), (k + 2, -1.0)]  # no-ops mid-row
    row += [(k + 3, 2.0)]                     # claims slot 0
    row += [(0, 1.5)]                         # slot 0 holds k+3: all - 1.5
    row += [(k + 3, 0.5)]                     # matches slot 0
    return row


def middle_slot_freed(k: int) -> list[tuple[int, float]]:
    """Slots k/2 and k-1 freed together (equal weights), the first of them
    claimed, the other claimed next, and the row then full again."""
    mid = k // 2
    row = [(j, 1.0 if j in (mid, k - 1) else 3.0) for j in range(k)]
    row += [(k, 1.0)]           # frees mid and k-1 (exactly 0.0)
    row += [(k + 1, 0.75)]      # claims mid
    row += [(k + 2, 0.25)]      # claims k-1
    row += [(mid, 0.5)]         # mid holds k+1 now: no match, decrement
    return row


def _equal_weights(k: int, n: int, rng) -> list[tuple[int, float]]:
    """Unit weights over 2k labels: decrements to exactly 0 free whole
    groups of slots at once."""
    return [(int(c), 1.0) for c in rng.integers(0, 2 * k, n)]


def _random_row(k: int, n: int, rng) -> list[tuple[int, float]]:
    """Labels in [-1, 3k), weights on a 0.375 grid from -0.375 (0 and a
    negative included)."""
    labels = rng.integers(-1, 3 * k, n)
    weights = rng.integers(-1, 8, n) * 0.375
    return [(int(c), float(w)) for c, w in zip(labels, weights)]


def case_rows(k: int, rng, n_random: int = 0) -> list[list]:
    """The rows of one case at sketch width k, shuffled: every count of
    the list above, the hand-made rows, and ``n_random`` more rows of
    random counts in [0, chunk]."""
    counts = [0, 1, k - 1, k, k + 1, CHUNK - 1, CHUNK]
    rows = [_random_row(k, n, rng) for n in counts]
    rows += [_equal_weights(k, n, rng) for n in (k + 1, 3 * k, CHUNK)]
    for hand in (freed_then_claimed(k), middle_slot_freed(k)):
        rows.append(hand)
        rows.append(hand + _random_row(k, CHUNK - len(hand), rng))
    rows += [_random_row(k, int(n), rng)
             for n in rng.integers(0, CHUNK + 1, n_random)]
    assert all(len(r) <= CHUNK for r in rows)
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


def _lay_out(rows, first_start: int, rng):
    """Place rows one after another, row i starting at an offset that is i
    mod 8 past a multiple of 8; returns (starts, counts, end)."""
    starts, counts, pos = [], [], first_start
    for i, row in enumerate(rows):
        pos = -(-pos // 8) * 8 + i % 8
        starts.append(pos)
        counts.append(len(row))
        pos += len(row) + int(rng.integers(0, 3))
    return starts, counts, pos


def _fill(length: int, rows, starts, rng):
    """Flat (labels, weights) of ``length`` entries: junk everywhere, each
    row's entries at its start."""
    labels = np.full(length, JUNK_LABEL, np.int32)
    labels += rng.integers(0, 4, length).astype(np.int32)
    weights = np.full(length, 2.5, np.float32)
    for start, row in zip(starts, rows):
        if row:
            c, w = zip(*row)
            labels[start:start + len(row)] = c
            weights[start:start + len(row)] = w
    return labels, weights


def fused_case(k: int, seed: int, *, tile_r: int = 13, n_random: int = 91):
    """A fused round: dict of numpy ``row_start``/``row_count``
    [n_steps, tile_r], ``step_dmax`` [n_steps, 1], flat ``labels``/
    ``weights`` and ``n_entries_in``. Pad rows (count 0, start 0) fill the
    last step, so the row count is ``n_steps * tile_r``."""
    rng = np.random.default_rng(seed)
    rows = case_rows(k, rng, n_random)
    starts, counts, end = _lay_out(rows, 3, rng)
    n_steps = -(-len(rows) // tile_r)
    pad = n_steps * tile_r - len(rows)
    labels, weights = _fill(end + 5, rows, starts, rng)
    row_start = np.asarray(starts + [0] * pad, np.int32).reshape(n_steps,
                                                                 tile_r)
    row_count = np.asarray(counts + [0] * pad, np.int32).reshape(n_steps,
                                                                 tile_r)
    return {"row_start": row_start, "row_count": row_count,
            "step_dmax": row_count.max(axis=1, keepdims=True).astype(np.int32),
            "labels": labels, "weights": weights,
            "n_entries_in": labels.shape[0]}


def stream_case(k: int, seed: int, *, tile_r: int = 6,
                fill=(6, 2, 0, 5, 1), n_random: int = 0):
    """An aligned streamed round of every row of :func:`case_rows` (so
    ``sum(fill)`` is 14 + ``n_random``): window w holds ``fill[w]`` row
    slots (its first slots; the rest are pads) laid out from a window-relative
    offset 1. Every row ends at least ``chunk`` slots before its window's
    end (the reference kernel slices ``chunk`` lanes from a start).
    Returns a dict of numpy ``row_start``/``row_count``/``step_dmax``,
    the windowed ``labels``/``weights`` [n_windows * W],
    ``entry_gather`` (identity over every slot), ``window_entries`` and
    ``n_entries_in``."""
    rng = np.random.default_rng(seed)
    rows = case_rows(k, rng, n_random)
    assert sum(fill) == len(rows) and all(f <= tile_r for f in fill)
    n_windows = len(fill)
    per_window, taken, ends = [], 0, []
    for f in fill:
        win_rows = rows[taken:taken + f]
        taken += f
        starts, counts, end = _lay_out(win_rows, 1, rng)
        per_window.append((win_rows, starts, counts))
        ends.append(end)
    w = -(-(max(ends) + CHUNK) // 8) * 8
    labels = np.empty(n_windows * w, np.int32)
    weights = np.empty(n_windows * w, np.float32)
    row_start = np.zeros((n_windows, tile_r), np.int32)
    row_count = np.zeros((n_windows, tile_r), np.int32)
    for i, (win_rows, starts, counts) in enumerate(per_window):
        lab, wgt = _fill(w, win_rows, starts, rng)
        labels[i * w:(i + 1) * w] = lab
        weights[i * w:(i + 1) * w] = wgt
        row_start[i, :len(starts)] = starts
        row_count[i, :len(counts)] = counts
    return {"row_start": row_start, "row_count": row_count,
            "step_dmax": row_count.max(axis=1, keepdims=True).astype(np.int32),
            "labels": labels, "weights": weights,
            "entry_gather": np.arange(n_windows * w, dtype=np.int32),
            "window_entries": w, "n_entries_in": n_windows * w}


def gather_tile(row_start, row_count, labels, weights, chunk: int = CHUNK):
    """[rows, chunk] (label, weight) tile of flat rows at int64 starts,
    masked to (-1, 0.0) past each count: the reference fold's input."""
    starts = np.asarray(row_start, np.int64).reshape(-1)
    counts = np.asarray(row_count).reshape(-1)
    lane = np.arange(chunk)
    valid = lane[None, :] < counts[:, None]
    idx = np.where(valid, starts[:, None] + lane[None, :], 0)
    return (np.where(valid, labels[idx], -1).astype(np.int32),
            np.where(valid, weights[idx], 0.0).astype(np.float32))


def stream_tile(case, chunk: int = CHUNK):
    """The streamed case's tile in row-slot order."""
    n_windows, _ = case["row_start"].shape
    base = np.arange(n_windows, dtype=np.int64)[:, None] * case[
        "window_entries"]
    return gather_tile(base + case["row_start"], case["row_count"],
                       case["labels"], case["weights"], chunk)


#: K9 tile shapes (width D, rows R): D = 1, multiples of 4 at and below
#: the kernel's narrow chunk (8), odd widths, its wide chunk (32) and one
#: past it, and the widest bucket (128, four chunks); R = 1, odd, no
#: multiple of a block's 128 rows, and more than one block
TILE_SHAPES = ((1, 1), (4, 129), (7, 130), (8, 257), (32, 77), (33, 133),
               (128, 131))
#: entries of junk before a tile laid out by :func:`embed_at` at an offset
#: that is no multiple of 4 (16 bytes)
UNALIGNED_OFFSET = 1


def tile_case(k: int, width: int, n_rows: int, seed: int):
    """A padded [n_rows, width] (labels int32, weights float32) tile: rows
    of every kind of :func:`case_rows` that fit the width (the hand-made
    rows where they fit whole), equal-weight and random rows of the full
    width, and all-pad rows, in shuffled order; each row padded with
    (-1, 0.0) past its entries, as the plan's gather pads it."""
    rng = np.random.default_rng(seed)
    kinds = [_random_row(k, width, rng), [], _equal_weights(k, width, rng)]
    for hand in (freed_then_claimed(k), middle_slot_freed(k)):
        if len(hand) <= width:
            kinds.append(hand)
            kinds.append(hand + _random_row(k, width - len(hand), rng))
    kinds += [r for r in case_rows(k, rng) if len(r) <= width]
    rows = kinds[:n_rows] + [
        _random_row(k, int(n), rng)
        for n in rng.integers(0, width + 1, max(n_rows - len(kinds), 0))]
    labels = np.full((n_rows, width), -1, np.int32)
    weights = np.zeros((n_rows, width), np.float32)
    for pos, i in enumerate(rng.permutation(n_rows)):
        row = rows[i]
        if row:
            c, w = zip(*row)
            labels[pos, :len(row)] = c
            weights[pos, :len(row)] = w
    return labels, weights


def embed_at(x, offset: int = UNALIGNED_OFFSET):
    """``x`` flattened after ``offset`` junk entries (labels 10_000 or
    weights 2.5): ``embed_at(x)[offset:]`` reshaped is ``x`` again, a
    contiguous slice whose first entry lies ``4 * offset`` bytes past the
    array's start."""
    fill = JUNK_LABEL if x.dtype == np.int32 else 2.5
    return np.concatenate([np.full(offset, fill, x.dtype), x.reshape(-1)])


def _rescan_rows(k: int, rng, n_random: int):
    """Rows of counts 0, 1, k-1, k, k+1, chunk-1 and chunk and
    ``n_random`` random ones, shuffled, with their candidates: returns
    (rows, cands), a list of [(label, weight)] and one of [k] int32."""
    counts = [0, 1, k - 1, k, k + 1, CHUNK - 1, CHUNK]
    counts += [int(n) for n in rng.integers(0, CHUNK + 1, n_random)]
    counts = [counts[i] for i in rng.permutation(len(counts))]
    cands, rows = [], []
    for i, n in enumerate(counts):
        cand = rng.integers(0, 2 * k, k).astype(np.int32)
        if i % 3 == 0:
            cand[k // 2] = cand[0]        # a duplicate candidate
        if i % 2 == 0:
            cand[k - 1] = -1              # an empty slot
        if i == 5:
            cand[:] = -1                  # no candidate at all
        live = cand[cand >= 0]
        labels = rng.integers(-1, 3 * k, n)
        if live.size:
            pick = rng.random(n) < 0.6
            labels[pick] = rng.choice(live, int(pick.sum()))
        weights = rng.integers(-2, 8, n) * 0.375
        if n >= 4 and live.size:
            labels[n // 2], weights[n // 2] = live[0], 0.0
            labels[n // 2 + 1], weights[n // 2 + 1] = live[-1], -0.0
        cands.append(cand)
        rows.append([(int(c), float(w)) for c, w in zip(labels, weights)])
    return rows, cands


def _rescan_fill(length: int, rows, starts, cands, rng):
    """Flat (labels, weights) of ``length`` entries: each row's entries at
    its start; every entry between two rows (and before the first and
    after the last) a candidate label of one of its two neighbours, weight
    2.5."""
    labels = np.empty(length, np.int32)
    weights = np.full(length, 2.5, np.float32)
    prev_end, prev_live = 0, np.zeros(0, np.int32)
    counts = [len(row) for row in rows]
    bounds = list(zip(starts, counts, cands)) + [(length, 0, None)]
    for start, count, cand in bounds:
        live = prev_live if cand is None else np.concatenate(
            [prev_live, cand[cand >= 0]])
        if not live.size:
            live = np.asarray([0], np.int32)
        labels[prev_end:start] = rng.choice(live, start - prev_end)
        if cand is not None:
            prev_end, prev_live = start + count, cand[cand >= 0]
    for start, row in zip(starts, rows):
        if row:
            c, w = zip(*row)
            labels[start:start + len(row)] = c
            weights[start:start + len(row)] = w
    return labels, weights


def rescan_case(k: int, seed: int, *, tile_r: int = 13, n_random: int = 91):
    """A fused round 0 for the rescan: the round's fields as in
    :func:`fused_case`, plus ``cand`` [n_steps * tile_r, k] int32.

    Rows of counts 0, 1, k-1, k, k+1, chunk-1 and chunk and ``n_random``
    random ones, shuffled. Each row's candidates come from a small
    alphabet, some duplicated, some -1, one row's all -1; its entries'
    labels are mostly its candidates, with weights on a 0.375 grid from
    -0.75, and +0.0 and -0.0 on candidate labels mid-row. Every entry
    between two rows (and after the last) carries a candidate label of
    one of its two neighbours and weight 2.5."""
    rng = np.random.default_rng(seed)
    rows, cands = _rescan_rows(k, rng, n_random)
    starts, counts, end = _lay_out(rows, 3, rng)
    length = end + 5
    labels, weights = _rescan_fill(length, rows, starts, cands, rng)
    n_steps = -(-len(rows) // tile_r)
    pad = n_steps * tile_r - len(rows)
    row_start = np.asarray(starts + [0] * pad, np.int32).reshape(n_steps,
                                                                 tile_r)
    row_count = np.asarray(counts + [0] * pad, np.int32).reshape(n_steps,
                                                                 tile_r)
    cand = np.concatenate([np.stack(cands),
                           np.full((pad, k), -1, np.int32)])
    return {"row_start": row_start, "row_count": row_count,
            "step_dmax": row_count.max(axis=1, keepdims=True).astype(np.int32),
            "labels": labels, "weights": weights, "cand": cand,
            "n_entries_in": length, "n_rows": len(rows)}


def stream_rescan_case(k: int, seed: int, *, tile_r: int = 6,
                       fill=(6, 2, 0, 5, 1), n_random: int = 7):
    """An aligned streamed round 0 for the rescan (K8): the rows and
    candidates of :func:`rescan_case` (so ``sum(fill)`` is 7 +
    ``n_random``) laid out in windows as in :func:`stream_case`: window w
    holds ``fill[w]`` row slots (its first; the rest are pads, count 0,
    candidates -1), from a window-relative offset 1, every row ending at
    least ``chunk`` slots before its window's end. Each window's gaps
    carry its neighbouring rows' candidates, weight 2.5. Returns the
    fields of :func:`stream_case` plus ``cand`` [n_windows * tile_r, k]
    int32."""
    rng = np.random.default_rng(seed)
    rows, cands = _rescan_rows(k, rng, n_random)
    assert sum(fill) == len(rows) and all(f <= tile_r for f in fill)
    n_windows = len(fill)
    per_window, taken, ends = [], 0, []
    for f in fill:
        win_rows, win_cands = rows[taken:taken + f], cands[taken:taken + f]
        taken += f
        starts, counts, end = _lay_out(win_rows, 1, rng)
        per_window.append((win_rows, win_cands, starts, counts))
        ends.append(end)
    w = -(-(max(ends) + CHUNK) // 8) * 8
    labels = np.empty(n_windows * w, np.int32)
    weights = np.empty(n_windows * w, np.float32)
    row_start = np.zeros((n_windows, tile_r), np.int32)
    row_count = np.zeros((n_windows, tile_r), np.int32)
    cand = np.full((n_windows, tile_r, k), -1, np.int32)
    for i, (win_rows, win_cands, starts, counts) in enumerate(per_window):
        lab, wgt = _rescan_fill(w, win_rows, starts, win_cands, rng)
        labels[i * w:(i + 1) * w] = lab
        weights[i * w:(i + 1) * w] = wgt
        row_start[i, :len(starts)] = starts
        row_count[i, :len(counts)] = counts
        if win_cands:
            cand[i, :len(win_cands)] = np.stack(win_cands)
    return {"row_start": row_start, "row_count": row_count,
            "step_dmax": row_count.max(axis=1, keepdims=True).astype(np.int32),
            "labels": labels, "weights": weights,
            "entry_gather": np.arange(n_windows * w, dtype=np.int32),
            "window_entries": w, "n_entries_in": n_windows * w,
            "cand": cand.reshape(n_windows * tile_r, k)}


#: the chunk widths C of the staged BM folds (K10 at 8 and 32, K3 at 16
#: and 32): a BM case has rows of counts C-1, C and C+1 for each
BM_CHUNKS = (8, 16, 32)
#: labels of the BM cases' rows: a small alphabet, so that candidates
#: match, lose and replace
BM_LABELS = 6


def bm_ties() -> list[tuple[int, float]]:
    """Ties wk == w: each replaces the candidate (a decrement would leave
    the old one at 0.0); a match in between."""
    return [(2, 1.5), (3, 1.5), (3, 0.75), (2, 2.25), (5, 2.25)]


def bm_runs() -> list[tuple[int, float]]:
    """A run of the carry's label, a smaller rival, the run again."""
    return [(4, 0.375)] * 5 + [(1, 0.75)] + [(4, 0.375)] * 3 + [(0, 0.375)]


def bm_just_above() -> list[tuple[int, float]]:
    """Decrements that leave the carry one ulp above the entry that comes
    next: 1 + 2^-23 less 1.0 is 2^-23, which then beats 2^-24 (a
    decrement to 2^-24) and ties 2^-24 (a replace)."""
    eps = float(np.float32(2.0 ** -23))
    return [(1, 1.0), (1, eps), (2, 1.0), (3, eps / 2), (4, eps / 2),
            (4, 0.375)]


def bm_noops() -> list[tuple[int, float]]:
    """Entries that fold nothing mid-row: label -1 of weight > 0, weights
    0.0, -0.0 and < 0 on live labels (the carry's included)."""
    return [(1, 1.0), (-1, 2.0), (1, 0.0), (2, -0.0), (1, -0.0),
            (3, -0.375), (2, 0.375)]


BM_HAND_ROWS = (bm_ties, bm_runs, bm_just_above, bm_noops)


def _bm_random_row(n: int, rng) -> list[tuple[int, float]]:
    """Labels in [-1, BM_LABELS), weights on a 0.375 grid from -0.375,
    and one in eight of the zero weights -0.0."""
    labels = rng.integers(-1, BM_LABELS, n)
    weights = (rng.integers(-1, 8, n) * 0.375).astype(np.float32)
    weights[(weights == 0) & (rng.random(n) < 0.125)] = -0.0
    return [(int(c), float(w)) for c, w in zip(labels, weights)]


def bm_case_rows(rng, n_random: int = 0) -> list[list]:
    """The rows of a BM case, shuffled: random rows of every count of
    the module docstring, each hand-made row alone and followed by random
    entries up to the chunk, and ``n_random`` rows of random counts in
    [0, chunk]."""
    counts = {0, 1, CHUNK - 1, CHUNK}
    for c in BM_CHUNKS:
        counts |= {c - 1, c, c + 1}
    rows = [_bm_random_row(n, rng) for n in sorted(counts)]
    for hand in BM_HAND_ROWS:
        rows.append(hand())
        rows.append(hand() + _bm_random_row(CHUNK - len(hand()), rng))
    rows += [_bm_random_row(int(n), rng)
             for n in rng.integers(0, CHUNK + 1, n_random)]
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


def bm_init(rows, rng) -> np.ndarray:
    """Per-row incumbents: -1, the row's first label (-1 for an empty
    row) or a random label, in turn."""
    init = rng.integers(0, BM_LABELS, len(rows)).astype(np.int32)
    for i, row in enumerate(rows):
        if i % 3 == 0:
            init[i] = -1
        elif i % 3 == 1:
            init[i] = row[0][0] if row else -1
    return init


def bm_case(seed: int, *, tile_r: int = 13, n_random: int = 91):
    """A fused round 0 for the BM fold: the round's fields as in
    :func:`fused_case`, plus ``init`` [n_steps * tile_r] int32 (-1 on the
    pad rows) and ``n_rows`` (the real rows, in layout order)."""
    rng = np.random.default_rng(seed)
    rows = bm_case_rows(rng, n_random)
    starts, counts, end = _lay_out(rows, 3, rng)
    n_steps = -(-len(rows) // tile_r)
    pad = n_steps * tile_r - len(rows)
    labels, weights = _fill(end + 5, rows, starts, rng)
    row_start = np.asarray(starts + [0] * pad, np.int32).reshape(n_steps,
                                                                 tile_r)
    row_count = np.asarray(counts + [0] * pad, np.int32).reshape(n_steps,
                                                                 tile_r)
    init = np.concatenate([bm_init(rows, rng), np.full(pad, -1, np.int32)])
    return {"row_start": row_start, "row_count": row_count,
            "step_dmax": row_count.max(axis=1, keepdims=True).astype(np.int32),
            "labels": labels, "weights": weights, "init": init,
            "n_entries_in": labels.shape[0], "n_rows": len(rows)}


def bm_tile_case(width: int, n_rows: int, seed: int):
    """A padded [n_rows, width] BM tile and its incumbents: (labels int32,
    weights float32, init [n_rows] int32). Rows: the hand-made rows where
    they fit whole, a full-width random row, an all-pad row, the rows of
    :func:`bm_case_rows` that fit, then random rows of random counts, in
    shuffled order; each padded with (-1, 0.0) past its entries."""
    rng = np.random.default_rng(seed)
    kinds = [_bm_random_row(width, rng), []]
    kinds += [hand() for hand in BM_HAND_ROWS if len(hand()) <= width]
    kinds += [r for r in bm_case_rows(rng) if len(r) <= width]
    rows = kinds[:n_rows] + [
        _bm_random_row(int(n), rng)
        for n in rng.integers(0, width + 1, max(n_rows - len(kinds), 0))]
    rows = [rows[i] for i in rng.permutation(n_rows)]
    labels = np.full((n_rows, width), -1, np.int32)
    weights = np.zeros((n_rows, width), np.float32)
    for pos, row in enumerate(rows):
        if row:
            c, w = zip(*row)
            labels[pos, :len(row)] = c
            weights[pos, :len(row)] = w
    return labels, weights, bm_init(rows, rng)
