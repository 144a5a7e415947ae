"""Dry run of every cell: per-rank memory, bytes, FLOPs, collectives and
roofline terms of every cell of the five LM archs, the four GNN archs,
DCN-v2 and ``lpa-mg8`` on a mesh of ranks, from shapes alone. A host
computation: inputs and workspaces are meta tensors and nothing is
allocated on any device.

The port's counterpart of ``repro.launch.dryrun``, which lowers and
compiles each cell's step with XLA and reads XLA's analyses. The port
has no compiler to ask, so each figure has a named counterpart here.

LPA (``run_lpa_cell``):

  * ``argument_bytes`` — XLA's argument size: the per-rank bytes of the
    cell's meta workspace (``cells.build_lpa_cell``; the reference's
    argument also holds the step's two scalars, 5 B, which the port's
    step takes as Python values);
  * ``output_bytes`` — what the step returns: the rank's [V_pad] int32
    labels and its int32 changed count;
  * ``temp_bytes`` — XLA's temp size: :func:`lpa_step_temp_bytes`, a
    byte model of the port's step, the most bytes it holds at once above
    its inputs;
  * ``bytes_per_chip`` — XLA's "bytes accessed": :func:`lpa_step_bytes`,
    the bytes the port's step reads and writes (a count from shapes, not
    XLA's figure);
  * ``flops_per_chip`` — the reference's analytic formula: entries x 6 x
    k (about 6 operations per entry per sketch slot);
  * ``collectives`` — the bytes the reference parses out of the compiled
    step's HLO: ``core.distributed.lpa_collective_bytes``.

LM (``run_lm_cell``; the plan of ``cells.build_cell`` on the mesh):

  * ``argument_bytes`` — the per-rank bytes of the plan's inputs under
    their specs (:func:`spec_bytes`: the reference's ``shard_shape``
    bytes, exactly);
  * ``output_bytes`` — what the step returns, per rank, under the same
    specs (train: the parameters and optimizer state; prefill: the
    [B/D, V/M] logits; decode: the logits and the cache); ``alias_bytes``
    the same, as each is written in place or made during the step;
  * ``temp_bytes`` — :func:`lm_local_run`: ``LiveBytes``' peak over the
    rank's local call on meta tensors (every layer, the cell's own
    chunking); collective buffers not counted;
  * ``raw_cost`` — ``CostCounter`` over the same local call. The port has
    no scan, so nothing is undercounted: this is where it parts from the
    reference's ``raw_cost``, which counts its layer scan's body once;
    its bytes are the port's unfused eager traffic;
  * ``flops_per_chip``, ``bytes_per_chip`` — ``probes.lm_cell_cost`` at
    the plan's probe extents: the FLOPs of the ops the port runs (the
    roofline's compute term); ``flops_per_chip_xla_cpu`` the same with
    the converts XLA's CPU backend adds around every bf16 op, the figure
    the reference's CPU probe gives (for comparison only: neither the
    card nor the reference's TPU target runs them); ``model_flops_global``
    — ``probes.lm_model_flops``;
  * ``collectives`` — :func:`lm_collective_bytes`, in the reference
    parser's convention, with ``hlo_collective_loop_factor`` =
    ``n_layers``. Float payloads are counted in float32, as the
    reference's CPU HLO carries them (it computes bf16 in float32); the
    card's collective dtype is taken to be the same, float32, which is an
    upper bound where a sharded port step sent its bf16 activations (no
    LM step across cards exists in the port yet).
    ``collectives_moved`` the same ops counted whole, what the ranks send
    (the parse reads a tuple of more than five arrays as 0: the ``cp``
    weight and embedding gradients' all-reduces), so the roofline's
    collective term and t_lb, which read ``collectives``, leave out the
    difference. Every layout's count is held to the reference's HLO
    (tests/test_torch_launch.py), so ``collectives_checked`` is true.

GNN and recsys (``run_model_cell``; the plan of ``cells.build_cell`` on
the mesh, and the rank's share of its step, ``cells.rank_step``: a
full-graph rank runs its N/P nodes and E/P edges against the node tables
its all-gathers make whole, a tree-layout rank its B/P trees, a DCN-v2
rank its batch rows and table rows):

  * ``argument_bytes`` — :func:`spec_bytes` of the plan's inputs;
  * ``output_bytes`` — train: the parameters and AdamW state, donated, so
    ``alias_bytes`` the same; serve: the rank's [B/D] float32 logits;
    retrieval: its [1, NC/P] scores (the reference leaves them sharded);
  * ``temp_bytes`` — :func:`model_local_run`: ``LiveBytes``' peak over
    the rank's step on meta tensors (the collectives' results included);
  * ``raw_cost``, ``flops_per_chip``, ``bytes_per_chip`` —
    ``CostCounter`` over the same call (the models are unrolled, as the
    reference's ``raw_flops`` is exact); ``model_flops_global`` = FLOPs
    x P, the reference's formula, so ``useful_flops_ratio`` is 1;
  * ``collectives`` — :func:`gnn_collective_bytes` or
    :func:`recsys_collective_bytes`, the ops the reference's HLO places,
    in its parse's convention (a tuple of more than five arrays counts
    0), with ``hlo_collective_loop_factor`` 1; ``collectives_moved`` the
    same ops counted whole (what the ranks send), ``collective_ops`` the
    op list. Every layout's count is held to the reference's HLO
    (tests/test_torch_launch_gnn.py), so ``collectives_checked`` is true.

The ranks: the reference's two production meshes (``--mesh``: 256 and
512 ranks) and any count (``--ranks N``: a 1-D mesh for LPA, (N, 1)
("data", "model") for the LM, GNN and recsys cells; 1: one card). An
LPA cell whose int32 positions cannot index its per-rank arrays is
recorded ``ok: false`` with that reason (``web_4b`` on one rank: 3.4 B
entries); any other cell that cannot be built records its error. An
unknown arch id exits 2.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --mesh both --ranks 1
Results land in launch_results_torch/dryrun/<mesh>/<arch>__<shape>.json;
``python -m repro_torch.launch.report`` tabulates them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.registry import all_arch_ids, get_arch
from repro_torch.core.distributed import (DistLPAWorkspace,
                                          lpa_collective_bytes)
from repro_torch.launch.cells import (build_cell, build_lpa_cell,
                                      decode_layout, lpa_cell_engine,
                                      mesh_extents, meta_tensor)
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.probes import (_local_cfg, lm_cell_cost,
                                       lm_model_flops)
from repro_torch.launch.roofline import roofline
from repro_torch.train.elastic import (axes_extent, leaves_with_specs,
                                       map_with_specs, mesh_sizes,
                                       shard_shape)
from repro_torch.tree import tree_leaves

__all__ = ["HBM_PER_CHIP", "ALLOC_GRAIN", "workspace_bytes",
           "lpa_step_temp_bytes", "lpa_step_bytes", "int32_overflow",
           "run_lpa_cell", "lm_collective_bytes", "spec_bytes",
           "lm_local_run", "lm_local_step", "lm_train_inputs",
           "lm_train_measure", "lm_extrapolate", "lm_train_total",
           "run_lm_cell",
           "gnn_collective_bytes", "recsys_collective_bytes",
           "model_local_run", "run_model_cell", "run_cell", "main"]

HBM_PER_CHIP = 80e9  # NVIDIA H100 80GB
#: the CUDA caching allocator rounds every block up to a multiple of this
ALLOC_GRAIN = 512
INT32_MAX = 2**31 - 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def workspace_bytes(ws: DistLPAWorkspace) -> int:
    """The bytes one rank holds of ``ws``: every stacked array (and every
    array of a per-round tuple), over the P ranks."""
    total = 0
    for value in vars(ws).values():
        arrays = value if isinstance(value, tuple) else (value,)
        total += sum(_nbytes(a) for a in arrays
                     if isinstance(a, torch.Tensor))
    return total // ws.n_shards


def _per_rank_max(t: torch.Tensor, fallback: int) -> int:
    """The largest per-rank sum of a [P, ...] count array, or
    ``fallback`` where the array has shapes only (meta)."""
    if t.is_meta:
        return fallback
    return int(t.reshape(t.shape[0], -1).sum(dim=1).max())


def _final_rows(ws: DistLPAWorkspace) -> int:
    """The final round's real rows on the fullest rank: each vertex owns
    at most one (a meta workspace: every label slot)."""
    frv = ws.final_row_vertex
    if frv.is_meta:
        return min(ws.v_pad, frv.shape[1])
    return int((frv >= 0).sum(dim=1).max())


class _StepTrace:
    """A walk through one step: the tensors it holds (``new``/``free``,
    each rounded to the allocator's grain) and the bytes it moves."""

    def __init__(self):
        self.live: dict = {}
        self.now = self.peak = self.moved = 0

    def new(self, name: str, nbytes: int, read: int = 0) -> None:
        """An op that reads ``read`` bytes and writes a new tensor."""
        size = -(-nbytes // ALLOC_GRAIN) * ALLOC_GRAIN
        self.live[name] = size
        self.now += size
        self.peak = max(self.peak, self.now)
        self.moved += read + nbytes

    def io(self, read: int, write: int) -> None:
        """An op that writes into a tensor held elsewhere."""
        self.moved += read + write

    def free(self, *names: str) -> None:
        for name in names:
            self.now -= self.live.pop(name)


def _masked_take(t: _StepTrace, out: str, n: int) -> None:
    """``where(idx >= 0, src[idx.clamp_min(0).long()], fill)`` over n
    int32 positions: the halo exchange's hub and send buffers."""
    t.new("_valid", n, read=4 * n)
    t.new("_clamped", 4 * n, read=4 * n)
    t.new("_long", 8 * n, read=4 * n)
    t.free("_clamped")
    t.new("_taken", 4 * n, read=12 * n)
    t.free("_long")
    t.new(out, 4 * n, read=5 * n)
    t.free("_valid", "_taken")


def _mul_u32(t: _StepTrace, out: str, nb: int) -> None:
    """``sketch._mul_u32`` on an int64 tensor of ``nb`` bytes."""
    t.new("_lo", nb, read=nb)
    t.new("_hi", nb, read=nb)
    t.new("_lo_c", nb, read=nb)
    t.new("_hi_c", nb, read=nb)
    t.new("_hi_m", nb, read=nb)
    t.free("_hi_c")
    t.new("_hi_s", nb, read=nb)
    t.free("_hi_m")
    t.new("_sum", nb, read=2 * nb)
    t.free("_lo_c", "_hi_s")
    t.new(out, nb, read=nb)
    t.free("_sum", "_lo", "_hi")


def _choose(t: _StepTrace, n: int, k: int) -> None:
    """``sketch.choose_from_candidates`` over [n, k] candidates (the
    caller's ``cand_c``/``cand_w`` stay held); leaves ``want`` [n]."""
    s = k + 1
    t.new("_eq", n * k, read=4 * n * k + 4 * n)
    t.new("_pos", n * k, read=4 * n * k)
    t.new("_both", n * k, read=2 * n * k)
    t.free("_eq", "_pos")
    t.new("_cur", 4 * n * k, read=5 * n * k)
    t.free("_both")
    t.new("cur_w", 4 * n, read=4 * n * k)
    t.free("_cur")
    t.new("cand_c1", 4 * n * s, read=4 * n * s)  # cat with the incumbent
    t.new("cand_w1", 4 * n * s, read=4 * n * s)
    t.new("valid1", n * s, read=4 * n * s)
    t.new("w", 4 * n * s, read=5 * n * s)
    t.new("w_best", 4 * n, read=4 * n * s)
    t.new("_ge", n * s, read=4 * n * s + 4 * n)
    t.new("tied", n * s, read=2 * n * s)
    t.free("_ge")
    # hash_mix(cand_c1): int64 arithmetic masked to 32 bits
    nb = 8 * n * s
    t.new("_x64", nb, read=4 * n * s)
    t.new("_xm", nb, read=nb)
    t.free("_x64")
    _mul_u32(t, "_h1", nb)
    t.free("_xm")
    t.new("_h2", nb, read=nb)            # ^ seed term
    t.free("_h1")
    t.new("_shift", nb, read=nb)
    t.new("_h3", nb, read=2 * nb)        # h ^ (h >> 15)
    t.free("_shift", "_h2")
    _mul_u32(t, "_h4", nb)
    t.free("_h3")
    t.new("_shift", nb, read=nb)
    t.new("_hash", nb, read=2 * nb)      # h ^ (h >> 13)
    t.free("_shift", "_h4")
    t.new("h", nb, read=n * s + nb)      # where(tied, h, UINT_MAX)
    t.free("_hash")
    t.new("h_best", 8 * n, read=nb)
    t.new("_le", n * s, read=nb + 8 * n)
    t.new("in_hash", n * s, read=2 * n * s)
    t.free("_le")
    t.new("_masked", 4 * n * s, read=5 * n * s)
    t.new("c_best", 4 * n, read=4 * n * s)
    t.free("_masked")
    t.new("_none", n, read=4 * n)
    t.new("want", 4 * n, read=9 * n)
    t.free("_none", "cur_w", "cand_c1", "cand_w1", "valid1", "w", "w_best",
           "tied", "h", "h_best", "in_hash", "c_best")


def _walk_step(ws: DistLPAWorkspace, engine: str) -> _StepTrace:
    """One rank's ungated mg step (``core.distributed._shard_move``) on
    ``engine``, op by op, in the order Python runs and frees them."""
    if engine not in ("pallas", "pallas_fused"):
        raise ValueError(f"the step byte model covers the LPA cells' "
                         f"engines, pallas and pallas_fused; got {engine!r}")
    if (engine == "pallas_fused") != (ws.fused_starts is not None):
        raise ValueError(f"engine {engine!r} does not fold this "
                         f"workspace's layout ({lpa_cell_engine(ws)!r})")
    t = _StepTrace()
    p, v, k = ws.n_shards, ws.v_pad, ws.k
    m = ws.nbr_pos.shape[1]
    # the label exchange
    if ws.send_idx is None:
        t.new("table", 4 * p * v, read=4 * v)       # all-gather
    else:
        hp, h = ws.hub_pad, ws.h_pad
        _masked_take(t, "hub_buf", hp)
        t.new("hub_all", 4 * p * hp, read=4 * hp)   # all-gather
        _masked_take(t, "send_buf", p * h)
        t.new("recv", 4 * p * h, read=4 * p * h)    # all-to-all
        n_tab = v + p * (hp + h)
        t.new("table", 4 * n_tab, read=4 * n_tab)   # cat
        t.free("hub_buf", "hub_all", "send_buf", "recv")
    # the entry arrays (valid and safe are held to the end of the step)
    t.new("valid", m, read=4 * m)
    t.new("_clamped", 4 * m, read=4 * m)
    t.new("safe", 8 * m, read=4 * m)
    t.free("_clamped")
    t.new("_taken", 4 * m, read=12 * m)
    t.new("el0", 4 * m, read=5 * m)
    t.free("_taken")
    t.new("ew0", 4 * m, read=5 * m)
    # the fold rounds; each round's outputs are the next round's entries
    if engine == "pallas":
        for r, gather in enumerate(ws.round_gathers):
            rows = gather.shape[1]
            n = rows * gather.shape[2]
            # sketch._gather_entries: the padded [R, chunk] tiles
            t.new("_clamped", 4 * n, read=4 * n)
            t.new("_safe", 8 * n, read=4 * n)
            t.free("_clamped")
            t.new("_valid", n, read=4 * n)
            t.new("_taken", 4 * n, read=12 * n)
            t.new(f"gl{r}", 4 * n, read=5 * n)
            t.free("_taken")
            t.new("_taken", 4 * n, read=12 * n)
            t.new(f"gw{r}", 4 * n, read=5 * n)
            t.free("_taken", "_safe", "_valid")
            if r:
                t.free(f"gl{r - 1}", f"gw{r - 1}")
            # K9: reads the tiles, writes [R, k] sketches
            t.new(f"sk{r}", 4 * rows * k, read=8 * n)
            t.new(f"sv{r}", 4 * rows * k)
            if r:
                t.free(f"sk{r - 1}", f"sv{r - 1}")
        last_rows = ws.round_gathers[-1].shape[1]
    else:
        for r in range(ws.n_rounds):
            starts = ws.fused_starts[r]
            rows = starts.shape[1] * starts.shape[2]
            entries = _per_rank_max(ws.fused_counts[r], ws.fused_entries[r])
            # K1: reads each row's (start, count) and its entries
            t.new(f"sk{r}", 4 * rows * k, read=8 * rows + 8 * entries)
            t.new(f"sv{r}", 4 * rows * k)
            if r:
                t.free(f"sk{r - 1}", f"sv{r - 1}")
        last_rows = rows
    # the final rows' sketches scattered to their vertices
    nf = min(_final_rows(ws), last_rows)
    t.new("cand_c0", 4 * v * k)
    for name in ("_rows_k", "_rows_v"):
        t.new(name, 4 * nf * k, read=8 * nf + 4 * nf * k)
        t.io(read=8 * nf + 4 * nf * k, write=4 * nf * k)
        t.free(name)
        if name == "_rows_k":
            t.new("cand_w", 4 * v * k)
    t.new("_pos", v * k, read=4 * v * k)
    t.new("cand_c", 4 * v * k, read=5 * v * k)
    t.free("_pos", "cand_c0")
    _choose(t, v, k)
    # the move rule and the changed count (core.distributed._move_epilogue)
    t.new("allowed", v, read=8 * v)
    t.new("is_real", v, read=4 * v)
    t.new("_and", v, read=2 * v)
    t.new("new_labels", 4 * v, read=9 * v)
    t.free("_and")
    t.new("_ne", v, read=8 * v)
    t.new("changed", v, read=2 * v)
    t.free("_ne")
    t.new("_count", 4, read=v)
    t.new("_psum", 4, read=4)                    # psum's operand
    t.io(read=4, write=4)                        # all-reduce
    return t


def lpa_step_temp_bytes(ws: DistLPAWorkspace, engine: str) -> int:
    """The most bytes one rank's ungated mg ``dist_lpa_step`` holds at
    once above its inputs (the rank's workspace blocks and labels),
    each tensor rounded up to the allocator's 512 B: the counterpart of
    XLA's temp size of the reference's compiled step. On the card,
    ``torch.cuda.max_memory_allocated()`` over a step, less what was
    allocated before it.

    The temporaries, in the order the step makes them (m = M_pad
    entries, v = V_pad, n = R_r · chunk a round's padded tile, s = k + 1):

      * the label table: the all-gather's [P · v] int32 (halo: the hub
        and send buffers, with their masks and int64 positions, the
        all-gather and all-to-all results and their [v + P(HUB_pad +
        H_pad)] concatenation);
      * the entry arrays, held to the end: ``valid`` [m] bool, ``safe``
        [m] int64 (made through an [m] int32 clamp), entry labels [m]
        int32 (through the [m] int32 gather) and weights [m] float32;
      * each round on ``pallas``: ``_gather_entries``' [n] int32 clamp
        and int64 positions, [n] bool mask and two [n] gathers, and its
        [n] int32 labels and float32 weights tiles, held until the next
        round's are made; K9's [R_r, k] int32 and float32 sketches, held
        until the next round's are made;
      * each round on ``pallas_fused``: K1's [rows_r, k] int32 and
        float32 sketches, held until the next round's are made;
      * the scatter: [v, k] int32 candidates and float32 weights, the
        final rows' sketches gathered ([rows, k] each, one at a time),
        the [v, k] mask and masked candidates;
      * ``choose_from_candidates``: [v, k] masks and weights, the [v, s]
        candidate and weight columns with the incumbent, their mask,
        weights and ties, the int64 [v, s] hash and its temporaries
        (``_mul_u32``'s halves and partial products), the [v] bests;
      * the move rule: [v] masks, the new labels, the changed mask and
        the count's int32 scalars.

    ``engine`` is "pallas" (the bucketed round gathers, K9) or
    "pallas_fused" (the fused layout, K1). A meta workspace (shapes
    only) counts every label slot as owning a final row and a fused
    round's entries as its whole input.
    """
    return _walk_step(ws, engine).peak


def lpa_step_bytes(ws: DistLPAWorkspace, engine: str) -> int:
    """The bytes one rank's ungated mg step reads and writes, op by op
    (each op's inputs read once and its outputs written once; a gather
    reads its positions and one element per position; K1 reads each
    row's range and entries, K9 its whole padded tile): the counterpart
    of XLA's "bytes accessed" of the reference's step, counted from
    shapes, not XLA's figure. The ops are those of
    :func:`lpa_step_temp_bytes`."""
    return _walk_step(ws, engine).moved


def int32_overflow(ws: DistLPAWorkspace) -> str | None:
    """Why the workspace's int32 positions cannot index a rank's arrays,
    or None: the entry arrays (round 0's positions), the label table
    (``nbr_pos``) and every round's [rows, k] entries must each hold at
    most 2^31 - 1 elements."""
    p, m = ws.n_shards, ws.nbr_pos.shape[1]
    table = ws.v_pad * p if ws.send_idx is None else \
        ws.v_pad + p * (ws.hub_pad + ws.h_pad)
    rows = ([g.shape[1] for g in ws.round_gathers]
            if ws.round_gathers is not None else [])
    sizes = {"entries": m, "label table": table}
    sizes.update({f"round {r + 1} entries": r_rows * ws.k
                  for r, r_rows in enumerate(rows[:-1])})
    over = {name: n for name, n in sizes.items() if n > INT32_MAX}
    if not over:
        return None
    return ("int32 positions cannot index a rank's "
            + ", ".join(f"{name} ({n})" for name, n in over.items())
            + f": more than 2^31 - 1 = {INT32_MAX}")


def run_lpa_cell(spec, cell, mesh, mesh_name: str) -> dict:
    """The LPA branch: the cell's record on ``mesh``."""
    rec = {
        "arch": spec.arch_id, "shape": cell.name, "kind": cell.kind,
        "mesh": mesh_name, "n_devices": int(mesh.devices.size),
        "note": cell.note, "ok": False,
    }
    try:
        plan = build_lpa_cell(spec, cell, int(mesh.devices.size))
        ws = plan.workspace
        engine = lpa_cell_engine(ws)
        rec["engine"] = engine
        rec["n_rounds"] = plan.meta["n_rounds"]
        mem = {"argument_bytes": workspace_bytes(ws),
               "output_bytes": 4 * ws.v_pad + 4,
               "temp_bytes": lpa_step_temp_bytes(ws, engine),
               "alias_bytes": 0}
        peak = (mem["argument_bytes"] + mem["output_bytes"]
                + mem["temp_bytes"] - mem["alias_bytes"])
        mem["peak_bytes_per_device"] = peak
        mem["fits_80g_hbm"] = bool(peak < HBM_PER_CHIP)
        rec["memory"] = mem
        # fold flops are analytic (about 6 operations per entry per slot)
        n_dev = int(mesh.devices.size)
        k = spec.config.lpa.k
        flops_chip = plan.meta["n_edges"] / n_dev * 6 * k
        rec["flops_per_chip"] = flops_chip
        rec["bytes_per_chip"] = float(lpa_step_bytes(ws, engine))
        rec["model_flops_global"] = plan.meta["n_edges"] * 6 * k
        rec["useful_flops_ratio"] = (rec["model_flops_global"]
                                     / (flops_chip * n_dev))
        coll = lpa_collective_bytes(ws)
        rec["collectives"] = {op: float(b) for op, b in coll.items()}
        rec["roofline"] = roofline(flops_chip, rec["bytes_per_chip"],
                                   coll["total"]).to_dict()
        reason = int32_overflow(ws)
        if reason is None:
            rec["ok"] = True
        else:
            rec["error"] = reason
    except (ValueError, TypeError, KeyError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def _lm_dims(cfg, mesh, meta) -> dict:
    dext, mext = mesh_extents(mesh)
    b, s = meta["batch"], meta["seq"]
    return {"sizes": mesh_sizes(mesh), "dext": dext, "mext": mext, "B": b,
            "S": s, "b_loc": b // dext if b % dext == 0 else b}


class _Colls:
    """Collectives in the parse's convention: ``loop`` ops sit in the
    layer scan's body (x ``n_layers``), ``entry`` ops in ENTRY (x 1);
    an all-reduce counts twice; an op over an axis group of extent 1 is
    no collective and counts 0."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.out: dict = {}
        self.moved_out: dict = {}  # every op whole (``add_tuple``)
        self.ops: dict = {}  # (op, result bytes) -> instances in the HLO

    def add(self, op: str, nbytes: float, extent: int, loop: bool = False,
            times: int = 1) -> None:
        if extent <= 1 or nbytes <= 0:
            return
        key = (op, float(nbytes))
        self.ops[key] = self.ops.get(key, 0) + times
        nbytes *= times * (2 if op == "all-reduce" else 1)
        nbytes *= self.n_layers if loop else 1
        self.out[op] = self.out.get(op, 0.0) + nbytes
        self.moved_out[op] = self.moved_out.get(op, 0.0) + nbytes

    def add_tuple(self, op: str, arrays, extent: int, times: int = 1,
                  loop: bool = False) -> None:
        """One op whose result is a tuple of ``arrays`` (each one's
        bytes), as XLA's combiner makes them: the parse reads a tuple of
        more than five arrays as 0 (the HLO text's ``/*index=5*/``
        comment); ``moved`` counts every array."""
        arrays = [float(a) for a in arrays if a > 0]
        if extent <= 1 or not arrays:
            return
        whole = sum(arrays) * times * (2 if op == "all-reduce" else 1)
        whole *= self.n_layers if loop else 1
        self.moved_out[op] = self.moved_out.get(op, 0.0) + whole
        counted = whole if len(arrays) <= 5 else 0.0
        key = (op, sum(arrays) if len(arrays) <= 5 else 0.0)
        self.ops[key] = self.ops.get(key, 0) + times
        self.out[op] = self.out.get(op, 0.0) + counted

    def totals(self) -> dict:
        out = dict(self.out)
        out["total"] = sum(out.values())
        return out

    def moved(self) -> dict:
        """The bytes of every op whole, by op, with their ``"total"``:
        what the ranks send, tuples of any length included."""
        out = dict(self.moved_out)
        out["total"] = sum(out.values())
        return out

    def op_list(self) -> list:
        """``[op, result bytes, instances]`` of every collective as the
        HLO lists them (a loop's op once), largest bytes x instances
        first: what the reference's ``perf_lab`` tallies from the HLO."""
        return sorted(([op, b, n] for (op, b), n in self.ops.items()),
                      key=lambda x: -x[1] * x[2])


def _weight_gathers(c: _Colls, shape, spec, sizes,
                    whole: bool = True) -> None:
    """A cp weight [n_in, n_out] (one layer's) gathered whole: first over
    the axis on its output dim (result: the weight over the input dim's
    extent), then over the axis on its input dim (the whole weight);
    ``whole=False``: the first gather only (the weight stays split on its
    input dim)."""
    e_in, e_out = (axes_extent(spec[-2], sizes),
                   axes_extent(spec[-1], sizes))
    n = 4 * math.prod(shape[-2:])
    c.add("all-gather", n / e_in, e_out, loop=True)
    if whole:
        c.add("all-gather", n, e_in, loop=True)


def _latent_split(c: _Colls, rows: int, r: int, rope: int, m: int,
                  backward: bool) -> None:
    """MLA's ``w_dkv`` output [rows, r + rope], split in ``m`` equal
    shards on its last dim (column parallel), against the latent [rows,
    r] and the rope key [rows, rope] it is sliced into, each split in
    ``m`` equal shards (the forward's slices; the backward pads their
    gradients back). GSPMD moves each piece between the ranks whose
    shards overlap: one collective-permute per shard distance, of the
    largest piece any rank sends that far; in the backward, where a rank
    takes its piece from more than one other rank, one all-gather of the
    piece whole instead."""
    w = (r + rope) / m
    for lo, n in ((0, r), (r, rope)):
        p = n / m
        moves, senders = {}, {}
        for j in range(m):  # the piece's shard j: [lo + j p, lo + (j+1) p)
            for i in range(m):  # the output's shard i: [i w, (i+1) w)
                size = (min(lo + (j + 1) * p, (i + 1) * w)
                        - max(lo + j * p, i * w))
                if i == j or size <= 0:
                    continue
                moves[i - j] = max(moves.get(i - j, 0), size)
                senders.setdefault(i, set()).add(j)
        if backward and any(len(s) > 1 for s in senders.values()):
            c.add("all-gather", 4 * rows * n, m, loop=True)
            continue
        for size in moves.values():
            c.add("collective-permute", 4 * rows * size, m, loop=True)


def lm_collective_bytes(plan, mesh) -> dict:
    """``_lm_collectives(plan, mesh)``' bytes by op, with their
    ``"total"``."""
    return _lm_collectives(plan, mesh).totals()


def _lm_collectives(plan, mesh) -> _Colls:
    """The collective bytes one call of an LM cell's step moves on each
    rank of ``mesh``, by op, with their ``"total"``: the counterpart of
    what ``repro.launch.dryrun`` parses out of the reference's compiled
    step (``repro.launch.roofline.collective_bytes`` of its HLO, with
    ``loop_factor = n_layers``), in that parse's convention, quirks
    included:

      * the bytes of each op's result on a rank; an all-reduce twice;
      * every op outside ENTRY times ``n_layers`` (the parse scales
        anything in a non-entry computation: the layer scan's body, and
        also the attention's inner KV scan, once);
      * a tuple result of more than five arrays counts 0 (the HLO text
        puts an ``/*index=5*/`` comment in it, whose ``=`` the parse's
        result pattern cannot cross), as XLA's combiner makes the
        weights' gradient all-reduces;
      * float32 activations: the reference's CPU compile computes its
        bf16 products in float32, and the collectives carry those; the
        dry run assumes the same float32 payloads on the card.

    An op over an axis group of extent 1 is no collective. Symbols: L
    layers, d model width, H/KV heads, dh head width, V vocab, E experts,
    k top-k, f expert width, B batch, S sequence, D data extent (the
    batch axes), M model extent, b = B / D, c the loss chunk, n_c = S / c
    chunks, g = ``n_groups``, cap the experts' capacity of S/g tokens;
    MLA: r the latent (kv_lora) width, rope its rope key's. In ``tp`` the
    model axis splits the KV heads into G = gcd(KV, M) groups, and each
    head's dh over the M/G ranks of a group where KV % M != 0 (MQA, and
    GQA with fewer heads than ranks: "split dh"), a rank holding h = KV /
    G heads (or parts of them). The formulas come from the reference's
    HLO on its SMOKE configs (2 layers, d = 64, B = 4, S = 64) on (2, 2)
    and (2, 4) ("data", "model") meshes, with and without remat
    (tests/test_torch_launch.py holds every layout below to it):

    ``tp`` prefill (``build_lm_prefill``):
      * per layer: all-reduce [b, S, d] after ``wo`` (the row-parallel
        attention output) and after ``w_down`` (the FFN's; dense);
        MoE: the router's probabilities all-gathered over the data axes
        ([B, S, E]), a collective-permute of the groups' [b, g, M - 1]
        int32 starts, an all-reduce of the combine's gathered [b, g, S/g
        · k, d]; shared experts: an all-reduce [b, S, d];
      * split dh: the rope halves of the new key [b, S, h, dh/2] (two)
        and k_norm's sums [b, S, h] all-reduced over a head's ranks, its
        value chunk [b, kv_chunk, h, dh] all-gathered there (inside the
        KV scan);
      * MLA: kv_ln's sums [b, S] and the rope halves [b, S, 1, rope/2]
        all-reduced; the latent and the rope key sliced out of w_dkv's
        output [b, S, r + rope] split on 'model', each into its own
        split (``_latent_split``: a collective-permute per shard
        distance), the latent [b, S, r] all-gathered whole;
      * ENTRY: all-reduce [b, S, d] of the vocab-sharded embedding lookup.
    ``tp`` decode (``build_lm_decode``), per layer:
      * all-gather of the new key and value [b, KV, dh] and the query
        [b, H, dh] over the head groups, of one new entry [b, h, dh] and
        the query's [b, H h / KV, dh] over a head's ranks; over the data
        axes of the new key and value [B, KV, dh] (the scatter's
        updates);
      * all-reduce over 'model' of the softmax's max and sum [b, H], of
        its weighted values [b, H, dh] (the partials of the split
        sequence) over both groups, after ``wo`` [b, d] and the FFN [b,
        d]; MoE as in prefill at one token a row; split dh: the rope
        halves and k_norm's sums as in prefill; ENTRY: all-reduce [b, d]
        of the embedding lookup, all-gather of the scatter's [B, 2] int32
        indices for the key and the value. MLA: the latent [b, r] and the
        rope and absorbed queries [b, H (rope + r)] gathered, H heads of
        r reduced, the latent split as in prefill at one token.
    ``tp`` train (``sp_mode == "none"``), per layer, the prefill's
    collectives and:
      * all-reduce [b, S, d] of the input gradients of the
        column-parallel products: q, k, v (MLA: wq, w_dkv), the FFN's
        gate and up (up alone without GLU; MoE: the shared experts'); of
        the combine's gather transposed, a scatter-add [b, g, S/g + 1,
        d]; of q_norm's [dh] and k_norm's [dh / (M/G)] gradients;
      * split dh: the value chunk gathered again and the key and value
        chunks' gradients [b, kv_chunk, h, dh] all-reduced (two, in the
        KV scan's backward), k_norm's backward sums;
      * MLA: the latent gathered again; all-reduced: its two gradients
        [b, S, r] (from w_uk and w_uv), kv_ln's backward sums [b, S],
        the rope key's gradient [b, S, rope] (summed over the split
        heads); the pieces' gradients padded back into w_dkv's split
        (``_latent_split(backward=True)``);
      * remat: the forward's per-layer collectives again, but the dense
        FFN's and the shared experts' output all-reduces;
      * ENTRY: per loss chunk the head's input gradient [b, c, d] and its
        [b, c] sums, two partial losses, and the head's [V/M, d] weight
        gradient chunks over the data axes (one tuple of n_c).
    ``cp`` train (``build_lm_train``'s default), per layer:
      * all-gather of each 2-D layer weight, 2-D sharded for storage, in
        the forward and again in the backward (``_weight_gathers``), of
        the norms ln1, ln2, q/k-norm (or kv_ln) over the data axes, and
        in the forward of K and V [b, S, KV·dh] over 'model' (queries
        stay sequence-sharded); MoE: the routed experts' [E/M, d, f]
        all-gathered over the data axes (forward) and reduce-scattered
        (backward), the router's [b, S, E] over 'model' and [B, S, E]
        over the data axes, the dispatch and combine all-to-alls of
        [b, g/M, E, cap, d] in the forward and the backward;
      * all-reduce over 'model' of dK and dV [b, KV, S, dh] (inside the
        attention's scan); the weights' gradients in three tuples: every
        norm and 2-D weight over 'model' (0), then over the data axes
        the attention's projections with the FFN's output or the router,
        and the norms (k_norm only with remat) with the FFN's gate and
        up;
      * MLA: the backward keeps the latent's gradient split on r: kv_ln
        is not gathered again, w_uk and w_uv only over their output
        dim's axis; it gathers a [b, S, H·v] gradient and kv_ln's [b, S]
        scales over 'model', switches the latent's gradient pieces
        between the r and the sequence split (five all-to-alls of [b, S,
        r/M]) and moves kv_ln's gradient [r/M]; the weights' gradients
        leave in three tuples of more than five (0);
      * remat: the forward's K, V, router and expert gathers and its
        all-to-alls again, every norm's gather (ENTRY's too), MLA's w_uk
        and w_uv whole; without MLA, K and V three more times (the
        attention's checkpointed chunks and their backward);
      * ENTRY: all-gather of the embedding [V, d] over 'model', of
        final_ln [d] (forward and backward) and of norms sharded on
        their L dim, of the targets' [b, c] chunks (forward and remat,
        2 n_c) and of h [b, S, d] over 'model' for the loss head;
        collective-permutes of the targets' [b, c/M] slices (n_c (M -
        1)); the loss chunks' all-reduces: [b, c] sums and [b, c, d]
        head input gradients (one tuple of n_c each) and the n_c + 1
        float32 partial losses; the embedding's whole gradient [V, d]
        over 'model' in one tuple with three squared-norm partials under
        MLA (counted), five otherwise (0).
    """
    cfg, meta = plan.config, plan.meta
    kind, mode = meta["kind"], meta.get("mode", "tp")
    dm = _lm_dims(cfg, mesh, meta)
    sizes, dext, mext = dm["sizes"], dm["dext"], dm["mext"]
    B, S, b = dm["B"], dm["S"], dm["b_loc"]
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    moe, mla = cfg.moe, cfg.mla
    c = _Colls(L)
    if kind == "decode":
        s_tokens, split = 1, B % dext == 0
        b = b if split else B
    else:
        s_tokens, split = S, True
    if moe is not None:
        ng = moe.n_groups if s_tokens % max(moe.n_groups, 1) == 0 else 1
        sg = s_tokens // ng
        cap = max(1, math.ceil(sg * moe.top_k / moe.n_experts
                               * moe.capacity_factor))
    x = 4 * b * s_tokens * d  # one float32 [b, S, d] activation
    AR, AG, CP = "all-reduce", "all-gather", "collective-permute"
    if mode == "tp":
        train = kind == "train"
        # remat recomputes each layer's forward in the backward: its
        # collectives again, but the dense FFN's and the shared experts'
        # output all-reduces, whose results the backward does not need
        fwd, bwd = (2 if train and cfg.remat else 1), int(train)
        ffn_in = 2 if cfg.glu else 1  # the FFN's column-parallel inputs
        cols = 2 if mla is not None else 3  # wq, w_dkv; or wq, wk, wv
        # the row-parallel attention output, and the embedding lookup
        c.add(AR, x, mext, loop=True, times=fwd)
        c.add(AR, x, mext, loop=False)
        if moe is None:
            c.add(AR, x, mext, loop=True)
            cols += ffn_in
        else:
            e = moe.n_experts
            c.add(AG, 4 * B * s_tokens * e, dext, loop=True, times=fwd)
            c.add(CP, 4 * b * ng * (mext - 1), mext, loop=True, times=fwd)
            c.add(AR, 4 * b * ng * sg * moe.top_k * d, mext, loop=True,
                  times=fwd)
            if train:  # the combine's gather transposed: a scatter-add
                c.add(AR, 4 * b * ng * (sg + 1) * d, mext, loop=True)
            if moe.n_shared:
                c.add(AR, x, mext, loop=True)
                cols += ffn_in
        if train:  # the input gradients of the column-parallel products
            c.add(AR, x, mext, loop=True, times=cols)
        # the model axis over the heads: gk groups of them, a head's dh
        # split over the g ranks of a group (KV % M != 0: MQA, GQA), kv_h
        # heads to a rank
        split_kv = mla is None and KV % mext != 0
        gk = math.gcd(KV, mext)
        g, kv_h = mext // gk, KV // gk
        rope = mla.qk_rope_dim if mla is not None else dh
        if kind == "decode":
            s_ext = mext if split else mesh.devices.size
            if mla is None:
                # the new key and value entries and the query, over the
                # head groups and over a head's dh split (one entry)
                c.add(AG, 4 * b * KV * dh, gk, loop=True, times=2)
                c.add(AG, 4 * b * kv_h * dh, g, loop=True)
                c.add(AG, 4 * b * H * dh, gk, loop=True)
                c.add(AG, 4 * b * H * dh * kv_h / KV, g, loop=True)
                entries, pv = (KV * dh, KV * dh), H * dh
            else:
                # the new latent entry, the rope and absorbed queries
                r = mla.kv_lora_rank
                c.add(AG, 4 * b * r, mext, loop=True)
                c.add(AG, 4 * b * H * (rope + r), mext, loop=True)
                entries, pv = (r, rope), H * r
            if split:
                for n in entries:
                    c.add(AG, 4 * B * n, dext, loop=True)
                c.add(AG, 4 * B * 2, dext, loop=False, times=2)
            c.add(AR, 4 * b * H, s_ext, loop=True, times=2)
            if mla is None and split:  # over the two groups
                c.add(AR, 4 * b * pv, g, loop=True)
                c.add(AR, 4 * b * pv, gk, loop=True)
            else:
                c.add(AR, 4 * b * pv, s_ext, loop=True)
        if split_kv or mla is not None:
            # the new key's rope halves, reduced over the dh-split (MLA:
            # its one rope head over the latent's split) shards
            heads, ext = (1, mext) if mla is not None else (kv_h, g)
            c.add(AR, 4 * b * s_tokens * heads * (rope // 2), ext,
                  loop=True, times=2 * fwd)
        if split_kv and cfg.qk_norm:  # k_norm's sums over the split dh
            c.add(AR, 4 * b * s_tokens * kv_h, g, loop=True,
                  times=fwd + bwd)
        if split_kv and kind != "decode":
            # the value chunk, inside the attention's KV scan (again in
            # its backward, with the key and value chunks' gradients)
            chunk = 4 * b * min(cfg.kv_chunk, S) * kv_h * dh
            c.add(AG, chunk, g, loop=True, times=fwd + bwd)
            if train:
                c.add(AR, chunk, g, loop=True, times=2)
        if train and cfg.qk_norm:  # q_norm's and k_norm's gradients
            c.add(AR, 4 * dh, mext, loop=True)
            c.add(AR, 4 * dh / g, gk, loop=True)
        if mla is not None:
            r = mla.kv_lora_rank
            # kv_ln's sums over the latent's split; the latent and the
            # rope key sliced out of w_dkv's split output
            c.add(AR, 4 * b * s_tokens, mext, loop=True, times=fwd)
            for _ in range(fwd):
                _latent_split(c, b * s_tokens, r, rope, mext,
                              backward=False)
            if kind != "decode":  # the latent whole, for w_uk and w_uv
                c.add(AG, 4 * b * S * r, mext, loop=True, times=fwd + bwd)
            if train:
                # the latent's gradients from w_uk and w_uv, kv_ln's
                # backward sums, the rope key's gradient summed over the
                # split heads; the pieces' gradients padded back
                c.add(AR, 4 * b * S * r, mext, loop=True, times=2)
                c.add(AR, 4 * b * S, mext, loop=True)
                c.add(AR, 4 * b * S * rope, mext, loop=True)
                _latent_split(c, b * S, r, rope, mext, backward=True)
        if train:
            # ENTRY: per loss chunk the head's input gradient and its
            # sums, and two partial losses; the head's weight gradient
            # chunks over the data axes
            lc = min(cfg.loss_chunk, S)
            n_c = S // lc
            c.add(AR, 4 * b * lc * d + 4 * b * lc, mext, loop=False,
                  times=n_c)
            c.add(AR, 4, mext, loop=False, times=2)
            c.add_tuple(AR, [4 * (V / mext) * d] * n_c, dext)
        return c
    if mode != "cp":
        raise ValueError(f"lm_collective_bytes covers the cells' layouts, "
                         f"tp and cp; got {mode!r}")
    from repro_torch.launch.cells import lm_param_specs
    from repro_torch.models.transformer import param_structs
    params = param_structs(cfg)
    specs = lm_param_specs(cfg, params, mesh, "cp")
    layers, lspecs = params["layers"], specs["layers"]
    if moe is not None:
        layers = dict(layers, **layers["moe"])
        lspecs = dict(lspecs, **lspecs["moe"])
        del layers["moe"], lspecs["moe"]
    norms = [n for n in ("ln1", "q_norm", "k_norm", "kv_ln", "ln2")
             if n in layers]
    mats = [n for n, t in layers.items() if t.dim() == 3 and n not in norms]
    experts = [n for n, t in layers.items() if t.dim() == 4]
    # remat: the rematerialised forward gathers every norm again, and the
    # weights the backward does not gather whole; the other weights'
    # gathers it shares with the backward
    fwd = 2 if cfg.remat else 1
    for phase in ("forward", "backward", "remat")[:1 + fwd]:
        # MLA's backward keeps the latent's gradient split on r over
        # 'model': kv_ln is not gathered again, w_uk and w_uv only over
        # their output dim's axis
        split_r = mla is not None and phase == "backward"
        for n in norms:
            if not (split_r and n == "kv_ln"):
                c.add(AG, 4 * layers[n].shape[1],
                      axes_extent(lspecs[n][1], sizes), loop=True)
        for n in mats:
            latent = mla is not None and n in ("w_uk", "w_uv")
            if phase != "remat" or latent:
                _weight_gathers(c, layers[n].shape, lspecs[n], sizes,
                                whole=not (split_r and latent))
    if mla is None:
        kv_width = (KV * dh, KV * dh)
    else:
        kv_width = (H * (mla.qk_nope_dim + mla.qk_rope_dim),
                    H * mla.v_head_dim)
    for w in kv_width:
        c.add(AG, 4 * b * S * w, mext, loop=True, times=fwd)
        c.add(AR, 4 * b * S * w, mext, loop=True)
    if cfg.remat and mla is None:
        # K and V again in the attention's checkpointed chunks, and once
        # more in their backward
        c.add(AG, 4 * b * S * KV * dh, mext, loop=True, times=3)
    for n in experts:
        e, f_in, f_out = layers[n].shape[1:]
        whole = 4 * e * f_in * f_out / mext
        c.add(AG, whole, dext, loop=True, times=fwd)
        c.add("reduce-scatter", whole / dext, dext, loop=True)
    if moe is not None:
        e = moe.n_experts
        c.add(AG, 4 * b * S * e, mext, loop=True, times=fwd)
        c.add(AG, 4 * B * S * e, dext, loop=True, times=fwd)
        c.add("all-to-all", 4 * b * (ng // mext) * e * cap * d, mext,
              loop=True, times=2 * fwd + 2)

    def nbytes(names):
        return [4 * math.prod(layers[n].shape[1:]) for n in names]

    # the weights' gradients leave each layer in three all-reduces: every
    # norm and 2-D weight over 'model' (a tuple of more than five: 0),
    # then the rest over the data axes
    c.add_tuple(AR, nbytes(norms + mats), mext, loop=True)
    if mla is None:
        # the attention's projections with the FFN's output (or the
        # router); the norms with the FFN's column-parallel inputs
        # (without remat k_norm's goes with the first)
        ffn_in = [n for n in mats if n in ("w_gate", "w_up")]
        c.add_tuple(AR, nbytes([n for n in mats if n not in ffn_in]), dext,
                    loop=True)
        c.add_tuple(AR, nbytes([n for n in norms if cfg.remat
                                or n != "k_norm"] + ffn_in), dext,
                    loop=True)
    else:
        r = mla.kv_lora_rank
        # two tuples of more than five (0); the backward's own: a [b, S,
        # H·v] gradient gathered over the sequence for the products with
        # the latent, kv_ln's [b, S] scales; the latent's gradient pieces
        # switched between the r split and the sequence split (five
        # all-to-alls of [b, S, r/M]); kv_ln's gradient [r/M] moved to its
        # storage layout
        grads = nbytes(norms + mats)
        c.add_tuple(AR, grads[::2], dext, loop=True)
        c.add_tuple(AR, grads[1::2], dext, loop=True)
        c.add(AG, 4 * b * S * H * mla.v_head_dim, mext, loop=True)
        c.add(AG, 4 * b * S, mext, loop=True)
        c.add("all-to-all", 4 * b * S * r / mext, mext, loop=True, times=5)
        c.add(CP, 4 * r / mext, min(dext, mext), loop=True)
    # ENTRY: the embedding, final_ln, norms sharded on L, the loss head
    c.add(AG, 4 * V * d, axes_extent(specs["embed"][0], sizes), loop=False)
    c.add(AG, 4 * d, axes_extent(specs["final_ln"][0], sizes), loop=False,
          times=2)
    for n in norms:
        lead = axes_extent(lspecs[n][0], sizes)
        c.add(AG, 4 * L * layers[n].shape[1]
              / axes_extent(lspecs[n][1], sizes), lead, loop=False,
              times=fwd)
    lc = min(cfg.loss_chunk, S)
    n_c = S // lc
    c.add(AG, 4 * b * lc, mext, loop=False, times=2 * n_c)
    c.add(AG, 4 * b * S * d, mext, loop=False)
    c.add(CP, 4 * b * lc / mext, mext, loop=False, times=n_c * (mext - 1))
    c.add_tuple(AR, [4 * b * lc] * n_c, mext)
    c.add_tuple(AR, [4 * b * lc * d] * n_c, mext)
    c.add_tuple(AR, [4] * (n_c + 1), dext)
    # the embedding's whole gradient over 'model', in one tuple with
    # squared-norm partials of the gradients: three under MLA (counted),
    # five otherwise (0)
    c.add_tuple(AR, [4] * (3 if mla is not None else 5) + [4 * V * d],
                mext)
    return c


# ---------------------------------------------------------------------------
# the LM branch
# ---------------------------------------------------------------------------

def spec_bytes(tree, specs, mesh) -> int:
    """The bytes one rank holds of ``tree`` under ``specs`` (the sum of
    each leaf's shard: ``NamedSharding.shard_shape`` in the reference)."""
    return sum(math.prod(shard_shape(t.shape, sp, mesh)) * t.element_size()
               for _, t, sp in leaves_with_specs(tree, specs))


def _shards(tree, specs, mesh):
    """``tree``'s per-rank shards as meta tensors."""
    return map_with_specs(tree, specs, lambda t, sp: meta_tensor(
        shard_shape(t.shape, sp, mesh), t.dtype))


def _local_lm_cfg(cfg, kind: str, mode: str, mext: int):
    """The config a rank runs, its weights at the widths it computes
    with. ``tp`` divides the heads (not in a decode: its query is
    all-gathered against a cache of every head), the FFN, the experts'
    capacity and the vocabulary by the model extent, as the probe's
    ``_local_cfg`` does, with the cell's own chunking and remat; ``cp``
    keeps every width (each layer's weights are gathered whole) but the
    vocabulary, and a rank dispatches its own group. A rank's routed
    experts are E/M of them (expert parallel on 'model'); the local run
    keeps all E (top-k needs them) at an FFN width of f/M, so the expert
    weights it casts and holds are a rank's E/M experts' bytes (their
    products and [.., cap, f] intermediates are then M times below a
    rank's, in ``tp`` where the capacity is divided too)."""
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, d_expert_ff=max(1, cfg.moe.d_expert_ff // mext))
    if mode == "cp":
        moe = moe and dataclasses.replace(
            moe, n_groups=max(1, moe.n_groups // mext))
        return dataclasses.replace(cfg, moe=moe,
                                   vocab=max(1, cfg.vocab // mext))
    local = dataclasses.replace(
        _local_cfg(dataclasses.replace(cfg, moe=moe), mext, 1),
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, remat=cfg.remat,
        vocab=max(1, cfg.vocab // mext))
    if kind == "decode":
        local = dataclasses.replace(local, n_heads=cfg.n_heads,
                                    n_kv_heads=cfg.n_kv_heads)
    return local


def _lm_local_shapes(plan, mesh) -> tuple:
    """(b, s) a rank's step runs: the batch over the data extent; the
    sequence over 'model' in ``cp``, and in a decode as
    ``decode_layout`` splits the cache."""
    meta = plan.meta
    dext, mext = mesh_extents(mesh)
    b, s = meta["batch"], meta["seq"]
    if meta["kind"] == "decode":
        b_ax, s_ax, _ = decode_layout(mesh, b)
        sizes = mesh_sizes(mesh)
        return b // axes_extent(b_ax, sizes), s // axes_extent(s_ax, sizes)
    return b // dext, s // mext if meta.get("mode") == "cp" else s


def lm_local_step(plan, mesh) -> tuple:
    """(config, b, s) of the step a rank of ``plan`` on ``mesh`` runs:
    ``_local_lm_cfg`` of the plan's config, ``_lm_local_shapes``."""
    meta = plan.meta
    lcfg = _local_lm_cfg(plan.config, meta["kind"], meta.get("mode", "tp"),
                         mesh_extents(mesh)[1])
    return (lcfg, *_lm_local_shapes(plan, mesh))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_train_inputs(cfg, b: int, s: int, device="meta",
                    generator=None) -> tuple:
    """(params, batch) of a rank's train step at ``cfg``, batch ``b`` x
    sequence ``s``: on meta the shapes alone; on a card the weights and
    tokens drawn from ``generator`` (a plain tree, no leaf requiring
    gradients, as on meta)."""
    from repro_torch.models.transformer import init_params, param_structs
    from repro_torch.tree import param_tree, tree_map

    if torch.device(device).type == "meta":
        return param_structs(cfg), {
            k: meta_tensor((b, s), torch.int32)
            for k in ("tokens", "targets")}
    params = tree_map(lambda t: t.detach(),
                      param_tree(init_params(generator, cfg, device=device)))
    return params, {k: torch.randint(0, cfg.vocab, (b, s),
                                     generator=generator, device=device,
                                     dtype=torch.int32)
                    for k in ("tokens", "targets")}


def lm_train_loss(cfg):
    """The train step's loss, ``loss(params, batch)``."""
    from repro_torch.models.transformer import loss_fn
    return lambda p, bt: loss_fn(p, bt["tokens"], bt["targets"], cfg)


def lm_train_measure(cfg, params, batch) -> tuple:
    """(peak, counter) of the layered part of a rank's train step on
    ``lm_train_inputs``' tensors: ``CostCounter`` over the loss's forward
    and backward (every gradient), and ``P_act``, the peak above the
    inputs of the forward and backward with gradients taken for the
    embedding, head and final norm only (the moment
    :func:`lm_local_run` takes for the activations). On a card the peak
    is the allocator's above what was resident; elsewhere (meta, the
    CPU) ``LiveBytes``'."""
    from repro_torch.launch.live_bytes import LiveBytes
    from repro_torch.train.steps import value_and_grad

    loss = lm_train_loss(cfg)
    cc = CostCounter()
    with cc:
        value_and_grad(loss, params, batch)
    top = [v.requires_grad_(True) for k, v in params.items()
           if k != "layers"]
    dev = top[0].device
    if dev.type != "cuda":
        with LiveBytes() as lb:
            torch.autograd.grad(loss(params, batch), top)
        peak = lb.peak
    else:
        torch.cuda.synchronize(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.autograd.grad(loss(params, batch), top)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - resident
    for v in top:
        v.requires_grad_(False)
    return peak, cc


def lm_extrapolate(points: dict, n_layers: int) -> tuple:
    """(peak, cost record) at ``n_layers`` from ``points`` (layer count ->
    (peak, cost record)), affine through the two largest counts."""
    lo, hi = sorted(points)[-2:]
    (p_lo, c_lo), (p_hi, c_hi) = points[lo], points[hi]
    k = (n_layers - hi) / (hi - lo)
    peak = p_hi + round(k * (p_hi - p_lo))
    cost = {key: v + k * (v - c_lo[key]) if key != "bytes_are" else v
            for key, v in c_hi.items()}
    return peak, cost


def lm_train_total(plan, mesh, peak: int, cost: dict) -> tuple:
    """(temp_bytes, raw_cost) of a rank's whole train step from the
    layered part's ``peak`` (``P_act``) and ``cost`` at the cell's depth:
    AdamW's count added, and the largest of the three moments of
    :func:`lm_local_run` (plus one gathered layer in ``cp``)."""
    from repro_torch.models.common import Params
    from repro_torch.launch.live_bytes import LiveBytes
    from repro_torch.models.transformer import param_structs
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.schedule import cosine_schedule

    # the parameters as a module, updated in place (as the port's train
    # path runs them), and the gradients and moments as trees
    shards = Params(_shards(plan.args[0], plan.specs[0], mesh))
    grads, m, v = (_shards(plan.args[0], plan.specs[0], mesh)
                   for _ in range(3))
    state = {"m": m, "v": v, "step": meta_tensor((), torch.int32)}
    cc = CostCounter()
    with LiveBytes() as lb_opt, cc:
        lr = cosine_schedule(state["step"], 3e-4, 100, 10000)
        adamw_update(grads, state, shards, lr)
    opt = _cost_record(cc)
    cost = {k: v + opt[k] if k != "bytes_are" else v
            for k, v in cost.items()}
    g = _tree_bytes(grads)
    s_max = max(t.numel() * t.element_size()
                for t in tree_leaves(grads["layers"]))
    temp = max(peak, g + s_max, g + lb_opt.peak)
    if plan.meta.get("mode") == "cp":
        temp += _tree_bytes(param_structs(
            dataclasses.replace(plan.config, n_layers=1))["layers"])
    return temp, cost


def lm_local_run(spec, cell, plan, mesh) -> dict:
    """One call of the cell's step as a rank runs it, on meta tensors:
    ``{"temp_bytes", "raw_cost", "layers_run", "points"}``.

    Prefill and decode: the step at the rank's config
    (``_local_lm_cfg``) and shapes (``_lm_local_shapes``) under
    ``LiveBytes`` and ``CostCounter``; the peak above the inputs is the
    temporaries (the logits included; a decode writes its cache in
    place).

    Train: the step's parts apart, as a sharded step holds them. Its
    FLOPs and bytes: ``CostCounter`` over the loss's forward and backward
    at the rank's config and shapes (:func:`lm_train_measure`), and over
    AdamW on the rank's shards. Its memory, the largest of three moments
    of the step (:func:`lm_train_total`):

      * ``P_act``: the peak of the loss's forward and backward with
        gradients taken for the embedding, head and final norm only (the
        loss head's chunks and the first recomputed layer come before
        the layers' weight gradients build up);
      * ``G + S`` at the end of the backward: ``G``, the rank's gradient
        shards under the plan's specs (every layer's weight gradients
        reduce-scattered to the storage layout in ``cp``; ``tp``'s are
        the local shards), and ``S``, the largest layer leaf's shard (the
        port's backward stacks a stacked leaf's per-layer gradients:
        slices and stack live together);
      * ``G + P_opt``: AdamW's peak on the rank's shards (the parameters
        a module updated in place, as the port's train path holds them),
        the new moments included;

    and ``cp`` also holds one layer's gathered float32 weights (the
    reference's per-layer all-gathers carry float32), which the local
    run takes as inputs.

    Every layer runs the same ops on the same shapes, so the peak and the
    counts of the layered part are affine in the layer count L: they are
    measured at 2, 3 and 4 layers and extrapolated to L when both
    differences agree (else the call runs at L). ``layers_run`` says
    which; ``points`` holds each measured count's (peak, cost record),
    which a run of the same parts on a card is held to.

    Not counted: collective buffers (NCCL's own), and the allocator's
    rounding of large blocks past 512 B."""
    from repro_torch.launch.live_bytes import LiveBytes
    from repro_torch.models.transformer import init_cache, param_structs

    kind = plan.meta["kind"]
    lcfg, b, s = lm_local_step(plan, mesh)
    i32 = torch.int32

    def measure(n: int) -> tuple:
        """(peak, cost record) of the layered part at ``n`` layers."""
        ncfg = dataclasses.replace(lcfg, n_layers=n)
        if kind == "train":
            peak, cc = lm_train_measure(ncfg, *lm_train_inputs(ncfg, b, s))
            return peak, _cost_record(cc)
        params = param_structs(ncfg)
        fn = build_cell(dataclasses.replace(spec, config=ncfg), cell).fn
        if kind == "prefill":
            args = (params, meta_tensor((b, s), i32))
        else:
            args = (params, init_cache(ncfg, b, s, device="meta"),
                    meta_tensor((b,), i32), meta_tensor((b,), i32))
        cc = CostCounter()
        with torch.no_grad(), LiveBytes() as lb, cc:
            fn(*args)
        return lb.peak, _cost_record(cc)

    n_layers, points = lcfg.n_layers, (2, 3, 4)
    layers_run = f"extrapolated from {points}"
    if n_layers <= points[-1]:
        runs = {n_layers: measure(n_layers)}
        (peak, cost), layers_run = runs[n_layers], n_layers
    else:
        runs = {n: measure(n) for n in points}
        steps = {runs[n + 1][0] - runs[n][0] for n in points[:2]}
        counts = [runs[n][1]["flops"] for n in points]
        if len(steps) == 1 and counts[2] - counts[1] == counts[1] - counts[0]:
            peak, cost = lm_extrapolate(runs, n_layers)
        else:
            peak, cost = measure(n_layers)
            layers_run = n_layers
    if kind == "train":
        temp, cost = lm_train_total(plan, mesh, peak, cost)
    else:
        temp = peak
    return {"temp_bytes": temp, "raw_cost": cost, "layers_run": layers_run,
            "points": runs}


def _cost_record(cc) -> dict:
    return {"flops": float(cc.flops), "bytes": float(cc.bytes),
            "transcendentals": float(cc.transcendentals),
            "bytes_are": "unfused eager traffic of the port's ops"}


def run_lm_cell(spec, cell, mesh, mesh_name: str) -> dict:
    """The LM branch: the cell's record on ``mesh``, the reference's keys
    with the port's counterparts (see the module docstring)."""
    rec = {
        "arch": spec.arch_id, "shape": cell.name, "kind": cell.kind,
        "mesh": mesh_name, "n_devices": int(mesh.devices.size),
        "note": cell.note, "ok": False,
    }
    try:
        t0 = time.perf_counter()
        plan = build_cell(spec, cell, mesh)
        meta, cfg = plan.meta, spec.config
        rec["mode"] = meta["mode"]
        dext, mext = mesh_extents(mesh)
        arg = spec_bytes(plan.args, plan.specs, mesh)
        if meta["kind"] == "train":
            out = spec_bytes(plan.args[:2], plan.specs[:2], mesh)
        else:
            b, _ = _lm_local_shapes(plan, mesh)
            elem = torch.tensor([], dtype=cfg.dtype).element_size()
            out = b * -(-cfg.vocab // mext) * elem
            if meta["kind"] == "decode":
                out += spec_bytes(plan.args[1], plan.specs[1], mesh)
        local = lm_local_run(spec, cell, plan, mesh)
        # every output is written in place over an input (a decode's
        # cache) or made during the step (counted in temp_bytes)
        mem = {"argument_bytes": arg, "output_bytes": out,
               "temp_bytes": local["temp_bytes"], "alias_bytes": out}
        peak = (mem["argument_bytes"] + mem["output_bytes"]
                + mem["temp_bytes"] - mem["alias_bytes"])
        mem["peak_bytes_per_device"] = peak
        mem["fits_80g_hbm"] = bool(peak < HBM_PER_CHIP)
        rec["memory"] = mem
        rec["raw_cost"] = local["raw_cost"]
        rec["layers_run"] = local["layers_run"]
        kind, b, s = meta["kind"], meta["batch"], meta["seq"]
        rec["probe_model"] = meta.get("probe_model", mext)
        rec["probe_data"] = meta.get("probe_data", dext)
        corr = lm_cell_cost(cfg, kind, b, s, rec["probe_model"],
                            rec["probe_data"])
        rec["flops_per_chip"] = corr["flops"]
        rec["flops_per_chip_xla_cpu"] = corr["flops_xla_cpu"]
        rec["bytes_per_chip"] = corr["bytes"]
        rec["model_flops_global"] = lm_model_flops(cfg, kind, b, s)
        rec["useful_flops_ratio"] = (
            rec["model_flops_global"]
            / (corr["flops"] * mesh.devices.size) if corr["flops"] else None)
        colls = _lm_collectives(plan, mesh)
        coll = rec["collectives"] = colls.totals()
        rec["collective_ops"] = colls.op_list()
        rec["collectives_moved"] = colls.moved()
        rec["collectives_checked"] = True
        rec["hlo_collective_loop_factor"] = float(cfg.n_layers)
        rec["roofline"] = roofline(corr["flops"], corr["bytes"],
                                   coll["total"]).to_dict()
        rec["build_s"] = time.perf_counter() - t0
        rec["ok"] = True
    except (ValueError, TypeError, KeyError, RuntimeError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


# ---------------------------------------------------------------------------
# the GNN and recsys branch
# ---------------------------------------------------------------------------

def _leaf_bytes(tree) -> list:
    return [t.numel() * t.element_size() for t in tree_leaves(tree)]


def gnn_collective_bytes(plan, mesh) -> dict:
    """``_gnn_collectives(plan, mesh)``' bytes by op, in the parse's
    convention, with their ``"total"``."""
    return _gnn_collectives(plan, mesh).totals()


def _gnn_collectives(plan, mesh) -> _Colls:
    """The collective bytes one call of a GNN cell's train step moves on
    each rank of ``mesh``: the counterpart of what ``repro.launch.dryrun``
    parses out of the reference's compiled step
    (``repro.launch.roofline.collective_bytes``, loop factor 1: the
    models are unrolled), in that parse's convention: the bytes of each
    op's result on a rank, an all-reduce twice, a tuple of more than five
    arrays 0 (``_Colls.add_tuple``; ``moved()`` counts those whole).
    Every op spans all P ranks (the flattened mesh). float32 throughout.

    The formulas come from the reference's HLO on its SMOKE configs on
    (2, 2) and (2, 4) meshes at 2 to 4 layers, d = 16 and 24 (N the
    padded nodes, L layers, d the hidden width, S = (l_max + 1)^2 and H
    heads for Equiformer-v2). GSPMD gathers every node table whole and
    all-reduces every segment reduction over the [N + 1] segments (the
    dump row included); its backward all-gathers each segment output's
    cotangent at [N + P] (N + 1 padded to a multiple of P) after moving
    it between the two row layouts by collective-permutes of P - 1 rows,
    one each way:

      * tree layout (``minibatch_lg``): the trees are independent, so the
        one collective is the gradient all-reduce, every parameter and the
        loss in one tuple (0 in the parse);
      * PNA: per layer the table [N, d]; all-reduces of the max and min
        [N + 1, d], of the sums (layer 0: the degree, the count and a
        third [N + 1] vector with the sum and square sum [N + 1, d];
        middle layers: the two sums and one [N + 1]; the last: the two
        sums); permutes of 4 [P - 1, d] each way a layer and L + 1 [P - 1];
        4 [N + P, d] gathers a layer;
      * MeshGraphNet: per layer the table [N, d], the sum [N + 1, d], one
        [P - 1, d] permute each way, one [N + P, d] gather;
      * EGNN: per layer the tables [N, 3] and [N, d]; the sums (layer 0:
        [N + 1, d], the degree [N + 1], [N + 1, 3]; middle layers [N + 1,
        d] and [N + 1, 3]; the last [N + 1, d] alone: its coordinates are
        unused); permutes of [P - 1, d] each way a layer, one [P - 1], and
        [P - 1, 3] each way for all but the last; gathers of [N + P, d] a
        layer and [N + P, 3] for all but the last;
      * Equiformer-v2: the coordinates [N, 3] once; per layer the irreps
        table [N, S, d], three [H, N + 1] all-reduces (the attention's
        segment softmax) and the sum [N + 1, S, d], one [P - 1, S, d]
        permute each way, one [N + P, S, d] gather, a tuple of two [H, N +
        1] and the irreps cotangent [N, S, d];
      * the backward's gradient all-reduces: every parameter, the loss and
        the node-table cotangents (two [N, d] a layer; EGNN also two [N,
        3] for all but the last), combined into tuples of more than five
        arrays (0), but for PNA and EGNN the encoder's weight and bias,
        the decoder's weight and the loss, four arrays, counted.
    """
    meta, cfg = plan.meta, plan.config
    p = int(mesh.devices.size)
    c = _Colls(1)
    params = plan.args[0]
    grads = _leaf_bytes(params) + [4]
    if meta.get("layout") == "tree":
        c.add_tuple("all-reduce", grads, p)
        return c
    n, L, d = meta["n_nodes"], cfg.n_layers, cfg.d_hidden
    if L < 2:
        raise ValueError(f"the counts are taken at 2 or more layers; "
                         f"got {L}")
    arch = type(cfg).__name__
    AG, AR, CP = "all-gather", "all-reduce", "collective-permute"

    def x(*dims):
        return 4 * math.prod(dims)

    cot = [x(n, d)] * 2 * L     # the node tables' cotangents
    counted = []                # the backward's four-array tuple
    if arch == "PNAConfig":
        c.add(AG, x(n, d), p, times=L)
        c.add(AR, x(n + 1, d), p, times=2 * L)
        c.add_tuple(AR, [x(n + 1)] * 3 + [x(n + 1, d)] * 2, p)
        c.add_tuple(AR, [x(n + 1, d)] * 2 + [x(n + 1)], p, times=L - 2)
        c.add_tuple(AR, [x(n + 1, d)] * 2, p)
        c.add(CP, x(p - 1, d), p, times=8 * L)
        c.add(CP, x(p - 1), p, times=L + 1)
        c.add(AG, x(n + p, d), p, times=4 * L)
        cot += [x(n + 1, d)] * 2 * L
        counted = [params["encode"][0]["w"], params["encode"][0]["b"],
                   params["decode"][0]["w"]]
    elif arch == "MGNConfig":
        c.add(AG, x(n, d), p, times=L)
        c.add(AR, x(n + 1, d), p, times=L)
        c.add(CP, x(p - 1, d), p, times=2 * L)
        c.add(AG, x(n + p, d), p, times=L)
    elif arch == "EGNNConfig":
        c.add(AG, x(n, 3), p, times=L)
        c.add(AG, x(n, d), p, times=L)
        c.add_tuple(AR, [x(n + 1, d), x(n + 1), x(n + 1, 3)], p)
        c.add_tuple(AR, [x(n + 1, d), x(n + 1, 3)], p, times=L - 2)
        c.add(AR, x(n + 1, d), p)
        c.add(CP, x(p - 1, d), p, times=2 * L)
        c.add(CP, x(p - 1), p)
        c.add(CP, x(p - 1, 3), p, times=2 * (L - 1))
        c.add(AG, x(n + p, d), p, times=L)
        c.add(AG, x(n + p, 3), p, times=L - 1)
        cot += [x(n, 3)] * 2 * (L - 1)
        counted = [params["encode"][0]["w"], params["encode"][0]["b"],
                   params["decode"][0]["w"]]
    elif arch == "EquiformerConfig":
        s, h = cfg.n_sph, cfg.n_heads
        c.add(AG, x(n, 3), p)
        c.add(AG, x(n, s, d), p, times=L)
        c.add(AR, x(h, n + 1), p, times=3 * L)
        c.add(AR, x(n + 1, s, d), p, times=L)
        c.add(CP, x(p - 1, s, d), p, times=2 * L)
        c.add(AG, x(n + p, s, d), p, times=L)
        c.add_tuple(AR, [x(h, n + 1)] * 2, p, times=L)
        c.add(AR, x(n, s, d), p, times=L)
        cot = []
    else:
        raise ValueError(f"no collective count for {arch}")
    counted = [t.numel() * t.element_size() for t in counted]
    if counted:
        c.add_tuple(AR, counted + [4], p)
        rest = list(grads[:-1])
        for b in counted:
            rest.remove(b)
    else:
        rest = grads
    c.add_tuple(AR, rest + cot, p)
    return c


def recsys_collective_bytes(plan, mesh) -> dict:
    """``_recsys_collectives(plan, mesh)``' bytes by op, in the parse's
    convention, with their ``"total"``."""
    return _recsys_collectives(plan, mesh).totals()


def _recsys_collectives(plan, mesh) -> _Colls:
    """The collective bytes one call of a DCN-v2 cell moves on each rank
    of ``mesh`` (D ranks on the batch axes, M on 'model'), in the
    parse's convention (``_gnn_collectives``). From the reference's HLO on
    its SMOKE config (2 to 6 tables) on (2, 2) and (2, 4) meshes:

      * every cell: the lookups in the row-sharded tables, all-reduced
        over 'model', one tuple of ``n_sparse`` [b, D_e] arrays (b the
        rank's rows: B / D for train and serve, the one query for
        retrieval, whose query is replicated);
      * train: the tables' squared gradient norms over 'model' (AdamW's
        clip), one tuple of ``n_sparse`` scalars, and the gradient
        all-reduce over the batch axes: every parameter (a table as its
        [V / M, D_e] shard) and the loss, one tuple.

    Retrieval's scores stay sharded: no collective gathers them."""
    meta, cfg = plan.meta, plan.config
    dext, mext = mesh_extents(mesh)
    c = _Colls(1)
    k, e = cfg.n_sparse, cfg.embed_dim
    rows = 1 if meta["kind"] == "retrieval" else meta["batch"] // dext
    c.add_tuple("all-reduce", [4 * rows * e] * k, mext)
    if meta["kind"] == "recsys_train":
        c.add_tuple("all-reduce", [4] * k, mext)
        shards = [math.prod(shard_shape(t.shape, sp, mesh)) * t.element_size()
                  for _, t, sp in leaves_with_specs(plan.args[0],
                                                    plan.specs[0])]
        c.add_tuple("all-reduce", shards + [4], dext)
    return c


def _rank_args(plan, mesh) -> tuple:
    """The rank's shards of ``plan.args`` as meta tensors, the parameters
    as the cell's model (on meta, a table as its shard)."""
    model = plan.init(torch.Generator(), device="meta")
    shards = _shards(plan.args, plan.specs, mesh)
    if hasattr(model, "tables"):
        for name, t in shards[0]["tables"].items():
            model.tables[name] = torch.nn.Parameter(t)
    return (model,) + tuple(shards[1:])


def model_local_run(plan, mesh) -> dict:
    """One call of a GNN or DCN-v2 cell's step as a rank of ``mesh`` runs
    it (``cells.rank_step``) on meta tensors: ``{"temp_bytes",
    "raw_cost"}``, ``LiveBytes``' peak (the bytes the call's ops made and
    still held at once: every temporary, the gradients, the new AdamW
    moments and the collectives' results) and ``CostCounter``'s totals.
    A serving call runs without autograd, as the card serves."""
    from repro_torch.launch.cells import rank_step
    from repro_torch.launch.live_bytes import LiveBytes
    fn = rank_step(plan, mesh)
    args = _rank_args(plan, mesh)
    train = plan.meta["kind"] in ("gnn_train", "recsys_train")
    cc = CostCounter()
    with torch.set_grad_enabled(train), LiveBytes() as lb, cc:
        fn(*args)
    return {"temp_bytes": lb.peak, "raw_cost": _cost_record(cc)}


def _model_output_bytes(plan, mesh) -> tuple:
    """(output bytes, alias bytes) a rank's call returns: train the
    donated parameters and AdamW state; serve its [B / D] float32
    logits; retrieval its [1, NC / P] scores."""
    kind = plan.meta["kind"]
    if kind in ("gnn_train", "recsys_train"):
        out = spec_bytes(plan.args[:2], plan.specs[:2], mesh)
        return out, out
    if kind == "recsys_serve":
        return 4 * plan.meta["batch"] // mesh_extents(mesh)[0], 0
    return 4 * plan.meta["candidates"] // int(mesh.devices.size), 0


def run_model_cell(spec, cell, mesh, mesh_name: str) -> dict:
    """The GNN and recsys branch: the cell's record on ``mesh``, the
    reference's keys with the port's counterparts (see the module
    docstring)."""
    rec = {
        "arch": spec.arch_id, "shape": cell.name, "kind": cell.kind,
        "mesh": mesh_name, "n_devices": int(mesh.devices.size),
        "note": cell.note, "ok": False,
    }
    try:
        t0 = time.perf_counter()
        plan = build_cell(spec, cell, mesh)
        n_dev = int(mesh.devices.size)
        out, alias = _model_output_bytes(plan, mesh)
        local = model_local_run(plan, mesh)
        mem = {"argument_bytes": spec_bytes(plan.args, plan.specs, mesh),
               "output_bytes": out, "temp_bytes": local["temp_bytes"],
               "alias_bytes": alias}
        peak = (mem["argument_bytes"] + mem["output_bytes"]
                + mem["temp_bytes"] - mem["alias_bytes"])
        mem["peak_bytes_per_device"] = peak
        mem["fits_80g_hbm"] = bool(peak < HBM_PER_CHIP)
        rec["memory"] = mem
        rec["meta"] = dict(plan.meta)
        cost = rec["raw_cost"] = local["raw_cost"]
        # the models are unrolled: the counts are exact
        rec["flops_per_chip"] = cost["flops"]
        rec["bytes_per_chip"] = cost["bytes"]
        rec["model_flops_global"] = cost["flops"] * n_dev
        rec["useful_flops_ratio"] = 1.0 if cost["flops"] else None
        colls = (_gnn_collectives if spec.family == "gnn"
                 else _recsys_collectives)(plan, mesh)
        coll = rec["collectives"] = colls.totals()
        rec["collectives_moved"] = colls.moved()
        rec["collective_ops"] = colls.op_list()
        rec["collectives_checked"] = True
        rec["hlo_collective_loop_factor"] = 1.0
        rec["roofline"] = roofline(cost["flops"], cost["bytes"],
                                   coll["total"]).to_dict()
        rec["build_s"] = time.perf_counter() - t0
        rec["ok"] = True
    except (ValueError, TypeError, KeyError, RuntimeError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def run_cell(spec, cell, mesh, mesh_name: str) -> dict:
    """The cell's record on ``mesh`` (the LM, LPA, or GNN and recsys
    branch)."""
    if spec.family == "lm":
        return run_lm_cell(spec, cell, mesh, mesh_name)
    if spec.family == "lpa":
        return run_lpa_cell(spec, cell, mesh, mesh_name)
    return run_model_cell(spec, cell, mesh, mesh_name)


def _meshes(which: str, ranks, family: str) -> list:
    """The meshes of ``--mesh``, and with ``ranks`` one of that many
    ranks: 1-D ("shard") for the LPA cells, (ranks, 1) ("data",
    "model") for the LM, GNN and recsys cells (data parallel: one rank
    holds a model, DCN-v2's tables whole on its one 'model' rank)."""
    meshes = []
    if which in ("single", "both"):
        meshes.append(("single_pod_16x16", make_production_mesh()))
    if which in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16",
                       make_production_mesh(multi_pod=True)))
    if ranks is not None:
        mesh = (make_mesh((ranks,), ("shard",)) if family == "lpa"
                else make_mesh((ranks, 1), ("data", "model")))
        meshes.append((f"ranks_{ranks}", mesh))
    return meshes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="lpa-mg8",
                    help="an arch id, or all (every LM, GNN, recsys and "
                         "LPA arch)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="also a mesh of this many ranks (1: one card)")
    ap.add_argument("--out", default="launch_results_torch/dryrun")
    args = ap.parse_args(argv)

    try:
        specs = [get_arch(a) for a in (all_arch_ids() if args.arch == "all"
                                       else [args.arch])]
    except KeyError as e:
        print(f"dryrun: {e.args[0]}", file=sys.stderr)
        return 2
    if args.ranks is not None and args.ranks < 1:
        ap.error(f"--ranks must be positive, got {args.ranks}")
    n_ok = n_fail = 0
    for spec in specs:
        for mesh_name, mesh in _meshes(args.mesh, args.ranks, spec.family):
            outdir = os.path.join(args.out, mesh_name)
            os.makedirs(outdir, exist_ok=True)
            for cell in spec.cells:
                if args.shape != "all" and cell.name != args.shape:
                    continue
                rec = run_cell(spec, cell, mesh, mesh_name)
                if rec["ok"]:
                    r, mem = rec["roofline"], rec["memory"]
                    extra = (f" peak={mem['peak_bytes_per_device']/1e9:.2f}GB"
                             f" fits={mem['fits_80g_hbm']}"
                             f" bottleneck={r['bottleneck']}"
                             f" t_lb={r['step_time_lb_s']*1e3:.2f}ms")
                else:
                    extra = " " + rec["error"][:160]
                print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {mesh_name} "
                      f"{spec.arch_id}/{cell.name}{extra}", flush=True)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
                path = os.path.join(outdir,
                                    f"{spec.arch_id}__{cell.name}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
