"""Dry run of the paper's LPA cells: per-rank memory, bytes, FLOPs,
collectives and roofline terms of every cell of ``lpa-mg8`` on a mesh of
ranks, from shapes alone. A host computation: the workspaces are meta
tensors and nothing is allocated on any device.

The port's counterpart of the LPA branch of ``repro.launch.dryrun``,
which lowers and compiles each cell's step with XLA and reads XLA's
analyses. The port has no compiler to ask, so each figure has a named
counterpart here:

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

The ranks: the reference's two production meshes (``--mesh``: 256 and
512 ranks) and any 1-D count (``--ranks 1``: one card). A cell whose
int32 positions cannot index its per-rank arrays is recorded ``ok:
false`` with that reason (``web_4b`` on one rank: 3.4 B entries). The
LM, GNN and recsys branches of the reference's dry run are not ported
(ROADMAP, Queue 1): another ``--arch`` exits non-zero and writes nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch lpa-mg8 \\
      --mesh both --ranks 1
Results land in launch_results_torch/dryrun/<mesh>/<arch>__<shape>.json;
``python -m repro_torch.launch.report`` tabulates them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.distributed import (DistLPAWorkspace,
                                          lpa_collective_bytes)
from repro_torch.launch.cells import build_lpa_cell, lpa_cell_engine
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.roofline import roofline

__all__ = ["HBM_PER_CHIP", "ALLOC_GRAIN", "workspace_bytes",
           "lpa_step_temp_bytes", "lpa_step_bytes", "int32_overflow",
           "run_cell", "main"]

HBM_PER_CHIP = 80e9  # NVIDIA H100 80GB
#: the CUDA caching allocator rounds every block up to a multiple of this
ALLOC_GRAIN = 512
INT32_MAX = 2**31 - 1
#: what ports the dry run's other branches
NOT_PORTED = ("the {family} branch of the dry run (repro.launch.dryrun) "
              "is not ported: ROADMAP Queue 1, item 2 (launch/), the "
              "slice after the LPA half")


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


def run_cell(spec, cell, mesh, mesh_name: str) -> dict:
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


def _meshes(which: str, ranks) -> list:
    meshes = []
    if which in ("single", "both"):
        meshes.append(("single_pod_16x16", make_production_mesh()))
    if which in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16",
                       make_production_mesh(multi_pod=True)))
    if ranks is not None:
        meshes.append((f"ranks_{ranks}", make_mesh((ranks,), ("shard",))))
    return meshes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="lpa-mg8")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="also a 1-D mesh of this many ranks (1: one card)")
    ap.add_argument("--out", default="launch_results_torch/dryrun")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lpa":
        print(f"dryrun: {args.arch}: " + NOT_PORTED.format(
            family=spec.family), file=sys.stderr)
        return 2
    if args.ranks is not None and args.ranks < 1:
        ap.error(f"--ranks must be positive, got {args.ranks}")
    n_ok = n_fail = 0
    for mesh_name, mesh in _meshes(args.mesh, args.ranks):
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        for cell in spec.cells:
            if args.shape != "all" and cell.name != args.shape:
                continue
            rec = run_cell(spec, cell, mesh, mesh_name)
            if rec["ok"]:
                r = rec["roofline"]
                extra = (f" peak={rec['memory']['peak_bytes_per_device']/1e9:.2f}GB"
                         f" fits={rec['memory']['fits_80g_hbm']}"
                         f" bottleneck={r['bottleneck']}"
                         f" t_lb={r['step_time_lb_s']*1e3:.2f}ms")
            else:
                extra = " " + rec["error"][:160]
            print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {mesh_name} "
                  f"{spec.arch_id}/{cell.name}{extra}", flush=True)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
            path = os.path.join(outdir, f"{spec.arch_id}__{cell.name}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
