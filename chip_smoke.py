#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's LPA methods through the hand-written CUDA kernels, in
phases; any failure raises and exits non-zero. The paths, each read with
the kernel launch counts set to 0 just before it:

  * νMG8-LPA — ``lpa(graph, LPAConfig(method="mg", k=8, chunk=128,
    fold_backend="pallas_fused"))``, the paper's headline method (K1, K2);
  * νBM-LPA — ``method="bm"`` on the same engine (K3);
  * the double-scan ablation — ``method="mg", rescan=True`` (K1, K4);
  * exact LPA — ``method="exact"``, plain torch (no fold kernel), the O(|E|)
    baseline whose memory the sketches are compared against;
  * the frontier marks — one FM launch (``kernels.frontier``) an
    iteration on every path above that tracks the frontier, the
    plain-torch engine's included;
  * the streamed engine — νMG8 through ``fold_backend="auto"``, which
    resolves to ``pallas_stream`` past the budget (K5, K6; unaligned),
    and νMG8, νBM and the rescan ablation on ``pallas_stream`` with
    ``aligned_layout=True`` (K5 + K6, K7, K5 + K8);
  * the per-bucket engine — νMG8, νBM and the rescan ablation on
    ``fold_backend="pallas"`` (K9 on every bucket of every round; K10 on
    every round-0 bucket; the padded tiles are a plain torch gather);
  * sparse frontier execution — νMG8 with ``frontier_gate=True`` on
    ``pallas_fused``, dense and ``frontier_sparse=True`` (K1, K2 over the
    compacted rows), and sparse on ``pallas_stream`` with the aligned
    layout (K5, K6 over the compacted windows); each sparse run at the
    default capacity and at one every iteration fits.
  * the partitioner — ``lpa_partition(graph, 4, config)`` with the
    νMG8 config above (K1, K2), then the numpy packing;
  * distributed LPA — ``dist_lpa`` over 4 ``gloo`` ranks sharing the
    card (``spawn_ranks``; each label exchange staged through the host),
    each shard folding its single-width plan: K1 every round on
    ``pallas_fused`` (K3 for νBM, K4 for the rescan), K5 on
    ``pallas_stream`` (K7, K8), K9 on ``pallas`` (K10);
  * the GNN serving path — ``lpa_partition`` of a 2^18 graph (K1, K2),
    then PNA, MeshGraphNet and EGNN forwards at full width on it, PNA on
    sampled ``minibatch_lg`` batches and Equiformer-v2 and EGNN on the
    ``molecule`` cell (plain torch: matmuls, gathers and scatters; the
    GNN layers have no TPU kernel to port);
  * the training path — ``lpa_partition`` of the 2^18 graph again (K1,
    K2), then train steps (forward, backward, hand-written AdamW with the
    cosine schedule; plain torch) of PNA FULL on it, of PNA and
    MeshGraphNet on ``minibatch_lg`` trees, of the four archs on
    ``molecule`` and ``full_graph_sm``, and of DCN-v2 FULL (46.88 M
    table rows); its checkpoints, the launcher's crash and resume, and
    data-parallel steps over 4 gloo ranks (no kernel but K1/K2);
  * the LM family — the five transformer LMs (GQA, MQA, qk-norm, MLA,
    MoE) served and trained through ``repro_torch.launch.cells``'
    prefill, decode and train cells at full width (plain torch: the
    reference's attention, MoE dispatch and loss have no TPU kernel to
    port);
  * the paper's own cells — ``lpa-mg8``'s ``web_560m`` at its size
    (18.5 M vertices, ~562 M directed slots) run to convergence through
    ``launch.cells.build_lpa_cell``'s step on a one-rank NCCL group, on
    the fused layout (K1 every round), and the cell's own bucketed step
    (K9 every round) at 2^20 and 2^16 vertices.

Phases:

  0. the device (nvidia-smi name and power limit, torch's view of it);
  1. build the kernel libraries from ``src/repro_torch/csrc/`` (one nvcc
     per source, all started together; sm_90a) and print the build times
     and ptxas's registers, static shared memory and spills per kernel
     instantiation;
  2. each kernel against its plain-torch version on the card, with exact
     equality (float32 outputs as int32 bits), and its time (CUDA
     events) beside the bytes it must move:
     K1–K4 at the round shapes of the main graph's fused plan, K5–K8 at
     those of its streamed plan,
     K9/K10 at every bucket shape of its bucketed plan (also per bucket
     and per bucket width, with their dynamic shared memory); the rescan
     merge's time, the streamed engine's
     windowed re-layout per iteration, unaligned and aligned, and the
     per-bucket engine's padded-tile gather per round, on the main graph;
  3. whole-path parity: on a 2^16-vertex graph the kernels
     (``pallas_fused``, ``pallas``, and ``auto``, which resolves to
     ``pallas_stream`` there) against the plain-torch engine (``jnp``)
     for mg and bm, equal labels and histories; the frontier-gated mg
     runs there, dense on ``jnp`` and ``pallas_fused`` and sparse on
     ``pallas_fused`` at the default capacity and at one that overflows
     on some iterations, all equal; then the plain-torch engine's whole
     mg, bm and mg+rescan runs on the main graph, which phase 4's kernel
     runs must reproduce;
  4. the paths on ``powerlaw_communities(1 << 22)`` (4.19 M vertices,
     ~90 M directed CSR slots) with launch counts checked, labels and
     histories equal to phase 3's plain runs (the streamed runs: equal to
     the fused runs of the same method; the sparse runs: equal to the
     fused dense gated run), quality (modularity, NMI against the
     planted truth; one modularity call timed, and the bm run's computed
     twice, to equal bits, and once in float64), seconds per iteration
     and peak device memory; FM held to its plain version on every
     iteration's ``changed`` mask of the mg run and of the dense gated
     run (and an all-true one), each mg mask timed beside its bytes;
     exact LPA's group sums held to the CPU's on non-integer weights;
     the peak memories side by side;
  4w. the int64 instantiations (a graph whose offsets are int64: past
     2**31 - 1 slots): K1-K4 with int64 starts on rows that start on
     both sides of 2**31 (one straddles it) in entry arrays of 2**31 +
     2**20 entries, and FM with int64 offsets over them, each equal to
     its plain version; ``lpa()`` with int64 offsets on the main graph
     (mg, bm, rescan, gated sparse) and on a 2048 x 2048 grid (mg, one
     round: K2 wide), each equal to the int32 run (labels, histories,
     launch counts), with its launches counted by width; the wide
     kernels timed and held to plain as in phases 2 and 4;
  5. the runtime contracts and the partitioner: on the 2^16 graph, mg
     and bm on every engine replayed through ``get_engine(...,
     checked=True)`` beside the bare engine (equal wanted labels and
     launch counts each iteration, ``lpa()``'s labels at the end, a NaN
     weight raising ``ContractError``); then ``lpa_partition(graph, 4)``
     on the main graph with the main path's config, its edge cut beside
     ``contiguous_parts``'s and its seconds;
  6. distributed LPA: 4 gloo ranks on the card (one process each,
     started once). At 2^16, every rank builds each workspace itself
     and runs mg, bm and the rescan on jnp, pallas, pallas_fused and
     pallas_stream (unaligned and aligned), with the full gather and the
     halo exchange, and gated mg on pallas_fused: each equal to the
     single-host ``lpa()`` of its method and engine on the card (labels,
     iterations), with the plan's launches on every rank. At 2^22, fused
     mg with the full gather and with the halo exchange, fused bm and
     fused rescan with halo, and aligned streamed mg with halo, each
     equal to phase 4's single-host run of its method, every rank
     building each workspace itself. Before every run, each kernel
     launch of its first step (K1, K3, K4; K5, K7, K8; K9, K10) is held
     to its plain twin, int32 bits, on the inputs the shard mover gave
     it on the rank's own blocks (the 2^16 streamed shards carry
     appended all-pad windows and unused stride columns, which the phase
     requires and prints). Per rank at 2^22: the step's ms (median over
     a timed replay), the label exchange's ms alone and its bytes
     (received, and staged through the host), peak device memory,
     launches (checked against the plan) and the build seconds, the
     halo tables' among them;
  7. the GNN serving path, float32 matmuls with TF32 off (asserted):
     (a) PNA, MeshGraphNet and EGNN at SMOKE on the full-graph batch of
     a 2^12 graph and Equiformer-v2 on 16 molecules, one state dict on
     the card and on the CPU, within rtol = atol = 1e-4 (Equiformer
     1e-3), with the largest difference between two card runs; (b) the
     example's path: ``lpa_partition(graph, 4)`` of
     ``powerlaw_communities(1 << 18)`` with the main config (K1 and K2
     launches equal to the plan's rounds x iterations, each kernel then
     held to its plain version on that plan's rounds as in phase 2, and
     the partition equal to the plain-torch engine's; its edge cut
     beside ``contiguous_parts``'s), then PNA, MeshGraphNet and EGNN at
     FULL width (the cell widths of ``launch/cells.py``: 100 features,
     16 classes) on its full-graph batch; (c) ``minibatch_lg``: three
     batches sampled on the host from the main graph (1,024 seeds,
     fanouts (15, 10), 602 features), PNA FULL on each; (d) the
     ``molecule`` cell (128 molecules of 30 nodes and 64 edges),
     Equiformer-v2 and EGNN at FULL (the cells of
     ``repro_torch.launch.serve``). Each forward: the median of 5
     between CUDA events after 2 warm-up runs, peak device memory, the
     output's shape and finiteness;
  8. the training path, TF32 off (asserted), ``repro_torch.launch.
     train_cells``' cells: (a) each GNN arch and DCN-v2 at SMOKE, 3 train
     steps from one state dict on the card and on the CPU, losses and
     parameters within rtol = atol = 1e-4 (Equiformer 1e-3); (b)
     ``lpa_partition`` of the 2^18 graph as in 7b (K1/K2 launches
     counted, held to plain, equal to jnp's partition), then PNA FULL, 5
     full-graph train steps; (c) ``minibatch_lg`` in the tree layout
     (1,024 trees, fanouts (15, 10), 602 features, one batch a step):
     PNA and MeshGraphNet FULL; (d) ``molecule``: Equiformer-v2 and EGNN
     FULL; ``full_graph_sm`` (2,708 nodes, 10,556 edges, 1,433 features):
     all four FULL; (e) DCN-v2 FULL (tables drawn on a CUDA generator):
     5 train steps of 65,536 rows, a ``CheckpointManager`` save and
     restore of the whole state bit for bit (bytes, seconds), forwards at
     512 and 262,144 rows, one query against 1,000,000 candidates; (f)
     ``python -m repro_torch.launch.train --arch dcn-v2`` uninterrupted
     and, beside it, with ``--fail-at 6``, then relaunched: the resumed
     losses and last checkpoint equal the uninterrupted run's bit for
     bit; (g)
     ``make_dp_train_step`` over 4 gloo ranks on the card, PNA FULL on
     256 trees a rank, int8 and plain: every rank's parameters equal bit
     for bit, step and all-reduce ms and bytes per rank. Every train
     step: ms between CUDA events (median after the first), peak device
     memory, loss;
  9. the LM family (``repro_torch.launch.serve``'s ``LM_CELLS``), TF32
     off (asserted) in the float32 parts, parameters drawn on a CUDA
     generator: (a) each arch at SMOKE, one state dict on the card and
     on the CPU, in float32: forward, ``loss_fn`` and a 12-token
     decode's logits within rtol = atol = 1e-4, and 3 train steps'
     losses and parameters too; then the configs' bfloat16 on both, the
     largest difference printed; (b) each FULL config cut to 2 layers,
     float32: 12 one-token decode steps' logits against the forward's
     (2e-4 dense, 5e-4 MLA; MoE capacity raised so nothing drops); (c)
     qwen3-1.7b FULL, 28 layers, bf16: ``prefill_32k`` (batch 2),
     ``decode_32k`` (batch 16 against a 32,768 cache), ``long_500k``
     (batch 1, a 524,288 cache), ``train_4k`` (batch 8, 5 steps, remat);
     (d) glm4-9b FULL, 40 layers: prefill (batch 1) and decode (16); (e)
     deepseek-v2-lite (27 layers), granite-34b (40 of 88) and
     qwen3-moe-235b (4 of 94): prefill at seq 4,096 (batch 2) and decode
     against a 32,768 cache; (f) ``python -m repro_torch.launch.train
     --arch qwen3-1.7b`` (SMOKE) as 8f runs DCN-v2: the resumed losses
     and last checkpoint equal the uninterrupted run's bit for bit. Each
     timed cell: ms (median between CUDA events after a warm-up; a 32k
     prefill warms up on its first 4,096 tokens), tokens/s, peak device
     memory and the
     bound (bytes at 3.35 TB/s or bf16 FLOPs at 989 TFLOP/s,
     ``launch.serve.lm_cost``);
  10. the paper's LPA cells (``configs/lpa_graphs.py``, the LPA half of
     ``repro_torch.launch``): (a) ``launch.dryrun`` of ``web_4b``,
     ``web_560m`` and ``web_4b_halo`` on 1, 256 and 512 ranks, host
     arithmetic on meta workspaces: per-rank workspace bytes, the step's
     temporaries (``lpa_step_temp_bytes``), peak and fit in 80 GB, bytes
     moved, collectives, roofline terms and bottleneck, and
     ``launch.report``'s table (the 3.4 B-slot cells cannot run on one
     rank: int32 positions); (b) ``web_560m`` at its size:
     ``powerlaw_communities(18_500_000, p_in=0.79, mix=0.02, seed=1)``
     within 1% of the cell's 567 M slots, the fused workspace
     (``build_dist_workspace(graph, 1, k=8, chunk=128, fused=True)``;
     the cell's bucketed layout needs more than 80 GB on one rank), both
     built on the host by a process of this script's own
     (``--write-web-cell``) started at phase 7 and waited for here, run
     to convergence by ``dist_lpa`` through ``build_lpa_cell``'s step on
     a one-rank NCCL group, every K1 launch held to its plain version
     (int32 bits, 2^22 rows at a time); the run again with each step
     between CUDA events (median), resident and peak memory; one step's
     ``ShardComm.bytes_by_op`` equal to ``lpa_collective_bytes``, its
     temporaries within 5% of ``lpa_step_temp_bytes`` and the roofline's
     t_lb (``lpa_step_bytes``) not above the measured step; a
     ``torch.profiler`` table of 3 steps; modularity and communities;
     (c) the cell's own bucketed step (``engine="pallas"``, K9) at 2^20
     vertices: its temporaries within 5% of ``lpa_step_temp_bytes``,
     each K9 launch equal to its plain version; at 2^16, the cell's step
     to convergence on both layouts equal to single-host ``lpa()`` on
     the same engine, label for label;
  11. the LM half of the dry run (``launch.probes``, ``launch.cost``,
     the LM branch of ``launch.dryrun``, ``train.elastic.remesh``): (a)
     the dry run of the five LM archs' four cells on 256 and 512 ranks
     and on one, host work on meta tensors in processes of this
     script's own (``--lm-dryrun``) started at phase 7: per-rank peak and
     fit in 80 GB, the three roofline terms, bottleneck and t_lb, and
     the report's table; (b) each arch's probe layer at train_4k's local
     shapes on the 16 x 16 mesh, and qwen3-1.7b's prefill_32k layer (its
     [2, 1, 32,768, 32,768] float32 score square, unchunked), at the
     published widths on the card: ``CostCounter``'s totals on the card
     equal to meta's, the median ms of 5 calls (CUDA events) not below
     the roofline's t_lb of the counted FLOPs and bytes, ``LiveBytes``'
     peak on meta within 5% of the allocator's above resident; (c) the
     dry run of qwen3-1.7b on one rank at phase 9's shapes: argument
     bytes within 5% of phase 9's resident bytes (less what was
     allocated before its model), temp bytes within 5% of its working
     bytes; (d) qwen3-1.7b FULL saved by the checkpoint manager and
     restored by ``remesh`` on 4 gloo ranks sharing the card under "tp"
     and "fsdp" on a (2, 2) mesh: every shard equal to its slice, the
     shards gathered on rank 0 equal to the tree, a (1, 3) mesh raising
     before anything moves; (e) the rank-local train steps (the parts
     ``dryrun.lm_local_run`` measures on meta: the loss forward and
     backward at the rank's config and shapes on the 16 x 16 mesh,
     published widths, 2 and 3 layers) of deepseek's context-parallel
     ``train_4k`` and of the tensor-parallel train of deepseek,
     granite-34b and qwen3-moe: ``CostCounter``'s totals on the card
     equal to meta's, the allocator's ``P_act`` within 5% of
     ``LiveBytes``' on meta, the median ms of 5 steps beside the t_lb
     of the counted FLOPs and bytes, and the card's points extrapolated
     to the cell's depth equal to the dry run's ``raw_cost`` and within
     5% of its ``temp_bytes``;
  12. the GNN and recsys half of the dry run (the mesh layouts of the
     GNN and DCN-v2 cells, ``cells.rank_step`` and the GNN and recsys
     branch of ``launch.dryrun``): (a) the dry run of the four GNN
     archs' and DCN-v2's four cells on 256 and 512 ranks and on one, and
     of minibatch_lg's PNA on 8g's 4 ranks, host work on meta tensors in
     processes of this script's own (``--gnn-dryrun``) started at phase
     7: per-rank peak and fit in 80 GB, the three roofline terms,
     bottleneck and t_lb, and the report's table; (b) the one-rank
     records of phase 8's cells (8c minibatch_lg with PNA and
     MeshGraphNet, 8d molecule and full_graph_sm, 8e DCN-v2 at 65,536,
     512 and 262,144 rows and 1,000,000 candidates) against the same
     cells run on the card at the same widths: argument bytes within 5%
     of the bytes resident for the call's inputs, temp bytes within 5%
     of the call's peak above them, t_lb not above the median call,
     ``CostCounter``'s totals on the card equal to meta's; (c) the
     4-rank record's collective bytes within 1% of what ``ShardComm``
     recorded a step in 8g's plain (float32) run;
  13. one JSON line describing every kernel (K1 and K2 also list the
     partitions of phases 7 and 8 as ``gnn_partition`` and
     ``train_partition``; K1 and K9 the cells of phase 10; FM every
     path's launches; K1w-K4w and FMw, the int64 instantiations, phase
     4w's launches by width).

The last line of standard output is ``{"ok": true, "device": {...}}``.
Run from the root of a checkout: ``python3 chip_smoke.py``. Without a
CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: HBM rate of one H100 SXM (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores of one H100 SXM, operations/s
F32_OPS_PER_S = 67e12
SEEDS = (1, 2, 5, 11)
#: log2 vertices of the main-path graph and of the small parity graph
SCALE = 22
PARITY_SCALE = 16
#: clock cycles of the device-side wait that timed launches queue behind
#: (about 50 ms at the H100's ~1.98 GHz boost clock)
QUEUE_WAIT_CYCLES = 100_000_000
#: launch-count keys of the fused kernels K1–K4, the streamed K5–K8 and
#: the per-bucket tile kernels K9–K10
FUSED_KEYS = ("fused_fold", "fused_select", "bm_fold", "rescan")
STREAM_KEYS = ("stream_fold", "stream_select", "stream_bm", "stream_rescan")
TILE_KEYS = ("tile_mg_fold", "tile_bm_fold")
#: a sparse row capacity every frontier fits: each iteration compacted
FIT_ALL_CAP = 1 << 30
#: kernel library -> its source in the repo
KERNEL_SOURCES = {"mg_fused": "src/repro_torch/csrc/mg_fused.cu",
                  "mg_stream": "src/repro_torch/csrc/mg_stream.cu",
                  "mg_tile": "src/repro_torch/csrc/mg_tile.cu",
                  "frontier_marks": "src/repro_torch/csrc/frontier_marks.cu"}


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: mangled-name fragment -> kernel, most specific first
_KERNEL_OF_SYMBOL = (("frontier_marks", "FM frontier_marks"),
                     ("tile_bm_fold", "K10 tile_bm_fold"),
                     ("tile_fold", "K9 tile_fold"),
                     ("stream_bm", "K7 stream_bm"),
                     ("stream_rescan", "K8 stream_rescan"),
                     ("stream_select", "K6 stream_select"),
                     ("stream_fold", "K5 stream_fold"),
                     ("bm_fold", "K3 bm_fold"), ("rescan", "K4 rescan"),
                     ("select", "K2 select"), ("fold", "K1 fold"))


#: mangled-name fragment -> names of the kernel's template arguments,
#: most specific first
_TEMPLATE_ARGS = (("tile_bm_fold", ("C", "aligned")),
                  ("tile_fold", ("k", "C", "aligned")))


def _ptxas_summary(report: str) -> list[str]:
    """One line per kernel instantiation: its template arguments,
    registers, static shared memory and spill bytes (the stage of K3, K9
    and K10 is dynamic shared memory, sized per launch: phase 2 prints
    it)."""
    lines, current = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kind = next(k for frag, k in _KERNEL_OF_SYMBOL if frag in name)
            args = re.findall(r"L([ib])(\d+)E", name)
            labels = next((a for frag, a in _TEMPLATE_ARGS if frag in name),
                          ("k",))
            current = " ".join([kind] + [f"{n}={v}" for n, (_, v)
                                         in zip(labels, args)])
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            lines.append((current, spill))
        m = re.search(r"Used (\d+) registers", line)
        if m and lines and lines[-1][0] == current:
            smem = re.search(r"(\d+) bytes smem", line)
            lines[-1] = (current, f"{m.group(1)} registers, "
                         f"{smem.group(1) if smem else 0} B static shared "
                         f"memory, {lines[-1][1]}")
    return [f"{name}: {info}" for name, info in lines]


def _time_ms(fn, *, warmup: int, reps: int) -> float:
    """Median device time of one ``fn()`` over ``reps`` calls (CUDA events).

    All ``reps`` calls, each between its own pair of events, are queued
    behind a device-side wait (``torch.cuda._sleep``), so the host has put
    them all in the stream before the card reaches the first: an event
    interval holds the call's device work, not the host's launch overhead
    (wrapper checks, allocation, the ctypes call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(QUEUE_WAIT_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(a, b) -> float:
    import torch
    if a.numel() == 0:
        return 0.0
    return float(torch.max(torch.abs(a.double() - b.double())))


def _same_bits(a, b) -> bool:
    """``torch.equal``, on the int32 bits of float32 tensors (so -0.0 is
    not +0.0 there)."""
    import torch
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _check_same_run(ref, got, where: str) -> None:
    """Two ``lpa()`` results must agree on labels and every history."""
    import torch
    if not torch.equal(ref.labels, got.labels):
        raise AssertionError(f"{where}: the labels differ from the "
                             f"reference run's")
    for field in ("iterations", "converged", "changed_history",
                  "frontier_history", "work_rows_history"):
        if getattr(ref, field) != getattr(got, field):
            raise AssertionError(f"{where}: {field} differs: "
                                 f"{getattr(ref, field)} vs "
                                 f"{getattr(got, field)}")


def kernels_vs_plain(graph, plan, tag: str, phase: str = "2",
                     row_contiguous: bool = True) -> dict:
    """Phase 2: K1 on every round but the last, K2 on the last, each held
    to exact equality with its plain version on two inputs of the round's
    shape: random entries from a small label alphabet (every branch of the
    fold and every tie-break runs) and the main path's own first iteration
    (labels = vertex ids, each round fed the previous round's output).
    The kernel and plain times are taken on the main path's inputs, the
    kernel's also on the random ones; bytes and bounds per round. Phase
    7b runs it on the 2^18 graph's plan (``phase`` names the phase in
    the printed lines; ``row_contiguous`` adds round 0's diagnostic)."""
    import numpy as np
    import torch
    from repro_torch.kernels.mg_sketch import fused

    dev = graph.device
    k, chunk = plan.k, plan.chunk
    stats = {key: {"ms": 0.0, "plain_ms": 0.0, "random_ms": 0.0,
                   "bound_ms": 0.0, "bytes": 0, "ops": 0, "max_abs_err": 0.0,
                   "rounds": []} for key in ("K1", "K2")}
    labels0 = torch.arange(graph.n_nodes, dtype=torch.int32, device=dev)
    main_el = torch.index_select(labels0, 0, graph.indices)
    main_ew = graph.weights
    for r, rnd in enumerate(plan.rounds):
        rng = np.random.default_rng(r)
        n_in = rnd.n_entries_in
        rand_el = torch.from_numpy(rng.integers(-1, 24, n_in)
                                   .astype(np.int32)).to(dev)
        rand_ew = torch.from_numpy((rng.integers(0, 8, n_in) * 0.375)
                                   .astype(np.float32)).to(dev)
        rows = rnd.row_start.numel()
        entries = int(rnd.row_count.sum())
        if r < plan.n_rounds - 1:
            key = "K1"
            seeds = (None,)

            def kernel(el, ew, seed, rnd=rnd):
                return fused.fused_fold_round(rnd, el, ew, k=k, chunk=chunk)

            def plain(el, ew, seed, rnd=rnd):
                return fused.fused_fold_round_plain(rnd, el, ew, k=k,
                                                    chunk=chunk)
            n_bytes = 8 * entries + 8 * rows + 8 * k * rows
        else:
            key = "K2"
            seeds = SEEDS
            rv = rnd.row_vertex
            rand_inc = torch.from_numpy(rng.integers(-1, 24, rows)
                                        .astype(np.int32)).to(dev)
            rand_inc = torch.where(rv >= 0, rand_inc, -1)
            main_inc = torch.where(rv >= 0, labels0[torch.clamp_min(rv, 0)],
                                   -1)

            def kernel(el, ew, seed, rnd=rnd):
                inc = main_inc if el is main_el else rand_inc
                return fused.fused_select_round(rnd, el, ew, inc, seed, k=k,
                                                chunk=chunk)

            def plain(el, ew, seed, rnd=rnd):
                inc = main_inc if el is main_el else rand_inc
                return fused.fused_select_round_plain(rnd, el, ew, inc, seed,
                                                      k=k, chunk=chunk)
            n_bytes = 8 * entries + 8 * rows + 4 * rows + 4 * rows
        err = 0.0
        for name, el, ew in (("random", rand_el, rand_ew),
                             ("main-path", main_el, main_ew)):
            for seed in seeds:
                got = kernel(el, ew, seed)
                torch.cuda.synchronize()
                ref = plain(el, ew, seed)
                got, ref = ((got,), (ref,)) if key == "K2" else (got, ref)
                for a, b in zip(got, ref):
                    if not _same_bits(a, b):
                        raise AssertionError(
                            f"phase {phase}: {key} differs from its plain "
                            f"version on round {r}, {name} inputs, seed "
                            f"{seed}")
                    err = max(err, _max_abs_err(a, b))
        seed = seeds[0] if key == "K1" else 1
        random_ms = _time_ms(lambda: kernel(rand_el, rand_ew, seed),
                             warmup=3, reps=20)
        ms = _time_ms(lambda: kernel(main_el, main_ew, seed), warmup=3,
                      reps=20)
        plain_ms = _time_ms(lambda: plain(main_el, main_ew, seed), warmup=1,
                            reps=3)
        n_ops = 2 * k * entries  # a compare and an update per slot and entry
        bound, by = _bound_ms(n_bytes, n_ops)
        s = stats[key]
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["random_ms"] += random_ms
        s["bound_ms"] += bound
        s["bytes"] += n_bytes
        s["ops"] += n_ops
        s["bound_by"] = by
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["rounds"].append({"round": r, "rows": rows, "entries": entries,
                            "ms": ms, "random_ms": random_ms,
                            "plain_ms": plain_ms, "bound_ms": bound})
        print(f"{tag} phase {phase}: {key} round {r}: rows {rows}, entries "
              f"{entries}, exact match to plain on random and main-path "
              f"inputs; kernel {ms:.4f} ms on the main path's inputs "
              f"({random_ms:.4f} ms on random ones), plain {plain_ms:.3f} "
              f"ms, {n_bytes} B, bound {bound:.4f} ms ({by} at 3.35 TB/s), "
              f"{bound / ms:.1%} of bound", flush=True)
        if r == 0 and row_contiguous:
            s["row_contiguous_round0"] = _row_contiguous(
                "K1", rnd, main_el, main_ew,
                lambda rnd, el, ew: fused.fused_fold_round(
                    rnd, el, ew, k=k, chunk=chunk), ms, tag, phase)
        if key == "K1":
            out_k, out_v = kernel(main_el, main_ew, None)
            main_el, main_ew = out_k.reshape(-1), out_v.reshape(-1)
        del rand_el, rand_ew
        torch.cuda.empty_cache()
    return stats


def _row_contiguous(key: str, rnd, el, ew, run, csr_ms: float,
                    tag: str, phase: str = "2") -> dict:
    """Diagnostic: a round-0 kernel (``run(rnd, el, ew)``, K1 or K3) with
    its entries copied into row order, so that consecutive rows read
    consecutive entries (the streamed plan's windows lay them out so; the
    fused plan reads each row where its vertex sits in the CSR). Each
    row's entry sequence is unchanged, so the outputs must be equal; only
    the time may move. ``csr_ms`` is the kernel's time on the CSR layout:
    the difference is what the CSR order costs."""
    import torch

    counts = rnd.row_count.reshape(-1).long()
    firsts = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    intra = torch.arange(total, device=el.device) - torch.repeat_interleave(
        firsts, counts, output_size=total)
    perm = torch.repeat_interleave(rnd.row_start.reshape(-1).long(), counts,
                                   output_size=total) + intra
    packed = dataclasses.replace(
        rnd, row_start=firsts.to(torch.int32).reshape(rnd.row_start.shape),
        n_entries_in=total)
    c_el, c_ew = el[perm].contiguous(), ew[perm].contiguous()
    got = run(packed, c_el, c_ew)
    ref = run(rnd, el, ew)
    torch.cuda.synchronize()
    if not all(_same_bits(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"{key} on row-contiguous entries changed its "
                             f"output")
    ms = _time_ms(lambda: run(packed, c_el, c_ew), warmup=3, reps=20)
    print(f"{tag} phase {phase}: diagnostic: {key} round 0 on a "
          f"row-contiguous copy of its entries: {ms:.4f} ms, outputs "
          f"equal; the CSR order costs {csr_ms - ms:.4f} ms ({csr_ms:.4f} "
          f"ms, {csr_ms / ms:.2f}x the row-contiguous time)", flush=True)
    return {"ms": ms, "csr_ms": csr_ms, "csr_order_cost_ms": csr_ms - ms}


def _wall_ms(fn, *, reps: int) -> float:
    """Median host wall time of ``fn()`` ending in a synchronise: for work
    that synchronises inside (a ``nonzero``, a ``unique``), where the CUDA
    events of ``_time_ms`` cannot stay queued behind the device-side
    wait."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bm_rescan_vs_plain(graph, plan, tag: str, phase: str = "2") -> dict:
    """Phase 2 for K3 (BM fold) and K4 (rescan), both on round 0 of the
    main plan, each held to exact equality with its plain version on two
    inputs: random entries from a small label alphabet with random
    incumbents (K3; every branch and the tie wk == w run) or random
    candidates and weights some of which are <= 0 (K4); and the main
    path's first iteration (labels = vertex ids; K3 from the incumbent
    inits, K4 from that iteration's MG candidates). Times as in
    ``kernels_vs_plain``, and the rescan merge's on the main graph
    (``phase`` names the phase in the printed lines)."""
    import numpy as np
    import torch
    from repro_torch.core import sketch
    from repro_torch.kernels.mg_sketch import fused

    dev = graph.device
    k, chunk = plan.k, plan.chunk
    rnd = plan.rounds[0]
    rows = rnd.row_start.numel()
    entries = int(rnd.row_count.sum())
    rtv0 = plan.row_to_vertex0
    real = rtv0 >= 0
    n = plan.n_nodes
    rng = np.random.default_rng(99)
    labels0 = torch.arange(n, dtype=torch.int32, device=dev)
    main_el = torch.index_select(labels0, 0, graph.indices)
    main_ew = graph.weights
    rand_el = torch.from_numpy(rng.integers(-1, 6, rnd.n_entries_in)
                               .astype(np.int32)).to(dev)
    rand_ew = torch.from_numpy((rng.integers(0, 6, rnd.n_entries_in) * 0.375)
                               .astype(np.float32)).to(dev)
    # K4 counts entries of weight <= 0 too: shift some below zero
    rand_ew4 = rand_ew - 0.5
    rand_init = torch.where(real, torch.from_numpy(
        rng.integers(-1, 6, rows).astype(np.int32)).to(dev), -1)
    main_init = sketch.bm_init_rows(rtv0, labels0)
    rand_cand = torch.from_numpy(rng.integers(-1, 6, (rows, k))
                                 .astype(np.int32)).to(dev)
    s_k, _ = fused.run_mg_plan_fused(plan, main_el, main_ew)
    cand = torch.full((n + 1, k), -1, dtype=torch.int32, device=dev)
    rtv = plan.row_to_vertex
    cand[torch.where(rtv >= 0, rtv, n).long()] = s_k
    cand[n] = -1
    main_cand = cand[torch.where(real, rtv0, n).long()]
    del s_k, cand

    cases = {
        "K3": (lambda el, ew, x: fused.bm_fold_round_fused(
                   rnd, el, ew, x, chunk=chunk),
               lambda el, ew, x: fused.bm_fold_round_plain(
                   rnd, el, ew, x, chunk=chunk),
               (rand_el, rand_ew, rand_init), (main_el, main_ew, main_init),
               8 * entries + 12 * rows + 8 * rows, 4 * entries),
        "K4": (lambda el, ew, x: fused.rescan_round_fused(
                   rnd, el, ew, x, k=k, chunk=chunk),
               lambda el, ew, x: fused.rescan_round_plain(
                   rnd, el, ew, x, chunk=chunk),
               (rand_el, rand_ew4, rand_cand),
               (main_el, main_ew, main_cand),
               8 * entries + (8 + 4 * k) * rows + 4 * k * rows,
               2 * k * entries),
    }
    stats = {}
    parts = None
    for key, (kernel, plain, rand_in, main_in, n_bytes, n_ops) in \
            cases.items():
        err = 0.0
        for name, args in (("random", rand_in), ("main-path", main_in)):
            got = kernel(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            got, ref = (got, ref) if key == "K3" else ((got,), (ref,))
            for a, b in zip(got, ref):
                if not _same_bits(a, b):
                    raise AssertionError(f"{key} differs from its plain "
                                         f"version on {name} inputs")
                err = max(err, _max_abs_err(a, b))
            del got, ref
        random_ms = _time_ms(lambda: kernel(*rand_in), warmup=3, reps=20)
        ms = _time_ms(lambda: kernel(*main_in), warmup=3, reps=20)
        plain_ms = _time_ms(lambda: plain(*main_in), warmup=1, reps=3)
        bound, by = _bound_ms(n_bytes, n_ops)
        stats[key] = {"ms": ms, "random_ms": random_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
                      "ops": n_ops, "max_abs_err": err, "rows": rows,
                      "entries": entries}
        print(f"{tag} phase {phase}: {key} round 0: rows {rows}, entries "
              f"{entries}, exact match to plain on random and main-path "
              f"inputs; kernel {ms:.4f} ms on the main path's inputs "
              f"({random_ms:.4f} ms on random ones), plain {plain_ms:.3f} "
              f"ms, {n_bytes} B, bound {bound:.4f} ms ({by} at 3.35 TB/s), "
              f"{bound / ms:.1%} of bound", flush=True)
        if key == "K3":
            stats[key]["row_contiguous"] = _row_contiguous(
                "K3", rnd, main_el, main_ew,
                lambda rnd, el, ew: fused.bm_fold_round_fused(
                    rnd, el, ew, main_init, chunk=chunk), ms, tag, phase)
        if key == "K4":
            parts = kernel(*main_in)
        torch.cuda.empty_cache()
    merge_ms = _wall_ms(lambda: sketch.merge_rescan_partials(
        n, k, plan.max_rows0, rtv0, plan.row_rank0, parts), reps=5)
    stats["merge"] = {"ms": merge_ms, "max_rows0": plan.max_rows0,
                      "vertices_past_rank_chunk": int(torch.unique(
                          rtv0[plan.row_rank0 >= sketch._RANK_CHUNK]).numel())}
    print(f"{tag} phase {phase}: rescan merge (merge_rescan_partials) on "
          f"the main graph's first-iteration partials: {merge_ms:.3f} ms "
          f"(host wall, synchronised), max_rows0 {plan.max_rows0}, "
          f"{stats['merge']['vertices_past_rank_chunk']} vertices with more "
          f"than {sketch._RANK_CHUNK} rows", flush=True)
    return stats


def _plan_bytes(obj) -> int:
    """Device bytes of every tensor a plan holds (rounds included)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_plan_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(_plan_bytes(x) for x in obj)
    return 0


def _stream_rounds_table(plan) -> list[dict]:
    """Per round of a streamed plan: windows, stride W, window slots, real
    entries and row slots (what the re-layout writes and what the kernels
    read)."""
    return [{"round": r, "windows": rnd.n_windows, "W": rnd.window_entries,
             "window_slots": rnd.n_windows * rnd.window_entries,
             "real_entries": int(rnd.row_count.sum()),
             "row_slots": rnd.row_start.numel(), "aligned": rnd.aligned}
            for r, rnd in enumerate(plan.rounds)]


def stream_kernels_vs_plain(graph, plan, aligned_plan, tag: str) -> dict:
    """Phase 2 for K5–K8 on the main graph's (unaligned) streamed plan: K5
    on every round but the last, K6 on the last, K7 and K8 on round 0,
    each held to exact equality with its plain version on random windowed
    entries and on the main path's first iteration (labels = vertex ids,
    each round fed the previous round's kernel output through its
    re-layout); K8 also on the aligned plan's round 0. Each round is
    handed to the kernel and the plain version as an aligned view (its
    entries already windowed), so their times hold the fold alone; the
    re-layout (``windowed_entries``) is timed on its own, per round, and
    the aligned plan's one label gather beside ``labels[indices]``."""
    import numpy as np
    import torch
    from repro_torch.core import sketch
    from repro_torch.kernels.mg_sketch import streaming

    dev = graph.device
    k, chunk = plan.k, plan.chunk
    n = plan.n_nodes
    last = plan.n_rounds - 1
    stats = {key: {"ms": 0.0, "plain_ms": 0.0, "random_ms": 0.0,
                   "bound_ms": 0.0, "bytes": 0, "ops": 0, "max_abs_err": 0.0,
                   "rounds": []} for key in ("K5", "K6", "K7", "K8")}
    labels0 = torch.arange(n, dtype=torch.int32, device=dev)
    src_el = torch.index_select(labels0, 0, graph.indices)
    src_ew = graph.weights
    gather_ms = _time_ms(lambda: torch.index_select(labels0, 0,
                                                    graph.indices),
                         warmup=2, reps=10)
    aev = aligned_plan.aligned_entry_vertex

    def aligned_gather():
        ext = torch.cat([labels0, labels0.new_full((1,), -1)])
        return torch.index_select(ext, 0, aev)
    aligned_gather_ms = _time_ms(aligned_gather, warmup=2, reps=10)
    relayout_ms = []
    rtv0 = plan.row_to_vertex0
    real0 = rtv0 >= 0
    for r, rnd in enumerate(plan.rounds):
        slots = rnd.n_windows * rnd.window_entries
        view = dataclasses.replace(rnd, aligned=True, n_entries_in=slots)
        main_wl, main_ww = streaming.windowed_entries(rnd.entry_gather,
                                                      src_el, src_ew)
        relayout_ms.append(_time_ms(
            lambda rnd=rnd, el=src_el, ew=src_ew: streaming.windowed_entries(
                rnd.entry_gather, el, ew), warmup=2, reps=10))
        rng = np.random.default_rng(100 + r)
        rand_wl = torch.from_numpy(rng.integers(-1, 24, slots)
                                   .astype(np.int32)).to(dev)
        rand_ww = torch.from_numpy((rng.integers(0, 8, slots) * 0.375)
                                   .astype(np.float32)).to(dev)
        rows = rnd.row_start.numel()
        entries = int(rnd.row_count.sum())
        cases = {}
        if r < last:
            cases["K5"] = (
                lambda el, ew, x: streaming.stream_fold_round(
                    view, el, ew, k=k, chunk=chunk),
                lambda el, ew, x: streaming.stream_fold_round_plain(
                    view, el, ew, k=k, chunk=chunk),
                None, None, 8 * entries + 8 * rows + 8 * k * rows,
                2 * k * entries)
        else:
            rv = rnd.row_vertex
            main_inc = torch.where(rv >= 0, labels0[torch.clamp_min(rv, 0)],
                                   -1)
            rand_inc = torch.where(rv >= 0, torch.from_numpy(
                rng.integers(-1, 24, rows).astype(np.int32)).to(dev), -1)
            cases["K6"] = (
                lambda el, ew, x: streaming.stream_select_round(
                    view, el, ew, x, 1, k=k, chunk=chunk),
                lambda el, ew, x: streaming.stream_select_round_plain(
                    view, el, ew, x, 1, k=k, chunk=chunk),
                rand_inc, main_inc, 8 * entries + 8 * rows + 8 * rows,
                2 * k * entries)
        if r == 0:
            main_init = sketch.bm_init_rows(rtv0, labels0)
            rand_init = torch.where(real0, torch.from_numpy(
                rng.integers(-1, 6, rows).astype(np.int32)).to(dev), -1)
            s_k, _ = streaming.run_mg_plan_stream(plan, src_el, src_ew)
            cand = torch.full((n + 1, k), -1, dtype=torch.int32, device=dev)
            rtv = plan.row_to_vertex
            cand[torch.where(rtv >= 0, rtv, n).long()] = s_k
            cand[n] = -1
            main_cand = cand[torch.where(real0, rtv0, n).long()]
            del s_k, cand
            rand_cand = torch.from_numpy(rng.integers(-1, 6, (rows, k))
                                         .astype(np.int32)).to(dev)
            cases["K7"] = (
                lambda el, ew, x: streaming.bm_fold_round_stream(
                    view, el, ew, x, chunk=chunk),
                lambda el, ew, x: streaming.bm_fold_round_stream_plain(
                    view, el, ew, x, chunk=chunk),
                rand_init, main_init, 8 * entries + 12 * rows + 8 * rows,
                4 * entries)
            cases["K8"] = (
                lambda el, ew, x: streaming.rescan_round_stream(
                    view, el, ew, x, k=k, chunk=chunk),
                lambda el, ew, x: streaming.rescan_round_stream_plain(
                    view, el, ew, x, chunk=chunk),
                rand_cand, main_cand,
                8 * entries + (8 + 4 * k) * rows + 4 * k * rows,
                2 * k * entries)
        for key, (kernel, plain, rand_x, main_x, n_bytes, n_ops) in \
                cases.items():
            # K7 reads few labels on random inputs so every branch runs;
            # K8 counts entries of weight <= 0 too
            r_wl = torch.remainder(rand_wl, 6) if key == "K7" else rand_wl
            r_ww = rand_ww - 0.5 if key == "K8" else rand_ww
            err = 0.0
            for name, args in (("random", (r_wl, r_ww, rand_x)),
                               ("main-path", (main_wl, main_ww, main_x))):
                got = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                got, ref = ((got, ref) if isinstance(got, tuple)
                            else ((got,), (ref,)))
                for a, b in zip(got, ref):
                    if not _same_bits(a, b):
                        raise AssertionError(
                            f"{key} differs from its plain version on "
                            f"streamed round {r}, {name} inputs")
                    err = max(err, _max_abs_err(a, b))
                del got, ref
            random_ms = _time_ms(lambda: kernel(r_wl, r_ww, rand_x),
                                 warmup=3, reps=20)
            ms = _time_ms(lambda: kernel(main_wl, main_ww, main_x), warmup=3,
                          reps=20)
            plain_ms = _time_ms(lambda: plain(main_wl, main_ww, main_x),
                                warmup=1, reps=3)
            bound, by = _bound_ms(n_bytes, n_ops)
            st = stats[key]
            st["ms"] += ms
            st["plain_ms"] += plain_ms
            st["random_ms"] += random_ms
            st["bound_ms"] += bound
            st["bytes"] += n_bytes
            st["ops"] += n_ops
            st["bound_by"] = by
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["rounds"].append({"round": r, "windows": rnd.n_windows,
                                 "W": rnd.window_entries, "row_slots": rows,
                                 "entries": entries, "ms": ms,
                                 "random_ms": random_ms,
                                 "plain_ms": plain_ms, "bound_ms": bound})
            print(f"{tag} phase 2: {key} streamed round {r}: {rnd.n_windows} "
                  f"windows x W {rnd.window_entries}, row slots {rows}, "
                  f"entries {entries}, exact match to plain on random and "
                  f"main-path inputs; kernel {ms:.4f} ms on the main path's "
                  f"inputs ({random_ms:.4f} ms on random ones), plain "
                  f"{plain_ms:.3f} ms, {n_bytes} B, bound {bound:.4f} ms "
                  f"({by} at 3.35 TB/s), {bound / ms:.1%} of bound",
                  flush=True)
        if r == 0:
            # K8 on the aligned plan's round 0 (the same row slots): its
            # windowed arrays are the label gather into window slots and
            # the plan's weights, as lpa_move hands them over
            arnd = aligned_plan.rounds[0]
            if not (torch.equal(arnd.row_start, rnd.row_start)
                    and torch.equal(arnd.row_count, rnd.row_count)):
                raise AssertionError("the aligned plan's round 0 has other "
                                     "row slots")
            a_wl = aligned_gather()
            a_ww = aligned_plan.aligned_entry_weights

            def k8_aligned():
                return streaming.rescan_round_stream(arnd, a_wl, a_ww,
                                                     main_cand, k=k,
                                                     chunk=chunk)
            got = k8_aligned()
            torch.cuda.synchronize()
            ref = streaming.rescan_round_stream_plain(arnd, a_wl, a_ww,
                                                      main_cand, chunk=chunk)
            if not _same_bits(got, ref):
                raise AssertionError("K8 differs from its plain version on "
                                     "the aligned plan's round 0")
            ms = _time_ms(k8_aligned, warmup=3, reps=20)
            stats["K8"]["aligned_ms"] = ms
            print(f"{tag} phase 2: K8 on the aligned plan's round 0 "
                  f"(labels_ext[aligned_entry_vertex], aligned weights): "
                  f"exact match to plain; kernel {ms:.4f} ms", flush=True)
            del a_wl, got, ref
        if r < last:
            out_k, out_v = streaming.stream_fold_round(view, main_wl, main_ww,
                                                       k=k, chunk=chunk)
            src_el, src_ew = out_k.reshape(-1), out_v.reshape(-1)
        del rand_wl, rand_ww, main_wl, main_ww, cases
        torch.cuda.empty_cache()
    unaligned_ms = gather_ms + sum(relayout_ms)
    aligned_ms = aligned_gather_ms + sum(relayout_ms[1:])
    stats["relayout"] = {"labels_gather_ms": gather_ms,
                         "aligned_labels_gather_ms": aligned_gather_ms,
                         "windowed_entries_ms": relayout_ms,
                         "per_iteration_unaligned_ms": unaligned_ms,
                         "per_iteration_aligned_ms": aligned_ms}
    print(f"{tag} phase 2: streamed re-layout per iteration: "
          f"labels[indices] {gather_ms:.4f} ms + windowed_entries per round "
          + ", ".join(f"{m:.4f}" for m in relayout_ms)
          + f" ms = {unaligned_ms:.4f} ms unaligned; aligned: "
          f"labels_ext[aligned_entry_vertex] {aligned_gather_ms:.4f} ms + "
          f"rounds 1.. {sum(relayout_ms[1:]):.4f} ms = {aligned_ms:.4f} ms",
          flush=True)
    return stats


def _random_tile(shape, dev, seed: int):
    """A random padded tile of ``shape`` on the card: labels in [-1, 24)
    (-1 a pad), weights in {0, 0.375, ..., 2.625} (0 a no-op), from a
    seeded device generator."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    labels = torch.randint(-1, 24, shape, generator=gen, device=dev,
                           dtype=torch.int32)
    weights = torch.randint(0, 8, shape, generator=gen, device=dev,
                            dtype=torch.int32).to(torch.float32) * 0.375
    return labels, weights


def tile_kernels_vs_plain(graph, plan, tag: str) -> dict:
    """Phase 2 for K9 (every bucket of every round of the main graph's
    bucketed plan) and K10 (every round-0 bucket), each held to exact
    equality with its plain version on the bucket's padded tile from the
    main path's first iteration (labels = vertex ids, each round fed the
    previous round's kernel output; K10 from the incumbents) and on a
    random tile of the same shape. Kernel and plain times per round are
    sums over the round's buckets; each kernel's time is also kept per
    bucket and summed per bucket width over the rounds, each beside its
    bound and its launch's dynamic shared memory; the padded-tile gather
    (``sketch._gather_entries``, plain torch outside the kernels) is timed
    on its own, per round."""
    import torch
    from repro_torch.core import sketch
    from repro_torch.kernels.mg_sketch import mg_sketch, ops

    dev = graph.device
    k = plan.k
    labels0 = torch.arange(graph.n_nodes, dtype=torch.int32, device=dev)
    el = torch.index_select(labels0, 0, graph.indices)
    ew = graph.weights
    stats = {key: {"ms": 0.0, "plain_ms": 0.0, "random_ms": 0.0,
                   "bound_ms": 0.0, "bytes": 0, "ops": 0, "max_abs_err": 0.0,
                   "bound_by": "bytes", "rounds": []}
             for key in ("K9", "K10")}
    for key in ("K9", "K10"):
        stats[key]["buckets"] = []
    stats["gather"] = {"ms": 0.0, "rounds": []}
    for r, rnd in enumerate(plan.rounds):
        out_k = torch.zeros((rnd.n_rows_total, k), dtype=torch.int32,
                            device=dev)
        out_v = torch.zeros((rnd.n_rows_total, k), dtype=torch.float32,
                            device=dev)
        per = {key: {"ms": 0.0, "plain_ms": 0.0, "random_ms": 0.0,
                     "bound_ms": 0.0, "bytes": 0, "ops": 0}
               for key in ("K9", "K10")}
        gather_ms, shapes = 0.0, []
        for b, bucket in enumerate(rnd.buckets):
            rows, width = bucket.n_rows, bucket.width
            shapes.append(f"{width}x{rows}")
            gl, gw = sketch._gather_entries(bucket.gather, el, ew)
            gather_ms += _time_ms(
                lambda bucket=bucket: sketch._gather_entries(bucket.gather,
                                                             el, ew),
                warmup=1, reps=5)
            rand_l, rand_w = _random_tile((rows, width), dev,
                                          1000 * r + b)
            cases = {"K9": (
                lambda l, w, x: ops.mg_fold_tile_pallas(l, w, k),
                lambda l, w, x: sketch.mg_fold_tile(l, w, k),
                None, None, 8 * rows * width + 8 * k * rows,
                2 * k * rows * width)}
            if r == 0:
                main_init = labels0[bucket.vertex.long()]
                rand_init = torch.remainder(main_init, 24)
                cases["K10"] = (
                    lambda l, w, x: ops.bm_fold_tile_pallas(l, w, x),
                    lambda l, w, x: sketch.bm_fold_tile(l, w, x),
                    rand_init, main_init, 8 * rows * width + 12 * rows,
                    4 * rows * width)
            for key, (kernel, plain, rand_x, main_x, n_bytes, n_ops) in \
                    cases.items():
                err = 0.0
                for name, args in (("random", (rand_l, rand_w, rand_x)),
                                   ("main-path", (gl, gw, main_x))):
                    got = kernel(*args)
                    torch.cuda.synchronize()
                    ref = plain(*args)
                    for a, c in zip(got, ref):
                        if not _same_bits(a, c):
                            raise AssertionError(
                                f"{key} differs from its plain version on "
                                f"round {r}, bucket {width} x {rows}, "
                                f"{name} inputs")
                        err = max(err, _max_abs_err(a, c))
                    del got, ref
                ms = _time_ms(lambda: kernel(gl, gw, main_x), warmup=3,
                              reps=20)
                random_ms = _time_ms(lambda: kernel(rand_l, rand_w, rand_x),
                                     warmup=3, reps=20)
                plain_ms = _time_ms(lambda: plain(gl, gw, main_x), warmup=1,
                                    reps=3)
                bound, _ = _bound_ms(n_bytes, n_ops)
                pr = per[key]
                pr["ms"] += ms
                pr["random_ms"] += random_ms
                pr["plain_ms"] += plain_ms
                pr["bound_ms"] += bound
                pr["bytes"] += n_bytes
                pr["ops"] += n_ops
                stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"],
                                                err)
                stats[key]["buckets"].append({
                    "round": r, "width": width, "rows": rows, "ms": ms,
                    "bound_ms": bound, "plain_ms": plain_ms,
                    "smem_bytes": mg_sketch.tile_fold_smem_bytes(
                        width, k if key == "K9" else None,
                        gl.data_ptr() % 16 == 0)})
            s_k, s_v = ops.mg_fold_tile_pallas(gl, gw, k)
            pos = bucket.out_pos.long()
            out_k[pos] = s_k
            out_v[pos] = s_v
            del gl, gw, rand_l, rand_w, s_k, s_v, cases
        el, ew = out_k.reshape(-1), out_v.reshape(-1)
        stats["gather"]["ms"] += gather_ms
        stats["gather"]["rounds"].append({"round": r, "ms": gather_ms})
        for key, pr in per.items():
            if not pr["bytes"]:
                continue
            st = stats[key]
            for field in ("ms", "plain_ms", "random_ms", "bound_ms", "bytes",
                          "ops"):
                st[field] += pr[field]
            st["rounds"].append(dict(round=r, buckets=len(rnd.buckets),
                                     shapes=shapes, **pr))
            print(f"{tag} phase 2: {key} round {r} per bucket (width x "
                  f"rows: ms, share of bound): "
                  + ", ".join(f"{b['width']}x{b['rows']}: {b['ms']:.4f}, "
                              f"{b['bound_ms'] / b['ms']:.1%}"
                              for b in st["buckets"] if b["round"] == r),
                  flush=True)
            print(f"{tag} phase 2: {key} round {r}: {len(rnd.buckets)} "
                  f"buckets (width x rows: {', '.join(shapes)}), exact "
                  f"match to plain on random and main-path tiles; kernel "
                  f"{pr['ms']:.4f} ms on the main path's tiles "
                  f"({pr['random_ms']:.4f} ms on random ones), plain "
                  f"{pr['plain_ms']:.3f} ms, {pr['bytes']} B, bound "
                  f"{pr['bound_ms']:.4f} ms (bytes at 3.35 TB/s), "
                  f"{pr['bound_ms'] / pr['ms']:.1%} of bound", flush=True)
        print(f"{tag} phase 2: padded-tile gather (_gather_entries) round "
              f"{r}: {gather_ms:.4f} ms over {len(rnd.buckets)} buckets",
              flush=True)
        torch.cuda.empty_cache()
    for key in ("K9", "K10"):
        widths = {}
        for b in stats[key]["buckets"]:
            w = widths.setdefault(b["width"], {
                "width": b["width"], "rows": 0, "launches": 0, "ms": 0.0,
                "bound_ms": 0.0, "smem_bytes": b["smem_bytes"]})
            w["rows"] += b["rows"]
            w["launches"] += 1
            w["ms"] += b["ms"]
            w["bound_ms"] += b["bound_ms"]
        stats[key]["widths"] = [widths[w] for w in sorted(widths)]
        print(f"{tag} phase 2: {key} per bucket width over the rounds "
              f"(launches, rows, kernel ms, bound ms, share of bound, dynamic"
              f" shared memory per block): "
              + "; ".join(f"D={w['width']}: {w['launches']}, {w['rows']}, "
                          f"{w['ms']:.4f}, {w['bound_ms']:.4f}, "
                          f"{w['bound_ms'] / w['ms']:.1%}, "
                          f"{w['smem_bytes']} B"
                          for w in stats[key]["widths"]), flush=True)
    print(f"{tag} phase 2: per pallas iteration: K9 {stats['K9']['ms']:.4f} "
          f"ms ({sum(len(r.buckets) for r in plan.rounds)} launches), "
          f"padded-tile gather {stats['gather']['ms']:.4f} ms; per bm "
          f"iteration: K10 {stats['K10']['ms']:.4f} ms "
          f"({len(plan.rounds[0].buckets)} launches), gather "
          f"{stats['gather']['rounds'][0]['ms']:.4f} ms", flush=True)
    return stats


def _with_cap(ws, cfg, cap: int):
    """``ws`` and ``cfg`` with the sparse row capacity ``cap``. The
    capacity is a field of the plan bundle's spec that ``lpa()`` reads;
    the plans do not depend on it, so they are shared, not built again."""
    spec = dataclasses.replace(ws.bundle.spec, frontier_cap_rows=cap)
    bundle = dataclasses.replace(ws.bundle, spec=spec)
    return (dataclasses.replace(ws, bundle=bundle),
            dataclasses.replace(cfg, frontier_cap_rows=cap))


def _gated_parity(graph, gcfg, build_workspace, lpa, lpa_move,
                  mark_frontier, fused_active_rows, tag: str) -> dict:
    """Phase 3 (b): the frontier-gated mg runs on the parity graph. The
    dense gated run on the fused kernels equals the plain engine's; the
    sparse runs equal it, at the default capacity and at a capacity that
    some iterations overflow. That capacity comes from a replay of the
    dense run's frontiers: the median over iterations 1.. of each
    iteration's largest per-round active-row count. The overflowing run's
    ``work_rows_history`` must show exactly the replay's fit decisions:
    the active rows where every round fits, the dense rows elsewhere."""
    import torch
    ref = lpa(graph, dataclasses.replace(gcfg, fold_backend="jnp"))
    fcfg = dataclasses.replace(gcfg, fold_backend="pallas_fused")
    ws = build_workspace(graph, fcfg)
    dense = lpa(graph, fcfg, ws=ws)
    _check_same_run(ref, dense, "phase 3, gated, pallas_fused vs jnp")
    frontier = torch.ones(graph.n_nodes, dtype=torch.bool,
                          device=graph.device)
    cur = torch.arange(graph.n_nodes, dtype=torch.int32, device=graph.device)
    counts = []
    for it in range(dense.iterations):
        counts.append(fused_active_rows(ws.fused_plan, frontier))
        pl = (it % gcfg.rho) == 0
        cur, changed = lpa_move(ws, cur, pl, it + 1, fcfg, frontier=frontier)
        marked = mark_frontier(ws, changed)
        frontier = (frontier | marked) if pl else marked
    if not torch.equal(cur, dense.labels):
        raise AssertionError("phase 3, gated: the frontier replay diverged")
    maxima = [max(c) for c in counts]
    later = sorted(maxima[1:])
    cap = later[len(later) // 2]
    if cap == later[-1]:  # the upper half ties: overflow it by one
        cap -= 1
    if not later[0] <= cap < later[-1]:
        raise AssertionError(f"phase 3, gated: no capacity both fits and "
                             f"overflows iterations 1..: {maxima}")
    out = {"iterations": dense.iterations, "row_maxima": maxima,
           "overflow_cap": cap, "work_rows_history": {}}
    for name, sparse_cap in (("default", None), ("overflow", cap)):
        # the capacity is a plan-spec field: the workspace carries it
        scfg = dataclasses.replace(fcfg, frontier_sparse=True,
                                   frontier_cap_rows=sparse_cap)
        got = lpa(graph, scfg)
        for field in ("labels", "changed_history", "frontier_history",
                      "iterations"):
            a, b = getattr(dense, field), getattr(got, field)
            same = torch.equal(a, b) if field == "labels" else a == b
            if not same:
                raise AssertionError(f"phase 3, gated, sparse ({name} cap):"
                                     f" {field} differs from the dense run")
        out["work_rows_history"][name] = got.work_rows_history
    hist = out["work_rows_history"]["overflow"]
    dense_rows = dense.work_rows_history[0]
    want = [sum(c) if max(c) <= cap else dense_rows for c in counts]
    if hist != want:
        raise AssertionError(f"phase 3, gated: at cap {cap} the work rows "
                             f"{hist} are not the fit decisions' {want}")
    fell_back = sum(1 for m in maxima if m > cap)
    print(f"{tag} phase 3: 2^{PARITY_SCALE} vertices, frontier-gated mg: "
          f"pallas_fused dense == jnp ({dense.iterations} iterations, "
          f"changed_history {dense.changed_history}); sparse == dense at "
          f"the default cap (work rows "
          f"{out['work_rows_history']['default']}) and at cap {cap} "
          f"(largest active rows per iteration {maxima}; {fell_back} "
          f"iterations overflow it and fold densely; work rows {hist})",
          flush=True)
    return out


def _phase_took(tag: str, phase: int | str, t0: float,
                report: dict) -> None:
    took = time.perf_counter() - t0
    report.setdefault("phase_s", {})[str(phase)] = took
    print(f"{tag} phase {phase} took {took:.1f} s", flush=True)


def frontier_marks_vs_plain(graph, masks, gated_masks, tag: str,
                            phase: str = "4") -> dict:
    """Phase 4: the frontier marks (FM, ``kernels.frontier``) held to
    their plain version, bit for bit, on the main graph: on an all-true
    ``changed`` and on every iteration's ``changed`` of the main mg run
    (``masks``) and of the dense gated run (``gated_masks``), the card
    tensors their replays handed ``mark_frontier``. Each all-true and mg
    mask is timed, kernel and plain, between CUDA events (a call is the
    wrapper: its zeroed [N] output and the launch), beside the bytes the
    marks must move: ``changed`` read and ``marked`` written ([N] bytes
    each), one 32 B sector of ``offsets`` a changed vertex (at most all
    of ``offsets``) and the changed rows' ``indices`` (4 B a slot).
    ``ms``, ``plain_ms``, ``bound_ms`` and ``bytes`` are means over the
    mg run's iterations (one launch each). ``phase`` names the phase in
    the printed lines."""
    import torch
    from repro_torch.kernels import frontier

    n, offsets, indices = graph.n_nodes, graph.offsets, graph.indices
    degrees = graph.degrees
    cases = [("all-true", 0, torch.ones(n, dtype=torch.bool,
                                        device=graph.device))]
    cases += [("mg", it, c) for it, c in enumerate(masks)]
    cases += [("gated", it, c) for it, c in enumerate(gated_masks)]
    rows = []
    for run, it, changed in cases:
        got = frontier.frontier_marks(changed, offsets, indices)
        want = frontier.frontier_marks_plain(changed, offsets, indices)
        if not torch.equal(got, want):
            raise AssertionError(f"phase {phase}: FM differs from its plain "
                                 f"version on the {run} run's iteration "
                                 f"{it} mask")
        del got, want
        if run == "gated":
            continue
        n_changed = int(changed.sum())
        slots = int(degrees[changed].sum())
        n_bytes = 2 * n + min(32 * n_changed, 4 * (n + 1)) + 4 * slots
        bound, _ = _bound_ms(n_bytes, 0)
        ms = _time_ms(lambda c=changed: frontier.frontier_marks(
            c, offsets, indices), warmup=3, reps=20)
        plain_ms = _time_ms(lambda c=changed: frontier.frontier_marks_plain(
            c, offsets, indices), warmup=1, reps=3)
        rows.append({"run": run, "iteration": it, "changed": n_changed,
                     "slots": slots, "ms": ms, "plain_ms": plain_ms,
                     "bytes": n_bytes, "bound_ms": bound})
        print(f"{tag} phase {phase}: FM, {run} mask {it}: {n_changed} of {n} "
              f"vertices changed, {slots} slots; exact match to plain; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, {n_bytes} B, "
              f"bound {bound:.4f} ms (bytes at 3.35 TB/s), {bound / ms:.1%} "
              f"of bound", flush=True)
    main = [r for r in rows if r["run"] == "mg"]
    stats = {key: sum(r[key] for r in main) / len(main)
             for key in ("ms", "plain_ms", "bound_ms", "bytes")}
    stats.update(ops=0, bound_by="bytes", max_abs_err=0.0, masks=rows,
                 gated_masks_checked=len(gated_masks),
                 parity="exact (torch.equal) vs plain torch on the card, "
                        "on every iteration's changed mask of the mg and "
                        "the dense gated run and on an all-true one",
                 ms_is="one main-path iteration (the mean over the mg "
                       "run's iterations, one launch each)")
    print(f"{tag} phase {phase}: FM on every mask of the mg run ({len(main)}) "
          f"and of the dense gated run ({len(gated_masks)}) and on an "
          f"all-true one equals its plain version; mean a mg iteration: "
          f"kernel {stats['ms']:.4f} ms, plain {stats['plain_ms']:.3f} ms, "
          f"bound {stats['bound_ms']:.4f} ms, {stats['bound_ms'] / stats['ms']:.1%} "
          f"of bound", flush=True)
    return stats


#: entries of the wide phase's entry arrays: rows start on both sides of
#: 2**31, one straddles it
WIDE_ENTRIES = 2**31 + 2**20
#: the kernel launchers whose launches the wide phase counts by width, and
#: the position of the width argument (bytes of a row start or offset)
WIDTH_ARG = {"mg_fused_fold": 1, "mg_fused_select": 1,
             "mg_fused_bm_fold": 1, "mg_fused_rescan": 1,
             "frontier_marks": 2}


class _WidthCounted:
    """A kernel library whose launchers of :data:`WIDTH_ARG` also count
    their launches into ``counts[name, width in bytes]``."""

    def __init__(self, lib, counts):
        self._lib, self._counts = lib, counts

    def __getattr__(self, name):
        launcher = getattr(self._lib, name)
        at = WIDTH_ARG.get(name)
        if at is None:
            return launcher

        def launch(*args):
            self._counts[name, args[at]] += 1
            return launcher(*args)
        return launch


@contextlib.contextmanager
def _launches_by_width():
    """Inside: the fused kernels and the frontier marks count their
    launches by the width of their row starts or offsets, in the Counter
    this yields."""
    from repro_torch.kernels import frontier
    from repro_torch.kernels.mg_sketch import fused
    counts = collections.Counter()
    real = {mod: mod._library for mod in (fused, frontier)}
    try:
        for mod, load in real.items():
            mod._library = functools.partial(_WidthCounted, load(), counts)
        yield counts
    finally:
        for mod, load in real.items():
            mod._library = load


def _wide_rounds(k: int, chunk: int):
    """Entry arrays of :data:`WIDE_ENTRIES` entries and a round-0 round
    over them whose rows start on both sides of 2**31, one straddling it:
    vertex 0 holds the first ``base`` slots (never read), then rows of 1
    to 128 entries and one long row. Returns ``(el, ew, base, sub,
    shifted, offsets, degrees)``: ``sub`` launches the rows at or past
    ``base`` with int64 starts, ``shifted`` is the same rows with int32
    starts into the entries from ``base`` on."""
    import numpy as np
    import torch
    from repro_torch.graphs.csr import FusedRound, build_fused_fold_plan

    dev = torch.device("cuda")
    m, wide = WIDE_ENTRIES, 2**31
    base = wide - 1 - 3000  # the region the rows read: [base, m)
    el = torch.empty(m, dtype=torch.int32, device=dev)
    ew = torch.empty(m, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    el[base:] = torch.randint(0, 64, (m - base,), device=dev, generator=gen,
                              dtype=torch.int32)
    ew[base:] = torch.rand(m - base, device=dev, generator=gen) + 2.0**-24
    rng = np.random.default_rng(4)
    deg = np.concatenate([[base], rng.integers(1, 129, 6000)])
    deg[-1] += m - int(deg.sum())
    plan = build_fused_fold_plan(deg, k=k, chunk=chunk, tile_r=128,
                                 device=dev)
    rnd = plan.rounds[0]
    if rnd.row_start.dtype != torch.int64:
        raise AssertionError(f"phase 4w: round 0 of a {m}-slot plan has "
                             f"{rnd.row_start.dtype} starts")
    idx = torch.nonzero(rnd.row_start.reshape(-1) >= base).squeeze(1)
    idx = idx[:idx.numel() - idx.numel() % 128]
    starts = rnd.row_start.reshape(-1)[idx].reshape(-1, 128)
    counts = rnd.row_count.reshape(-1)[idx].reshape(-1, 128)
    sub = FusedRound(row_start=starts, row_count=counts,
                     step_dmax=counts.max(dim=1, keepdim=True).values,
                     n_entries_in=m)
    shifted = dataclasses.replace(sub, row_start=(starts - base).to(
        torch.int32), n_entries_in=m - base)
    ends = starts + counts
    if not bool(((starts < wide) & (ends > wide)).any()) \
            or int(starts.max()) < wide:
        raise AssertionError("phase 4w: no row straddles 2**31 or starts "
                             "past it")
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(deg)]),
                              device=dev)
    return el, ew, base, sub, shifted, offsets, deg


def _past_2_31_vs_plain(tag: str) -> dict:
    """Phase 4w (a): K1-K4 with int64 row starts on rows that start on
    both sides of 2**31 (one straddles it) in entry arrays of
    :data:`WIDE_ENTRIES` entries, each equal bit for bit to its plain
    version run on the same entries through int32 starts moved down by
    ``base``; the frontier marks with int64 offsets over the same entries
    as neighbour ids, equal to the plain marks of the same rows moved
    down (vertex 0, whose row is the unread slots, unchanged)."""
    import torch
    from repro_torch.kernels import frontier
    from repro_torch.kernels.mg_sketch import fused

    k, chunk = 8, 128
    el, ew, base, sub, shifted, offsets, deg = _wide_rounds(k, chunk)
    p_el, p_ew = el[base:], ew[base:]
    rows = sub.row_start.numel()
    gen = torch.Generator(device="cpu").manual_seed(2)
    inc = torch.randint(0, 64, (rows,), generator=gen,
                        dtype=torch.int32).cuda()
    cand = torch.randint(-1, 64, (rows, k), generator=gen,
                         dtype=torch.int32).cuda()
    pairs = {
        "K1": (fused.fused_fold_round(sub, el, ew, k=k, chunk=chunk),
               fused.fused_fold_round_plain(shifted, p_el, p_ew, k=k,
                                            chunk=chunk)),
        "K2": ((fused.fused_select_round(sub, el, ew, inc, 5, k=k,
                                         chunk=chunk),),
               (fused.fused_select_round_plain(shifted, p_el, p_ew, inc, 5,
                                               k=k, chunk=chunk),)),
        "K3": (fused.bm_fold_round_fused(sub, el, ew, inc, chunk=chunk),
               fused.bm_fold_round_plain(shifted, p_el, p_ew, inc,
                                         chunk=chunk)),
        "K4": ((fused.rescan_round_fused(sub, el, ew, cand, k=k,
                                         chunk=chunk),),
               (fused.rescan_round_plain(shifted, p_el, p_ew, cand,
                                         chunk=chunk),))}
    for key, (got, want) in pairs.items():
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"phase 4w: {key} with int64 starts past "
                                 f"2**31 differs from its plain version")
    del pairs
    n = deg.size
    changed = torch.rand(n, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5)) < 0.5
    changed[0] = False
    got = frontier.frontier_marks(changed, offsets, el)
    want = frontier.frontier_marks_plain(
        changed[1:], (offsets[1:] - base).to(torch.int32), p_el)
    if not (torch.equal(got[:-1], want) and not bool(got[-1])):
        raise AssertionError("phase 4w: FM with int64 offsets past 2**31 "
                             "differs from its plain version")
    straddle = int(((sub.row_start < 2**31)
                    & (sub.row_start + sub.row_count > 2**31)).sum())
    out = {"entries": WIDE_ENTRIES, "rows": rows,
           "first_start": int(sub.row_start.min()),
           "last_start": int(sub.row_start.max()),
           "rows_straddling_2_31": straddle,
           "fm_vertices": n, "fm_changed": int(changed.sum()),
           "fm_marked": int(got.sum())}
    print(f"{tag} phase 4w: {WIDE_ENTRIES} entries: K1, K2, K3 and K4 with "
          f"int64 starts on {rows} rows starting at {out['first_start']} to "
          f"{out['last_start']} ({straddle} straddling 2**31) equal their "
          f"plain versions on the same entries, bit for bit; FM with int64 "
          f"offsets over the {n} vertices ({out['fm_changed']} changed, "
          f"{out['fm_marked']} marked) equals the plain marks", flush=True)
    del el, ew, sub, shifted, p_el, p_ew, got, want
    torch.cuda.empty_cache()
    return out


def _wide_runs(graph, configs: dict, want: dict, tag: str,
               where: str) -> tuple[dict, dict]:
    """``lpa()`` of each config on ``graph`` with int32 offsets and on the
    same graph with int64 offsets, each on a workspace of its own: the
    wide run's labels and histories must equal the narrow run's
    (a sparse run's: the dense gated run's, but for its work rows), its
    launch counts (set to 0 just before) the narrow run's, and its
    launches by width ``want[path](iterations)``. Returns the wide runs
    and their launch counts by width, by path."""
    import torch
    from repro_torch.core.lpa import build_workspace, lpa
    from repro_torch.kernels.mg_sketch import fused

    g64 = dataclasses.replace(graph, offsets=graph.offsets.to(torch.int64))
    results, widths = {}, {}
    for path, pcfg in configs.items():
        ws32, ws64 = build_workspace(graph, pcfg), build_workspace(g64, pcfg)
        plan = ws64.fused_plan
        if plan.rounds[0].row_start.dtype != torch.int64 or any(
                r.row_start.dtype != torch.int32 for r in plan.rounds[1:]):
            raise AssertionError(f"phase 4w, {where}: the wide plan's "
                                 f"starts are not int64 then int32")
        ref_cfg = (dataclasses.replace(pcfg, frontier_sparse=False)
                   if pcfg.frontier_sparse else pcfg)
        fused.reset_launch_counts()
        ref = lpa(graph, ref_cfg, ws=ws32)
        torch.cuda.synchronize()
        ref_launches = dict(fused.LAUNCH_COUNTS)
        if pcfg.frontier_sparse:
            fused.reset_launch_counts()
            narrow = lpa(graph, pcfg, ws=ws32)
            torch.cuda.synchronize()
            ref_launches = dict(fused.LAUNCH_COUNTS)
        with _launches_by_width() as counts:
            fused.reset_launch_counts()
            res = lpa(g64, pcfg, ws=ws64)
            torch.cuda.synchronize()
            launches = dict(fused.LAUNCH_COUNTS)
        fields = ("labels", "iterations", "converged", "changed_history",
                  "frontier_history")
        for field in fields:
            a, b = getattr(ref, field), getattr(res, field)
            if not (torch.equal(a, b) if field == "labels" else a == b):
                raise AssertionError(f"phase 4w, {where}, {path}: {field} "
                                     f"differs from the int32 run")
        if pcfg.frontier_sparse and \
                narrow.work_rows_history != res.work_rows_history:
            raise AssertionError(f"phase 4w, {where}, {path}: work rows "
                                 f"differ from the int32 sparse run")
        if launches != ref_launches:
            raise AssertionError(f"phase 4w, {where}, {path}: launches "
                                 f"{launches}, the int32 run's "
                                 f"{ref_launches}")
        by_width = {f"{name}<{8 * w}>": c for (name, w), c in counts.items()}
        expected = want[path](res.iterations)
        if by_width != expected:
            raise AssertionError(f"phase 4w, {where}, {path}: launches by "
                                 f"width {by_width}, expected {expected}")
        results[path], widths[path] = res, by_width
        nonzero = {key: c for key, c in launches.items() if c}
        print(f"{tag} phase 4w: {where}, {path} with int64 offsets: "
              f"{res.iterations} iterations, labels and histories equal to "
              f"the int32 run's, launches {nonzero} as there; by width "
              f"{by_width}", flush=True)
        del ws32, ws64, ref
        torch.cuda.empty_cache()
    return results, widths


def wide_vs_plain(graph, cfg, tag: str) -> dict:
    """Phase 4w: the int64 instantiations of K1-K4 and the frontier marks.

    (a) past 2**31 entries (``_past_2_31_vs_plain``); (b) whole ``lpa()``
    runs with int64 offsets (``_wide_runs``) of mg, bm, the rescan and
    the gated sparse path on the main graph (K1 round 0, K3 and K4 wide;
    K1's later rounds and K2 int32) and of mg on a 2048 x 2048 grid, whose
    plan is one round (K2 wide); (c) the wide kernels timed and held to
    plain as in phases 2 and 4, on the main graph's plan with int64
    starts (K1 round 0, K3, K4, FM on the wide mg run's masks) and on the
    grid's (K2). Returns the kernel stats by key (``K1w`` ... ``FMw``)
    and each wide run's launches by width under ``"launches"``."""
    import torch
    from repro_torch.core.lpa import build_workspace, lpa_move
    from repro_torch.graphs.generators import grid2d

    out = {"past_2_31": _past_2_31_vs_plain(tag)}
    n_rounds = build_workspace(graph, cfg).fused_plan.n_rounds
    fm = "frontier_marks<64>"
    gated = dataclasses.replace(cfg, frontier_gate=True,
                                frontier_sparse=True)
    configs = {"wide_mg": cfg, "wide_bm": dataclasses.replace(
        cfg, method="bm"), "wide_rescan": dataclasses.replace(
        cfg, rescan=True), "wide_gated_sparse": gated}
    want = {
        "wide_mg": lambda it: {"mg_fused_fold<64>": it,
                               "mg_fused_fold<32>": it * (n_rounds - 2),
                               "mg_fused_select<32>": it, fm: it},
        "wide_bm": lambda it: {"mg_fused_bm_fold<64>": it, fm: it},
        "wide_rescan": lambda it: {"mg_fused_fold<64>": it,
                                   "mg_fused_fold<32>": it * (n_rounds - 1),
                                   "mg_fused_rescan<64>": it, fm: it},
        # every iteration folds round 0 once, dense or compacted
        "wide_gated_sparse": lambda it: {
            "mg_fused_fold<64>": it,
            "mg_fused_fold<32>": it * (n_rounds - 2),
            "mg_fused_select<32>": it, fm: it}}
    if n_rounds < 3:
        raise AssertionError(f"phase 4w: the main plan has {n_rounds} "
                             f"rounds; the wide runs need K1 past round 0")
    runs, launches = _wide_runs(graph, configs, want, tag, f"2^{SCALE}")
    grid = grid2d(2048, 2048, device=graph.device)
    grid_runs, grid_launches = _wide_runs(
        grid, {"wide_grid_mg": cfg},
        {"wide_grid_mg": lambda it: {"mg_fused_select<64>": it, fm: it}},
        tag, "2048 x 2048 grid")
    launches.update(grid_launches)
    out["launches"] = launches
    out["iterations"] = {p: r.iterations
                         for p, r in (runs | grid_runs).items()}
    # (c) the wide kernels against plain, timed
    g64 = dataclasses.replace(graph, offsets=graph.offsets.to(torch.int64))
    ws64 = build_workspace(g64, cfg)
    k1 = kernels_vs_plain(g64, ws64.fused_plan, tag, phase="4w",
                          row_contiguous=False)["K1"]
    r0 = k1["rounds"][0]
    out["K1w"] = {"ms": r0["ms"], "plain_ms": r0["plain_ms"],
                  "bound_ms": r0["bound_ms"], "bound_by": k1["bound_by"],
                  "max_abs_err": 0.0, "rows": r0["rows"],
                  "entries": r0["entries"],
                  "ms_is": "round 0 of one main-path iteration, int64 "
                           "starts (the later rounds are int32: row K1)"}
    out.update({f"{key}w": st for key, st in bm_rescan_vs_plain(
        g64, ws64.fused_plan, tag, phase="4w").items() if key != "merge"})
    g_grid = dataclasses.replace(grid,
                                 offsets=grid.offsets.to(torch.int64))
    gplan = build_workspace(g_grid, cfg).fused_plan
    if gplan.n_rounds != 1:
        raise AssertionError(f"phase 4w: the grid's plan has "
                             f"{gplan.n_rounds} rounds")
    out["K2w"] = kernels_vs_plain(g_grid, gplan, tag, phase="4w",
                                  row_contiguous=False)["K2"]
    out["K2w"]["ms_is"] = ("one iteration on the 2048 x 2048 grid (its one "
                           "round, int64 starts)")
    # FM with int64 offsets on the wide mg run's changed masks
    cur = torch.arange(graph.n_nodes, dtype=torch.int32,
                       device=graph.device)
    masks = []
    for it in range(runs["wide_mg"].iterations):
        cur, changed = lpa_move(ws64, cur, it % cfg.rho == 0, it + 1, cfg)
        masks.append(changed)
    if not torch.equal(cur, runs["wide_mg"].labels):
        raise AssertionError("phase 4w: the wide mg replay diverged")
    out["FMw"] = frontier_marks_vs_plain(g64, masks, [], tag, phase="4w")
    for key in ("K1w", "K2w", "K3w", "K4w", "FMw"):
        out[key]["parity"] = (
            "exact (torch.equal; float32 as int32 bits) vs plain torch on "
            "the card, int64 starts or offsets: on the main graph's round "
            "shapes (K2: the grid's) and on rows past 2**31")
    del ws64, masks, grid, g_grid, gplan
    torch.cuda.empty_cache()
    return out


def _run_path(graph, truth, ws, cfg, lpa, lpa_move, modularity, nmi,
              fused, quality_of=None, keep_changed=False) -> dict:
    """One path's whole ``lpa()`` run on the main graph with its launch
    counts (set to 0 just before, read just after), peak device memory,
    quality, and the seconds per iteration of a replay of the run's
    (pick-less, seed) sequence through ``lpa_move`` between CUDA events,
    queued behind a device-side wait as in ``_time_ms`` (a path that
    synchronises inside an iteration holds the card to the host's pace
    from there on). A frontier-gated replay carries the frontier as
    ``lpa()`` does, and a sparse one its per-iteration fit check
    (``PlanBundle.sparse_fit``, which synchronises: its host wall time is
    kept apart, and the event interval holds ``lpa_move`` alone). The
    replay must reproduce the run's labels. ``quality_of``: an earlier
    run's ``(labels, report)``; when this run's labels equal those, its
    modularity and NMI are that run's (the same functions of the same
    labels) and are not computed again. ``keep_changed``: the replay's
    ``changed`` mask of every iteration, the card tensors ``lpa()`` hands
    ``mark_frontier``, under ``"changed_masks"``."""
    import numpy as np
    import torch
    from repro_torch.core.lpa import mark_frontier
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = lpa(graph, cfg, ws=ws)
    torch.cuda.synchronize()
    lpa_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    labels = res.labels
    if (labels.shape != (graph.n_nodes,) or labels.dtype != torch.int32
            or int(labels.min()) < 0 or int(labels.max()) >= graph.n_nodes):
        raise AssertionError(f"{cfg.method}: labels out of shape or range")
    if quality_of is not None and torch.equal(labels, quality_of[0]):
        prev = quality_of[1]
        q, q_bits, quality = (prev["modularity"], prev["modularity_bits"],
                              prev["nmi"])
        modularity_ms = None
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_t = modularity(graph, labels, ws.edge_src)
        torch.cuda.synchronize()
        modularity_ms = (time.perf_counter() - t0) * 1e3
        q, q_bits = float(q_t), q_t.reshape(1).view(torch.int32).item()
        quality = nmi(labels, truth)
    # modularity lies in [-1/2, 1] and NMI in [0, 1]
    if not (np.isfinite(q) and -0.5 <= q <= 1.0 and 0.0 <= quality <= 1.0):
        raise AssertionError(f"{cfg.method}: modularity {q} or NMI "
                             f"{quality} out of range")
    cur = torch.arange(graph.n_nodes, dtype=torch.int32, device=graph.device)
    frontier = torch.ones(graph.n_nodes, dtype=torch.bool,
                          device=graph.device)
    cap_rows = ws.bundle.cap_rows()
    events, fit_ms, masks = [], [], []
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_WAIT_CYCLES)
    for it in range(res.iterations):
        pl = (it % cfg.rho) == 0
        sparse = False
        if cfg.frontier_sparse:
            # the check synchronises: time it alone, not the previous
            # iteration's device work it would otherwise wait for
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sparse, _ = ws.bundle.sparse_fit(frontier, cap_rows)
            fit_ms.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cur, changed = lpa_move(
            ws, cur, pl, it + 1, cfg,
            frontier=frontier if cfg.frontier_gate else None, sparse=sparse,
            cap_rows=cap_rows)
        end.record()
        events.append((start, end))
        if keep_changed:
            masks.append(changed.clone())
        if cfg.frontier_gate:
            marked = mark_frontier(ws, changed)
            frontier = (frontier | marked) if pl else marked
    torch.cuda.synchronize()
    if not torch.equal(cur, labels):
        raise AssertionError(f"{cfg.method}: the timed replay diverged "
                             f"from lpa()")
    out = {"changed_masks": masks} if keep_changed else {}
    return out | {"result": res, "iterations": res.iterations,
            "work_rows_history": res.work_rows_history, "fit_ms": fit_ms,
            "converged": res.converged,
            "changed_history": res.changed_history, "modularity": q,
            "modularity_bits": q_bits,
            "modularity_ms": modularity_ms, "nmi": quality, "lpa_s": lpa_s,
            "iter_ms": [s.elapsed_time(e) for s, e in events],
            "peak_bytes": peak, "resident_bytes": resident,
            "working_bytes": peak - resident, "launches": launches}


def _exact_vs_cpu(graph, truth, tag: str) -> dict:
    """``exact_choose`` and its group sums on the card against the CPU's,
    bit for bit, on one iteration of ``graph`` with random non-integer
    weights and the planted communities as labels (groups of up to a
    vertex's whole degree)."""
    import numpy as np
    import torch
    from repro_torch.core import exact

    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.random(graph.n_edges) * 3 + 0.1)
                         .astype(np.float32)).to(graph.device)
    labels = torch.as_tensor(np.asarray(truth), dtype=torch.int32,
                             device=graph.device)
    src = graph.sources()
    nbr = torch.index_select(labels, 0, graph.indices)
    t0 = time.perf_counter()
    got = exact.exact_choose(src, nbr, w, graph.n_nodes, labels, 1)
    sums = exact.exact_linking_weights(src, nbr, w, graph.n_nodes, labels)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = exact.exact_choose(src.cpu(), nbr.cpu(), w.cpu(), graph.n_nodes,
                             labels.cpu(), 1)
    ref_sums = exact.exact_linking_weights(src.cpu(), nbr.cpu(), w.cpu(),
                                           graph.n_nodes, labels.cpu())
    cpu_s = time.perf_counter() - t0
    if not (torch.equal(got.cpu(), ref) and torch.equal(sums.cpu(),
                                                         ref_sums)):
        raise AssertionError("exact: the card's group sums or choices "
                             "differ from the CPU's")
    longest = int(graph.degrees.max())
    print(f"{tag} phase 4: exact on 2^{PARITY_SCALE} vertices, "
          f"{graph.n_edges} slots, non-integer weights, planted labels: "
          f"choices and linking-weight sums on the card equal the CPU's "
          f"bit for bit (longest group up to {longest} edges); card "
          f"{gpu_s:.3f} s, CPU {cpu_s:.3f} s (wall, first call)", flush=True)
    return {"n_edges": graph.n_edges, "max_degree": longest,
            "gpu_s": gpu_s, "cpu_s": cpu_s}


def _checked_runs(g16, tag: str) -> dict:
    """Phase 5 (a): checked mode on the 2^16 graph. For mg and bm on each
    engine (jnp, pallas, pallas_fused, and auto, which resolves to
    pallas_stream there), ``lpa()``'s iterations are replayed with the
    engine from ``get_engine(..., checked=True)`` beside the bare one:
    each iteration's wanted labels and launch counts must be equal, and
    the replayed labels must be ``lpa()``'s. A NaN entry weight must then
    raise ``ContractError`` on the card. Times one checked and one bare
    fold per iteration (host wall, synchronised: a check syncs)."""
    import torch
    from repro_torch.core.checked import CheckedEngine, ContractError
    from repro_torch.core.fold_engine import get_engine
    from repro_torch.core.fold_program import FoldRequest
    from repro_torch.core.lpa import LPAConfig, build_workspace, lpa
    from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts

    def counted(fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(LAUNCH_COUNTS)

    report = {}
    for method in ("mg", "bm"):
        for backend in ("jnp", "pallas", "pallas_fused", "auto"):
            cfg = LPAConfig(method=method, k=8, chunk=128,
                            fold_backend=backend)
            ws = build_workspace(g16, cfg)
            ref = lpa(g16, cfg, ws=ws)
            name = ws.bundle.spec.backend
            bare = get_engine(name, checked=False)
            checked = get_engine(name, checked=True)
            if not isinstance(checked, CheckedEngine) or \
                    isinstance(bare, CheckedEngine):
                raise AssertionError(f"phase 5, {name}: checked={{True, "
                                     f"False}} gave {checked!r}, {bare!r}")
            labels = torch.arange(g16.n_nodes, dtype=torch.int32,
                                  device=g16.device)
            checked_ms, bare_ms = [], []
            for it in range(ref.iterations):
                nbr = torch.index_select(labels, 0, g16.indices)
                req = FoldRequest(family=method, seed=it + 1)
                t0 = time.perf_counter()
                got, got_counts = counted(lambda: checked.run(
                    ws.bundle, req, nbr, g16.weights, labels))
                t1 = time.perf_counter()
                want, want_counts = counted(lambda: bare.run(
                    ws.bundle, req, nbr, g16.weights, labels))
                t2 = time.perf_counter()
                checked_ms.append((t1 - t0) * 1e3)
                bare_ms.append((t2 - t1) * 1e3)
                if not torch.equal(got.want, want.want) or \
                        got_counts != want_counts:
                    raise AssertionError(
                        f"phase 5, {method} on {name}, iteration {it}: the "
                        f"checked fold differs (launches {got_counts} vs "
                        f"{want_counts})")
                pl = it % cfg.rho == 0
                allowed = (want.want < labels) if pl else \
                    (want.want != labels)
                labels = torch.where(allowed, want.want, labels)
            if not torch.equal(labels, ref.labels):
                raise AssertionError(f"phase 5, {method} on {name}: the "
                                     f"replayed labels are not lpa()'s")
            launched = {key: n for key, n in want_counts.items() if n}
            if (name == "jnp") == bool(launched):
                raise AssertionError(f"phase 5, {method} on {name}: "
                                     f"launches {want_counts}")
            bad = g16.weights.clone()
            bad[0] = float("nan")
            nbr = torch.index_select(labels, 0, g16.indices)
            try:
                checked.run(ws.bundle, FoldRequest(family=method, seed=1),
                            nbr, bad, labels)
            except ContractError as err:
                message = str(err)
            else:
                raise AssertionError(f"phase 5, {method} on {name}: a NaN "
                                     f"weight raised nothing")
            if "NaN/inf entry weight" not in message:
                raise AssertionError(f"phase 5: unexpected message "
                                     f"{message!r}")
            key = f"{method}_{backend}"
            report[key] = {"engine": name, "iterations": ref.iterations,
                           "launches": launched,
                           "checked_ms": statistics.median(checked_ms),
                           "bare_ms": statistics.median(bare_ms)}
            print(f"{tag} phase 5: 2^{PARITY_SCALE} vertices, checked "
                  f"{method} on {backend} ({name}): {ref.iterations} "
                  f"iterations replayed, wanted labels and launches "
                  f"({launched} in the last) equal to the bare engine's each "
                  f"iteration, final labels lpa()'s; a NaN weight raised "
                  f"ContractError({message!r}); fold median "
                  f"{report[key]['checked_ms']:.3f} ms checked, "
                  f"{report[key]['bare_ms']:.3f} ms bare (host wall)",
                  flush=True)
    return report


def _partition(graph, cfg, mg_labels, mg_launches, tag: str) -> dict:
    """Phase 5 (b): ``lpa_partition(graph, 4, cfg)`` on the main graph, its
    communities and launches those of phase 4's mg run; its edge cut
    beside the contiguous split's, and its seconds."""
    import numpy as np
    import torch
    from repro_torch.graphs.partition import (contiguous_parts,
                                              edge_cut_fraction,
                                              lpa_partition)
    from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts

    n_parts = 4
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    part = lpa_partition(graph, n_parts, cfg)
    seconds = time.perf_counter() - t0
    launches = {key: n for key, n in LAUNCH_COUNTS.items() if n}
    if launches != {key: n for key, n in mg_launches.items() if n}:
        raise AssertionError(f"phase 5, lpa_partition: launches {launches},"
                             f" phase 4's mg run {mg_launches}")
    t0 = time.perf_counter()
    base_cut = edge_cut_fraction(graph, contiguous_parts(graph, n_parts))
    base_s = time.perf_counter() - t0
    n = graph.n_nodes
    n_comm = int(torch.unique(mg_labels).numel())
    if (part.n_communities != n_comm or part.bounds[0] != 0
            or part.bounds[-1] != n
            or not np.array_equal(np.sort(part.order), np.arange(n))
            or not np.array_equal(np.bincount(part.parts, minlength=n_parts),
                                  np.diff(part.bounds))):
        raise AssertionError(f"phase 5, lpa_partition: {part.n_communities}"
                             f" communities (phase 4's mg run: {n_comm}), "
                             f"bounds {part.bounds}")
    print(f"{tag} phase 5: 2^{SCALE} vertices, lpa_partition(graph, "
          f"{n_parts}) on {cfg.fold_backend}: {part.n_communities} "
          f"communities and launches {launches} (phase 4's mg run's), "
          f"edge cut {part.edge_cut!r} "
          f"against contiguous_parts's {base_cut!r}; bounds "
          f"{part.bounds.tolist()}; {seconds:.2f} s (plans, lpa(), packing "
          f"and cut; the contiguous split and its cut {base_s:.2f} s)",
          flush=True)
    return {"n_parts": n_parts, "edge_cut": part.edge_cut,
            "launches": launches,
            "contiguous_edge_cut": base_cut,
            "n_communities": part.n_communities,
            "bounds": part.bounds.tolist(), "seconds": seconds,
            "contiguous_seconds": base_s}


# -- phase 6: distributed LPA over gloo ranks --------------------------------

#: ranks of the distributed phase, all on the one card (gloo: NCCL refuses
#: two ranks on one GPU)
DIST_RANKS = 4
#: the 2^16 matrix's engines: key -> (engine, workspace flags,
#: single-host LPAConfig fields)
DIST_ENGINES = {
    "jnp": ("jnp", {}, {"fold_backend": "jnp"}),
    "pallas": ("pallas", {}, {"fold_backend": "pallas"}),
    "fused": ("pallas_fused", {"fused": True, "tile_r": 32},
              {"fold_backend": "pallas_fused"}),
    "stream": ("pallas_stream", {"stream": True, "window_entries": 512},
               {"fold_backend": "pallas_stream", "stream_window": 512}),
    "stream_aligned": ("pallas_stream", {"stream": True,
                                         "window_entries": 512,
                                         "aligned": True},
                       {"fold_backend": "pallas_stream",
                        "stream_window": 512, "aligned_layout": True}),
}
#: method key -> (dist_lpa method, rescan)
DIST_METHODS = {"mg": ("mg", False), "bm": ("bm", False),
                "rescan": ("mg", True)}
#: the 2^22 workspaces, each built by every rank, and the runs on each:
#: name -> (build_dist_workspace flags, [(path, engine, method key)])
DIST_MAIN = {
    "fused_full": ({"fused": True},
                   [("dist_fused_mg_full", "pallas_fused", "mg")]),
    "fused_halo": ({"fused": True, "halo": True},
                   [("dist_fused_mg_halo", "pallas_fused", "mg"),
                    ("dist_fused_bm_halo", "pallas_fused", "bm"),
                    ("dist_fused_rescan_halo", "pallas_fused", "rescan")]),
    "stream_aligned_halo": ({"stream": True, "aligned": True, "halo": True},
                            [("dist_stream_mg_aligned_halo",
                              "pallas_stream", "mg")]),
}
#: replays of the exchange alone per 2^22 run
EXCHANGE_REPS = 10
#: Pick-Less cadence of the distributed runs: LPAConfig's default, which
#: phase 4's single-host runs used
DIST_RHO = 8


def _dist_twins() -> dict:
    """The kernel wrappers the shard mover calls, by name -> (launch-count
    key, plain twin taking the same arguments): the six round wrappers
    it imports, and the tile folds it calls as ``fold_tile``."""
    from repro_torch.kernels.mg_sketch import fused, ref, streaming
    return {
        "fused_fold_round": ("fused_fold", fused.fused_fold_round_plain),
        "bm_fold_round_fused": ("bm_fold", fused.bm_fold_round_plain),
        "rescan_round_fused": (
            "rescan", lambda *a, k, chunk: fused.rescan_round_plain(
                *a, chunk=chunk)),
        "stream_fold_round": ("stream_fold",
                              streaming.stream_fold_round_plain),
        "bm_fold_round_stream": ("stream_bm",
                                 streaming.bm_fold_round_stream_plain),
        "rescan_round_stream": (
            "stream_rescan", lambda *a, k, chunk:
            streaming.rescan_round_stream_plain(*a, chunk=chunk)),
        "mg_fold_tile_pallas": ("tile_mg_fold", ref.mg_fold_ref),
        "bm_fold_tile_pallas": ("tile_bm_fold", ref.bm_fold_ref),
    }


def _dist_launches_expected(engine: str, method: str, n_rounds: int,
                            iterations: int) -> dict:
    """The launches of one rank's ``dist_lpa`` run by the plan: per
    iteration ``n_rounds`` of K1 (K5, K9) for mg, one K3 (K7, K10) for
    bm, and ``n_rounds`` of K1 (K5, K9) plus one K4 (K8) for the rescan;
    none on the plain engine."""
    from repro_torch.kernels.launches import LAUNCH_COUNTS
    want = dict.fromkeys(LAUNCH_COUNTS, 0)
    fold, bm, rescan = {"pallas_fused": ("fused_fold", "bm_fold", "rescan"),
                        "pallas_stream": ("stream_fold", "stream_bm",
                                          "stream_rescan"),
                        "pallas": ("tile_mg_fold", "tile_bm_fold", None),
                        "jnp": (None, None, None)}[engine]
    if fold is None:
        return want
    if method == "bm":
        want[bm] = iterations
    else:
        want[fold] = iterations * n_rounds
        if method == "rescan" and rescan is not None:
            want[rescan] = iterations
    return want


def _dist_kernels_vs_plain(comm, ws, engine, mkey) -> dict:
    """Every kernel launch of this run's first step on this rank, replayed
    on the inputs the shard mover gave it (its own blocks: the stacked
    fused tiles, the window strides widened to the maximum over shards,
    the all-pad windows appended to the shorter shards) and held to its
    plain twin, float32 as int32 bits. The launches are recorded by
    wrapping the mover's round wrappers (and passing the engine's tile
    fold as ``fold_tile``); the recorded calls must be every launch the
    step made, as many as the plan says. Returns {launch key: {"calls",
    "max_abs_err"}}."""
    import contextlib
    from unittest import mock
    from repro_torch.core import distributed
    from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts
    from repro_torch.kernels.mg_sketch import ops
    method, rescan = DIST_METHODS[mkey]
    twins = _dist_twins()
    calls = []

    def recording(name, fn):
        def record(*args, **kw):
            calls.append((name, fn, args, kw))
            return fn(*args, **kw)
        return record

    tile = None
    if engine == "pallas":
        name = f"{method}_fold_tile_pallas"
        tile = recording(name, getattr(ops, name))
    reset_launch_counts()
    with contextlib.ExitStack() as stack:
        for name in twins:
            if hasattr(distributed, name):
                stack.enter_context(mock.patch.object(
                    distributed, name,
                    recording(name, getattr(distributed, name))))
        step = distributed.dist_lpa_step(comm, ws, engine=engine,
                                         method=method, rescan=rescan,
                                         fold_tile=tile)
        step(ws.init_labels[comm.rank].to(comm.device), True, 1)
    launched = {key: n for key, n in LAUNCH_COUNTS.items() if n}
    recorded: dict = {}
    for name, *_ in calls:
        key = twins[name][0]
        recorded[key] = recorded.get(key, 0) + 1
    planned = {key: n for key, n in _dist_launches_expected(
        engine, mkey, ws.n_rounds, 1).items() if n}
    if not (launched == recorded == planned):
        raise AssertionError(f"rank {comm.rank}: {engine} {mkey}: one step "
                             f"launched {launched}, recorded {recorded}, "
                             f"the plan {planned}")
    out: dict = {}
    for name, fn, args, kw in calls:
        key, plain = twins[name]
        got, want = fn(*args, **kw), plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"rank {comm.rank}: {engine} {mkey}: "
                                 f"{name} call {out.get(key, {}).get('calls', 0)}"
                                 f" differs from its plain twin on the "
                                 f"shard's inputs")
        rec = out.setdefault(key, {"calls": 0, "max_abs_err": 0.0})
        rec["calls"] += 1
        rec["max_abs_err"] = max([rec["max_abs_err"]] + [
            _max_abs_err(a, b) for a, b in zip(got, want)])
    return out


def _window_padding(ws, rank: int) -> list:
    """Per round of a streamed workspace, on this rank's shard: [windows,
    windows holding a row, window stride, columns any window uses]; the
    rest are the all-pad windows and columns the stacking added or the
    shard's own packing left."""
    pad = []
    for counts, gathers in zip(ws.stream_counts, ws.stream_gathers):
        used = (gathers[rank] >= 0).any(dim=0).nonzero()
        pad.append([counts.shape[1],
                    int((counts[rank] > 0).any(dim=1).sum()),
                    gathers.shape[2],
                    int(used.max()) + 1 if used.numel() else 0])
    return pad


def _dist_run(comm, ws, engine, mkey, want, gated=False) -> dict:
    """One ``dist_lpa`` run on this rank with its launch counts (set to 0
    just before, read just after), collective counters, wall seconds and
    peak device memory; raises unless the labels and iterations are
    ``want``'s and the launches the plan's."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import dist_lpa
    from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts
    method, rescan = DIST_METHODS[mkey]
    dev = comm.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    comm.reset_counts()
    t0 = time.perf_counter()
    labels, iters = dist_lpa(comm, ws, rho=DIST_RHO, engine=engine,
                             method=method, rescan=rescan,
                             frontier_gate=gated)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCH_COUNTS)
    want_labels, want_iters = want
    same = np.array_equal(labels.cpu().numpy(), want_labels)
    if iters != want_iters or not same:
        raise AssertionError(f"rank {comm.rank}: {engine} {mkey} (gated "
                             f"{gated}): {iters} iterations, labels equal "
                             f"{same}; the single-host run: {want_iters}")
    expected = _dist_launches_expected(engine, mkey, ws.n_rounds, iters)
    if launches != expected:
        raise AssertionError(f"rank {comm.rank}: {engine} {mkey}: launches "
                             f"{launches}, the plan's {expected}")
    return {"iterations": iters, "seconds": wall, "n_rounds": ws.n_rounds,
            "launches": {key: n for key, n in launches.items() if n},
            "calls": comm.calls, "exchanged_bytes": comm.exchanged_bytes,
            "staged_bytes": comm.staged_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "labels": labels}


def _dist_matrix(comm, graph, expected) -> dict:
    """At 2^16: this rank builds every stacked workspace of the matrix
    itself and runs mg, bm and the rescan on each engine and exchange,
    then gated mg on the fused one; each run must give the single-host
    run (``expected[(method, engine)]``) and the plan's launches. Before
    each run, every kernel of its first step is held to its plain twin
    on this rank's blocks (``_dist_kernels_vs_plain``)."""
    from repro_torch.core.distributed import build_dist_workspace
    out = {"builds": {}, "runs": {}, "checks": {}, "window_padding": {}}
    for ekey, (engine, flags, _) in DIST_ENGINES.items():
        for exchange in ("full", "halo"):
            t0 = time.perf_counter()
            ws = build_dist_workspace(graph, comm.world_size, k=8, chunk=128,
                                      halo=exchange == "halo", **flags)
            name = f"{ekey}_{exchange}"
            out["builds"][name] = time.perf_counter() - t0
            if ws.stream_gathers is not None:
                out["window_padding"][name] = _window_padding(ws, comm.rank)
            runs = [(mkey, False) for mkey in DIST_METHODS]
            if ekey == "fused":
                runs.append(("mg", True))
            for mkey, gated in runs:
                tag = f"{mkey}{'_gated' if gated else ''}"
                if engine != "jnp" and not gated:
                    out["checks"][f"{tag}_{name}"] = _dist_kernels_vs_plain(
                        comm, ws, engine, mkey)
                r = _dist_run(comm, ws, engine, mkey,
                              expected[(tag, ekey)], gated=gated)
                r.pop("labels")
                out["runs"][f"{tag}_{name}"] = r
    return out


def _dist_main(comm, graph, main_refs) -> dict:
    """At 2^22: for each workspace of ``DIST_MAIN``, this rank builds the
    stacked workspace itself, then for each run: its first step's kernels
    held to plain on this rank's blocks, ``dist_lpa`` (== phase 4's
    single-host run, the plan's launches), a timed replay of its steps
    through ``dist_lpa_step`` (host wall between barriers, synchronised;
    it must end at the same labels), and the label exchange alone."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import (_exchange,
                                              build_dist_workspace,
                                              dist_lpa_step)
    dev = comm.device
    out = {"builds": {}, "runs": {}, "checks": {}}
    for kind, (flags, runs) in DIST_MAIN.items():
        t0 = time.perf_counter()
        ws = build_dist_workspace(graph, comm.world_size, k=8, chunk=128,
                                  **flags)
        build_s = time.perf_counter() - t0
        out["builds"][kind] = {
            # every array has the leading P axis
            "seconds": build_s,
            "rank_bytes": _plan_bytes(ws) // comm.world_size,
            "sizes": {"v_pad": ws.v_pad, "m_pad": ws.nbr_pos.shape[1],
                      "h_pad": ws.h_pad, "hub_pad": ws.hub_pad,
                      "n_rounds": ws.n_rounds}}
        init = ws.init_labels[comm.rank].to(dev)
        own = init >= 0
        for path, engine, mkey in runs:
            out["checks"][path] = _dist_kernels_vs_plain(comm, ws, engine,
                                                         mkey)
            labels, iters = main_refs[mkey]
            r = _dist_run(comm, ws, engine, mkey, (labels.numpy(), iters))
            final = r.pop("labels")[init[own].long()]
            method, rescan = DIST_METHODS[mkey]
            step = dist_lpa_step(comm, ws, engine=engine, method=method,
                                 rescan=rescan)
            labels = init
            step_ms = []
            comm.reset_counts()
            for it in range(r["iterations"]):
                dist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                labels, delta = step(labels, it % DIST_RHO == 0, it + 1)
                int(delta)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(labels[own], final):
                raise AssertionError(f"rank {comm.rank}, {path}: the timed "
                                     f"replay diverged from dist_lpa")
            per_iter = {"calls": comm.calls / r["iterations"],
                        "exchanged_bytes": (comm.exchanged_bytes
                                            / r["iterations"]),
                        "staged_bytes": comm.staged_bytes / r["iterations"]}
            del step
            # the exchange alone, on this rank's blocks
            sh = ws.shard(comm.rank, dev)
            ex_ms = []
            for _ in range(EXCHANGE_REPS + 1):
                dist.barrier()
                torch.cuda.synchronize(dev)
                comm.reset_counts()
                t0 = time.perf_counter()
                _exchange(comm, sh, labels, -1)
                torch.cuda.synchronize(dev)
                ex_ms.append((time.perf_counter() - t0) * 1e3)
            r.update(step_ms=step_ms,
                     step_ms_median=statistics.median(step_ms),
                     per_iteration=per_iter,
                     exchange_ms_median=statistics.median(ex_ms[1:]),
                     exchange_bytes=comm.exchanged_bytes,
                     exchange_staged_bytes=comm.staged_bytes,
                     exchange_calls=comm.calls)
            out["runs"][path] = r
            del sh
        del ws
        torch.cuda.empty_cache()
    return out


def _dist_rank(comm, g16, expected16, graph, main_refs, out_dir) -> None:
    """Rank body of phase 6: the 2^16 matrix, then the 2^22 runs; this
    rank's report goes to ``out_dir/rank{r}.json``."""
    out = {"rank": comm.rank, "staged": comm.staged,
           "backend": comm.backend, "device": str(comm.device)}
    t0 = time.perf_counter()
    out["matrix"] = _dist_matrix(comm, g16, expected16)
    out["matrix_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["main"] = _dist_main(comm, graph, main_refs)
    out["main_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{comm.rank}.json").write_text(json.dumps(out))


def _on_host(graph):
    """The graph with its arrays on the host (handed to the ranks in shared
    memory)."""
    return dataclasses.replace(graph, offsets=graph.offsets.cpu(),
                               indices=graph.indices.cpu(),
                               weights=graph.weights.cpu())


def _distributed(g16, graph, main_refs: dict, tag: str) -> dict:
    """Phase 6: ``dist_lpa`` over ``DIST_RANKS`` gloo ranks sharing the
    card (one ``spawn_ranks``; each exchange staged through the host).

    (a) At 2^16: the single-host ``lpa()`` of every method and engine on
    the card, then each rank builds every workspace (full gather and halo,
    on jnp, pallas, pallas_fused with tile_r=32, pallas_stream with
    512-entry windows, unaligned and aligned) and runs mg, bm and the
    rescan on each, and gated mg on the fused one; each run equals the
    single-host run of its method and engine and launches what the plan
    says, and every kernel of its first step equals its plain twin on
    the rank's blocks. (b) At 2^22: each rank builds each workspace of
    ``DIST_MAIN`` and runs its paths against phase 4's runs
    (``main_refs``: CPU labels, iterations), with the same kernel check."""
    import tempfile
    import numpy as np
    from repro_torch.core.distributed import spawn_ranks
    from repro_torch.core.lpa import LPAConfig, lpa
    report = {"ranks": DIST_RANKS, "backend": "gloo"}
    t0 = time.perf_counter()
    expected = {}
    for mkey, (method, rescan) in DIST_METHODS.items():
        first = None
        for ekey, (_, _, fields) in DIST_ENGINES.items():
            res = lpa(g16, LPAConfig(method=method, rescan=rescan, k=8,
                                     chunk=128, **fields))
            got = (res.labels.cpu().numpy(), res.iterations)
            if first is not None and (got[1] != first[1] or
                                      not np.array_equal(got[0], first[0])):
                raise AssertionError(f"phase 6, single-host {mkey}: {ekey} "
                                     f"differs from jnp")
            first = first or got
            expected[(mkey, ekey)] = got
    res = lpa(g16, LPAConfig(method="mg", k=8, chunk=128,
                             fold_backend="pallas_fused",
                             frontier_gate=True))
    expected[("mg_gated", "fused")] = (res.labels.cpu().numpy(),
                                       res.iterations)
    single_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        t0 = time.perf_counter()
        spawn_ranks(_dist_rank, DIST_RANKS,
                    (_on_host(g16), expected, _on_host(graph), main_refs,
                     tmp))
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(DIST_RANKS)]
    report.update(single_host_s=single_s, spawn_s=spawn_s, ranks=ranks)

    # (a) the 2^16 matrix
    mats = [rk["matrix"] for rk in ranks]
    runs = mats[0]["runs"]
    checks: dict = {}
    for m in mats:
        for per_key in m["checks"].values():
            for key, rec in per_key.items():
                checks[key] = checks.get(key, 0) + rec["calls"]
    padded = {name: [m["window_padding"][name] for m in mats]
              for name in mats[0]["window_padding"]}
    # the streamed checks must have met a shard with appended all-pad
    # windows and one whose windows leave columns of the stride unused
    pad_windows = any(n_win > real for per_rank in padded.values()
                      for rounds in per_rank for n_win, real, _, _ in rounds)
    pad_columns = any(stride > used for per_rank in padded.values()
                      for rounds in per_rank for _, _, stride, used in rounds)
    if not (pad_windows and pad_columns):
        raise AssertionError("phase 6: no shard of the 2^16 streamed "
                             "workspaces has padded windows: the kernel "
                             "check met no padding")
    print(f"{tag} phase 6: 2^{PARITY_SCALE} vertices, {DIST_RANKS} gloo "
          f"ranks on one card (staged through the host: "
          f"{ranks[0]['staged']}): {len(runs)} dist_lpa runs per rank "
          f"(mg, bm, rescan x jnp, pallas, pallas_fused, pallas_stream "
          f"unaligned and aligned x full gather, halo; gated mg on "
          f"pallas_fused), every one equal to the single-host lpa() of its "
          f"method and engine in labels and iterations, launches the "
          f"plan's on every rank; every kernel launch of each run's first "
          f"step equal to its plain twin (int32 bits) on the rank's "
          f"blocks, launches checked summed over the ranks {checks}; "
          f"the streamed shards' windows per round [windows, with a row, "
          f"stride, columns used] per rank {padded['stream_full']}; "
          f"single-host runs {single_s:.1f} s, the matrix per rank "
          f"{[round(rk['matrix_s'], 1) for rk in ranks]} s", flush=True)
    for name, r in runs.items():
        print(f"{tag} phase 6: 2^{PARITY_SCALE}, {name}: {r['iterations']} "
              f"iterations, {r['n_rounds']} rounds, rank 0's launches "
              f"{r['launches']}, "
              f"{r['exchanged_bytes']} B exchanged and {r['staged_bytes']} "
              f"B staged on rank 0, {r['seconds']:.2f} s", flush=True)

    # (b) the main graph
    report["main"] = {}
    report["builds"] = {}
    for kind, (flags, kind_runs) in DIST_MAIN.items():
        builds = [rk["main"]["builds"][kind] for rk in ranks]
        print(f"{tag} phase 6: 2^{SCALE}, workspace {kind} {flags} "
              f"({builds[0]['sizes']}): built by each rank in "
              f"{[round(b['seconds'], 1) for b in builds]} s, the rank's "
              f"blocks {[b['rank_bytes'] for b in builds]} B", flush=True)
        report["builds"][kind] = builds
        for path, _, mkey in kind_runs:
            per = [rk["main"]["runs"][path] for rk in ranks]
            held = [rk["main"]["checks"][path] for rk in ranks]
            r0 = per[0]
            print(f"{tag} phase 6: 2^{SCALE}, {path}: {r0['iterations']} "
                  f"iterations, labels and iterations equal to phase "
                  f"4's single-host {mkey} run on every rank; first-step "
                  f"kernels equal to plain per rank "
                  f"{[{k: v['calls'] for k, v in h.items()} for h in held]}"
                  f"; step ms median per rank "
                  f"{[round(p['step_ms_median'], 3) for p in per]}; label "
                  f"exchange alone (host-staged {ranks[0]['staged']}) ms "
                  f"median per rank "
                  f"{[round(p['exchange_ms_median'], 3) for p in per]}, "
                  f"{r0['exchange_bytes']} B received and "
                  f"{r0['exchange_staged_bytes']} B staged per exchange "
                  f"on rank 0; per iteration {r0['per_iteration']}; "
                  f"dist_lpa wall {[round(p['seconds'], 3) for p in per]}"
                  f" s; peak device memory per rank "
                  f"{[p['peak_bytes'] for p in per]} B; launches per "
                  f"rank {[p['launches'] for p in per]}", flush=True)
            report["main"][path] = {"kind": kind, "flags": flags,
                                    "sizes": builds[0]["sizes"],
                                    "ranks": per, "checks": held}
    halo_s = [rk["main"]["builds"]["fused_halo"]["seconds"]
              - rk["main"]["builds"]["fused_full"]["seconds"]
              for rk in ranks]
    report["halo_tables_s"] = halo_s
    print(f"{tag} phase 6: the halo tables cost {[round(h, 1) for h in halo_s]}"
          f" s per rank (fused halo build minus fused full); the spawn "
          f"{spawn_s:.1f} s, of it the 2^22 part per rank "
          f"{[round(rk['main_s'], 1) for rk in ranks]} s", flush=True)
    return report


# -- phase 7: the GNN serving path --------------------------------------------

#: the four GNN archs, and their card-vs-CPU tolerance (rtol = atol) at
#: SMOKE (7a): float32 sums on the card add in another order
GNN_ARCHS = ("pna", "meshgraphnet", "egnn", "equiformer-v2")
GNN_TOL = {"pna": 1e-4, "meshgraphnet": 1e-4, "egnn": 1e-4,
           "equiformer-v2": 1e-3}
#: log2 vertices of 7a's graph (7b-7d's cells: ``repro_torch.launch.serve``)
GNN_SMOKE_SCALE = 12


def _gnn_card_vs_cpu(tag: str) -> dict:
    """7a: each arch at SMOKE, one state dict on the card and on the CPU:
    PNA, MeshGraphNet and EGNN on the full-graph batch of a 2^12 graph,
    Equiformer-v2 on 16 molecules; outputs within ``GNN_TOL``, and two
    runs on the card side by side."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import gnn_full_batch, molecule_batch
    from repro_torch.graphs.generators import powerlaw_communities
    from repro_torch.launch.serve import gnn_model

    n = 1 << GNN_SMOKE_SCALE
    g_cpu, _ = powerlaw_communities(n, p_in=0.5, mix=0.02, seed=1,
                                    device="cpu")
    g_card, _ = powerlaw_communities(n, p_in=0.5, mix=0.02, seed=1)
    graph_batches = (gnn_full_batch(0, g_cpu, d_feat=8),
                     gnn_full_batch(0, g_card, d_feat=8))
    mol = molecule_batch(0, 16, 30, 64, 8, device="cpu")
    mol_batches = (mol, {k: v.cuda() for k, v in mol.items()})
    out = {}
    for arch in GNN_ARCHS:
        cfg = get_arch(arch).smoke
        cpu_batch, card_batch = (mol_batches if arch == "equiformer-v2"
                                 else graph_batches)
        model, apply = gnn_model(arch, cfg, "cpu")
        card, _ = gnn_model(arch, cfg, seed=1)
        card.load_state_dict(model.state_dict())
        with torch.inference_mode():
            ref = apply(model, cpu_batch)
            got = apply(card, card_batch)
            again = apply(card, card_batch)
        tol = GNN_TOL[arch]
        err = _max_abs_err(got.cpu(), ref)
        run_to_run = _max_abs_err(got, again)
        scale = float(ref.abs().max())
        if got.device.type != "cuda" or not torch.allclose(
                got.cpu(), ref, rtol=tol, atol=tol):
            raise AssertionError(f"phase 7a, {arch}: the card's output is "
                                 f"off the CPU's by {err!r} (tolerance "
                                 f"{tol})")
        where = ("16 molecules" if arch == "equiformer-v2" else
                 f"2^{GNN_SMOKE_SCALE} graph, {g_card.n_edges} slots")
        print(f"{tag} phase 7a: {arch} SMOKE on the {where}: output "
              f"{list(got.shape)}, largest |output| {scale!r}, max abs err "
              f"vs CPU {err!r} (rtol = atol = {tol}), two runs on the card "
              f"differ by {run_to_run!r}", flush=True)
        out[arch] = {"max_abs_err": err, "tolerance": tol,
                     "run_to_run": run_to_run, "max_abs_output": scale,
                     "shape": list(got.shape)}
    return out


def _gnn_partition(g, lpa_cfg, tag: str, phase: str = "7b") -> dict:
    """7b (a): ``lpa_partition(g, 4, lpa_cfg)`` of the 2^18 graph with its
    K1/K2 launches counted (the plan's rounds x iterations); then K1 and
    K2 held to their plain versions on that plan's rounds (phase 2's
    check, on this path's own shapes and first-iteration inputs), and the
    partition held to the plain-torch engine's (``fold_backend="jnp"``:
    equal order, parts, bounds, communities and cut). Phase 8b runs it
    again before training (``phase`` names the phase in the lines)."""
    import numpy as np
    import torch
    from repro_torch.core.lpa import build_workspace
    from repro_torch.graphs.partition import (contiguous_parts,
                                              edge_cut_fraction,
                                              lpa_partition)
    from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    part = lpa_partition(g, 4, lpa_cfg)
    part_s = time.perf_counter() - t0
    launches = {key: n for key, n in LAUNCH_COUNTS.items() if n}
    # the fused plan that lpa() builds for lpa_cfg
    fplan = build_workspace(g, lpa_cfg).fused_plan
    n_rounds = fplan.n_rounds
    iters = launches.get("fused_select", 0)
    want = {"fused_fold": (n_rounds - 1) * iters, "fused_select": iters,
            "frontier_marks": iters}
    if not 0 < iters <= lpa_cfg.max_iters or launches != want:
        raise AssertionError(f"phase {phase}, lpa_partition: launches "
                             f"{launches}, the plan's {n_rounds} rounds x "
                             f"{iters} iterations give {want}")
    kstats = kernels_vs_plain(g, fplan, tag, phase=phase,
                              row_contiguous=False)
    del fplan
    reset_launch_counts()
    t0 = time.perf_counter()
    plain = lpa_partition(g, 4, dataclasses.replace(lpa_cfg,
                                                    fold_backend="jnp"))
    plain_s = time.perf_counter() - t0
    # the plain engine folds in torch; only the frontier marks launch
    plain_launches = {key: n for key, n in LAUNCH_COUNTS.items()
                      if n and key != "frontier_marks"}
    if plain_launches:
        raise AssertionError(f"phase {phase}, lpa_partition on jnp: a fold "
                             f"kernel ran: {plain_launches}")
    if (part.n_communities != plain.n_communities
            or part.edge_cut != plain.edge_cut
            or not np.array_equal(part.order, plain.order)
            or not np.array_equal(part.parts, plain.parts)
            or not np.array_equal(part.bounds, plain.bounds)):
        raise AssertionError(f"phase {phase}: lpa_partition on "
                             f"{lpa_cfg.fold_backend} ({part.n_communities}"
                             f" communities, cut {part.edge_cut!r}) differs "
                             f"from jnp's ({plain.n_communities}, "
                             f"{plain.edge_cut!r})")
    if not np.array_equal(np.sort(part.order), np.arange(g.n_nodes)):
        raise AssertionError(f"phase {phase}: the partition order is not a "
                             "permutation")
    base_cut = edge_cut_fraction(g, contiguous_parts(g, 4))
    print(f"{tag} phase {phase}: lpa_partition(graph, 4) on "
          f"{lpa_cfg.fold_backend}: {part.n_communities} communities, "
          f"launches {launches} ({n_rounds} rounds x {iters} iterations), "
          f"K1 and K2 exact to plain on this plan's rounds, order, parts, "
          f"bounds and cut equal to jnp's ({plain_s:.2f} s); edge cut "
          f"{part.edge_cut!r} against contiguous_parts's {base_cut!r}; "
          f"{part_s:.2f} s", flush=True)
    return {"launches": launches, "n_rounds": n_rounds, "iterations": iters,
            "seconds": part_s, "jnp_seconds": plain_s,
            "edge_cut": part.edge_cut, "contiguous_edge_cut": base_cut,
            "n_communities": part.n_communities,
            "kernels_vs_plain": {
                key: {f: st[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "max_abs_err")}
                for key, st in kstats.items()}}


def _gnn_example(lpa_cfg, tag: str) -> dict:
    """7b: the example's path at full width on the 2^18 graph:
    ``lpa_partition`` (K1, K2 counted and held to plain), then PNA,
    MeshGraphNet and EGNN at FULL on its full-graph batch."""
    import torch
    from repro_torch.launch.serve import (CLASSES, EXAMPLE, cell_config,
                                          example_batch, example_graph,
                                          gnn_model, serve)

    t0 = time.perf_counter()
    g = example_graph()
    gen_s = time.perf_counter() - t0
    print(f"{tag} phase 7b: powerlaw_communities(1<<{EXAMPLE['scale']}): "
          f"{g.n_nodes} vertices, {g.n_edges} slots (generated in "
          f"{gen_s:.1f} s)", flush=True)
    report = {"n_nodes": g.n_nodes, "n_edges": g.n_edges,
              "partition": _gnn_partition(g, lpa_cfg, tag)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = example_batch(g)
    torch.cuda.synchronize()
    report["batch_s"] = time.perf_counter() - t0
    for arch in ("pna", "meshgraphnet", "egnn"):
        cfg = cell_config(arch, EXAMPLE["d_feat"])
        model, apply = gnn_model(arch, cfg)
        r = serve(apply, model, [batch])
        if r["shape"] != [g.n_nodes, CLASSES]:
            raise AssertionError(f"phase 7b, {arch}: output {r['shape']}")
        r["config"] = dataclasses.asdict(cfg)
        report[arch] = r
        print(f"{tag} phase 7b: {arch} FULL {r['config']}: forward "
              f"{r['ms'][0]:.3f} ms (median of 5 after 2 warm-up), peak "
              f"{r['peak_bytes']} B ({r['working_bytes']} B above the "
              f"{r['resident_bytes']} B resident), output {r['shape']}, "
              f"finite", flush=True)
        del model
    return report


def _gnn_minibatch(graph, tag: str) -> dict:
    """7c: the minibatch_lg cell: three batches sampled on the host from
    the main graph (resident on the card), PNA at FULL on each."""
    import torch
    from repro_torch.graphs.sampler import sample_fanout, sampled_shape
    from repro_torch.launch.serve import (MINIBATCH, cell_config, gnn_model,
                                          minibatch_batch, serve)

    mb = MINIBATCH
    if graph.n_nodes != 1 << mb["scale"]:
        raise AssertionError(f"phase 7c: the main graph has "
                             f"{graph.n_nodes} vertices, the cell 2^"
                             f"{mb['scale']}")
    sample_s, batch_s, batches = [], [], []

    def timed_sample(g, seeds, fanouts, rng):
        t0 = time.perf_counter()
        sub = sample_fanout(g, seeds, fanouts, rng)
        sample_s.append(time.perf_counter() - t0)
        return sub

    for step in range(mb["steps"]):
        t0 = time.perf_counter()
        batches.append(minibatch_batch(graph, step, timed_sample))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    v, e = sampled_shape(mb["batch_nodes"], mb["fanouts"])
    for b in batches:
        if (tuple(b["node_feat"].shape) != (v, mb["d_feat"])
                or b["edge_src"].shape[0] != e
                or b["node_feat"].device.type != "cuda"):
            raise AssertionError(f"phase 7c: a batch of shape "
                                 f"{tuple(b['node_feat'].shape)}")
    model, apply = gnn_model("pna", cell_config("pna", mb["d_feat"]))
    r = serve(apply, model, batches)
    r.update(n_nodes=v, n_edges=e, sample_s=sample_s, batch_s=batch_s)
    print(f"{tag} phase 7c: minibatch_lg on the 2^{mb['scale']} graph: "
          f"{mb['batch_nodes']} seeds, fanouts {mb['fanouts']}: {v} nodes, "
          f"{e} edges a batch; host sampling "
          f"{', '.join(f'{s:.3f}' for s in sample_s)} s, whole batch "
          f"(sampling, features, copy) "
          f"{', '.join(f'{s:.3f}' for s in batch_s)} s; PNA FULL (d_in "
          f"{mb['d_feat']}) forward "
          f"{', '.join(f'{m:.3f}' for m in r['ms'])} ms (median of 5 each), "
          f"peak {r['peak_bytes']} B ({r['working_bytes']} B above "
          f"resident), output {r['shape']}, finite", flush=True)
    return r


def _gnn_molecule(tag: str) -> dict:
    """7d: the molecule cell: Equiformer-v2 and EGNN at FULL."""
    from repro_torch.launch.serve import (CLASSES, MOLECULE, cell_config,
                                          gnn_model, molecule_cell_batch,
                                          serve)

    mc = MOLECULE
    batch = molecule_cell_batch()
    n = mc["n_mol"] * mc["n_per"]
    report = {}
    for arch in ("equiformer-v2", "egnn"):
        cfg = cell_config(arch, mc["d_feat"])
        model, apply = gnn_model(arch, cfg)
        r = serve(apply, model, [batch])
        if r["shape"] != [n, CLASSES]:
            raise AssertionError(f"phase 7d, {arch}: output {r['shape']}")
        r["config"] = dataclasses.asdict(cfg)
        report[arch] = r
        print(f"{tag} phase 7d: molecule cell ({mc['n_mol']} molecules, "
              f"{n} nodes, {mc['n_mol'] * mc['e_per']} edges): {arch} FULL "
              f"{r['config']}: forward {r['ms'][0]:.3f} ms (median of 5), "
              f"peak {r['peak_bytes']} B ({r['working_bytes']} B above "
              f"resident), output {r['shape']}, finite", flush=True)
        del model
    return report


def _gnn_path(graph, lpa_cfg, tag: str) -> dict:
    """Phase 7: the GNN serving path (7a-7d), float32 matmuls without
    TF32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("phase 7: TF32 is on")
    report = {"card_vs_cpu": _gnn_card_vs_cpu(tag)}
    torch.cuda.empty_cache()
    report["example"] = _gnn_example(lpa_cfg, tag)
    torch.cuda.empty_cache()
    report["minibatch_lg"] = _gnn_minibatch(graph, tag)
    torch.cuda.empty_cache()
    report["molecule"] = _gnn_molecule(tag)
    return report


# -- phase 8: the training path ------------------------------------------------

#: card-vs-CPU tolerance (rtol = atol) of 8a's SMOKE train steps: float32
#: sums on the card add in another order
TRAIN_TOL = {"pna": 1e-4, "meshgraphnet": 1e-4, "egnn": 1e-4,
             "equiformer-v2": 1e-3, "dcn-v2": 1e-4}
#: SMOKE train steps of 8a, and DCN-v2's rows a step there
SMOKE_TRAIN_STEPS = 3
SMOKE_DCN_ROWS = 256
#: ranks and trees per rank of 8g's data-parallel steps
DP_RANKS = 4
DP_TREES = 256
#: the crash-and-resume run of 8f: the launcher's steps, checkpoint
#: cadence and injected failure
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL_AT = 12, 4, 6


def _param_leaves(model) -> list:
    from repro_torch.tree import tree_leaves
    return [p.detach() for p in tree_leaves(model)]


def _train_card_vs_cpu(tag: str) -> dict:
    """8a: each GNN arch and DCN-v2 at SMOKE, one state dict on the card
    and on the CPU, 3 train steps each (the reference's schedule): the
    losses and every parameter after them within ``TRAIN_TOL``. The GNN
    batches are 7a's (the 2^12 graph's full-graph batch, 16 molecules for
    Equiformer-v2), DCN-v2's ``dcn_batch`` rows."""
    import torch
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.data.synthetic import (dcn_batch, gnn_full_batch,
                                            molecule_batch)
    from repro_torch.graphs.generators import powerlaw_communities
    from repro_torch.launch.cells import build_cell
    from repro_torch.optim.adamw import adamw_init

    n = 1 << GNN_SMOKE_SCALE
    g_cpu, _ = powerlaw_communities(n, p_in=0.5, mix=0.02, seed=1,
                                    device="cpu")
    g_card, _ = powerlaw_communities(n, p_in=0.5, mix=0.02, seed=1)
    graph_batches = (gnn_full_batch(0, g_cpu, d_feat=8),
                     gnn_full_batch(0, g_card, d_feat=8))
    mol = molecule_batch(0, 16, 30, 64, 8, device="cpu")
    mol_batches = (mol, {k: v.cuda() for k, v in mol.items()})
    out = {}
    for arch in GNN_ARCHS + ("dcn-v2",):
        spec = get_arch(arch)
        spec = dataclasses.replace(spec, config=spec.smoke)
        if arch == "dcn-v2":
            cell = ShapeCell("smoke", "recsys_train",
                             {"batch": SMOKE_DCN_ROWS})
            cfg = spec.smoke
            steps = [dcn_batch(0, s, SMOKE_DCN_ROWS, cfg.n_dense,
                               cfg.n_sparse, cfg.vocab_sizes, device=dev)
                     for s in range(SMOKE_TRAIN_STEPS)
                     for dev in ("cpu", None)]
            cpu_batches, card_batches = steps[0::2], steps[1::2]
        else:
            cpu_b, card_b = (mol_batches if arch == "equiformer-v2"
                             else graph_batches)
            cell = ShapeCell("smoke", "gnn_full",
                             {"n_nodes": cpu_b["node_feat"].shape[0],
                              "n_edges": cpu_b["edge_src"].shape[0],
                              "d_feat": 8})
            cpu_batches = [cpu_b] * SMOKE_TRAIN_STEPS
            card_batches = [card_b] * SMOKE_TRAIN_STEPS
        plan = build_cell(spec, cell)
        model = plan.init(torch.Generator().manual_seed(0), device="cpu")
        card = plan.init(torch.Generator().manual_seed(1))
        card.load_state_dict(model.state_dict())
        opt, card_opt = adamw_init(model), adamw_init(card)
        ref_losses, losses = [], []
        for cb, gb in zip(cpu_batches, card_batches):
            model, opt, m = plan.fn(model, opt, cb)
            card, card_opt, cm = plan.fn(card, card_opt, gb)
            ref_losses.append(float(m["loss"]))
            losses.append(float(cm["loss"]))
        tol = TRAIN_TOL[arch]
        got, ref = _param_leaves(card), _param_leaves(model)
        if any(p.device.type != "cuda" for p in got) or \
                int(card_opt["step"]) != SMOKE_TRAIN_STEPS:
            raise AssertionError(f"phase 8a, {arch}: the card's state is "
                                 f"not on the card")
        err = max(_max_abs_err(a.cpu(), b) for a, b in zip(got, ref))
        loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
        ok = all(torch.allclose(a.cpu(), b, rtol=tol, atol=tol)
                 for a, b in zip(got, ref))
        ok = ok and torch.allclose(torch.tensor(losses),
                                   torch.tensor(ref_losses), rtol=tol,
                                   atol=tol)
        if not ok:
            raise AssertionError(f"phase 8a, {arch}: after "
                                 f"{SMOKE_TRAIN_STEPS} SMOKE train steps "
                                 f"the card is off the CPU: parameters by "
                                 f"{err!r}, losses {losses} vs "
                                 f"{ref_losses} (tolerance {tol})")
        print(f"{tag} phase 8a: {arch} SMOKE, {SMOKE_TRAIN_STEPS} train "
              f"steps on the card and on the CPU from one state: losses "
              f"{losses} (CPU {ref_losses}, max abs err {loss_err!r}), "
              f"parameters' max abs err {err!r} (rtol = atol = {tol})",
              flush=True)
        out[arch] = {"losses": losses, "cpu_losses": ref_losses,
                     "loss_err": loss_err, "param_err": err,
                     "tolerance": tol}
    return out


def _train_cell(tag: str, phase: str, what: str, plan, batches) -> dict:
    """``plan``'s train step on the card: the model from a CPU generator
    seeded 0, one step per batch (``train_steps``), printed."""
    import torch
    from repro_torch.launch.train_cells import train_steps
    from repro_torch.optim.adamw import adamw_init

    model = plan.init(torch.Generator().manual_seed(0))
    opt = adamw_init(model)
    r = train_steps(plan.fn, model, opt, batches)
    del r["model"], r["opt"]
    n_params = sum(p.numel() for p in model.parameters())
    r.update(config=dataclasses.asdict(plan.config), n_params=n_params,
             meta=dict(plan.meta))
    print(f"{tag} phase {phase}: {what}: {len(batches)} train steps "
          f"(forward, backward, AdamW) of {n_params} parameters: median "
          f"{r['median_ms']:.3f} ms after 1 warm-up (each: "
          f"{', '.join(f'{m:.3f}' for m in r['ms'])} ms), peak "
          f"{r['peak_bytes']} B ({r['working_bytes']} B above the "
          f"{r['resident_bytes']} B resident), losses "
          f"{', '.join(f'{x:.6f}' for x in r['losses'])}", flush=True)
    return r


def _train_example(lpa_cfg, tag: str) -> dict:
    """8b: the example's path, trained: ``lpa_partition`` of the 2^18
    graph (K1/K2 counted and held to plain, as 7b), then PNA FULL on its
    full-graph batch."""
    import torch
    from repro_torch.launch.serve import EXAMPLE, example_batch, example_graph
    from repro_torch.launch.train_cells import TRAIN_STEPS, example_plan

    g = example_graph()
    report = {"n_nodes": g.n_nodes, "n_edges": g.n_edges,
              "scale": EXAMPLE["scale"],
              "partition": _gnn_partition(g, lpa_cfg, tag, phase="8b")}
    torch.cuda.empty_cache()
    batch = example_batch(g)
    report["pna"] = _train_cell(
        tag, "8b", f"2^{EXAMPLE['scale']} full graph ({g.n_nodes} nodes, "
        f"{g.n_edges} edges, {EXAMPLE['d_feat']} features), PNA FULL",
        example_plan("pna", g), [batch] * TRAIN_STEPS)
    return report


def _train_minibatch(graph, tag: str) -> dict:
    """8c: ``minibatch_lg`` in the tree layout, sampled on the host from
    the main graph (resident on the card): PNA FULL and MeshGraphNet FULL,
    one batch a step."""
    from repro_torch.launch.serve import MINIBATCH
    from repro_torch.launch.train_cells import (TRAIN_STEPS, train_plan,
                                                tree_batch)

    batch_s, batches = [], []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batches.append(tree_batch(graph, step))
        batch_s.append(time.perf_counter() - t0)
    b = batches[0]
    if (b["node_feat"].device.type != "cuda"
            or b["node_feat"].shape[0] != MINIBATCH["batch_nodes"]):
        raise AssertionError(f"phase 8c: a tree batch of shape "
                             f"{tuple(b['node_feat'].shape)}")
    shape = tuple(b["node_feat"].shape)
    print(f"{tag} phase 8c: minibatch_lg in the tree layout from the 2^"
          f"{MINIBATCH['scale']} graph: node features {list(shape)}, "
          f"edges {list(b['edge_src'].shape)}; host seconds a batch "
          f"(sampling, features, copy): "
          f"{', '.join(f'{s:.3f}' for s in batch_s)}", flush=True)
    report = {"batch_s": batch_s, "node_feat_shape": list(shape)}
    for arch in ("pna", "meshgraphnet"):
        report[arch] = _train_cell(tag, "8c", f"minibatch_lg, {arch} FULL",
                                   train_plan(arch, "minibatch_lg"), batches)
    return report


def _train_small_cells(tag: str) -> dict:
    """8d: ``molecule`` (Equiformer-v2 and EGNN FULL) and ``full_graph_sm``
    (all four archs FULL)."""
    import torch
    from repro_torch.launch.serve import molecule_cell_batch
    from repro_torch.launch.train_cells import (TRAIN_STEPS,
                                                full_graph_sm_batch,
                                                train_plan)

    report = {"molecule": {}, "full_graph_sm": {}}
    mol = molecule_cell_batch()
    for arch in ("equiformer-v2", "egnn"):
        report["molecule"][arch] = _train_cell(
            tag, "8d", f"molecule, {arch} FULL", train_plan(arch, "molecule"),
            [mol] * TRAIN_STEPS)
        torch.cuda.empty_cache()
    sm = full_graph_sm_batch()
    for arch in GNN_ARCHS:
        report["full_graph_sm"][arch] = _train_cell(
            tag, "8d", f"full_graph_sm ({sm['node_feat'].shape[0]} nodes, "
            f"{sm['edge_src'].shape[0]} edges, {sm['node_feat'].shape[1]} "
            f"features), {arch} FULL", train_plan(arch, "full_graph_sm"),
            [sm] * TRAIN_STEPS)
        torch.cuda.empty_cache()
    return report


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _train_dcn(tag: str) -> dict:
    """8e: DCN-v2 FULL. The tables (46.88 M rows x 16) are drawn on a
    CUDA generator (a CPU one takes ~40 s for 750 M draws); 5 train steps
    at ``train_batch``'s 65,536 rows; one ``CheckpointManager`` save and
    restore of the whole state (parameters and AdamW moments), bit for
    bit, timed, then deleted; forwards at ``serve_p99`` and
    ``serve_bulk``; ``retrieval_cand``'s scores of one query against
    1,000,000 candidates."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import dcn_batch
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train_cells import (TRAIN_STEPS, registry_cell,
                                                train_plan, train_steps)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_leaves

    cfg = get_arch("dcn-v2").config
    plan = train_plan("dcn-v2", "train_batch")
    rows = registry_cell("dcn-v2", "train_batch").params["batch"]

    def batch(step, n):
        return dcn_batch(0, step, n, cfg.n_dense, cfg.n_sparse,
                         cfg.vocab_sizes)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = plan.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    table_rows = sum(cfg.vocab_sizes)
    opt = adamw_init(model)
    batches = [batch(s, rows) for s in range(TRAIN_STEPS)]
    r = train_steps(plan.fn, model, opt, batches)
    model, opt = r.pop("model"), r.pop("opt")
    report = {"init_s": init_s, "n_params": n_params,
              "table_rows": table_rows, "train": r}
    print(f"{tag} phase 8e: DCN-v2 FULL ({table_rows} table rows x "
          f"{cfg.embed_dim}, {n_params} parameters; drawn on a CUDA "
          f"generator in {init_s:.2f} s): {TRAIN_STEPS} train steps of "
          f"{rows} rows: median {r['median_ms']:.3f} ms after 1 warm-up "
          f"(each: {', '.join(f'{m:.3f}' for m in r['ms'])} ms), peak "
          f"{r['peak_bytes']} B ({r['working_bytes']} B above the "
          f"{r['resident_bytes']} B resident), losses "
          f"{', '.join(f'{x:.6f}' for x in r['losses'])}", flush=True)

    # one save and restore of the whole state
    state = {"params": model, "opt": opt}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        mgr = CheckpointManager(str(tmp), keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, state)
        save_s = time.perf_counter() - t0
        n_bytes = _dir_bytes(tmp)
        template = plan.init(torch.Generator(device="cuda").manual_seed(1))
        template = {"params": template, "opt": adamw_init(template)}
        t0 = time.perf_counter()
        restored, step = mgr.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    leaves, back = tree_leaves(state), tree_leaves(restored)
    same = (step == TRAIN_STEPS and len(leaves) == len(back)
            and all(b.device.type == "cuda" and _same_bits(a, b)
                    for a, b in zip(leaves, back)))
    if not same:
        raise AssertionError("phase 8e: the restored DCN-v2 state differs "
                             "from the saved one")
    del template, restored, back
    torch.cuda.empty_cache()
    report["checkpoint"] = {"bytes": n_bytes, "save_s": save_s,
                            "restore_s": restore_s, "leaves": len(leaves)}
    print(f"{tag} phase 8e: CheckpointManager save of the whole DCN-v2 "
          f"state ({len(leaves)} leaves: parameters, m, v, step): "
          f"{n_bytes} B in {save_s:.2f} s (fsynced), restore to the card "
          f"in {restore_s:.2f} s, every leaf equal bit for bit; directory "
          f"deleted", flush=True)

    # the serving cells and retrieval
    for name in ("serve_p99", "serve_bulk"):
        splan = train_plan("dcn-v2", name)
        n = registry_cell("dcn-v2", name).params["batch"]
        sb = [batch(100 + s, n) for s in range(2)]
        res = serve(lambda m, b: splan.fn(m, b["dense"], b["sparse"]),
                    model, sb)
        if res["shape"] != [n]:
            raise AssertionError(f"phase 8e, {name}: output {res['shape']}")
        report[name] = res
        print(f"{tag} phase 8e: DCN-v2 FULL {name} ({n} rows): forward "
              f"{', '.join(f'{m:.3f}' for m in res['ms'])} ms (median of 5 "
              f"each, 2 batches), peak {res['peak_bytes']} B, finite",
              flush=True)
    rcell = registry_cell("dcn-v2", "retrieval_cand").params
    rplan = train_plan("dcn-v2", "retrieval_cand")
    d_q = cfg.d_interact + cfg.mlp_dims[-1]
    cand = torch.randn((rcell["n_candidates"], d_q), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    q = batch(200, rcell["batch"])
    res = serve(lambda m, b: rplan.fn(m, b["dense"], b["sparse"], cand),
                model, [q])
    if res["shape"] != [rcell["batch"], rcell["n_candidates"]]:
        raise AssertionError(f"phase 8e, retrieval: output {res['shape']}")
    report["retrieval_cand"] = res
    print(f"{tag} phase 8e: DCN-v2 FULL retrieval_cand (1 query against "
          f"{rcell['n_candidates']} candidates x {d_q}, "
          f"{cand.numel() * 4} B): {res['ms'][0]:.3f} ms (median of 5), "
          f"peak {res['peak_bytes']} B, finite", flush=True)
    del model, opt, state, cand
    torch.cuda.empty_cache()
    return report


def _launch_train(root: Path, ckpt: Path, arch: str, *extra: str):
    """Start ``python -m repro_torch.launch.train --arch <arch>`` on the
    card (SMOKE) with the resume runs' steps; ``_finished`` waits."""
    import os
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--steps", str(RESUME_STEPS), "--ckpt-every",
           str(RESUME_EVERY), "--ckpt-dir", str(ckpt), *extra]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finished(proc) -> subprocess.CompletedProcess:
    out, err = proc.communicate(timeout=600)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _train_resume(root: Path, tag: str, arch: str = "dcn-v2",
                  phase: str = "8f") -> dict:
    """8f (DCN-v2) and 9f (qwen3-1.7b): crash and resume on the card. The
    launcher's run of ``RESUME_STEPS`` steps uninterrupted and, beside it
    (two processes on the card), one with ``--fail-at`` into a fresh
    directory (it must fail there); then that one relaunched: the
    resumed run's losses equal the tail of the uninterrupted run's bit
    for bit, and so does the last checkpoint (the launcher runs under
    ``torch.use_deterministic_algorithms(True)``)."""
    import tempfile
    import numpy as np

    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        t0 = time.perf_counter()
        procs = (_launch_train(root, Path(tmp, "ref"), arch),
                 _launch_train(root, Path(tmp, "crash"), arch, "--fail-at",
                               str(RESUME_FAIL_AT)))
        ref, crash = (_finished(p) for p in procs)
        resumed = _finished(_launch_train(root, Path(tmp, "crash"), arch))
        report["seconds"] = time.perf_counter() - t0
        if ref.returncode or resumed.returncode:
            raise AssertionError(f"phase {phase}: the launcher failed:\n"
                                 f"{ref.stderr[-2000:]}\n"
                                 f"{resumed.stderr[-2000:]}")
        if (crash.returncode == 0 or "injected failure at step "
                f"{RESUME_FAIL_AT}" not in crash.stderr):
            raise AssertionError(f"phase {phase}: the run with --fail-at did "
                                 f"not fail as injected:\n"
                                 f"{crash.stderr[-2000:]}")
        hist = json.loads(ref.stdout.strip().splitlines()[-1])
        tail = json.loads(resumed.stdout.strip().splitlines()[-1])
        start = tail["start"]
        last = f"step_{RESUME_STEPS:08d}/host_0.npz"
        with np.load(Path(tmp, "ref", last)) as a, \
                np.load(Path(tmp, "crash", last)) as b:
            same_ckpt = sorted(a.files) == sorted(b.files) and all(
                a[k].tobytes() == b[k].tobytes() for k in a.files)
    if (start != (RESUME_FAIL_AT // RESUME_EVERY) * RESUME_EVERY
            or tail["history"] != hist["history"][start:] or not same_ckpt):
        raise AssertionError(f"phase {phase}: the resumed run (from step "
                             f"{start}) differs from the uninterrupted one: "
                             f"{tail['history']} vs "
                             f"{hist['history'][start:]}; last checkpoint "
                             f"equal: {same_ckpt}")
    report.update(history=hist["history"], resumed_from=start,
                  tail=tail["history"])
    print(f"{tag} phase {phase}: python -m repro_torch.launch.train --arch "
          f"{arch} --steps {RESUME_STEPS} --ckpt-every {RESUME_EVERY} on the "
          f"card: uninterrupted and, beside it, --fail-at {RESUME_FAIL_AT} "
          f"(failed as injected), then relaunched from step {start}: the "
          f"resumed losses "
          f"{tail['history']} equal the uninterrupted run's tail bit for "
          f"bit, and so does the step-{RESUME_STEPS} checkpoint; three "
          f"launches in {report['seconds']:.1f} s", flush=True)
    return report


def _dp_rank(comm, graph, out_dir) -> None:
    """Rank body of 8g: PNA FULL on ``DP_TREES`` ``minibatch_lg`` trees of
    this rank's own (sampled from the host copy of the main graph),
    ``TRAIN_STEPS`` data-parallel steps with the int8 error-feedback
    all-reduce, then as many with the float32 mean, each run from the
    same init: every step's ms and its all-reduces' ms (host wall,
    synchronised), the bytes they send (and ``ShardComm.bytes_by_op``'s
    count of them, phase 12c's), and the parameters' bits equal across
    the ranks after each run. The report goes to
    ``out_dir/dp{r}.json``."""
    import torch
    from repro_torch.launch.train_cells import (TRAIN_STEPS, train_plan,
                                                tree_batch)
    from repro_torch.train.steps import make_dp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    plan = train_plan("pna", "minibatch_lg")
    t0 = time.perf_counter()
    batches = [{k: v.to(comm.device) for k, v in
                tree_batch(graph, s, DP_TREES, comm.rank,
                           comm.world_size).items()}
               for s in range(TRAIN_STEPS)]
    out = {"rank": comm.rank, "batch_s": time.perf_counter() - t0,
           "trees": DP_TREES}
    reduce = comm.all_reduce
    timing = {"s": 0.0, "bytes": 0}

    def timed_reduce(t, op="sum"):
        torch.cuda.synchronize(comm.device)
        t1 = time.perf_counter()
        res = reduce(t, op)
        torch.cuda.synchronize(comm.device)
        timing["s"] += time.perf_counter() - t1
        timing["bytes"] += t.numel() * t.element_size()
        return res

    comm.all_reduce = timed_reduce
    for run, compress in (("int8", True), ("plain", False)):
        model = plan.init(torch.Generator().manual_seed(0),
                          device=comm.device)
        init, step = make_dp_train_step(plan.loss, comm, compress=compress)
        opt, err = init(model)
        ms, ex_ms, wire, losses, by_op = [], [], [], [], []
        for b in batches:
            timing.update(s=0.0, bytes=0)
            comm.reset_counts()
            torch.cuda.synchronize(comm.device)
            t1 = time.perf_counter()
            model, opt, err, m = step(model, opt, err, b)
            torch.cuda.synchronize(comm.device)
            ms.append((time.perf_counter() - t1) * 1e3)
            ex_ms.append(timing["s"] * 1e3)
            wire.append(timing["bytes"])
            by_op.append(dict(comm.bytes_by_op))
            losses.append(float(m["loss"]))
        bits = torch.cat([p.reshape(-1) for p in _param_leaves(model)]
                         ).view(torch.int32)
        every = comm.all_gather(bits).reshape(comm.world_size, -1)
        n_params = bits.numel()
        out[run] = {"ms": ms, "exchange_ms": ex_ms, "wire_bytes": wire,
                    "bytes_by_op": by_op, "losses": losses,
                    "equal_across_ranks": bool((every == every[0]).all()),
                    "n_params": n_params}
    Path(out_dir, f"dp{comm.rank}.json").write_text(json.dumps(out))


def _train_dp(graph, tag: str) -> dict:
    """8g: ``make_dp_train_step`` over ``DP_RANKS`` gloo ranks sharing the
    card (one ``spawn_ranks``; the all-reduces staged through the host),
    PNA FULL on ``minibatch_lg`` trees, ``DP_TREES`` a rank: compressed
    and plain, every rank's parameters equal bit for bit."""
    import statistics
    import tempfile
    from repro_torch.core.distributed import spawn_ranks

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        t0 = time.perf_counter()
        spawn_ranks(_dp_rank, DP_RANKS, (_on_host(graph), tmp))
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"dp{r}.json").read_text())
                 for r in range(DP_RANKS)]
    report = {"ranks": ranks, "spawn_s": spawn_s}
    for run in ("int8", "plain"):
        if not all(rk[run]["equal_across_ranks"] for rk in ranks):
            raise AssertionError(f"phase 8g, {run}: the ranks' parameters "
                                 f"differ")
        losses = [rk[run]["losses"] for rk in ranks]
        if any(x != losses[0] for x in losses):
            raise AssertionError(f"phase 8g, {run}: the ranks' mean losses "
                                 f"differ: {losses}")
        n = ranks[0][run]["n_params"]
        print(f"{tag} phase 8g: {DP_RANKS} gloo ranks on the card, PNA FULL "
              f"({n} parameters), minibatch_lg trees, {DP_TREES} a rank, "
              f"{run} all-reduce: every rank's parameters equal bit for bit"
              f" after {len(losses[0])} steps; losses "
              f"{', '.join(f'{x:.6f}' for x in losses[0])}; per rank, step "
              f"ms (median after 1 warm-up) / all-reduce ms / bytes sent a "
              f"step: "
              + "; ".join(f"{statistics.median(rk[run]['ms'][1:]):.2f} / "
                          f"{statistics.median(rk[run]['exchange_ms'][1:]):.2f}"
                          f" / {rk[run]['wire_bytes'][0]}" for rk in ranks)
              + f" (the int8 payload is {n} B, the float32 gradient "
              f"{4 * n} B; the int8 sum travels as int32)", flush=True)
    return report


def _train_path(graph, lpa_cfg, root: Path, tag: str) -> dict:
    """Phase 8: the training path (8a-8g), float32 matmuls without TF32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("phase 8: TF32 is on")
    report = {"card_vs_cpu": _train_card_vs_cpu(tag)}
    for key, fn in (("example", lambda: _train_example(lpa_cfg, tag)),
                    ("minibatch_lg", lambda: _train_minibatch(graph, tag)),
                    ("small_cells", lambda: _train_small_cells(tag)),
                    ("dcn", lambda: _train_dcn(tag)),
                    ("resume", lambda: _train_resume(root, tag)),
                    ("data_parallel", lambda: _train_dp(graph, tag))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report[key] = fn()
        report[key + "_s"] = time.perf_counter() - t0
    print(f"{tag} phase 8: seconds by part: "
          + ", ".join(f"{key} {report[key + '_s']:.1f}" for key in
                      ("example", "minibatch_lg", "small_cells", "dcn",
                       "resume", "data_parallel")), flush=True)
    return report


# -- phase 9: the LM family -------------------------------------------------

#: bf16 tensor-core rate of one H100 SXM (dense, NVIDIA data sheet), FLOP/s
BF16_FLOPS_PER_S = 989e12
#: the LM archs, and the card-vs-CPU (9a) and decode-vs-forward (9b)
#: tolerances (rtol = atol): float32 sums on the card add in another
#: order; a forward and one-token decodes sum in other orders too
LM_ARCHS = ("qwen3-1.7b", "glm4-9b", "deepseek-v2-lite-16b", "granite-34b",
            "qwen3-moe-235b-a22b")
LM_CPU_TOL = 1e-4
LM_DECODE_TOL = {"dense": 2e-4, "mla": 5e-4}
#: tokens a row of 9a's and 9b's decodes; 9b's rows
LM_DECODE_TOKENS, LM_FULL_ROWS = 12, 2
#: warm-up calls of each timed LM cell, its timed calls by kind (a
#: 32k-token prefill takes seconds: it warms up on its first
#: ``LM_WARMUP_SEQ`` tokens), and train_4k's steps
LM_WARMUP, LM_WARMUP_SEQ, LM_TRAIN_STEPS = 1, 4096, 5
LM_REPS = {"prefill": 2, "decode": 3}
#: the registry cell each timed LM cell kind is
LM_KIND = {"prefill_32k": "prefill", "decode_32k": "decode",
           "long_500k": "decode", "train_4k": "train"}
#: the card, as phase 9 names it to the models' entry points
LM_DEVICE = "cuda"


def _no_drops(cfg):
    """``cfg`` with an MoE capacity every assignment fits (capacity factor
    max(8, E / k)), so a forward of S tokens and S one-token decodes
    route alike."""
    if cfg.moe is None:
        return cfg
    cf = max(8.0, cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _lm_pair(cfg):
    """(card model, CPU model) with one state dict, drawn on a CUDA
    generator."""
    from repro_torch.launch.serve import lm_model
    from repro_torch.models.transformer import init_params
    import torch
    card = lm_model(cfg)
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card, cpu


def _lm_outputs(model, cfg, batch, dev):
    """forward's hidden states, loss_fn and the last of ``LM_DECODE_TOKENS``
    decode steps' logits of ``batch`` on ``dev``."""
    import torch
    from repro_torch.models import transformer as tr
    b = {k: v.to(dev) for k, v in batch.items()}
    rows = b["tokens"].shape[0]
    with torch.no_grad():
        h = tr.forward(model, b["tokens"], cfg)
        loss = tr.loss_fn(model, b["tokens"], b["targets"], cfg)
    cache = tr.init_cache(cfg, rows, LM_DECODE_TOKENS, device=dev)
    for i in range(LM_DECODE_TOKENS):
        logits, cache = tr.decode_step(
            model, cache, b["tokens"][:, i],
            torch.full((rows,), i, dtype=torch.int32, device=dev), cfg)
    return {"forward": h, "loss": loss, "decode": logits}


def _lm_card_vs_cpu(tag: str) -> dict:
    """9a: each LM arch at SMOKE, one state dict on the card and on the
    CPU: in float32, forward, loss and a 12-token decode within
    ``LM_CPU_TOL``, and 3 train steps' losses and parameters too; then in
    the configs' bfloat16, the largest difference (printed, no gate: a
    bf16 router may pick another expert for a token on a near tie)."""
    import torch
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.cells import build_lm_train
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_leaves

    report = {}
    for arch in LM_ARCHS:
        spec = get_arch(arch)
        cfg = dataclasses.replace(spec.smoke, dtype=torch.float32)
        card, cpu = _lm_pair(cfg)
        batch = token_batch(0, 0, 3, 16, cfg.vocab, device="cpu")
        got = _lm_outputs(card, cfg, batch, LM_DEVICE)
        ref = _lm_outputs(cpu, cfg, batch, "cpu")
        errs = {k: _max_abs_err(ref[k], got[k].cpu()) for k in ref}
        for k in ref:
            if not torch.allclose(got[k].cpu(), ref[k], rtol=LM_CPU_TOL,
                                  atol=LM_CPU_TOL):
                raise AssertionError(f"phase 9a, {arch}: the card's {k} is "
                                     f"{errs[k]:.3g} off the CPU's")
        plan = build_lm_train(dataclasses.replace(spec, config=cfg),
                              ShapeCell("t", "train", {"seq": 16,
                                                       "batch": 2}))
        states = {"card": [card, adamw_init(card), LM_DEVICE],
                  "cpu": [cpu, adamw_init(cpu), "cpu"]}
        loss_err = 0.0
        for step in range(SMOKE_TRAIN_STEPS):
            losses = {}
            for name, st in states.items():
                b = token_batch(0, step, 2, 16, cfg.vocab, device=st[2])
                st[0], st[1], m = plan.fn(st[0], st[1], b)
                losses[name] = float(m["loss"])
            loss_err = max(loss_err, abs(losses["card"] - losses["cpu"]))
            if abs(losses["card"] - losses["cpu"]) > LM_CPU_TOL * (
                    1 + abs(losses["cpu"])):
                raise AssertionError(f"phase 9a, {arch}: step {step}'s loss "
                                     f"{losses['card']} on the card, "
                                     f"{losses['cpu']} on the CPU")
        param_err = 0.0
        for a, b in zip(tree_leaves(states["card"][0]),
                        tree_leaves(states["cpu"][0])):
            a = a.detach().cpu()
            param_err = max(param_err, _max_abs_err(a, b.detach()))
            if not torch.allclose(a, b.detach(), rtol=LM_CPU_TOL,
                                  atol=LM_CPU_TOL):
                raise AssertionError(f"phase 9a, {arch}: the parameters after"
                                     f" {SMOKE_TRAIN_STEPS} steps differ by "
                                     f"{param_err:.3g}")
        # the configs' own dtype, bfloat16, on both
        bcfg = spec.smoke
        with torch.no_grad():
            card.load_state_dict(cpu.state_dict())
        bf = {name: _lm_outputs(m, bcfg, batch, dev)
              for name, m, dev in (("card", card, LM_DEVICE),
                                   ("cpu", cpu, "cpu"))}
        bf_errs = {k: _max_abs_err(bf["cpu"][k].float(),
                                   bf["card"][k].float().cpu())
                   for k in bf["cpu"]}
        report[arch] = {"f32_max_abs_err": errs, "train_loss_err": loss_err,
                        "train_param_err": param_err,
                        "bf16_max_abs_err": bf_errs,
                        "bf16_loss": {d: float(bf[d]["loss"]) for d in bf}}
        print(f"{tag} phase 9a: {arch} SMOKE, card vs CPU, float32: forward "
              f"{errs['forward']:.3g}, loss {errs['loss']:.3g}, "
              f"{LM_DECODE_TOKENS}-token decode logits {errs['decode']:.3g}; "
              f"{SMOKE_TRAIN_STEPS} train steps: losses {loss_err:.3g}, "
              f"parameters {param_err:.3g} (tolerance {LM_CPU_TOL}); "
              f"bfloat16: forward {bf_errs['forward']:.3g}, loss "
              f"{bf_errs['loss']:.3g} ({report[arch]['bf16_loss']['card']:.6f}"
              f" vs {report[arch]['bf16_loss']['cpu']:.6f}), decode "
              f"{bf_errs['decode']:.3g}", flush=True)
        del card, cpu, states
    return report


def _lm_decode_vs_forward(tag: str) -> dict:
    """9b: each FULL config cut to 2 layers, float32, on the card: the
    logits of ``LM_DECODE_TOKENS`` one-token decode steps against the
    forward's next-token logits (MoE capacity raised so nothing drops)."""
    import torch
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.serve import lm_config, lm_model
    from repro_torch.models import transformer as tr

    report = {}
    for arch in LM_ARCHS:
        cfg = _no_drops(lm_config(arch, layers=2, dtype=torch.float32))
        model = lm_model(cfg)
        b = token_batch(0, 0, LM_FULL_ROWS, LM_DECODE_TOKENS, cfg.vocab)
        out = _lm_outputs(model, cfg, b, LM_DEVICE)
        with torch.no_grad():
            ref = out["forward"][:, -1] @ model.lm_head
        tol = LM_DECODE_TOL["mla" if cfg.mla is not None else "dense"]
        err = _max_abs_err(ref, out["decode"])
        if not torch.allclose(out["decode"], ref, rtol=tol, atol=tol):
            raise AssertionError(f"phase 9b, {arch}: decode is {err:.3g} off "
                                 f"the forward (tolerance {tol})")
        report[arch] = {"max_abs_err": err, "tol": tol,
                        "max_abs_logit": float(ref.abs().max())}
        print(f"{tag} phase 9b: {arch} FULL widths, 2 layers, float32: "
              f"{LM_DECODE_TOKENS} decode steps' logits within {err:.3g} of "
              f"the forward's (tolerance {tol}; largest |logit| "
              f"{report[arch]['max_abs_logit']:.3f})", flush=True)
        del model, out
        torch.cuda.empty_cache()
    return report


def _lm_cell(tag: str, phase: str, arch: str, cell: str, model, cfg
             ) -> dict:
    """One timed LM cell at ``LM_CELLS``' (batch, seq): prefill (the last
    position's logits), decode (one token a row at position seq - 1 of a
    zero cache of seq entries) or train (``LM_TRAIN_STEPS`` steps, the
    median after the first); ms, tokens/s, peak memory, the bound."""
    import math
    import torch
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.serve import LM_CELLS, lm_cost, lm_plan, time_calls
    from repro_torch.launch.train_cells import train_steps
    from repro_torch.models.transformer import init_cache
    from repro_torch.optim.adamw import adamw_init

    kind = LM_KIND[cell]
    b, s = LM_CELLS[arch]["cells"][cell]
    plan = lm_plan(arch, cell, cfg)
    t0 = time.perf_counter()
    if kind == "train":
        batches = [token_batch(0, i, b, s, cfg.vocab)
                   for i in range(LM_TRAIN_STEPS)]
        out = train_steps(plan.fn, model, adamw_init(model), batches)
        ms, out["out"] = out["median_ms"], torch.tensor(out["losses"])
        del out["model"], out["opt"]
        tokens = b * s
    elif kind == "prefill":
        tokens = token_batch(0, 0, b, s, cfg.vocab)["tokens"]
        out = time_calls(plan.fn, model, tokens, warmup=LM_WARMUP,
                         reps=LM_REPS[kind], warmup_args=(
                             model, tokens[:, :LM_WARMUP_SEQ]))
        ms, tokens = out["ms"], b * s
    else:
        cache = init_cache(cfg, b, s)
        tok = token_batch(0, 0, b, 1, cfg.vocab)["tokens"][:, 0]
        cur = torch.full((b,), s - 1, dtype=torch.int32, device=tok.device)
        out = time_calls(plan.fn, model, cache, tok, cur, warmup=LM_WARMUP,
                         reps=LM_REPS[kind])
        out["out"] = out["out"][0]
        del cache
        ms, tokens = out["ms"], b
    wall = time.perf_counter() - t0
    res = out.pop("out")
    if not bool(torch.isfinite(res.float()).all()):
        raise AssertionError(f"phase {phase}, {arch} {cell}: a non-finite "
                             f"output")
    want = {"train": (LM_TRAIN_STEPS,), "prefill": (b, cfg.vocab),
            "decode": (b, cfg.vocab)}[kind]
    if tuple(res.shape) != want:
        raise AssertionError(f"phase {phase}, {arch} {cell}: output "
                             f"{tuple(res.shape)}, expected {want}")
    cost = lm_cost(cfg, kind, b, s)
    t_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / BF16_FLOPS_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                              "operations")
    report = {"batch": b, "seq": s, "layers": cfg.n_layers, "ms": ms,
              "ms_all": out.get("ms_all", out["ms"]),
              "tokens_per_s": tokens / ms * 1e3, "bound_ms": bound,
              "bound_by": by, "bound_share": bound / ms, "wall_s": wall,
              "peak_bytes": out["peak_bytes"],
              "resident_bytes": out["resident_bytes"],
              "working_bytes": out["working_bytes"], **cost}
    if kind == "train":
        report["losses"] = res.tolist()
        if not math.isfinite(report["losses"][-1]):
            raise AssertionError(f"phase {phase}: non-finite loss")
    print(f"{tag} phase {phase}: {arch} {cell} ({cfg.n_layers} layers, "
          f"batch {b} x seq {s}, {cfg.dtype}): {ms:.3f} ms a "
          f"{'step' if kind == 'train' else 'call'} (median of "
          f"{LM_TRAIN_STEPS - 1 if kind == 'train' else LM_REPS[kind]} after "
          f"warm-up), {report['tokens_per_s']:.1f} tokens/s; peak device "
          f"memory {report['peak_bytes']} B ({report['peak_bytes'] / 2**30:.3f}"
          f" GiB; {report['working_bytes']} B above resident); bound "
          f"{bound:.3f} ms by {by} ({cost['flops']:.4g} FLOP, "
          f"{cost['bytes']:.4g} B): {report['bound_share']:.1%} of it"
          + (f"; losses {[round(x, 4) for x in report['losses']]}"
             if kind == "train" else ""), flush=True)
    del res, out
    torch.cuda.empty_cache()
    return report


def _lm_full(tag: str, phase: str, arch: str) -> dict:
    """The arch at FULL widths and ``LM_CELLS``' depth, drawn on a CUDA
    generator (bf16 compute): each of its cells, train last (it updates
    the parameters)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import LM_CELLS, lm_config, lm_model
    cfg = lm_config(arch)
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = lm_model(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    print(f"{tag} phase {phase}: {arch} FULL widths at {cfg.n_layers} of "
          f"{get_arch(arch).config.n_layers} layers: {n} parameters "
          f"({4 * n / 1e9:.2f} GB float32) drawn on the card in "
          f"{init_s:.2f} s", flush=True)
    # what was allocated before the model: phase 11c holds the dry run's
    # argument bytes to a cell's resident bytes less this
    report = {"n_params": n, "init_s": init_s, "layers": cfg.n_layers,
              "baseline_bytes": baseline}
    cells = sorted(LM_CELLS[arch]["cells"], key=lambda c: c == "train_4k")
    for cell in cells:
        report[cell] = _lm_cell(tag, phase, arch, cell, model, cfg)
    del model
    torch.cuda.empty_cache()
    return report


def _lm_path(root: Path, tag: str) -> dict:
    """Phase 9: the LM family (9a-9f), TF32 off in the float32 parts."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("phase 9: TF32 is on")
    report = {}
    parts = (("card_vs_cpu", "a", lambda: _lm_card_vs_cpu(tag)),
             ("decode_vs_forward", "b", lambda: _lm_decode_vs_forward(tag)),
             ("qwen3-1.7b", "c", lambda: _lm_full(tag, "9c", "qwen3-1.7b")),
             ("glm4-9b", "d", lambda: _lm_full(tag, "9d", "glm4-9b")),
             ("deepseek-v2-lite-16b", "e",
              lambda: _lm_full(tag, "9e", "deepseek-v2-lite-16b")),
             ("granite-34b", "e", lambda: _lm_full(tag, "9e", "granite-34b")),
             ("qwen3-moe-235b-a22b", "e",
              lambda: _lm_full(tag, "9e", "qwen3-moe-235b-a22b")),
             ("resume", "f", lambda: _train_resume(root, tag, "qwen3-1.7b",
                                                   "9f")))
    for key, _, fn in parts:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report[key] = fn()
        report[key + "_s"] = time.perf_counter() - t0
    print(f"{tag} phase 9: seconds by part: "
          + ", ".join(f"9{part} {key} {report[key + '_s']:.1f}"
                      for key, part, _ in parts), flush=True)
    return report


# -- phase 10: the paper's own LPA cells ------------------------------------

#: the web_560m cell at its size: the generator's arguments. The vertex
#: count is the cell's, the seed and mix those of every graph here; p_in
#: sets the directed slot count, which must come within WEB_SLOT_TOL of
#: the cell's (the hub overlay's heavy-tailed draws make the count move
#: by a few percent, not monotonically, with p_in)
WEB_560M = {"n": 18_500_000, "p_in": 0.79, "mix": 0.02, "seed": 1}
WEB_SLOT_TOL = 0.01
#: rows of a K1 launch held to its plain version at a time
PLAIN_ROWS = 1 << 22
#: 10c: log2 vertices of the bucketed step's graph; its measured
#: temporaries must come within CELL_TEMP_TOL of the byte model's
CELL_SCALE = 20
CELL_TEMP_TOL = 0.05
#: 10a: the dry run's rank counts (one card, the reference's two meshes)
DRYRUN_RANKS = (1, 256, 512)
#: 10b: steps under torch.profiler
PROFILE_STEPS = 3


#: the longest phase 10 waits for the web_560m writer (it starts at
#: phase 7 and takes ~2 min of host numpy)
WEB_CELL_WAIT_S = 900


def _write_web_cell(out: Path) -> int:
    """``--write-web-cell``: build ``web_560m``'s graph and fused workspace
    on the host (``cfg`` of ``lpa-mg8``) and save them to ``out`` for
    phase 10b. It runs as a process of its own, started at phase 7, so
    its minutes of host numpy overlap phases 7-9 instead of adding to the
    run; it touches no device."""
    os.nice(10)
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.distributed import build_dist_workspace
    from repro_torch.graphs.generators import powerlaw_communities
    cfg = get_arch("lpa-mg8").config.lpa
    t0 = time.perf_counter()
    graph, _ = powerlaw_communities(WEB_560M["n"], p_in=WEB_560M["p_in"],
                                    mix=WEB_560M["mix"],
                                    seed=WEB_560M["seed"], device="cpu")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws = build_dist_workspace(graph, 1, k=cfg.k, chunk=cfg.chunk, fused=True)
    build_s = time.perf_counter() - t0
    part = out / "web_560m.part"
    torch.save({"graph": graph, "ws": ws, "generate_s": gen_s,
                "workspace_s": build_s}, part)
    os.replace(part, out / "web_560m.pt")
    return 0


def _stop_web_cell(proc, out: Path) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(out, ignore_errors=True)


def _start_web_cell() -> tuple:
    """Start the ``web_560m`` writer (``_write_web_cell``) in a temporary
    directory; at exit it is stopped and the directory removed."""
    out = Path(tempfile.mkdtemp(prefix="web_560m_"))
    with open(out / "writer.log", "w") as log:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 "--write-web-cell", str(out)],
                                stdout=log, stderr=subprocess.STDOUT)
    atexit.register(_stop_web_cell, proc, out)
    return proc, out


def _load_web_cell(web: tuple) -> dict:
    """Wait for the writer and load what it saved (then drop the file)."""
    import torch
    proc, out = web
    rc = proc.wait(timeout=WEB_CELL_WAIT_S)
    if rc != 0:
        raise AssertionError(f"phase 10b: the web_560m writer exited {rc}: "
                             f"{(out / 'writer.log').read_text()[-3000:]}")
    t0 = time.perf_counter()
    data = torch.load(out / "web_560m.pt", weights_only=False)
    data["load_s"] = time.perf_counter() - t0
    (out / "web_560m.pt").unlink()
    return data


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cells_dryrun(tag: str) -> dict:
    """10a: ``launch.dryrun`` of the three ``lpa-mg8`` cells at 1, 256
    and 512 ranks (a host computation on meta workspaces), with the
    report's summary and table per rank count. Only the 3.4-billion-slot
    cells on one rank may be not ok, for int32 positions."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun, report
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    spec = get_arch("lpa-mg8")
    meshes = {1: ("ranks_1", make_mesh((1,), ("shard",))),
              256: ("single_pod_16x16", make_production_mesh()),
              512: ("multi_pod_2x16x16",
                    make_production_mesh(multi_pod=True))}
    out: dict = {}
    for p in DRYRUN_RANKS:
        name, mesh = meshes[p]
        recs = {}
        for cell in spec.cells:
            rec = dryrun.run_cell(spec, cell, mesh, name)
            want_ok = p > 1 or cell.name == "web_560m"
            if rec["ok"] != want_ok or (
                    not rec["ok"] and "int32" not in rec.get("error", "")):
                raise AssertionError(f"phase 10a: {cell.name} on {p} "
                                     f"rank(s): {rec}")
            recs[(spec.arch_id, cell.name)] = rec
            mem, r = rec["memory"], rec["roofline"]
            print(f"{tag} phase 10a: {cell.name} on {p} rank(s) "
                  f"({rec['engine']}, {rec['n_rounds']} spec rounds): "
                  f"workspace {mem['argument_bytes']} B a rank, step "
                  f"temporaries {mem['temp_bytes']} B "
                  f"(lpa_step_temp_bytes), peak "
                  f"{mem['peak_bytes_per_device']} B "
                  f"({mem['peak_bytes_per_device'] / 1e9:.2f} GB): fits 80 "
                  f"GB {mem['fits_80g_hbm']}; {rec['bytes_per_chip']:.6g} "
                  f"B moved (lpa_step_bytes), {rec['flops_per_chip']:.6g} "
                  f"FLOP, collectives {rec['collectives']}; roofline "
                  f"compute {r['compute_s'] * 1e3:.4f} ms, memory "
                  f"{r['memory_s'] * 1e3:.4f} ms, collective "
                  f"{r['collective_s'] * 1e3:.4f} ms: bottleneck "
                  f"{r['bottleneck']}, t_lb {r['step_time_lb_s'] * 1e3:.4f} "
                  f"ms" + ("" if rec["ok"] else f"; not ok: {rec['error']}"),
                  flush=True)
        print(f"{tag} phase 10a: {p} rank(s) ({name}): "
              f"{report.summary(recs)}\n{report.roofline_table(recs)}",
              flush=True)
        out[p] = {cell: rec for (_, cell), rec in recs.items()}
    return out


def _k1_vs_plain_blocks(rnd, el, ew, out_k, out_v, k: int, chunk: int,
                        where: str) -> float:
    """One K1 launch's outputs against its plain version, PLAIN_ROWS
    rows at a time (float32 as int32 bits); the largest difference."""
    from repro_torch.graphs.csr import FusedRound
    from repro_torch.kernels.mg_sketch import fused
    per_block = max(PLAIN_ROWS // rnd.tile_r, 1)
    err = 0.0
    for s0 in range(0, rnd.n_steps, per_block):
        s1 = min(s0 + per_block, rnd.n_steps)
        sub = FusedRound(row_start=rnd.row_start[s0:s1],
                         row_count=rnd.row_count[s0:s1],
                         step_dmax=rnd.step_dmax[s0:s1],
                         n_entries_in=rnd.n_entries_in)
        pk, pv = fused.fused_fold_round_plain(sub, el, ew, k=k, chunk=chunk)
        r0, r1 = s0 * rnd.tile_r, s1 * rnd.tile_r
        if not (_same_bits(out_k[r0:r1], pk) and _same_bits(out_v[r0:r1],
                                                             pv)):
            raise AssertionError(f"{where}: K1 rows [{r0}, {r1}) differ "
                                 f"from the plain version")
        err = max(err, _max_abs_err(out_k[r0:r1], pk),
                  _max_abs_err(out_v[r0:r1], pv))
    return err


def _profile_steps(step, labels, n_steps: int, rho: int) -> dict:
    """``torch.profiler`` over the first ``n_steps`` steps of a run from
    ``labels`` (Pick-Less every ``rho``-th): device time a step, wall a
    step, busy share and the top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(n_steps):
            labels, delta = step(labels, it % rho == 0, it + 1)
            int(delta)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.key, e.self_device_time_total / 1e3 / n_steps, e.count)
               for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in kernels)
    if device_ms <= 0:
        raise AssertionError("phase 10b: the profiler saw no device time")
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms,
            "top": [(name[:80], ms, n) for name, ms, n in
                    sorted(kernels, key=lambda k: -k[1])[:10]]}


def _web_560m(comm, dry: dict, web: tuple, tag: str) -> dict:
    """10b: ``web_560m`` at its size on one NCCL rank, through
    ``build_lpa_cell``'s step on the fused workspace (K1 every round),
    graph and workspace from the writer process ``web``."""
    import torch
    from unittest import mock
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import distributed
    from repro_torch.core.distributed import dist_lpa, lpa_collective_bytes
    from repro_torch.core.modularity import modularity
    from repro_torch.kernels.launches import (LAUNCH_COUNTS,
                                              reset_launch_counts)
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_lpa_cell, lpa_cell_engine
    from repro_torch.launch.roofline import roofline
    spec = get_arch("lpa-mg8")
    cell = next(c for c in spec.cells if c.name == "web_560m")
    cfg = spec.config.lpa
    run = {"rho": cfg.rho, "tau": cfg.tau, "max_iters": cfg.max_iters}
    t0 = time.perf_counter()
    saved = _load_web_cell(web)
    wait_s = time.perf_counter() - t0 - saved["load_s"]
    graph, ws = saved["graph"], saved["ws"]
    gen_s, build_s = saved["generate_s"], saved["workspace_s"]
    want = cell.params["n_edges"]
    off = graph.n_edges / want - 1
    if graph.n_nodes != cell.params["n_nodes"] or abs(off) > WEB_SLOT_TOL:
        raise AssertionError(f"phase 10b: {graph.n_nodes} vertices, "
                             f"{graph.n_edges} slots; the cell "
                             f"{cell.params}")
    plan = build_lpa_cell(spec, cell, 1)
    engine = lpa_cell_engine(ws)
    spec_mem = dry[1]["web_560m"]["memory"]
    if engine != "pallas_fused" or spec_mem["fits_80g_hbm"]:
        raise AssertionError(f"phase 10b: engine {engine}, the spec's "
                             f"memory {spec_mem}")
    print(f"{tag} phase 10b: web_560m: powerlaw_communities("
          f"{WEB_560M['n']}, p_in={WEB_560M['p_in']}, mix={WEB_560M['mix']}"
          f", seed={WEB_560M['seed']}): {graph.n_edges} directed slots "
          f"({graph.n_edges / graph.n_nodes:.2f} a vertex; the cell "
          f"{want}, {off:+.2%}), generated on the host in {gen_s:.1f} s; "
          f"build_dist_workspace(graph, 1, k={cfg.k}, chunk={cfg.chunk}, "
          f"fused=True) in {build_s:.1f} s (both in the writer process, "
          f"beside phases 7-9; waited {wait_s:.1f} s, loaded in "
          f"{saved['load_s']:.1f} s): {ws.n_rounds} rounds (the "
          f"spec's estimate {plan.meta['n_rounds']}), "
          f"{dryrun.workspace_bytes(ws)} B; the cell's bucketed layout "
          f"(lpa_dist_spec, engine pallas) needs "
          f"{spec_mem['peak_bytes_per_device']} B with its step's "
          f"temporaries on one rank, more than the card's 80 GB, so the "
          f"cell runs on the fused layout ({engine}, K1)", flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    step = plan.fn(comm, ws)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    # (1) the run to convergence, every K1 launch held to its plain version
    real_k1 = distributed.fused_fold_round
    checks = []

    def checked_k1(rnd, el, ew, *, k, chunk):
        out_k, out_v = real_k1(rnd, el, ew, k=k, chunk=chunk)
        err = _k1_vs_plain_blocks(rnd, el, ew, out_k, out_v, k, chunk,
                                  f"phase 10b, K1 launch {len(checks)}")
        checks.append((rnd.row_start.numel(), int(rnd.row_count.sum()),
                       err))
        return out_k, out_v

    t0 = time.perf_counter()
    reset_launch_counts()
    with mock.patch.object(distributed, "fused_fold_round", checked_k1):
        labels, iters = dist_lpa(comm, ws, step=step, **run)
    launches = {key: n for key, n in LAUNCH_COUNTS.items() if n}
    checked_s = time.perf_counter() - t0
    if launches != {"fused_fold": iters * ws.n_rounds} or \
            len(checks) != launches["fused_fold"]:
        raise AssertionError(f"phase 10b: launches {launches}, {len(checks)} "
                             f"checked, {iters} iterations x {ws.n_rounds} "
                             f"rounds")
    # (2) the same run, each step between CUDA events
    events = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    labels2, iters2 = dist_lpa(comm, ws, step=timed, **run)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events]
    if iters2 != iters or not torch.equal(labels2, labels):
        raise AssertionError("phase 10b: the timed run differs from the "
                             "checked run")
    median_ms = statistics.median(step_ms)
    # (3) one step: its collectives, its temporaries, its roofline
    first = ws.init_labels[0].to(comm.device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_counts()
    step(first, True, 1)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - before
    model_temp = dryrun.lpa_step_temp_bytes(ws, engine)
    coll = lpa_collective_bytes(ws)
    step_bytes, step_calls = dict(comm.bytes_by_op), dict(comm.calls_by_op)
    if step_bytes != {op: b for op, b in coll.items() if op != "total"}:
        raise AssertionError(f"phase 10b: one step's collectives "
                             f"{step_bytes}, lpa_collective_bytes {coll}")
    if abs(temp / model_temp - 1) > CELL_TEMP_TOL:
        raise AssertionError(f"phase 10b: one step held {temp} B, the "
                             f"model {model_temp} B")
    moved = dryrun.lpa_step_bytes(ws, engine)
    terms = roofline(graph.n_edges * 6 * cfg.k, moved, coll["total"])
    t_lb_ms = terms.step_time_s * 1e3
    if t_lb_ms > median_ms:
        raise AssertionError(f"phase 10b: t_lb {t_lb_ms} ms above the "
                             f"measured step {median_ms} ms")
    # (4) where a step's time goes
    prof = _profile_steps(step, first, PROFILE_STEPS, cfg.rho)
    del step, first
    torch.cuda.empty_cache()
    # (5) quality, on the card
    t0 = time.perf_counter()
    g_card = dataclasses.replace(graph, offsets=graph.offsets.cuda(),
                                 indices=graph.indices.cuda(),
                                 weights=graph.weights.cuda())
    q = float(modularity(g_card, labels))
    torch.cuda.synchronize()
    mod_s = time.perf_counter() - t0
    communities = int(torch.unique(labels).numel())
    del g_card
    torch.cuda.empty_cache()
    print(f"{tag} phase 10b: web_560m on one NCCL rank (P = 1) through "
          f"build_lpa_cell's step: {iters} iterations, {communities} "
          f"communities, modularity {q:.6f}; launches {launches}, every K1 "
          f"launch equal to its plain version (int32 bits, {PLAIN_ROWS} "
          f"rows at a time; max abs err "
          f"{max(e for _, _, e in checks)}; rounds (rows, entries): "
          + "; ".join(f"{r}, {e}" for r, e, _ in checks[:ws.n_rounds])
          + f"); step median {median_ms:.3f} ms (CUDA events; all "
          f"{[round(t, 3) for t in step_ms]}); resident {resident} B, peak "
          f"{peak} B over the run; one step held {temp} B above its "
          f"inputs, lpa_step_temp_bytes {model_temp} B (measured / model "
          f"{temp / model_temp:.4f}); one step's collectives "
          f"{step_bytes} (calls {step_calls}) == "
          f"lpa_collective_bytes; roofline {terms.to_dict()} "
          f"({moved} B moved by lpa_step_bytes): t_lb {t_lb_ms:.3f} ms = "
          f"{t_lb_ms / median_ms:.1%} of the step; host seconds: generate "
          f"{gen_s:.1f}, workspace {build_s:.1f}, checked run "
          f"{checked_s:.1f}, timed run {run_s:.2f}, modularity "
          f"{mod_s:.2f}", flush=True)
    print(f"{tag} phase 10b: torch.profiler over {PROFILE_STEPS} steps: "
          f"device {prof['device_ms']:.3f} ms a step of {prof['wall_ms']:.3f}"
          f" ms wall (busy {prof['busy_share']:.1%}); top kernels (ms a "
          f"step, calls over the {PROFILE_STEPS} steps): "
          + "; ".join(f"{name} {ms:.3f} ({n})"
                      for name, ms, n in prof["top"]), flush=True)
    return {"n_nodes": graph.n_nodes, "n_edges": graph.n_edges,
            "slots_off": off, "generator": WEB_560M, "generate_s": gen_s,
            "workspace_build_s": build_s, "writer_wait_s": wait_s,
            "load_s": saved["load_s"], "n_rounds": ws.n_rounds,
            "spec_rounds": plan.meta["n_rounds"],
            "workspace_bytes": dryrun.workspace_bytes(ws),
            "iterations": iters, "communities": communities,
            "modularity": q, "launches": launches,
            "k1_vs_plain": checks,
            "max_abs_err": max(e for _, _, e in checks),
            "step_ms": step_ms, "step_median_ms": median_ms,
            "resident_bytes": resident, "peak_bytes": peak,
            "step_temp_bytes": temp, "model_temp_bytes": model_temp,
            "collectives": step_bytes, "calls": step_calls,
            "step_bytes_model": moved,
            "roofline": terms.to_dict(), "profile": prof,
            "checked_run_s": checked_s, "modularity_s": mod_s}


def _cell_layout(comm, tag: str) -> dict:
    """10c: the cell's own (bucketed) step, K9 every round: one step at
    2^CELL_SCALE vertices, its temporaries against the byte model and
    each K9 launch against its plain version; at 2^PARITY_SCALE the
    cell's step run to convergence on both layouts against single-host
    ``lpa()`` on the same engine."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.distributed import build_dist_workspace, dist_lpa
    from repro_torch.core.lpa import lpa
    from repro_torch.graphs.generators import powerlaw_communities
    from repro_torch.kernels.launches import (LAUNCH_COUNTS,
                                              reset_launch_counts)
    from repro_torch.kernels.mg_sketch import ops, ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_lpa_cell, lpa_cell_engine
    spec = get_arch("lpa-mg8")
    cell = next(c for c in spec.cells if c.name == "web_560m")
    cfg = spec.config.lpa
    plan = build_lpa_cell(spec, cell, 1)
    graph, _ = powerlaw_communities(1 << CELL_SCALE, p_in=0.5, mix=0.02,
                                    seed=1, device="cpu")
    ws = build_dist_workspace(graph, 1, k=cfg.k, chunk=cfg.chunk)
    if lpa_cell_engine(ws) != "pallas":
        raise AssertionError(f"phase 10c: engine {lpa_cell_engine(ws)}")
    step = plan.fn(comm, ws)
    labels = ws.init_labels[0].to(comm.device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    new, delta = step(labels, True, 1)
    torch.cuda.synchronize()
    launches = {key: n for key, n in LAUNCH_COUNTS.items() if n}
    temp = torch.cuda.max_memory_allocated() - before
    model = dryrun.lpa_step_temp_bytes(ws, "pallas")
    if launches != {"tile_mg_fold": ws.n_rounds}:
        raise AssertionError(f"phase 10c: launches {launches}")
    if abs(temp / model - 1) > CELL_TEMP_TOL:
        raise AssertionError(f"phase 10c: the bucketed step held {temp} B, "
                             f"lpa_step_temp_bytes {model} B")
    # each K9 launch of the same step against its plain version
    errs = []

    def checked_k9(gl, gw, k):
        got = ops.mg_fold_tile_pallas(gl, gw, k)
        want = ref.mg_fold_ref(gl, gw, k)
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"phase 10c: K9 on round {len(errs)}'s "
                                 f"{tuple(gl.shape)} tile differs from "
                                 f"its plain version")
        errs.append((tuple(gl.shape), max(_max_abs_err(a, b)
                                          for a, b in zip(got, want))))
        return got

    new2, delta2 = plan.fn(comm, ws, fold_tile=checked_k9)(labels, True, 1)
    if not (torch.equal(new, new2) and int(delta) == int(delta2)):
        raise AssertionError("phase 10c: the checked step differs")
    tiles = [g.shape[1] * g.shape[2] for g in ws.round_gathers]
    print(f"{tag} phase 10c: the cell's bucketed step (engine pallas) at "
          f"2^{CELL_SCALE} vertices ({graph.n_edges} slots, round tiles "
          f"{tiles} entries): launches {launches}, each K9 launch equal to "
          f"its plain version (int32 bits; tiles and max abs err "
          f"{errs}); {temp} B held above its inputs, lpa_step_temp_bytes "
          f"{model} B (measured / model {temp / model:.4f})", flush=True)
    del step, ws, new, new2, labels
    torch.cuda.empty_cache()
    # the cell's step to convergence == single-host lpa() on its engine
    g16, _ = powerlaw_communities(1 << PARITY_SCALE, p_in=0.5, mix=0.02,
                                  seed=1, device="cpu")
    g16_card = dataclasses.replace(g16, offsets=g16.offsets.cuda(),
                                   indices=g16.indices.cuda(),
                                   weights=g16.weights.cuda())
    parity = {}
    for fused in (False, True):
        ws16 = build_dist_workspace(g16, 1, k=cfg.k, chunk=cfg.chunk,
                                    fused=fused)
        engine = lpa_cell_engine(ws16)
        reset_launch_counts()
        got, iters = dist_lpa(comm, ws16, rho=cfg.rho, tau=cfg.tau,
                              max_iters=cfg.max_iters,
                              step=plan.fn(comm, ws16))
        runs = {key: n for key, n in LAUNCH_COUNTS.items() if n}
        key = "fused_fold" if fused else "tile_mg_fold"
        if runs != {key: iters * ws16.n_rounds}:
            raise AssertionError(f"phase 10c: 2^{PARITY_SCALE} {engine}: "
                                 f"launches {runs}")
        want = lpa(g16_card, dataclasses.replace(cfg, fold_backend=engine))
        if iters != want.iterations or not torch.equal(got, want.labels):
            raise AssertionError(f"phase 10c: 2^{PARITY_SCALE} {engine}: "
                                 f"the cell's step differs from lpa()")
        parity[engine] = {"iterations": iters, "launches": runs}
    print(f"{tag} phase 10c: 2^{PARITY_SCALE} vertices, one NCCL rank: "
          f"dist_lpa through the cell's step == single-host lpa() on the "
          f"same engine, label for label: "
          + "; ".join(f"{e} {r['iterations']} iterations, launches "
                      f"{r['launches']}" for e, r in parity.items()),
          flush=True)
    return {"scale": CELL_SCALE, "n_edges": graph.n_edges,
            "round_tiles": tiles, "launches": launches,
            "step_temp_bytes": temp, "model_temp_bytes": model,
            "k9_vs_plain": errs, "max_abs_err": max(e for _, e in errs),
            "parity": parity}


def _lpa_cells(web: tuple, tag: str) -> dict:
    """Phase 10: the dry run of the paper's cells (10a), then on a
    one-rank NCCL group web_560m at its size (10b; its graph and
    workspace from the writer ``web``) and the cell's own layout
    (10c)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import ShardComm
    report: dict = {}
    t0 = time.perf_counter()
    report["dryrun"] = _cells_dryrun(tag)
    report["10a_s"] = time.perf_counter() - t0
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        comm = ShardComm("cuda:0")
        t0 = time.perf_counter()
        report["web_560m"] = _web_560m(comm, report["dryrun"], web, tag)
        report["10b_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["cell_layout"] = _cell_layout(comm, tag)
        report["10c_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    print(f"{tag} phase 10: seconds by part: "
          + ", ".join(f"{part} {report[part + '_s']:.1f}"
                      for part in ("10a", "10b", "10c")), flush=True)
    return report


# -- phase 11: the LM half of the dry run -------------------------------------

#: 11a: the dry run's meshes, as the dry run names them
LM_DRYRUN_MESHES = ("single_pod_16x16", "multi_pod_2x16x16", "ranks_1")
#: the longest phase 11 waits for the dry-run processes (started at
#: phase 7; about a minute of host work each)
LM_DRYRUN_WAIT_S = 900
#: 11b: the probe layers run on the card: (arch, cell, model extent,
#: data extent) of the cell's probe on the 16 x 16 mesh (train_4k runs
#: context parallel: a probe at model 1, data 256)
PROBE_LAYERS = tuple((arch, "train_4k", 1, 256) for arch in LM_ARCHS) + (
    ("qwen3-1.7b", "prefill_32k", 16, 16),)
PROBE_REPS = 5
#: 11b, 11c: LiveBytes on meta and the dry run's bytes against the card's
#: allocator
LM_MEM_TOL = 0.05
#: 11c: the phase-9 cells of qwen3-1.7b the dry run is held to
C11_CELLS = ("prefill_32k", "decode_32k", "long_500k", "train_4k")
#: 11d: gloo ranks sharing the card, their mesh, and a mesh that does not
#: divide qwen3-1.7b's TP layout
REMESH_RANKS, REMESH_MESH, REMESH_BAD = 4, (2, 2), (1, 3)
#: 11e: the rank-local train steps run on the card, (arch, layout) of
#: ``train_4k`` on the 16 x 16 mesh: deepseek's context-parallel one and
#: the tensor-parallel one (``sp_mode="none"``) of deepseek, granite-34b
#: and qwen3-moe, each at the depths the dry run measures
LOCAL_TRAINS = (("deepseek-v2-lite-16b", "cp"), ("deepseek-v2-lite-16b", "tp"),
                ("granite-34b", "tp"), ("qwen3-moe-235b-a22b", "tp"))
LOCAL_TRAIN_LAYERS = (2, 3)
#: 11e: the most a step may hold, its inputs included (the card's 80 GB
#: less the allocator's and CUDA's own); a larger step halves its batch
LOCAL_TRAIN_FIT = 72e9


def _c11_cells() -> dict:
    """11c's dry runs: qwen3-1.7b at 28 layers on one rank at phase 9's
    cut shapes (``launch.serve.LM_CELLS``). Train runs with ``sp_mode =
    "none"``: on a mesh of one rank that is phase 9's step itself (its
    ``tp`` layout on one rank rewrites nothing), where the default ``cp``
    plan would switch the attention to its context-parallel form."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import LM_CELLS
    spec = get_arch("qwen3-1.7b")
    spec = dataclasses.replace(spec, config=dataclasses.replace(
        spec.config, sp_mode="none"))
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for name in C11_CELLS:
        b, s = LM_CELLS["qwen3-1.7b"]["cells"][name]
        cell = ShapeCell(name, LM_KIND[name], {"batch": b, "seq": s})
        out[name] = dryrun.run_cell(spec, cell, mesh, "ranks_1")
    return out


def _lm_dryrun(out: Path, arch: str) -> int:
    """``--lm-dryrun OUT ARCH``: ``launch.dryrun`` of one LM arch on the
    reference's two meshes and one rank (records under ``OUT``), for
    qwen3-1.7b 11c's cells (``OUT/c11.json``), and ``lm_local_run`` of
    the arch's layouts of ``LOCAL_TRAINS`` (``OUT/local_ARCH_MODE.json``,
    what 11e holds the card to). A host computation on meta
    tensors in a process of its own, started at phase 7 so that it
    overlaps phases 7-10; it touches no device."""
    os.nice(10)
    from repro_torch.launch import dryrun
    rc = dryrun.main(["--arch", arch, "--mesh", "both", "--ranks", "1",
                      "--out", str(out)])
    if arch == "qwen3-1.7b":
        part = out / "c11.part"
        part.write_text(json.dumps(_c11_cells()))
        os.replace(part, out / "c11.json")
    for a, mode in LOCAL_TRAINS:
        if a == arch:
            spec, cell, plan, mesh = _local_train_plan(arch, mode)
            local = dryrun.lm_local_run(spec, cell, plan, mesh)
            local["points"] = {n: [peak, cost] for n, (peak, cost)
                               in local["points"].items()}
            part = out / f"local_{arch}_{mode}.part"
            part.write_text(json.dumps(local))
            os.replace(part, out / f"local_{arch}_{mode}.json")
    return rc


def _start_lm_dryrun() -> tuple:
    """Start one ``--lm-dryrun`` process per LM arch, writing to one
    temporary directory; at exit they are stopped and it is removed."""
    out = Path(tempfile.mkdtemp(prefix="lm_dryrun_"))
    procs = {}
    for arch in LM_ARCHS:
        with open(out / f"{arch}.log", "w") as log:
            procs[arch] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--lm-dryrun", str(out), arch],
                stdout=log, stderr=subprocess.STDOUT)
    atexit.register(_stop_lm_dryrun, procs, out)
    return procs, out


def _stop_lm_dryrun(procs: dict, out: Path) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(out, ignore_errors=True)


def _lm_dryrun_records(dry: tuple, tag: str) -> dict:
    """11a: wait for the dry-run processes; print every LM record (per-rank
    peak and its fit in 80 GB, the roofline's three terms, bottleneck and
    t_lb) and each mesh's report; every record must be ok."""
    from repro_torch.launch import report
    procs, out = dry
    t0 = time.perf_counter()
    for arch, proc in procs.items():
        rc = proc.wait(timeout=LM_DRYRUN_WAIT_S)
        if rc != 0:
            raise AssertionError(
                f"phase 11a: the dry run of {arch} exited {rc}: "
                f"{(out / f'{arch}.log').read_text()[-3000:]}")
    waited = time.perf_counter() - t0
    recs_by_mesh = {}
    for mesh_name in LM_DRYRUN_MESHES:
        recs = report.load(str(out), mesh_name)
        want = {(a, c) for a in LM_ARCHS for c in LM_KIND}
        if set(recs) != want:
            raise AssertionError(f"phase 11a: {mesh_name}: records "
                                 f"{sorted(recs)}")
        for (arch, shape), rec in sorted(recs.items()):
            if not rec["ok"]:
                raise AssertionError(f"phase 11a: {mesh_name} {arch}/{shape}:"
                                     f" {rec.get('error')}")
            if rec.get("collectives_checked") is not True:
                raise AssertionError(f"phase 11a: {mesh_name} {arch}/{shape}:"
                                     " collective count not held to the "
                                     "reference's HLO")
            mem, r = rec["memory"], rec["roofline"]
            print(f"{tag} phase 11a: {arch}/{shape} on {mesh_name} "
                  f"({rec['n_devices']} ranks, {rec['mode']}): peak "
                  f"{mem['peak_bytes_per_device']} B "
                  f"({mem['peak_bytes_per_device'] / 1e9:.2f} GB; argument "
                  f"{mem['argument_bytes']}, temp {mem['temp_bytes']}): "
                  f"fits 80 GB {mem['fits_80g_hbm']}; compute "
                  f"{r['compute_s'] * 1e3:.4f} ms, memory "
                  f"{r['memory_s'] * 1e3:.4f} ms, collective "
                  f"{r['collective_s'] * 1e3:.4f} ms: bottleneck "
                  f"{r['bottleneck']}, t_lb {r['step_time_lb_s'] * 1e3:.4f} "
                  f"ms ({rec['flops_per_chip']:.6g} FLOP, "
                  f"{rec['bytes_per_chip']:.6g} B, "
                  f"{rec['collectives']['total']:.6g} collective B as the "
                  f"reference's parse counts them, "
                  f"{rec['collectives_moved']['total']:.6g} B moved)",
                  flush=True)
        print(f"{tag} phase 11a: {mesh_name}: {report.summary(recs)}\n"
              f"{report.roofline_table(recs)}", flush=True)
        recs_by_mesh[mesh_name] = {f"{a}/{c}": rec
                                   for (a, c), rec in recs.items()}
    c11 = json.loads((out / "c11.json").read_text())
    local = {f"{a}/{mode}": json.loads(
        (out / f"local_{a}_{mode}.json").read_text())
        for a, mode in LOCAL_TRAINS}
    return {"records": recs_by_mesh, "c11": c11, "local": local,
            "waited_s": waited}


def _probe_layer(arch: str, cell: str, mm: int, md: int, tag: str) -> dict:
    """11b: ``lm_fwd_probe``'s layer of ``arch`` at the cell's local shapes
    (published widths, attention unchunked) on the card, weights drawn on
    the card: its ``CostCounter`` totals on the card equal to those on
    meta; the median ms of ``PROBE_REPS`` calls (CUDA events, after a
    warm-up, outside the counter) against the roofline's t_lb of the
    counted FLOPs and bytes; LiveBytes' peak on meta against the
    allocator's peak above what was resident."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import probes
    from repro_torch.launch.cost import CostCounter
    from repro_torch.launch.live_bytes import LiveBytes
    from repro_torch.launch.roofline import roofline
    from repro_torch.models.transformer import (_layer, init_params,
                                                param_structs)
    from repro_torch.tree import param_tree

    spec = get_arch(arch)
    c = next(x for x in spec.cells if x.name == cell)
    cfg = spec.config
    lcfg = probes._local_cfg(cfg, mm, md)
    b, s = max(1, c.params["batch"] // md), c.params["seq"]
    single = dataclasses.replace(lcfg, n_layers=1)

    def layer(layers, x, pos):
        return _layer(probes._first_layer(layers), x, lcfg, pos)

    # on meta: the count and the bytes held
    meta_args = (param_structs(single)["layers"],
                 torch.empty((b, s, cfg.d_model), dtype=cfg.dtype,
                             device="meta"),
                 torch.empty((b, s), dtype=torch.int32, device="meta"))
    with torch.no_grad(), CostCounter() as cc_meta:
        layer(*meta_args)
    with torch.no_grad(), LiveBytes() as live:
        layer(*meta_args)
    # on the card
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(gen, single, device="cuda")
    layers = param_tree(model)["layers"]
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda"
                    ).to(cfg.dtype)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(
        b, s).contiguous()
    with torch.no_grad():
        out = layer(layers, x, pos)  # warm-up
        with CostCounter() as cc_card:
            layer(layers, x, pos)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        layer(layers, x, pos)
        torch.cuda.synchronize()
        held = torch.cuda.max_memory_allocated() - resident
        ms = _time_ms(lambda: layer(layers, x, pos), warmup=0,
                      reps=PROBE_REPS)
    finite = bool(torch.isfinite(out.float()).all())
    if not finite or tuple(out.shape) != (b, s, cfg.d_model):
        raise AssertionError(f"phase 11b, {arch} {cell}: output "
                             f"{tuple(out.shape)}, finite {finite}")
    meta_t, card_t = cc_meta.totals(), cc_card.totals()
    if meta_t != card_t:
        raise AssertionError(f"phase 11b, {arch} {cell}: the card's count "
                             f"{card_t} differs from meta's {meta_t}")
    t_lb = roofline(card_t["flops"], card_t["bytes"], 0.0)
    if t_lb.step_time_s * 1e3 > ms:
        raise AssertionError(f"phase 11b, {arch} {cell}: t_lb "
                             f"{t_lb.step_time_s * 1e3:.4f} ms above the "
                             f"measured {ms:.4f} ms")
    mem_err = held / live.peak - 1
    if abs(mem_err) > LM_MEM_TOL:
        raise AssertionError(f"phase 11b, {arch} {cell}: the card held "
                             f"{held} B above resident, LiveBytes on meta "
                             f"{live.peak} B ({mem_err:+.2%})")
    share = t_lb.step_time_s * 1e3 / ms
    rep = {"batch": b, "seq": s, "model_extent": mm, "data_extent": md,
           "ms": ms, "t_lb_ms": t_lb.step_time_s * 1e3,
           "bound_by": t_lb.bottleneck, "t_lb_share": share,
           "flops": card_t["flops"], "transcendentals":
           card_t["transcendentals"], "bytes": card_t["bytes"],
           "by_class": card_t["by_class"], "held_bytes": held,
           "live_bytes_meta": live.peak, "held_vs_meta": mem_err}
    print(f"{tag} phase 11b: {arch} {cell} probe layer (published widths, "
          f"local extents model {mm} data {md}: batch {b} x seq {s}, "
          f"{lcfg.n_heads} heads, attention unchunked) on the card: "
          f"CostCounter equal to meta's ({card_t['flops']:.6g} FLOP, "
          f"{card_t['transcendentals']:.6g} transcendentals, "
          f"{card_t['bytes']:.6g} B unfused eager traffic; products "
          f"{card_t['by_class']['product']['flops']:.6g}, the port's "
          f"converts {card_t['by_class']['convert']['flops']:.6g}; XLA's "
          f"CPU converts, not run, "
          f"{card_t['by_class']['xla_cpu_convert']['flops']:.6g}); "
          f"{ms:.4f} ms "
          f"(median of {PROBE_REPS}, CUDA events) against t_lb "
          f"{t_lb.step_time_s * 1e3:.4f} ms by {t_lb.bottleneck}: "
          f"{share:.1%} of it; held {held} B above resident against "
          f"LiveBytes {live.peak} B on meta ({mem_err:+.3%})", flush=True)
    del model, layers, x, pos, out
    torch.cuda.empty_cache()
    return rep


def _dryrun_vs_phase9(c11: dict, lm: dict, tag: str) -> dict:
    """11c: the dry run of qwen3-1.7b on one rank at phase 9's shapes
    against phase 9's own measurements of those cells (not run again):
    ``argument_bytes`` against the bytes resident for the cell (resident
    less what was allocated before the model was drawn), ``temp_bytes``
    against the working bytes (peak less resident), each within
    ``LM_MEM_TOL``."""
    measured = lm["qwen3-1.7b"]
    base = measured["baseline_bytes"]
    out = {}
    for name, rec in c11.items():
        if not rec["ok"]:
            raise AssertionError(f"phase 11c: {name}: {rec.get('error')}")
        m9 = measured[name]
        mem = rec["memory"]
        held = m9["resident_bytes"] - base
        arg_err = mem["argument_bytes"] / held - 1
        temp_err = mem["temp_bytes"] / m9["working_bytes"] - 1
        out[name] = {"argument_bytes": mem["argument_bytes"],
                     "resident_bytes": held, "argument_err": arg_err,
                     "temp_bytes": mem["temp_bytes"],
                     "working_bytes": m9["working_bytes"],
                     "temp_err": temp_err}
        print(f"{tag} phase 11c: qwen3-1.7b {name} (batch {m9['batch']} x "
              f"seq {m9['seq']}, 28 layers, one rank, {rec['mode']}): dry "
              f"run argument {mem['argument_bytes']} B against phase 9's "
              f"resident {held} B ({arg_err:+.3%}), temp "
              f"{mem['temp_bytes']} B against phase 9's working "
              f"{m9['working_bytes']} B ({temp_err:+.3%})", flush=True)
        if abs(arg_err) > LM_MEM_TOL or abs(temp_err) > LM_MEM_TOL:
            raise AssertionError(f"phase 11c, {name}: argument "
                                 f"{arg_err:+.2%}, temp {temp_err:+.2%}")
    return out


def _remesh_rank(comm, ckpt: str, out_dir: str) -> None:
    """Rank body of 11d: restore qwen3-1.7b FULL from the checkpoint with
    ``remesh`` under ``lm_param_specs`` "tp" and "fsdp" on a (2, 2) mesh,
    reading only this rank's slices (memory maps); each shard equal to
    the logical slice (``torch.equal``), the shards gathered on rank 0
    equal to the stored tree; a mesh that does not divide raises before
    anything moves. The report goes to ``out_dir/remesh{r}.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.cells import lm_param_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import param_structs
    from repro_torch.train.elastic import (leaves_with_specs, remesh,
                                           shard_slices)
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_arch("qwen3-1.7b").config
    structs = param_structs(cfg)
    leaves = CheckpointManager(ckpt).open_leaves()
    tree = tree_unflatten(structs, leaves)
    mesh = make_mesh(REMESH_MESH, ("data", "model"))
    rank, world = comm.rank, comm.world_size
    out = {"rank": rank}
    for mode in ("tp", "fsdp"):
        specs = lm_param_specs(cfg, structs, mesh, mode)
        torch.cuda.synchronize(comm.device)
        t0 = time.perf_counter()
        shards = tree_leaves(remesh(tree, specs, mesh, rank,
                                    device=comm.device))
        torch.cuda.synchronize(comm.device)
        seconds = time.perf_counter() - t0
        equal = gathered_equal = True
        # each leaf's gather runs while rank 0 checks the leaf before it
        pending = None
        for (_, leaf, spec), shard in zip(leaves_with_specs(tree, specs),
                                          shards):
            sl = shard_slices(leaf.shape, spec, mesh, rank)
            host = shard.cpu()
            equal &= torch.equal(host, torch.from_numpy(np.array(leaf[sl])))
            parts = ([torch.empty_like(host) for _ in range(world)]
                     if rank == 0 else None)
            work = dist.gather(host, parts, dst=0, async_op=True)
            if pending is not None:
                gathered_equal &= _remesh_gathered(pending, rank, mesh)
            pending = (work, host, parts, leaf, spec)
        gathered_equal &= _remesh_gathered(pending, rank, mesh)
        out[mode] = {"seconds": seconds, "equal": bool(equal),
                     "gathered_equal": bool(gathered_equal),
                     "bytes": sum(t.numel() * t.element_size()
                                  for t in shards)}
        del shards
        torch.cuda.empty_cache()
    bad = make_mesh(REMESH_BAD, ("data", "model"))
    before = torch.cuda.memory_allocated(comm.device)
    try:
        remesh(tree, lm_param_specs(cfg, structs, bad, "tp"), bad, rank,
               device=comm.device)
        out["bad_mesh"] = "did not raise"
    except ValueError as e:
        out["bad_mesh"] = str(e)
    out["bad_mesh_moved"] = torch.cuda.memory_allocated(comm.device) - before
    Path(out_dir, f"remesh{rank}.json").write_text(json.dumps(out))


def _remesh_gathered(pending: tuple, rank: int, mesh) -> bool:
    """Wait for one leaf's gather; on rank 0, whether the shards placed
    at their slices equal the stored leaf."""
    import numpy as np
    from repro_torch.train.elastic import shard_slices
    work, _, parts, leaf, spec = pending
    work.wait()
    if rank != 0:
        return True
    whole = np.empty(leaf.shape, dtype=leaf.dtype)
    for r, part in enumerate(parts):
        whole[shard_slices(leaf.shape, spec, mesh, r)] = part.numpy()
    return bool(np.array_equal(whole, leaf))


def _remesh(tag: str) -> dict:
    """11d: qwen3-1.7b FULL drawn on the card and saved once by the
    checkpoint manager in the reference's layout (in TMPDIR), then
    restored by ``REMESH_RANKS`` gloo ranks sharing the card
    (``_remesh_rank``)."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.distributed import spawn_ranks
    from repro_torch.launch.serve import lm_config, lm_model

    with tempfile.TemporaryDirectory(prefix="chip_smoke_remesh_") as tmp:
        cfg = lm_config("qwen3-1.7b")
        model = lm_model(cfg)
        t0 = time.perf_counter()
        CheckpointManager(tmp).save(0, model)
        save_s = time.perf_counter() - t0
        n_bytes = 4 * sum(p.numel() for p in model.parameters())
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_ranks(_remesh_rank, REMESH_RANKS, (tmp, tmp))
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"remesh{r}.json").read_text())
                 for r in range(REMESH_RANKS)]
    for rk in ranks:
        for mode in ("tp", "fsdp"):
            if not rk[mode]["equal"]:
                raise AssertionError(f"phase 11d, {mode}, rank {rk['rank']}:"
                                     f" a shard differs from its slice")
        if "not divisible" not in rk["bad_mesh"] or rk["bad_mesh_moved"]:
            raise AssertionError(f"phase 11d, rank {rk['rank']}: the mesh "
                                 f"{REMESH_BAD} gave {rk['bad_mesh']!r}, "
                                 f"{rk['bad_mesh_moved']} B moved")
    for mode in ("tp", "fsdp"):
        if not ranks[0][mode]["gathered_equal"]:
            raise AssertionError(f"phase 11d, {mode}: the gathered shards "
                                 f"differ from the tree")
        print(f"{tag} phase 11d: remesh of qwen3-1.7b FULL ({n_bytes} B "
              f"float32, saved in {save_s:.2f} s) under {mode} on a "
              f"{REMESH_MESH} mesh of {REMESH_RANKS} gloo ranks sharing the "
              f"card: every shard equal to its slice, the shards gathered on "
              f"rank 0 equal to the tree; per rank bytes / seconds: "
              + "; ".join(f"{rk[mode]['bytes']} / {rk[mode]['seconds']:.3f}"
                          for rk in ranks), flush=True)
    print(f"{tag} phase 11d: a {REMESH_BAD} mesh raised before anything "
          f"moved: {ranks[0]['bad_mesh']}; ranks ran in {spawn_s:.1f} s",
          flush=True)
    return {"ranks": ranks, "save_s": save_s, "spawn_s": spawn_s,
            "tree_bytes": n_bytes}


def _local_train_plan(arch: str, mode: str) -> tuple:
    """(spec, cell, plan, mesh) of ``arch``'s ``train_4k`` in the ``mode``
    layout (``tp``: ``sp_mode="none"``) on the 16 x 16 mesh."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    spec = get_arch(arch)
    if mode == "tp":
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, sp_mode="none"))
    cell = next(c for c in spec.cells if c.name == "train_4k")
    mesh = make_production_mesh()
    plan = build_cell(spec, cell, mesh)
    if plan.meta["mode"] != mode:
        raise AssertionError(f"phase 11e, {arch}: the plan's layout is "
                             f"{plan.meta['mode']}, not {mode}")
    return spec, cell, plan, mesh


def _local_train(arch: str, mode: str, local: dict, tag: str) -> dict:
    """11e: the rank's local train step of ``arch``'s ``train_4k`` in the
    ``mode`` layout on the 16 x 16 mesh, the parts ``dryrun.lm_local_run``
    measures on meta run on the card (``dryrun.lm_train_inputs`` on a
    CUDA generator, ``dryrun.lm_train_measure``) at the rank's config and
    shapes (``dryrun.lm_local_step``), published widths, at each depth of
    ``LOCAL_TRAIN_LAYERS``. ``local`` is ``lm_local_run``'s result for the
    layout (made on meta in the ``--lm-dryrun`` process). At each depth:
    ``CostCounter`` totals on the card equal to meta's; the allocator's
    ``P_act`` within ``LM_MEM_TOL`` of ``LiveBytes``' on meta; the median
    ms of ``PROBE_REPS`` steps (``value_and_grad`` of the loss, CUDA
    events, after the counted one) against the roofline's t_lb of the
    counted FLOPs and bytes. Then the card's points extrapolated to the
    cell's depth and completed by ``dryrun.lm_train_total`` give the
    record's ``raw_cost`` (equal) and ``temp_bytes`` (within
    ``LM_MEM_TOL``). A step whose parameters, gradients and ``P_act``
    would not fit in ``LOCAL_TRAIN_FIT`` runs at the largest batch that
    does (a cut, printed; its points are then held to meta's at that
    batch, and the record is not compared)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import roofline
    from repro_torch.train.steps import value_and_grad
    from repro_torch.tree import tree_leaves

    _, _, plan, mesh = _local_train_plan(arch, mode)
    lcfg, b0, s = dryrun.lm_local_step(plan, mesh)
    meta_points = {int(n): (peak, cost)
                   for n, (peak, cost) in local["points"].items()}
    out, card_points = {}, {}
    for n in LOCAL_TRAIN_LAYERS:
        ncfg = dataclasses.replace(lcfg, n_layers=n)
        # the largest batch (halving from the rank's) whose parameters,
        # their gradients and P_act fit
        b, (p_meta, c_meta) = b0, meta_points[n]
        while True:
            params, batch = dryrun.lm_train_inputs(ncfg, b, s)
            need = (2 * sum(t.numel() * 4 for t in tree_leaves(params))
                    + 2 * b * s * 4 + p_meta)
            if need <= LOCAL_TRAIN_FIT or b == 1:
                break
            b //= 2
            peak, cc = dryrun.lm_train_measure(ncfg, params, batch)
            p_meta, c_meta = peak, dryrun._cost_record(cc)
        # on the card: the counted step and P_act, then PROBE_REPS steps
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(n)
        params, batch = dryrun.lm_train_inputs(ncfg, b, s, "cuda", gen)
        p_card, cc = dryrun.lm_train_measure(ncfg, params, batch)
        c_card = dryrun._cost_record(cc)
        loss_of = dryrun.lm_train_loss(ncfg)
        loss, grads = value_and_grad(loss_of, params, batch)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        shapes = [tuple(g.shape) for g in tree_leaves(grads)] == [
            tuple(p.shape) for p in tree_leaves(params)]
        del loss, grads
        ms = _time_ms(functools.partial(value_and_grad, loss_of, params,
                                        batch), warmup=0, reps=PROBE_REPS)
        del params, batch
        torch.cuda.empty_cache()
        where = f"phase 11e, {arch} {mode} {n} layers"
        if not (finite and shapes):
            raise AssertionError(f"{where}: finite {finite}, gradient "
                                 f"shapes {shapes}")
        if c_card != c_meta:
            raise AssertionError(f"{where}: the card's count {c_card} "
                                 f"differs from meta's {c_meta}")
        mem_err = p_card / p_meta - 1
        if abs(mem_err) > LM_MEM_TOL:
            raise AssertionError(f"{where}: P_act {p_card} B on the card, "
                                 f"{p_meta} B by LiveBytes on meta "
                                 f"({mem_err:+.2%})")
        t_lb = roofline(c_card["flops"], c_card["bytes"], 0.0)
        if t_lb.step_time_s * 1e3 > ms:
            raise AssertionError(f"{where}: t_lb "
                                 f"{t_lb.step_time_s * 1e3:.4f} ms above "
                                 f"the measured {ms:.4f} ms")
        card_points[n] = (p_card, c_card)
        share = t_lb.step_time_s * 1e3 / ms
        cut = "none" if b == b0 else f"batch {b0} -> {b}"
        out[n] = {"batch": b, "seq": s, "cut": cut, "ms": ms,
                  "t_lb_ms": t_lb.step_time_s * 1e3,
                  "bound_by": t_lb.bottleneck, "t_lb_share": share,
                  "flops": c_card["flops"], "bytes": c_card["bytes"],
                  "p_act_card": p_card, "p_act_meta": p_meta,
                  "p_act_vs_meta": mem_err}
        print(f"{tag} phase 11e: {arch} train_4k {mode} rank-local train "
              f"step ({n} layers, published widths, batch {b} x seq {s}, "
              f"{ncfg.n_heads} heads, remat {ncfg.remat}; cut: {cut}) on "
              f"the card: CostCounter equal to meta's "
              f"({c_card['flops']:.6g} FLOP, {c_card['bytes']:.6g} B "
              f"unfused eager traffic); {ms:.4f} ms (median of "
              f"{PROBE_REPS}, CUDA events) against t_lb "
              f"{t_lb.step_time_s * 1e3:.4f} ms by {t_lb.bottleneck}: "
              f"{share:.1%} of it; P_act {p_card} B above resident against "
              f"LiveBytes {p_meta} B on meta ({mem_err:+.3%})", flush=True)
    if all(r["cut"] == "none" for r in out.values()):
        peak, cost = dryrun.lm_extrapolate(card_points, lcfg.n_layers)
        temp, cost = dryrun.lm_train_total(plan, mesh, peak, cost)
        want_t, want_c = local["temp_bytes"], local["raw_cost"]
        temp_err = temp / want_t - 1
        where = f"phase 11e, {arch} {mode} at {lcfg.n_layers} layers"
        if any(not math.isclose(cost[k], want_c[k], rel_tol=1e-9)
               for k in ("flops", "bytes", "transcendentals")):
            raise AssertionError(f"{where}: the card's points give "
                                 f"{cost}, the record {want_c}")
        if abs(temp_err) > LM_MEM_TOL:
            raise AssertionError(f"{where}: the card's points give temp "
                                 f"{temp} B, the record {want_t} B "
                                 f"({temp_err:+.2%})")
        out["record"] = {"layers": lcfg.n_layers, "temp_bytes": temp,
                         "record_temp_bytes": want_t,
                         "temp_vs_record": temp_err, "p_act": peak,
                         "flops": cost["flops"]}
        print(f"{tag} phase 11e: {arch} train_4k {mode}: the card's 2- and "
              f"3-layer points extrapolated to {lcfg.n_layers} layers give "
              f"the record's raw_cost ({cost['flops']:.6g} FLOP, "
              f"{cost['bytes']:.6g} B) and temp {temp} B against its "
              f"{want_t} B ({temp_err:+.3%}; P_act {peak} B)", flush=True)
    return out


def _lm_dryrun_path(dry: tuple, lm: dict, tag: str) -> dict:
    """Phase 11: the LM dry run (11a), the probe layers on the card (11b),
    the dry run against phase 9 (11c), remesh over gloo ranks (11d), the
    rank-local train steps of the dry run's layouts on the card (11e)."""
    import torch
    report: dict = {}
    t0 = time.perf_counter()
    dr = _lm_dryrun_records(dry, tag)
    report["dryrun"], report["11a_s"] = dr, time.perf_counter() - t0
    t0 = time.perf_counter()
    report["probes"] = {f"{a}/{c}": _probe_layer(a, c, mm, md, tag)
                        for a, c, mm, md in PROBE_LAYERS}
    report["11b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["vs_phase9"] = _dryrun_vs_phase9(dr["c11"], lm, tag)
    report["11c_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["remesh"] = _remesh(tag)
    report["11d_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["local_trains"] = {
        f"{a}/{mode}": _local_train(a, mode, dr["local"][f"{a}/{mode}"], tag)
        for a, mode in LOCAL_TRAINS}
    report["11e_s"] = time.perf_counter() - t0
    print(f"{tag} phase 11: seconds by part: "
          + ", ".join(f"{part} {report[part + '_s']:.1f}"
                      for part in ("11a", "11b", "11c", "11d", "11e"))
          + f" (11a waited {dr['waited_s']:.1f} s for the dry runs)",
          flush=True)
    return report


# -- phase 12: the GNN and recsys half of the dry run -------------------------

#: 12a: the archs of the dry run, its meshes as the dry run names them, and
#: the mesh of 8g's ranks, on which minibatch_lg's PNA record is also made
MODEL_ARCHS = GNN_ARCHS + ("dcn-v2",)
MODEL_DRYRUN_MESHES = ("single_pod_16x16", "multi_pod_2x16x16", "ranks_1")
MODEL_DP_MESH = f"ranks_{DP_RANKS}"
#: the longest phase 12 waits for the dry-run processes (started at
#: phase 7; under a minute of host work each)
MODEL_DRYRUN_WAIT_S = 900
#: 12b: the one-rank records held to runs of phase 8's cells on the card
#: (8c, 8d, 8e), the timed calls after one warm-up, and the tolerance of
#: the argument and temp bytes against the allocator
C12_CELLS = (("pna", "minibatch_lg"), ("meshgraphnet", "minibatch_lg"),
             ("equiformer-v2", "molecule"), ("egnn", "molecule"),
             ("pna", "full_graph_sm"), ("meshgraphnet", "full_graph_sm"),
             ("egnn", "full_graph_sm"), ("equiformer-v2", "full_graph_sm"),
             ("dcn-v2", "train_batch"), ("dcn-v2", "serve_p99"),
             ("dcn-v2", "serve_bulk"), ("dcn-v2", "retrieval_cand"))
C12_REPS = 3
MODEL_MEM_TOL = 0.05
#: 12c: the 4-rank record's collective bytes against 8g's ShardComm
MODEL_COLL_TOL = 0.01


def _model_dryrun(out: Path, arch: str) -> int:
    """``--gnn-dryrun OUT ARCH``: ``launch.dryrun`` of one GNN or recsys
    arch on the reference's two meshes and one rank (records under
    ``OUT``), and for PNA minibatch_lg's record on 8g's ranks. A host
    computation on meta tensors in a process of its own, started at
    phase 7 so that it overlaps phases 7-11; it touches no device."""
    os.nice(10)
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    rc = dryrun.main(["--arch", arch, "--mesh", "both", "--ranks", "1",
                      "--out", str(out)])
    if arch == "pna":
        spec = get_arch(arch)
        cell = next(c for c in spec.cells if c.name == "minibatch_lg")
        rec = dryrun.run_cell(spec, cell,
                              make_mesh((DP_RANKS, 1), ("data", "model")),
                              MODEL_DP_MESH)
        (out / MODEL_DP_MESH).mkdir(exist_ok=True)
        part = out / MODEL_DP_MESH / "pna__minibatch_lg.part"
        part.write_text(json.dumps(rec))
        os.replace(part, part.with_suffix(".json"))
    return rc


def _start_model_dryrun() -> tuple:
    """Start one ``--gnn-dryrun`` process per GNN and recsys arch, writing
    to one temporary directory; at exit they are stopped and it is
    removed."""
    out = Path(tempfile.mkdtemp(prefix="model_dryrun_"))
    procs = {}
    for arch in MODEL_ARCHS:
        with open(out / f"{arch}.log", "w") as log:
            procs[arch] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--gnn-dryrun", str(out), arch],
                stdout=log, stderr=subprocess.STDOUT)
    atexit.register(_stop_lm_dryrun, procs, out)
    return procs, out


def _model_record_line(rec: dict) -> str:
    mem, r = rec["memory"], rec["roofline"]
    return (f"peak {mem['peak_bytes_per_device']} B "
            f"({mem['peak_bytes_per_device'] / 1e9:.2f} GB; argument "
            f"{mem['argument_bytes']}, temp {mem['temp_bytes']}): fits 80 GB "
            f"{mem['fits_80g_hbm']}; compute {r['compute_s'] * 1e3:.4f} ms, "
            f"memory {r['memory_s'] * 1e3:.4f} ms, collective "
            f"{r['collective_s'] * 1e3:.4f} ms: bottleneck {r['bottleneck']},"
            f" t_lb {r['step_time_lb_s'] * 1e3:.4f} ms "
            f"({rec['flops_per_chip']:.6g} FLOP, {rec['bytes_per_chip']:.6g} "
            f"B, {rec['collectives']['total']:.6g} collective B as the "
            f"reference's parse counts them, "
            f"{rec['collectives_moved']['total']:.6g} B moved)")


def _model_dryrun_records(dry: tuple, tag: str) -> dict:
    """12a: wait for the dry-run processes; print every GNN and recsys
    record (per-rank peak and its fit in 80 GB, the roofline's three
    terms, bottleneck and t_lb) and each mesh's report; a record that is
    not ok must state why."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import report
    procs, out = dry
    t0 = time.perf_counter()
    for arch, proc in procs.items():
        rc = proc.wait(timeout=MODEL_DRYRUN_WAIT_S)
        log = (out / f"{arch}.log").read_text()
        if rc != 0 and "Traceback" in log:
            raise AssertionError(f"phase 12a: the dry run of {arch} exited "
                                 f"{rc}: {log[-3000:]}")
    waited = time.perf_counter() - t0
    want = {(a, c.name) for a in MODEL_ARCHS for c in get_arch(a).cells}
    recs_by_mesh = {}
    for mesh_name in MODEL_DRYRUN_MESHES + (MODEL_DP_MESH,):
        recs = report.load(str(out), mesh_name)
        expect = (want if mesh_name != MODEL_DP_MESH
                  else {("pna", "minibatch_lg")})
        if set(recs) != expect:
            raise AssertionError(f"phase 12a: {mesh_name}: records "
                                 f"{sorted(recs)}")
        for (arch, shape), rec in sorted(recs.items()):
            if not rec["ok"]:
                if not rec.get("error"):
                    raise AssertionError(f"phase 12a: {mesh_name} "
                                         f"{arch}/{shape} is not ok and "
                                         f"states no reason")
                print(f"{tag} phase 12a: {arch}/{shape} on {mesh_name}: "
                      f"not built: {rec['error']}", flush=True)
                continue
            print(f"{tag} phase 12a: {arch}/{shape} on {mesh_name} "
                  f"({rec['n_devices']} ranks): " + _model_record_line(rec),
                  flush=True)
        print(f"{tag} phase 12a: {mesh_name}: {report.summary(recs)}\n"
              f"{report.roofline_table(recs)}", flush=True)
        recs_by_mesh[mesh_name] = {f"{a}/{c}": rec
                                   for (a, c), rec in recs.items()}
    return {"records": recs_by_mesh, "waited_s": waited}


def _c12_inputs(arch: str, cell: str, graph) -> tuple:
    """(model, the rest of the call's arguments) of a 12b cell on the
    card: the model drawn from a generator seeded 0 (DCN-v2's on the
    card), AdamW's state for a train cell, and the cell's batch as
    phase 8 makes it, keeping the inputs the dry run's plan has."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import dcn_batch
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import molecule_cell_batch
    from repro_torch.launch.train_cells import (full_graph_sm_batch,
                                                registry_cell, train_plan,
                                                tree_batch)
    from repro_torch.optim.adamw import adamw_init

    plan = train_plan(arch, cell)
    spec = get_arch(arch)
    one = build_cell(spec, registry_cell(arch, cell),
                     make_mesh((1, 1), ("data", "model")))
    if arch == "dcn-v2":
        cfg = spec.config
        model = plan.init(torch.Generator(device="cuda").manual_seed(0))
        n = registry_cell(arch, cell).params["batch"]
        b = dcn_batch(0, 0, n, cfg.n_dense, cfg.n_sparse, cfg.vocab_sizes)
        if cell == "train_batch":
            return plan, model, (adamw_init(model), b)
        if cell != "retrieval_cand":
            return plan, model, (b["dense"], b["sparse"])
        cand = torch.randn(tuple(one.args[3].shape), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(2))
        return plan, model, (b["dense"], b["sparse"], cand)
    if cell == "minibatch_lg":
        batch = tree_batch(graph, 0)
    elif cell == "molecule":
        batch = molecule_cell_batch()
    else:
        batch = full_graph_sm_batch()
    batch = {k: v for k, v in batch.items() if k in one.args[2]}
    model = plan.init(torch.Generator().manual_seed(0))
    return plan, model, (adamw_init(model), batch)


def _phase8_ms(train: dict, arch: str, cell: str):
    """Phase 8's median ms of the cell (8c, 8d, 8e), where it has one."""
    if cell == "minibatch_lg":
        return train["minibatch_lg"][arch]["median_ms"]
    if cell in ("molecule", "full_graph_sm"):
        run = train["small_cells"][cell].get(arch)
        return run and run["median_ms"]
    dcn = train["dcn"]
    if cell == "train_batch":
        return dcn["train"]["median_ms"]
    return statistics.median(dcn[cell]["ms"])


def _model_vs_card(records: dict, graph, train: dict, tag: str) -> dict:
    """12b: each one-rank record of ``C12_CELLS`` against the cell run on
    the card at the same widths (phase 8's cells, run again here with
    their bytes counted): ``argument_bytes`` within ``MODEL_MEM_TOL`` of
    the bytes resident for the call's inputs (less what was allocated
    before them), ``temp_bytes`` within it of the call's peak above them
    (``max_memory_allocated`` over the calls after a warm-up), the
    roofline's t_lb not above the median call, and ``CostCounter``'s
    totals over one call on the card equal to the record's (meta)."""
    import torch
    from repro_torch.launch.cost import CostCounter
    out = {}
    for arch, cell in C12_CELLS:
        rec = records["ranks_1"][f"{arch}/{cell}"]
        if not rec["ok"]:
            raise AssertionError(f"phase 12b: {arch}/{cell} on one rank: "
                                 f"{rec.get('error')}")
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        plan, model, rest = _c12_inputs(arch, cell, graph)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - base
        train_cell = rec["meta"]["kind"] in ("gnn_train", "recsys_train")

        def call():
            nonlocal model, rest
            if train_cell:
                model, opt, _ = plan.fn(model, *rest)
                rest = (opt,) + rest[1:]
            else:
                plan.fn(model, *rest)

        ms = []
        with torch.set_grad_enabled(train_cell):
            for rep in range(1 + C12_REPS):
                if rep == 1:
                    # after the warm-up (cuBLAS workspaces)
                    torch.cuda.synchronize()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            working = torch.cuda.max_memory_allocated() - held
            with CostCounter() as cc:
                call()
            torch.cuda.synchronize()
        mem, cost = rec["memory"], rec["raw_cost"]
        arg_err = mem["argument_bytes"] / resident - 1
        temp_err = mem["temp_bytes"] / working - 1
        median = statistics.median(ms[1:])
        t_lb = rec["roofline"]["step_time_lb_s"] * 1e3
        same = (cc.flops == cost["flops"] and cc.bytes == cost["bytes"]
                and cc.transcendentals == cost["transcendentals"])
        p8 = _phase8_ms(train, arch, cell)
        out[f"{arch}/{cell}"] = {
            "argument_bytes": mem["argument_bytes"], "resident_bytes":
            resident, "argument_err": arg_err, "temp_bytes":
            mem["temp_bytes"], "working_bytes": working, "temp_err":
            temp_err, "ms": ms, "median_ms": median, "t_lb_ms": t_lb,
            "phase8_ms": p8, "card_flops": cc.flops, "card_bytes": cc.bytes,
            "count_equal": same}
        print(f"{tag} phase 12b: {arch}/{cell} on one rank: dry run "
              f"argument {mem['argument_bytes']} B against the card's "
              f"resident {resident} B ({arg_err:+.3%}), temp "
              f"{mem['temp_bytes']} B against the card's working {working} B"
              f" ({temp_err:+.3%}); median {median:.3f} ms of {C12_REPS} "
              f"calls after 1 warm-up (phase 8: "
              + (f"{p8:.3f} ms" if p8 else "not run") + f") against t_lb "
              f"{t_lb:.4f} ms ({rec['roofline']['bottleneck']}); card count "
              f"{cc.flops} FLOP, {cc.bytes} B "
              + ("equal to meta's" if same else
                 f"against meta's {cost['flops']:.0f}, {cost['bytes']:.0f}"),
              flush=True)
        if abs(arg_err) > MODEL_MEM_TOL or abs(temp_err) > MODEL_MEM_TOL:
            raise AssertionError(f"phase 12b, {arch}/{cell}: argument "
                                 f"{arg_err:+.2%}, temp {temp_err:+.2%}")
        if t_lb > median:
            raise AssertionError(f"phase 12b, {arch}/{cell}: t_lb {t_lb} ms "
                                 f"above the measured {median} ms")
        if not same:
            raise AssertionError(f"phase 12b, {arch}/{cell}: the card's "
                                 f"count differs from meta's")
        del model, rest
    torch.cuda.empty_cache()
    return out


def _model_vs_dp(records: dict, train: dict, tag: str) -> dict:
    """12c: minibatch_lg's PNA record on 8g's ranks against 8g's plain
    run (``compress=False``): the collective bytes a rank moves a step
    (``collectives_moved``: the gradient all-reduce and the loss, every
    array counted) within ``MODEL_COLL_TOL`` of the bytes ``ShardComm``
    recorded on each rank in each step."""
    rec = records[MODEL_DP_MESH]["pna/minibatch_lg"]
    if not rec["ok"]:
        raise AssertionError(f"phase 12c: {rec.get('error')}")
    want = rec["collectives_moved"]["total"]
    got = [[sum(step.values()) for step in rk["plain"]["bytes_by_op"]]
           for rk in train["data_parallel"]["ranks"]]
    worst = max(abs(b / want - 1) for steps in got for b in steps)
    print(f"{tag} phase 12c: minibatch_lg PNA FULL on {DP_RANKS} ranks: the "
          f"dry run's collective bytes a rank a step {want:.0f} "
          f"({rec['collectives']['total']:.0f} as the reference's parse "
          f"counts them: its gradient tuple holds more than five arrays) "
          f"against 8g's ShardComm, plain float32 all-reduce, by rank and "
          f"step: {got} (worst {worst:+.4%})", flush=True)
    if worst > MODEL_COLL_TOL:
        raise AssertionError(f"phase 12c: collective bytes {got} against "
                             f"the dry run's {want}")
    return {"dryrun_bytes": want, "shardcomm_bytes": got, "worst_err": worst}


def _model_dryrun_path(dry: tuple, graph, train: dict, tag: str) -> dict:
    """Phase 12: the GNN and recsys dry run (12a), its one-rank records
    against the card (12b), its 4-rank record against 8g (12c)."""
    report: dict = {}
    t0 = time.perf_counter()
    dr = _model_dryrun_records(dry, tag)
    report["dryrun"], report["12a_s"] = dr, time.perf_counter() - t0
    t0 = time.perf_counter()
    report["vs_card"] = _model_vs_card(dr["records"], graph, train, tag)
    report["12b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["vs_dp"] = _model_vs_dp(dr["records"], train, tag)
    report["12c_s"] = time.perf_counter() - t0
    print(f"{tag} phase 12: seconds by part: "
          + ", ".join(f"{part} {report[part + '_s']:.1f}"
                      for part in ("12a", "12b", "12c"))
          + f" (12a waited {dr['waited_s']:.1f} s for the dry runs)",
          flush=True)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="also write the full report as JSON here")
    parser.add_argument("--write-web-cell", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--lm-dryrun", nargs=2, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--gnn-dryrun", nargs=2, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.write_web_cell:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        return _write_web_cell(Path(args.write_web_cell))
    if args.lm_dryrun:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        return _lm_dryrun(Path(args.lm_dryrun[0]), args.lm_dryrun[1])
    if args.gnn_dryrun:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        return _model_dryrun(Path(args.gnn_dryrun[0]), args.gnn_dryrun[1])

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    from repro_torch.core.lpa import (LPAConfig, build_workspace, lpa,
                                      lpa_move, mark_frontier)
    from repro_torch.core.modularity import modularity, nmi
    from repro_torch.graphs.csr import (fused_active_rows,
                                        plan_dispatches, plan_padded_entries,
                                        plan_round0_dispatches)
    from repro_torch.graphs.generators import powerlaw_communities
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.mg_sketch import fused

    t_start = time.perf_counter()
    report: dict = {}

    # -- phase 0: the device -------------------------------------------------
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    tag = f"[{smi}]"
    print(f"phase 0: nvidia-smi: {smi}; torch: {kind}, {count} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    report["device"] = {"nvidia_smi": smi, "kind": kind, "count": count}

    # -- phase 1: build (one nvcc per source, all started together) ----------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = dict(zip(KERNEL_SOURCES,
                          pool.map(load_library, KERNEL_SOURCES)))
    build_wall = time.perf_counter() - t0
    report["build_seconds"] = {name: b.seconds for name, b in builds.items()}
    report["build_wall_seconds"] = build_wall
    for name, built in builds.items():
        print(f"{tag} phase 1: built {built.path.name} in "
              f"{built.seconds:.2f} s", flush=True)
        for line in _ptxas_summary(built.ptxas):
            print(f"{tag} phase 1: ptxas {line}")
    print(f"{tag} phase 1: all {len(builds)} builds in {build_wall:.2f} s "
          f"wall",
          flush=True)

    # -- the main-path graph and its plan (host-side set-up) -----------------
    cfg = LPAConfig(method="mg", k=8, chunk=128, fold_backend="pallas_fused")
    t0 = time.perf_counter()
    graph, truth = powerlaw_communities(1 << SCALE, p_in=0.5, mix=0.02, seed=1)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws = build_workspace(graph, cfg)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    fplan = ws.fused_plan
    deg = graph.degrees
    d_max, n_wide = int(deg.max()), int((deg > cfg.chunk).sum())
    rows0 = int((fplan.row_to_vertex0 >= 0).sum())
    print(f"{tag} set-up: powerlaw_communities(1<<{SCALE}): "
          f"{graph.n_nodes} vertices, {graph.n_edges} directed CSR slots, "
          f"largest degree {d_max}, {n_wide} vertices of degree > "
          f"{cfg.chunk}, generated in {gen_s:.1f} s; plans built in "
          f"{plan_s:.1f} s; fused plan {fplan.n_rounds} rounds, {rows0} "
          f"round-0 rows in {fplan.rounds[0].n_steps} steps x "
          f"{fplan.rounds[0].tile_r}, max_rows0 {fplan.max_rows0}",
          flush=True)
    report["graph"] = {"n_nodes": graph.n_nodes, "n_edges": graph.n_edges,
                       "scale": SCALE, "generate_s": gen_s,
                       "plan_build_s": plan_s, "n_rounds": fplan.n_rounds,
                       "round0_steps": fplan.rounds[0].n_steps,
                       "round0_rows": rows0, "max_degree": d_max,
                       "vertices_past_chunk": n_wide,
                       "max_rows0": fplan.max_rows0,
                       "fused_plan_bytes": _plan_bytes(fplan)}
    # the streamed workspaces: "auto" (past the budget: pallas_stream,
    # unaligned) and pallas_stream with the aligned layout
    cfg_auto = dataclasses.replace(cfg, fold_backend="auto")
    cfg_aligned = dataclasses.replace(cfg, fold_backend="pallas_stream",
                                      aligned_layout=True)
    stream_ws = {}
    report["stream_plans"] = {}
    for key, scfg in (("auto", cfg_auto), ("aligned", cfg_aligned)):
        t0 = time.perf_counter()
        sws = build_workspace(graph, scfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if sws.bundle.spec.backend != "pallas_stream":
            raise AssertionError(f"{key}: resolved to "
                                 f"{sws.bundle.spec.backend}, not "
                                 f"pallas_stream")
        splan = sws.stream_plan
        table = _stream_rounds_table(splan)
        slots = sum(t["window_slots"] for t in table)
        report["stream_plans"][key] = {
            "plan_build_s": build_s, "plan_bytes": _plan_bytes(splan),
            "aligned": splan.aligned, "n_rounds": splan.n_rounds,
            "rounds": table, "window_slots": slots,
            "gather_slots": sum(t["window_slots"] for t in table
                                if not t["aligned"])}
        stream_ws[key] = sws
        print(f"{tag} set-up: {key} workspace resolves to pallas_stream "
              f"(aligned {splan.aligned}); built in {build_s:.1f} s; "
              f"streamed plan {splan.n_rounds} rounds, "
              f"{_plan_bytes(splan)} B resident on the card, {slots} "
              f"window slots per iteration, "
              f"{report['stream_plans'][key]['gather_slots']} of them "
              f"re-laid every iteration; rounds (windows, W, slots, real "
              f"entries, row slots): "
              + "; ".join(f"{t['windows']}, {t['W']}, {t['window_slots']}, "
                          f"{t['real_entries']}, {t['row_slots']}"
                          for t in table), flush=True)

    # the per-bucket workspace: the bucketed plan alone
    cfg_pallas = dataclasses.replace(cfg, fold_backend="pallas")
    t0 = time.perf_counter()
    ws_pallas = build_workspace(graph, cfg_pallas)
    torch.cuda.synchronize()
    bplan = ws_pallas.plan
    report["bucketed_plan"] = {
        "plan_build_s": time.perf_counter() - t0,
        "plan_bytes": _plan_bytes(bplan), "n_rounds": bplan.n_rounds,
        "padded_slots": plan_padded_entries(bplan),
        "dispatches": plan_dispatches(bplan),
        "round0_dispatches": plan_round0_dispatches(bplan),
        "rounds": [{"round": r, "rows": rnd.n_rows_total,
                    "real_entries": int(sum(int((b.gather >= 0).sum())
                                            for b in rnd.buckets)),
                    "padded_slots": sum(b.width * b.n_rows
                                        for b in rnd.buckets),
                    "buckets": [[b.width, b.n_rows] for b in rnd.buckets]}
                   for r, rnd in enumerate(bplan.rounds)]}
    bp = report["bucketed_plan"]
    print(f"{tag} set-up: pallas workspace (bucketed plan only) built in "
          f"{bp['plan_build_s']:.1f} s, {bp['plan_bytes']} B on the card; "
          f"{bp['n_rounds']} rounds, {bp['padded_slots']} padded slots, "
          f"{bp['dispatches']} K9 launches per mg iteration, "
          f"{bp['round0_dispatches']} K10 per bm iteration; rounds (rows, "
          f"real entries, padded slots, width x rows): "
          + "; ".join(f"{t['rows']}, {t['real_entries']}, "
                      f"{t['padded_slots']}, "
                      + " ".join(f"{w}x{n}" for w, n in t["buckets"])
                      for t in bp["rounds"]), flush=True)

    # -- phase 2: each kernel against its plain version ----------------------
    t_phase = time.perf_counter()
    kstats = kernels_vs_plain(graph, fplan, tag)
    kstats.update(bm_rescan_vs_plain(graph, fplan, tag))
    kstats.update(stream_kernels_vs_plain(graph, stream_ws["auto"].stream_plan,
                                          stream_ws["aligned"].stream_plan,
                                          tag))
    kstats.update(tile_kernels_vs_plain(graph, bplan, tag))
    report["kernels_vs_plain"] = kstats
    _phase_took(tag, 2, t_phase, report)

    # -- phase 3: whole-path parity, kernels vs plain torch, on the card -----
    # (a) the small graph through every engine, for mg and bm. The paper
    # defaults make νMG collapse on it (its hubs reach most vertices; the
    # JAX package does the same), νBM keeps communities; (b) the
    # frontier-gated runs there, dense and sparse; (c) holds the main
    # graph's whole runs.
    t_phase = time.perf_counter()
    g16, truth16 = powerlaw_communities(1 << PARITY_SCALE, p_in=0.5,
                                        mix=0.02, seed=1)
    report["parity"] = {}
    for method in ("mg", "bm"):
        runs = {}
        for backend in ("jnp", "pallas_fused", "auto", "pallas"):
            pcfg = LPAConfig(method=method, k=8, chunk=128,
                             fold_backend=backend)
            t0 = time.perf_counter()
            pws = build_workspace(g16, pcfg)
            # 8·|E| is past the budget at 2^16: "auto" streams
            if backend == "auto" and pws.bundle.spec.backend != \
                    "pallas_stream":
                raise AssertionError(f"phase 3, 2^{PARITY_SCALE}: auto "
                                     f"resolved to {pws.bundle.spec.backend}")
            fused.reset_launch_counts()
            runs[backend] = lpa(g16, pcfg, ws=pws)
            torch.cuda.synchronize()
            runs[backend + "_s"] = time.perf_counter() - t0
            runs[backend + "_launches"] = dict(fused.LAUNCH_COUNTS)
        launched = runs["auto_launches"]
        if (any(launched[key] for key in FUSED_KEYS + TILE_KEYS)
                or not any(launched[key] for key in STREAM_KEYS)):
            raise AssertionError(f"phase 3, auto, {method}: launches "
                                 f"{launched}")
        tiled = runs["pallas_launches"]
        if (any(tiled[key] for key in FUSED_KEYS + STREAM_KEYS)
                or not tiled["tile_mg_fold" if method == "mg"
                             else "tile_bm_fold"]):
            raise AssertionError(f"phase 3, pallas, {method}: launches "
                                 f"{tiled}")
        for backend in ("pallas_fused", "auto", "pallas"):
            _check_same_run(runs["jnp"], runs[backend],
                            f"phase 3, 2^{PARITY_SCALE}, {method}, "
                            f"{backend}")
        got = runs["pallas_fused"]
        q16 = float(modularity(g16, got.labels))
        nmi16 = nmi(got.labels, truth16)
        print(f"{tag} phase 3: 2^{PARITY_SCALE} vertices, {method}: "
              f"pallas_fused == jnp, auto (pallas_stream, launches "
              f"{launched}) == jnp and pallas (launches {tiled}) == jnp "
              f"(labels, {got.iterations} iterations, changed_history "
              f"{got.changed_history}, frontier and work-row histories); "
              f"modularity {q16:.6f}, NMI vs planted {nmi16:.6f}; wall jnp "
              f"{runs['jnp_s']:.2f} s, pallas_fused "
              f"{runs['pallas_fused_s']:.2f} s, auto {runs['auto_s']:.2f} s, "
              f"pallas {runs['pallas_s']:.2f} s (plans included)",
              flush=True)
        report["parity"][method] = {
            "iterations": got.iterations,
            "changed_history": got.changed_history, "modularity": q16,
            "nmi": nmi16, "jnp_s": runs["jnp_s"],
            "pallas_fused_s": runs["pallas_fused_s"],
            "auto_s": runs["auto_s"], "auto_launches": launched,
            "pallas_s": runs["pallas_s"], "pallas_launches": tiled}
    del runs, got, pws
    # (b) frontier-gated mg at 2^16: dense on the plain engine and on the
    # fused kernels, sparse at the default capacity and at the median of
    # the iterations' largest per-round active-row counts, which some
    # iterations overflow (dense fold) and others fit (sparse fold)
    report["parity"]["gated"] = _gated_parity(
        g16, LPAConfig(method="mg", k=8, chunk=128, frontier_gate=True),
        build_workspace, lpa, lpa_move, mark_frontier, fused_active_rows,
        tag)
    # (b) the plain-torch engine's whole runs on the main graph; phase 4's
    # kernel runs must reproduce them
    paths = {"mg": cfg, "bm": dataclasses.replace(cfg, method="bm"),
             "rescan": dataclasses.replace(cfg, rescan=True)}
    ws_plain = build_workspace(graph, dataclasses.replace(cfg,
                                                          fold_backend="jnp"))
    plain_res = {}
    report["parity_main"] = {}
    for path, pcfg in paths.items():
        t0 = time.perf_counter()
        plain_res[path] = lpa(graph, dataclasses.replace(
            pcfg, fold_backend="jnp"), ws=ws_plain)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        r = plain_res[path]
        print(f"{tag} phase 3: 2^{SCALE} vertices, {path}, plain-torch "
              f"engine (jnp): {r.iterations} iterations, changed_history "
              f"{r.changed_history}; lpa() wall {plain_s:.2f} s", flush=True)
        report["parity_main"][path] = {"iterations": r.iterations,
                                       "changed_history": r.changed_history,
                                       "jnp_lpa_s": plain_s}
    _phase_took(tag, 3, t_phase, report)

    # -- phase 4: the paths at the real size ---------------------------------
    t_phase = time.perf_counter()
    n_rounds = fplan.n_rounds
    report["main"] = {}
    final_labels = {}
    fused_res = {}
    for path, pcfg in paths.items():
        out = _run_path(graph, truth, ws, pcfg, lpa, lpa_move, modularity,
                        nmi, fused, keep_changed=path == "mg")
        if path == "mg":
            mg_masks = out.pop("changed_masks")
        res, launches = out.pop("result"), out["launches"]
        it = res.iterations
        want = dict.fromkeys(fused.LAUNCH_COUNTS, 0)
        want["frontier_marks"] = it
        if path == "mg":
            want.update(fused_fold=it * (n_rounds - 1), fused_select=it)
        elif path == "bm":
            want.update(bm_fold=it)
        else:
            want.update(fused_fold=it * n_rounds, rescan=it)
        if launches != want:
            raise AssertionError(f"phase 4, {path}: launches {launches}, "
                                 f"expected {want}")
        _check_same_run(plain_res[path], res, f"phase 4, 2^{SCALE}, {path}")
        if path == "rescan":
            out["merge_share"] = (kstats["merge"]["ms"]
                                  / statistics.median(out["iter_ms"]))
        if path == "bm":
            # modularity adds every segment in a fixed order: a second
            # call on the same labels must give the same bits
            q2 = modularity(graph, res.labels, ws.edge_src)
            bits2 = q2.reshape(1).view(torch.int32).item()
            if bits2 != out["modularity_bits"]:
                raise AssertionError(f"phase 4, bm: modularity {float(q2)!r} "
                                     f"on a second call, "
                                     f"{out['modularity']!r} on the first")
            # the same sums in float64: how far float32's are off
            q64 = float(modularity(dataclasses.replace(
                graph, weights=graph.weights.double()), res.labels,
                ws.edge_src))
            out["modularity_f64"] = q64
            print(f"{tag} phase 4: 2^{SCALE} vertices, bm: modularity "
                  f"{out['modularity']!r} (bits {out['modularity_bits']:#010x})"
                  f" on two calls, equal bits; one call "
                  f"{out['modularity_ms']:.2f} ms (host wall, synchronised); "
                  f"in float64 {q64!r}", flush=True)
        print(f"{tag} phase 4: 2^{SCALE} vertices, {graph.n_edges} slots, "
              f"{path}: {it} iterations (converged {res.converged}), "
              f"changed_history {res.changed_history}; modularity "
              f"{out['modularity']:.6f} ({out['modularity_ms']:.2f} ms), NMI "
              f"vs planted {out['nmi']:.6f}; "
              f"labels and histories equal to the plain-torch engine's run; "
              f"lpa_move median {statistics.median(out['iter_ms']) / 1e3:.6f}"
              f" s/iteration (mean {statistics.mean(out['iter_ms']) / 1e3:.6f}"
              f" s); lpa() wall {out['lpa_s']:.2f} s; peak device memory "
              f"{out['peak_bytes']} B ({out['peak_bytes'] / 2**30:.3f} GiB), "
              f"{out['working_bytes']} B above the {out['resident_bytes']} B "
              f"resident at the start; launches {launches}"
              + (f"; rescan merge {kstats['merge']['ms']:.3f} ms = "
                 f"{out['merge_share']:.1%} of an iteration"
                 if path == "rescan" else ""), flush=True)
        report["main"][path] = out
        final_labels[path] = res.labels
        fused_res[path] = res
    del plain_res
    torch.cuda.empty_cache()
    # the streamed engine: each run must give the fused run of its method
    # (labels and every history), which equals the plain-torch run above
    stream_paths = {
        "stream_mg_auto": ("mg", "auto", cfg_auto),
        "stream_mg_aligned": ("mg", "aligned", cfg_aligned),
        "stream_bm_aligned": ("bm", "aligned",
                              dataclasses.replace(cfg_aligned, method="bm")),
        "stream_rescan_aligned": ("rescan", "aligned",
                                  dataclasses.replace(cfg_aligned,
                                                      rescan=True))}
    for path, (fpath, wkey, scfg) in stream_paths.items():
        sws = stream_ws[wkey]
        s_rounds = sws.stream_plan.n_rounds
        out = _run_path(graph, truth, sws, scfg, lpa, lpa_move, modularity,
                        nmi, fused, quality_of=(fused_res[fpath].labels,
                                                report["main"][fpath]))
        res, launches = out.pop("result"), out["launches"]
        it = res.iterations
        want = dict.fromkeys(fused.LAUNCH_COUNTS, 0)
        want["frontier_marks"] = it
        if fpath == "mg":
            want.update(stream_fold=it * (s_rounds - 1), stream_select=it)
        elif fpath == "bm":
            want.update(stream_bm=it)
        else:
            want.update(stream_fold=it * s_rounds, stream_rescan=it)
        if launches != want:
            raise AssertionError(f"phase 4, {path}: launches {launches}, "
                                 f"expected {want}")
        _check_same_run(fused_res[fpath], res,
                        f"phase 4, 2^{SCALE}, {path} vs fused {fpath}")
        out["plan"] = wkey
        out["plan_bytes"] = report["stream_plans"][wkey]["plan_bytes"]
        out["plan_build_s"] = report["stream_plans"][wkey]["plan_build_s"]
        print(f"{tag} phase 4: 2^{SCALE} vertices, {path} "
              f"({scfg.fold_backend} -> {sws.bundle.spec.backend}, aligned "
              f"{sws.stream_plan.aligned}): {it} iterations, labels and "
              f"histories equal to the fused {fpath} run; lpa_move median "
              f"{statistics.median(out['iter_ms']) / 1e3:.6f} s/iteration "
              f"(mean {statistics.mean(out['iter_ms']) / 1e3:.6f} s); lpa() "
              f"wall {out['lpa_s']:.2f} s; peak device memory "
              f"{out['peak_bytes']} B ({out['peak_bytes'] / 2**30:.3f} GiB), "
              f"{out['working_bytes']} B above the {out['resident_bytes']} B "
              f"resident at the start; streamed plan {out['plan_bytes']} B, "
              f"built in {out['plan_build_s']:.1f} s; launches {launches}",
              flush=True)
        report["main"][path] = out
    # the per-bucket engine: each run must give the fused run of its
    # method, which equals the plain-torch run above
    for fpath in ("mg", "bm", "rescan"):
        path = f"pallas_{fpath}"
        pcfg = dataclasses.replace(paths[fpath], fold_backend="pallas")
        out = _run_path(graph, truth, ws_pallas, pcfg, lpa, lpa_move,
                        modularity, nmi, fused,
                        quality_of=(fused_res[fpath].labels,
                                    report["main"][fpath]))
        res, launches = out.pop("result"), out["launches"]
        it = res.iterations
        want = dict.fromkeys(fused.LAUNCH_COUNTS, 0)
        want["frontier_marks"] = it
        if fpath == "bm":
            want.update(tile_bm_fold=it * plan_round0_dispatches(bplan))
        else:
            want.update(tile_mg_fold=it * plan_dispatches(bplan))
        if launches != want:
            raise AssertionError(f"phase 4, {path}: launches {launches}, "
                                 f"expected {want}")
        _check_same_run(fused_res[fpath], res,
                        f"phase 4, 2^{SCALE}, {path} vs fused {fpath}")
        print(f"{tag} phase 4: 2^{SCALE} vertices, {path}: {it} "
              f"iterations, labels and histories equal to the fused "
              f"{fpath} run; lpa_move median "
              f"{statistics.median(out['iter_ms']) / 1e3:.6f} s/iteration "
              f"(mean {statistics.mean(out['iter_ms']) / 1e3:.6f} s); lpa() "
              f"wall {out['lpa_s']:.2f} s; peak device memory "
              f"{out['peak_bytes']} B ({out['peak_bytes'] / 2**30:.3f} GiB), "
              f"{out['working_bytes']} B above the {out['resident_bytes']} B "
              f"resident at the start; launches {launches}", flush=True)
        report["main"][path] = out
    del fused_res
    torch.cuda.empty_cache()
    # sparse frontier execution: frontier-gated mg, dense and sparse on the
    # fused engine, sparse on the aligned streamed engine, each sparse one
    # at the default capacity and at one every iteration fits (so that
    # every launch runs compacted); every sparse run equals the fused
    # dense gated run (labels, changed and frontier histories, iterations)
    cfg_gate = dataclasses.replace(cfg, frontier_gate=True)
    sparse_fused = dataclasses.replace(cfg_gate, frontier_sparse=True)
    sparse_stream = dataclasses.replace(cfg_aligned, frontier_gate=True,
                                        frontier_sparse=True)
    gated_paths = {
        "gated_fused_dense": (ws, cfg_gate),
        "gated_fused_sparse": (ws, sparse_fused),
        "gated_fused_sparse_fit": _with_cap(ws, sparse_fused, FIT_ALL_CAP),
        "gated_stream_sparse_aligned": (stream_ws["aligned"], sparse_stream),
        "gated_stream_sparse_aligned_fit": _with_cap(
            stream_ws["aligned"], sparse_stream, FIT_ALL_CAP)}
    gated_dense = None
    for path, (gws, gcfg) in gated_paths.items():
        out = _run_path(graph, truth, gws, gcfg, lpa, lpa_move, modularity,
                        nmi, fused, quality_of=None if gated_dense is None
                        else (gated_dense.labels,
                              report["main"]["gated_fused_dense"]),
                        keep_changed=gated_dense is None)
        if gated_dense is None:
            gated_masks = out.pop("changed_masks")
        res, launches = out.pop("result"), out["launches"]
        it = res.iterations
        want = dict.fromkeys(fused.LAUNCH_COUNTS, 0)
        want["frontier_marks"] = it
        if gws.fused_plan is not None:
            want.update(fused_fold=it * (n_rounds - 1), fused_select=it)
        else:
            want.update(stream_fold=it * (gws.stream_plan.n_rounds - 1),
                        stream_select=it)
        if launches != want:
            raise AssertionError(f"phase 4, {path}: launches {launches}, "
                                 f"expected {want}")
        if gated_dense is None:
            gated_dense = res
        else:
            for field in ("labels", "changed_history", "frontier_history",
                          "iterations"):
                a, b = getattr(gated_dense, field), getattr(res, field)
                if not (torch.equal(a, b) if field == "labels" else a == b):
                    raise AssertionError(f"phase 4, {path}: {field} differs "
                                         f"from the dense gated run")
        fit = (f"; sparse_fit median {statistics.median(out['fit_ms']):.3f}"
               f" ms (host wall, synchronised)" if out["fit_ms"] else "")
        print(f"{tag} phase 4: 2^{SCALE} vertices, {path}: {it} iterations "
              f"(converged {res.converged}), changed_history "
              f"{res.changed_history}, frontier_history "
              f"{[round(f, 6) for f in res.frontier_history]}, "
              f"work_rows_history {res.work_rows_history}"
              + ("" if res is gated_dense else
                 ", equal to the dense gated run")
              + f"; modularity {out['modularity']:.6f}, NMI vs planted "
              f"{out['nmi']:.6f}; lpa_move median "
              f"{statistics.median(out['iter_ms']) / 1e3:.6f} s/iteration "
              f"(mean {statistics.mean(out['iter_ms']) / 1e3:.6f} s){fit}; "
              f"lpa() wall {out['lpa_s']:.2f} s; peak device memory "
              f"{out['peak_bytes']} B ({out['peak_bytes'] / 2**30:.3f} GiB), "
              f"{out['working_bytes']} B above the {out['resident_bytes']} B "
              f"resident at the start; launches {launches}", flush=True)
        report["main"][path] = out
    del gated_dense, res
    # the frontier marks: every launch of the runs above went through the
    # same kernel as the plain engine's reference runs, so hold it to its
    # plain version on the masks those runs marked
    kstats["FM"] = frontier_marks_vs_plain(graph, mg_masks, gated_masks, tag)
    del mg_masks, gated_masks
    torch.cuda.empty_cache()
    # exact LPA: plain torch (no kernel); its group sums first, on the
    # 2^16 graph with non-integer weights, against the CPU's bits
    report["exact_check"] = _exact_vs_cpu(g16, truth16, tag)
    # the exact fold groups by the edge sources, which a workspace holds
    # for the exact method alone
    ws_exact = dataclasses.replace(ws_plain, edge_src=graph.sources())
    out = _run_path(graph, truth, ws_exact,
                    dataclasses.replace(cfg, method="exact",
                                        fold_backend="jnp"),
                    lpa, lpa_move, modularity, nmi, fused)
    res = out.pop("result")
    # exact folds in plain torch; only the frontier marks launch
    if ({key: n for key, n in out["launches"].items() if n}
            != {"frontier_marks": res.iterations}):
        raise AssertionError(f"phase 4, exact: launches {out['launches']}, "
                             f"want one frontier_marks an iteration")
    print(f"{tag} phase 4: 2^{SCALE} vertices, exact: {res.iterations} "
          f"iterations (converged {res.converged}), changed_history "
          f"{res.changed_history}; modularity {out['modularity']:.6f}, NMI "
          f"vs planted {out['nmi']:.6f}; lpa_move median "
          f"{statistics.median(out['iter_ms']) / 1e3:.6f} s/iteration; "
          f"lpa() wall {out['lpa_s']:.2f} s; peak device memory "
          f"{out['peak_bytes']} B ({out['peak_bytes'] / 2**30:.3f} GiB), "
          f"{out['working_bytes']} B above the {out['resident_bytes']} B "
          f"resident at the start", flush=True)
    report["main"]["exact"] = out
    final_labels["exact"] = res.labels
    del res
    # the same four runs without frontier tracking (no frontier marks);
    # same labels
    paths["exact"] = dataclasses.replace(cfg, method="exact",
                                         fold_backend="jnp")
    for path, pcfg in paths.items():
        pws = ws_exact if path == "exact" else ws
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = lpa(graph, dataclasses.replace(pcfg, track_frontier=False),
                  ws=pws)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if not torch.equal(res.labels, final_labels[path]):
            raise AssertionError(f"phase 4, {path}: labels without "
                                 f"frontier tracking differ")
        report["main"][path]["untracked_peak_bytes"] = peak
        report["main"][path]["untracked_working_bytes"] = peak - resident
        del res
    mem = {p: report["main"][p] for p in ("mg", "bm", "rescan", "exact")}
    print(f"{tag} phase 4: peak device memory at 2^{SCALE} (B; working set "
          f"above what was resident at the start in brackets): "
          + ", ".join(f"{p} {m['peak_bytes']} ({m['working_bytes']})"
                      for p, m in mem.items())
          + "; exact's working set / "
          + ", ".join(f"{p}'s {mem['exact']['working_bytes'] / max(m['working_bytes'], 1):.2f}x"
                      for p, m in mem.items() if p != "exact"), flush=True)
    print(f"{tag} phase 4: the same without frontier tracking "
          f"(track_frontier=False, labels equal): "
          + ", ".join(f"{p} {m['untracked_peak_bytes']} "
                      f"({m['untracked_working_bytes']})"
                      for p, m in mem.items())
          + "; exact's working set / "
          + ", ".join(f"{p}'s {mem['exact']['untracked_working_bytes'] / max(m['untracked_working_bytes'], 1):.2f}x"
                      for p, m in mem.items() if p != "exact"), flush=True)
    _phase_took(tag, 4, t_phase, report)

    # -- phase 4w: the int64 instantiations ----------------------------------
    t_phase = time.perf_counter()
    wide = wide_vs_plain(graph, cfg, tag)
    report["wide"] = {key: wide.pop(key)
                      for key in ("past_2_31", "launches", "iterations")}
    kstats.update(wide)
    _phase_took(tag, "4w", t_phase, report)

    # -- phase 5: the runtime contracts and the partitioner ------------------
    t_phase = time.perf_counter()
    report["checked"] = _checked_runs(g16, tag)
    torch.cuda.empty_cache()
    report["partition"] = _partition(graph, cfg, final_labels["mg"],
                                     report["main"]["mg"]["launches"], tag)
    _phase_took(tag, 5, t_phase, report)

    # -- phase 6: distributed LPA over gloo ranks sharing the card -----------
    t_phase = time.perf_counter()
    main_refs = {path: (final_labels[path].cpu(),
                        report["main"][path]["iterations"])
                 for path in DIST_METHODS}
    # the ranks hold their own blocks: free this process's plans first
    del (ws, stream_ws, ws_pallas, ws_plain, ws_exact, fplan, bplan,
         final_labels, sws, splan, gws, gated_paths, pws)
    torch.cuda.empty_cache()
    report["distributed"] = _distributed(g16, graph, main_refs, tag)
    del g16
    _phase_took(tag, 6, t_phase, report)

    # -- phase 7: the GNN serving path ---------------------------------------
    # phase 10's web_560m graph and workspace, phase 11's LM dry runs and
    # phase 12's GNN and recsys dry runs, host work in processes of their
    # own meanwhile
    web_cell = _start_web_cell()
    lm_dry = _start_lm_dryrun()
    model_dry = _start_model_dryrun()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report["gnn"] = _gnn_path(graph, cfg, tag)
    _phase_took(tag, 7, t_phase, report)

    # -- phase 8: the training path ------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report["train"] = _train_path(graph, cfg, root, tag)
    _phase_took(tag, 8, t_phase, report)

    # -- phase 9: the LM family ---------------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report["lm"] = _lm_path(root, tag)
    _phase_took(tag, 9, t_phase, report)

    # -- phase 10: the paper's own LPA cells ---------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report["lpa_cells"] = _lpa_cells(web_cell, tag)
    _phase_took(tag, 10, t_phase, report)

    # -- phase 11: the LM half of the dry run --------------------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report["lm_dryrun"] = _lm_dryrun_path(lm_dry, report["lm"], tag)
    _phase_took(tag, 11, t_phase, report)

    # -- phase 12: the GNN and recsys half of the dry run -------------------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report["model_dryrun"] = _model_dryrun_path(model_dry, graph,
                                                report["train"], tag)
    _phase_took(tag, 12, t_phase, report)

    # -- phase 13: the kernels line -------------------------------------------
    main = report["main"]
    gnn_launches = report["gnn"]["example"]["partition"]["launches"]
    train_launches = report["train"]["example"]["partition"]["launches"]
    # K1/K2 held to plain on the 2^18 partition's plan (phases 7b and 8b)
    partitions_vs_plain = (
        report["gnn"]["example"]["partition"]["kernels_vs_plain"],
        report["train"]["example"]["partition"]["kernels_vs_plain"])
    # launches of the distributed runs, summed over the ranks
    dist_launches = {}
    for path, run in report["distributed"]["main"].items():
        dist_launches[path] = run["ranks"]
    # the paper's cells (phase 10): web_560m's run, the bucketed step
    cells = report["lpa_cells"]
    cell_launches = {
        "web_560m": cells["web_560m"]["launches"],
        f"cell_bucketed_2^{CELL_SCALE}": cells["cell_layout"]["launches"]}
    cell_launches.update({f"cell_{engine}_2^{PARITY_SCALE}": run["launches"]
                          for engine, run in
                          cells["cell_layout"]["parity"].items()})
    cell_errs = {"K1": cells["web_560m"]["max_abs_err"],
                 "K9": cells["cell_layout"]["max_abs_err"]}
    dist_ranks = report["distributed"]["ranks"]
    for name in dist_ranks[0]["matrix"]["runs"]:
        dist_launches[f"dist16_{name}"] = [
            rk["matrix"]["runs"][name] for rk in dist_ranks]

    def by_path(key, paths):
        out = {p: main[p]["launches"][key] for p in paths}
        for p, per_rank in dist_launches.items():
            total = sum(r["launches"].get(key, 0) for r in per_rank)
            if total:
                out[p] = total
        if key in gnn_launches:
            out["gnn_partition"] = gnn_launches[key]
        if key in train_launches:
            out["train_partition"] = train_launches[key]
        for path, launched in cell_launches.items():
            if key in launched:
                out[path] = launched[key]
        return out
    rows = (("K1", "mg_fused_fold", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:173", "mg",
             by_path("fused_fold", ("mg", "rescan", "gated_fused_dense",
                                    "gated_fused_sparse",
                                    "gated_fused_sparse_fit"))),
            ("K2", "mg_fused_select", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:234", "mg",
             by_path("fused_select", ("mg", "gated_fused_dense",
                                      "gated_fused_sparse",
                                      "gated_fused_sparse_fit"))),
            ("K3", "mg_fused_bm_fold", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:181", "bm",
             by_path("bm_fold", ("bm",))),
            ("K4", "mg_fused_rescan", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:191", "rescan",
             by_path("rescan", ("rescan",))),
            ("K5", "mg_stream_fold", "mg_stream",
             "src/repro/kernels/mg_sketch/streaming.py:93", "stream_mg_auto",
             by_path("stream_fold", ("stream_mg_auto", "stream_mg_aligned",
                                     "stream_rescan_aligned",
                                     "gated_stream_sparse_aligned",
                                     "gated_stream_sparse_aligned_fit"))),
            ("K6", "mg_stream_select", "mg_stream",
             "src/repro/kernels/mg_sketch/streaming.py:104",
             "stream_mg_auto",
             by_path("stream_select", ("stream_mg_auto",
                                       "stream_mg_aligned",
                                       "gated_stream_sparse_aligned",
                                       "gated_stream_sparse_aligned_fit"))),
            ("K7", "mg_stream_bm_fold", "mg_stream",
             "src/repro/kernels/mg_sketch/streaming.py:304",
             "stream_bm_aligned", by_path("stream_bm", ("stream_bm_aligned",))),
            ("K8", "mg_stream_rescan", "mg_stream",
             "src/repro/kernels/mg_sketch/streaming.py:316",
             "stream_rescan_aligned",
             by_path("stream_rescan", ("stream_rescan_aligned",))),
            ("K9", "mg_tile_fold", "mg_tile",
             "src/repro/kernels/mg_sketch/mg_sketch.py:29", "pallas_mg",
             by_path("tile_mg_fold", ("pallas_mg", "pallas_rescan"))),
            ("K10", "mg_tile_bm_fold", "mg_tile",
             "src/repro/kernels/mg_sketch/mg_sketch.py:61", "pallas_bm",
             by_path("tile_bm_fold", ("pallas_bm",))),
            ("FM", "frontier_marks", "frontier_marks",
             "no Pallas kernel: the reference's jax.ops.segment_max "
             "(src/repro/core/lpa.py:234)", "mg",
             by_path("frontier_marks", tuple(main))))
    # the int64 instantiations, with phase 4w's launches by width
    wide_launches = report["wide"]["launches"]

    def by_width(name):
        return {p: c[name] for p, c in wide_launches.items() if name in c}
    rows += tuple(
        (key + "w", f"{name}<int64>", lib, replaces, main_path,
         by_width(f"{name}<64>"))
        for key, name, lib, replaces, main_path in (
            ("K1", "mg_fused_fold", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:173", "wide_mg"),
            ("K2", "mg_fused_select", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:234", "wide_grid_mg"),
            ("K3", "mg_fused_bm_fold", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:181", "wide_bm"),
            ("K4", "mg_fused_rescan", "mg_fused",
             "src/repro/kernels/mg_sketch/fused.py:191", "wide_rescan"),
            ("FM", "frontier_marks", "frontier_marks",
             "no Pallas kernel: the reference's jax.ops.segment_max "
             "(src/repro/core/lpa.py:234)", "wide_mg")))
    kernels = []
    for key, name, lib, replaces, main_path, launches_by_path in rows:
        st = kstats[key]
        err = st["max_abs_err"]
        for vs_plain in partitions_vs_plain:
            if key in vs_plain:
                err = max(err, vs_plain[key]["max_abs_err"])
        err = max(err, cell_errs.get(key, 0.0))
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[lib],
            "replaces": replaces,
            "launches": launches_by_path[main_path],
            "max_abs_err": err, "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
            "launches_by_path": launches_by_path,
            "parity": st.get("parity", "exact (torch.equal; float32 as "
                                       "int32 bits) vs plain torch on the "
                                       "card"),
            "ms_is": st.get("ms_is", "one main-path iteration (sum over "
                                     "its launches)"),
            "dist_launches_are": f"summed over the {DIST_RANKS} ranks"})
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(report, indent=1))
    print(f"{tag} total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
