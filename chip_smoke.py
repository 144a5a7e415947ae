#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives νMG8-LPA — ``lpa(graph, LPAConfig(method="mg", k=8, chunk=128,
fold_backend="pallas_fused"))``, the paper's headline method — through
the hand-written CUDA kernels, in phases; any failure raises and exits
non-zero:

  0. the device (nvidia-smi name and power limit, torch's view of it);
  1. build the kernels from ``src/repro_torch/csrc/`` (nvcc, sm_90a) and
     print the build time and ptxas's registers and spills;
  2. each kernel against its plain-torch version on the card, at the
     round shapes of the main graph's fused plan, with exact equality,
     and its time (CUDA events) beside the bytes it must move;
  3. whole-path parity: on a 2^16-vertex graph the kernels
     (``pallas_fused``) against the plain-torch engine (``jnp``), equal
     labels and histories; then the plain-torch engine's whole run on
     the main graph, which phase 4's kernel run must reproduce;
  4. the main path on ``powerlaw_communities(1 << 22)`` (4.19 M
     vertices, ~90 M directed CSR slots) with launch counts checked
     against iterations x rounds, labels and histories equal to phase
     3's plain run, quality (modularity, NMI against the planted truth),
     seconds per iteration and peak device memory;
  5. one JSON line describing every kernel.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Run from the root of a checkout: ``python3 chip_smoke.py``. Without a
CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
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
KERNEL_SOURCE = "src/repro_torch/csrc/mg_fused.cu"


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ptxas_summary(report: str) -> list[str]:
    """One line per kernel instantiation: registers and spill bytes."""
    lines, current = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kind = "K1 fold" if "fold" in name else "K2 select"
            k = re.search(r"ILi(\d+)E", name)
            current = f"{kind} k={k.group(1) if k else '?'}"
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
            lines[-1] = (current, f"{m.group(1)} registers, {lines[-1][1]}")
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


def _check_same_run(ref, got, where: str) -> None:
    """Two ``lpa()`` results must agree on labels and every history."""
    import torch
    if not torch.equal(ref.labels, got.labels):
        raise AssertionError(f"{where}: pallas_fused labels differ from jnp")
    for field in ("iterations", "converged", "changed_history",
                  "frontier_history", "work_rows_history"):
        if getattr(ref, field) != getattr(got, field):
            raise AssertionError(f"{where}: {field} differs: "
                                 f"{getattr(ref, field)} vs "
                                 f"{getattr(got, field)}")


def kernels_vs_plain(graph, plan, tag: str) -> dict:
    """Phase 2: K1 on every round but the last, K2 on the last, each held
    to exact equality with its plain version on two inputs of the round's
    shape: random entries from a small label alphabet (every branch of the
    fold and every tie-break runs) and the main path's own first iteration
    (labels = vertex ids, each round fed the previous round's output).
    The kernel and plain times are taken on the main path's inputs, the
    kernel's also on the random ones; bytes and bounds per round."""
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
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{key} differs from its plain version on round "
                            f"{r}, {name} inputs, seed {seed}")
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
        print(f"{tag} phase 2: {key} round {r}: rows {rows}, entries "
              f"{entries}, exact match to plain on random and main-path "
              f"inputs; kernel {ms:.4f} ms on the main path's inputs "
              f"({random_ms:.4f} ms on random ones), plain {plain_ms:.3f} "
              f"ms, {n_bytes} B, bound {bound:.4f} ms ({by} at 3.35 TB/s), "
              f"{bound / ms:.1%} of bound", flush=True)
        if key == "K1":
            out_k, out_v = kernel(main_el, main_ew, None)
            main_el, main_ew = out_k.reshape(-1), out_v.reshape(-1)
        del rand_el, rand_ew
        torch.cuda.empty_cache()
    return stats


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="also write the full report as JSON here")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    from repro_torch.core.lpa import LPAConfig, build_workspace, lpa, lpa_move
    from repro_torch.core.modularity import modularity, nmi
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

    # -- phase 1: build --------------------------------------------------------
    built = load_library("mg_fused")
    print(f"{tag} phase 1: built {built.path.name} in {built.seconds:.2f} s",
          flush=True)
    for line in _ptxas_summary(built.ptxas):
        print(f"{tag} phase 1: ptxas {line}")
    report["build_seconds"] = built.seconds

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
    print(f"{tag} set-up: powerlaw_communities(1<<{SCALE}): "
          f"{graph.n_nodes} vertices, {graph.n_edges} directed CSR slots, "
          f"generated in {gen_s:.1f} s; plans built in {plan_s:.1f} s; "
          f"fused plan {fplan.n_rounds} rounds, round-0 steps "
          f"{fplan.rounds[0].n_steps} x {fplan.rounds[0].tile_r} rows",
          flush=True)
    report["graph"] = {"n_nodes": graph.n_nodes, "n_edges": graph.n_edges,
                       "scale": SCALE, "generate_s": gen_s,
                       "plan_build_s": plan_s, "n_rounds": fplan.n_rounds,
                       "round0_steps": fplan.rounds[0].n_steps}

    # -- phase 2: each kernel against its plain version ----------------------
    kstats = kernels_vs_plain(graph, fplan, tag)
    report["kernels_vs_plain"] = kstats

    # -- phase 3: whole-path parity, kernels vs plain torch, on the card -----
    # (a) the small graph through both engines. The paper defaults make
    # LPA collapse on it (its hubs reach most vertices), so it checks the
    # first iterations and the convergence bookkeeping more than settled
    # communities; (b) holds the main graph's whole run.
    g16, truth16 = powerlaw_communities(1 << PARITY_SCALE, p_in=0.5,
                                        mix=0.02, seed=1)
    runs = {}
    for backend in ("jnp", "pallas_fused"):
        t0 = time.perf_counter()
        runs[backend] = lpa(g16, LPAConfig(method="mg", k=8, chunk=128,
                                           fold_backend=backend))
        torch.cuda.synchronize()
        runs[backend + "_s"] = time.perf_counter() - t0
    got = runs["pallas_fused"]
    _check_same_run(runs["jnp"], got, f"phase 3, 2^{PARITY_SCALE}")
    q16 = float(modularity(g16, got.labels))
    nmi16 = nmi(got.labels, truth16)
    print(f"{tag} phase 3: 2^{PARITY_SCALE} vertices: pallas_fused == "
          f"jnp (labels, {got.iterations} iterations, changed_history "
          f"{got.changed_history}, frontier and work-row histories); "
          f"modularity {q16:.6f}, NMI vs planted {nmi16:.6f}; wall jnp "
          f"{runs['jnp_s']:.2f} s, pallas_fused {runs['pallas_fused_s']:.2f} "
          f"s", flush=True)
    report["parity"] = {"iterations": got.iterations,
                        "changed_history": got.changed_history,
                        "modularity": q16, "nmi": nmi16,
                        "jnp_s": runs["jnp_s"],
                        "pallas_fused_s": runs["pallas_fused_s"]}
    del g16, runs, got
    # (b) the plain-torch engine's whole run on the main graph; phase 4's
    # kernel run must reproduce it
    t0 = time.perf_counter()
    plain_res = lpa(graph, dataclasses.replace(cfg, fold_backend="jnp"))
    torch.cuda.synchronize()
    plain_lpa_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"{tag} phase 3: 2^{SCALE} vertices, plain-torch engine (jnp): "
          f"{plain_res.iterations} iterations, changed_history "
          f"{plain_res.changed_history}; lpa() wall {plain_lpa_s:.2f} s "
          f"(plan build included)", flush=True)
    report["parity_main"] = {"iterations": plain_res.iterations,
                             "changed_history": plain_res.changed_history,
                             "jnp_lpa_s": plain_lpa_s}

    # -- phase 4: the main path at the real size -----------------------------
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = lpa(graph, cfg, ws=ws)
    torch.cuda.synchronize()
    lpa_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    n_rounds = fplan.n_rounds
    if launches["fused_fold"] != res.iterations * (n_rounds - 1):
        raise AssertionError(f"phase 4: K1 launched {launches['fused_fold']} "
                             f"times, expected {res.iterations} x "
                             f"{n_rounds - 1}")
    if launches["fused_select"] != res.iterations:
        raise AssertionError(f"phase 4: K2 launched "
                             f"{launches['fused_select']} times, expected "
                             f"{res.iterations}")
    _check_same_run(plain_res, res, f"phase 4, 2^{SCALE}")
    labels = res.labels
    if (labels.shape != (graph.n_nodes,) or labels.dtype != torch.int32
            or int(labels.min()) < 0 or int(labels.max()) >= graph.n_nodes):
        raise AssertionError("phase 4: labels out of shape or range")
    q = float(modularity(graph, labels, ws.edge_src))
    quality = nmi(labels, truth)
    # modularity lies in [-1/2, 1] and NMI in [0, 1]; the labels and
    # histories were held to the plain engine's run (phase 3) just above
    if not (np.isfinite(q) and -0.5 <= q <= 1.0 and 0.0 <= quality <= 1.0):
        raise AssertionError(f"phase 4: modularity {q} or NMI {quality} "
                             f"out of range")
    # seconds per iteration: CUDA events around lpa_move, replaying the
    # run's (pick-less, seed) sequence, queued behind a device-side wait as
    # in _time_ms; it must reproduce the run's labels
    cur = torch.arange(graph.n_nodes, dtype=torch.int32, device=graph.device)
    events = []
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_WAIT_CYCLES)
    for it in range(res.iterations):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cur, _ = lpa_move(ws, cur, (it % cfg.rho) == 0, it + 1, cfg)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    iter_ms = [s.elapsed_time(e) for s, e in events]
    if not torch.equal(cur, labels):
        raise AssertionError("phase 4: the timed replay diverged from lpa()")
    print(f"{tag} phase 4: 2^{SCALE} vertices, {graph.n_edges} slots: "
          f"{res.iterations} iterations (converged {res.converged}), "
          f"changed_history {res.changed_history}; modularity {q:.6f}, "
          f"NMI vs planted {quality:.6f}; labels and histories equal to "
          f"the plain-torch engine's run; lpa_move median "
          f"{statistics.median(iter_ms) / 1e3:.6f} s/iteration (mean "
          f"{statistics.mean(iter_ms) / 1e3:.6f} s); lpa() wall {lpa_s:.2f} "
          f"s; plan build {plan_s:.1f} s; peak device memory {peak} B "
          f"({peak / 2**30:.2f} GiB); launches K1 {launches['fused_fold']} "
          f"= {res.iterations} x {n_rounds - 1}, K2 "
          f"{launches['fused_select']} = {res.iterations}", flush=True)
    report["main"] = {"iterations": res.iterations,
                      "converged": res.converged,
                      "changed_history": res.changed_history,
                      "modularity": q, "nmi": quality,
                      "iter_ms": iter_ms, "lpa_s": lpa_s,
                      "peak_bytes": peak, "launches": launches}

    # -- phase 5: the kernels line --------------------------------------------
    replaces = {"K1": "src/repro/kernels/mg_sketch/fused.py:173",
                "K2": "src/repro/kernels/mg_sketch/fused.py:234"}
    names = {"K1": "mg_fused_fold", "K2": "mg_fused_select"}
    counts = {"K1": launches["fused_fold"], "K2": launches["fused_select"]}
    kernels = []
    for key in ("K1", "K2"):
        s = kstats[key]
        kernels.append({
            "name": names[key], "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces[key], "launches": counts[key],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "parity": "exact (torch.equal) vs plain torch on the card",
            "ms_is": "one main-path iteration (sum over its launches)"})
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(f"{tag} total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
