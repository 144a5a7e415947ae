"""Time K8, the streamed rescan, against the layouts it was chosen over.

K8 (``src/repro_torch/csrc/mg_stream.cu:mg_stream_rescan_kernel``) scores
each row slot's candidates over round 0's windows with a group of k
lanes per row slot, blocks of 256 threads. ``scripts/k8_layouts.cu``
holds the alternatives: one thread per row slot (K8 before its
redesign), the group at 1,024, 128 and 512 threads a block, and a window
stage in shared memory (16-byte copies at 1,024 and 512 threads a block,
4-byte copies at 1,024). This script builds that file and, on round 0
of the streamed plan of the 2^22 graph of ``chip_smoke.py``
(first-iteration inputs: labels = vertex ids, the candidates of that
iteration's MG fold), holds every layout to K8's plain
version bit for bit, on the windowed arrays as the re-layout writes them
and on copies that start 4 bytes past a 16-byte boundary (which the
16-byte stage refuses), then times them all in turns, forward then
backward, so that a drift of the card's clock weighs on each alike.

Usage, on a machine with a CUDA card and nvcc::

    python3 scripts/k8_layouts.py [--scale 22]

Prints the card's name and power limit, then one line per layout: its
time (the mean of its two medians) and its share of the bytes bound.
Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the alternative layouts, in the order of k8_layouts.cu's codes, and
#: whether they take a window base 4 bytes past a 16-byte boundary
LAYOUTS = (("one thread per row slot (K8 before its redesign)", True),
           ("group of 8 lanes, 1024 threads a block", True),
           ("group of 8 lanes, 128 threads a block", True),
           ("window stage, 16-byte copies, 1024 threads", False),
           ("window stage, 4-byte copies, 1024 threads", True),
           ("window stage, 16-byte copies, 512 threads", False),
           ("group of 8 lanes, 512 threads a block", True))


def _build() -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    out = ROOT / "build" / "k8_layouts" / "libk8_layouts.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I",
                           str(ROOT / "src" / "repro_torch" / "csrc"), "-o",
                           str(out), str(ROOT / "scripts" / "k8_layouts.cu")],
                          check=True, capture_output=True, text=True)
    for line in proc.stderr.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.k8_layout_rescan.argtypes = [ptr] * 6 + [i32, i32, i64, i32, ptr]
    lib.k8_layout_rescan.restype = i32
    return lib


def _off16(x):
    """A copy of ``x`` whose first element lies 4 bytes past a 16-byte
    boundary."""
    import torch
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x
    return flat[1:]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=22,
                        help="log2 of the graph's vertex count")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("k8_layouts: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import _bound_ms, _nvidia_smi, _same_bits, _time_ms
    from repro_torch.core.lpa import LPAConfig, build_workspace
    from repro_torch.graphs.generators import powerlaw_communities
    from repro_torch.kernels.mg_sketch import streaming

    print(_nvidia_smi(), flush=True)
    lib = _build()
    graph, _ = powerlaw_communities(1 << args.scale, p_in=0.5, mix=0.02,
                                    seed=1)
    cfg = LPAConfig(method="mg", k=8, chunk=128, fold_backend="pallas_stream")
    plan = build_workspace(graph, cfg).stream_plan
    k, n = plan.k, plan.n_nodes
    rnd = plan.rounds[0]
    labels0 = torch.arange(n, dtype=torch.int32, device=graph.device)
    el = torch.index_select(labels0, 0, graph.indices)
    wl, ww = streaming.windowed_entries(rnd.entry_gather, el, graph.weights)
    view = dataclasses.replace(rnd, aligned=True, n_entries_in=wl.numel())
    # the first iteration's candidates per round-0 row slot
    s_k, _ = streaming.run_mg_plan_stream(plan, el, graph.weights)
    cand = torch.full((n + 1, k), -1, dtype=torch.int32, device=el.device)
    rtv = plan.row_to_vertex
    cand[torch.where(rtv >= 0, rtv, n).long()] = s_k
    cand[n] = -1
    rtv0 = plan.row_to_vertex0
    cand = cand[torch.where(rtv0 >= 0, rtv0, n).long()].contiguous()
    del s_k
    rows = rnd.row_start.numel()
    entries = int(rnd.row_count.sum())
    unaligned = (_off16(wl), _off16(ww))

    def shipped(wl=wl, ww=ww):
        return streaming.rescan_round_stream(view, wl, ww, cand, k=k,
                                             chunk=plan.chunk)

    def alternative(code, wl=wl, ww=ww):
        def run():
            out = torch.empty((rows, k), dtype=torch.float32,
                              device=wl.device)
            rc = lib.k8_layout_rescan(
                rnd.row_start.data_ptr(), rnd.row_count.data_ptr(),
                cand.data_ptr(), wl.data_ptr(), ww.data_ptr(),
                out.data_ptr(), rnd.n_windows, rnd.tile_r,
                rnd.window_entries, code,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"k8_layout_rescan({code}) returned {rc}")
            return out
        return run

    runs = {"K8 (group of 8 lanes, 256 threads a block)": shipped}
    runs.update({name: alternative(code)
                 for code, (name, _) in enumerate(LAYOUTS)})
    ref = streaming.rescan_round_stream_plain(view, wl, ww, cand,
                                              chunk=plan.chunk)
    checks = [(name, run) for name, run in runs.items()]
    checks.append(("K8, window base 4 bytes past 16",
                   lambda: shipped(*unaligned)))
    checks += [(f"{name}, window base 4 bytes past 16",
                alternative(code, *unaligned))
               for code, (name, takes) in enumerate(LAYOUTS) if takes]
    for name, run in checks:
        got = run()
        torch.cuda.synchronize()
        if not _same_bits(got, ref):
            raise AssertionError(f"{name} differs from K8's plain version")
    times = {name: [] for name in runs}
    order = list(runs)
    for names in (order, order[::-1]):
        for name in names:
            times[name].append(_time_ms(runs[name], warmup=3, reps=20))
    bound, by = _bound_ms(8 * entries + (8 + 8 * k) * rows, 2 * k * entries)
    print(f"round 0: {rnd.n_windows} windows x W {rnd.window_entries}, "
          f"{rows} row slots, {entries} entries; every layout equals the "
          f"plain version bit for bit (and on the offset copies where it "
          f"takes them); bound {bound:.4f} ms ({by})")
    for name, ms_pair in times.items():
        ms = statistics.fmean(ms_pair)
        print(f"{name}: {ms:.4f} ms ({ms_pair[0]:.4f}, {ms_pair[1]:.4f}), "
              f"{bound / ms:.1%} of bound", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
