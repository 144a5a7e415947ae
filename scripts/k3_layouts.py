"""Time K3, the fused BM fold, against the layouts it was chosen over.

K3 (``src/repro_torch/csrc/mg_fused.cu:mg_fused_bm_fold_kernel``) folds
round 0 of the fused plan from a shared-memory stage of 32 entries a row
in one buffer. ``scripts/k3_layouts.cu`` holds the alternatives: the
stage at C = 16 and at C = 32 in two buffers, and a group of 8 lanes per
row. This script builds that file, holds every layout to K3's plain
version bit for bit on round 0 of the 2^22 graph of ``chip_smoke.py``
(first-iteration inputs: labels = vertex ids, the incumbents' inits),
and times them all in turns, forward then backward, so that a drift of
the card's clock weighs on each alike.

Usage, on a machine with a CUDA card and nvcc::

    python3 scripts/k3_layouts.py [--scale 22]

Prints the card's name and power limit, then one line per layout: its
time (the mean of its two medians), its share of the bytes bound and its
dynamic shared memory a block. Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the alternative layouts, in the order of k3_layouts.cu's codes, with
#: their dynamic shared memory a block
LAYOUTS = (("stage C=16, two buffers", 34_816),
           ("stage C=32, two buffers", 67_584),
           ("group of 8 lanes per row", 0))


def _build() -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    out = ROOT / "build" / "k3_layouts" / "libk3_layouts.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I",
                    str(ROOT / "src" / "repro_torch" / "csrc"), "-o",
                    str(out), str(ROOT / "scripts" / "k3_layouts.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.k3_layout_fold.argtypes = [ptr] * 7 + [i32, i32, ptr]
    lib.k3_layout_fold.restype = i32
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=22,
                        help="log2 of the graph's vertex count")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("k3_layouts: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import _bound_ms, _nvidia_smi, _same_bits, _time_ms
    from repro_torch.core import sketch
    from repro_torch.core.lpa import LPAConfig, build_workspace
    from repro_torch.graphs.generators import powerlaw_communities
    from repro_torch.kernels.mg_sketch import fused

    print(_nvidia_smi(), flush=True)
    lib = _build()
    graph, _ = powerlaw_communities(1 << args.scale, p_in=0.5, mix=0.02,
                                    seed=1)
    cfg = LPAConfig(method="mg", k=8, chunk=128, fold_backend="pallas_fused")
    plan = build_workspace(graph, cfg).fused_plan
    rnd = plan.rounds[0]
    labels0 = torch.arange(plan.n_nodes, dtype=torch.int32,
                           device=graph.device)
    el = torch.index_select(labels0, 0, graph.indices)
    ew = graph.weights
    init = sketch.bm_init_rows(plan.row_to_vertex0, labels0)
    rows = rnd.row_start.numel()
    entries = int(rnd.row_count.sum())

    def shipped():
        return fused.bm_fold_round_fused(rnd, el, ew, init, chunk=cfg.chunk)

    def alternative(code):
        def run():
            out_c = torch.empty((rows,), dtype=torch.int32, device=el.device)
            out_w = torch.empty((rows,), dtype=torch.float32,
                                device=el.device)
            rc = lib.k3_layout_fold(
                rnd.row_start.data_ptr(), rnd.row_count.data_ptr(),
                init.data_ptr(), el.data_ptr(), ew.data_ptr(),
                out_c.data_ptr(), out_w.data_ptr(), rows, code,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"k3_layout_fold({code}) returned {rc}")
            return out_c, out_w
        return run

    runs = {"K3 (stage C=32, one buffer)": (shipped, 33_792)}
    runs.update({name: (alternative(code), smem)
                 for code, (name, smem) in enumerate(LAYOUTS)})
    ref = fused.bm_fold_round_plain(rnd, el, ew, init, chunk=cfg.chunk)
    for name, (run, _) in runs.items():
        got = run()
        torch.cuda.synchronize()
        if not all(_same_bits(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} differs from K3's plain version")
    times = {name: [] for name in runs}
    order = list(runs)
    for names in (order, order[::-1]):
        for name in names:
            times[name].append(_time_ms(runs[name][0], warmup=3, reps=20))
    bound, by = _bound_ms(8 * entries + 20 * rows, 4 * entries)
    print(f"round 0: {rows} rows, {entries} entries; every layout equals the "
          f"plain version bit for bit; bound {bound:.4f} ms ({by})")
    for name, ms_pair in times.items():
        ms = statistics.fmean(ms_pair)
        print(f"{name}: {ms:.4f} ms ({ms_pair[0]:.4f}, {ms_pair[1]:.4f}), "
              f"{bound / ms:.1%} of bound, {runs[name][1]} B of dynamic "
              f"shared memory a block", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
