"""Quickstart on the PyTorch/CUDA port (``src/repro_torch``): the paper in
one minute, the port's counterpart of ``quickstart.py``.

Runs exact (ν-LPA analogue), νMG8 and νBM label propagation on a web-like
graph and prints the paper's headline trade-off: the sketch methods match
the exact method's community quality at a fraction of the working set.

  PYTHONPATH=src python examples/quickstart_torch.py                # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.core.fold_engine import resolve_auto
from repro_torch.core.lpa import LPAConfig, lpa
from repro_torch.core.modularity import modularity, nmi
from repro_torch.device import resolve_device
from repro_torch.graphs.generators import powerlaw_communities


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    graph, truth = powerlaw_communities(16384, p_in=0.5, mix=0.02, seed=1,
                                        device=device)
    print(f"web-like graph on {device}: {graph.n_nodes} vertices, "
          f"{graph.n_edges} directed edges\n")
    print(f"{'method':8s} {'iters':>5s} {'seconds':>8s} {'modularity':>10s} "
          f"{'NMI':>6s} {'working set':>12s}")

    for method in ("exact", "mg", "bm"):
        cfg = LPAConfig(method=method, rho=2)
        t0 = time.perf_counter()
        res = lpa(graph, cfg, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        q = float(modularity(graph, res.labels))
        score = nmi(res.labels, truth)
        if method == "exact":
            ws = graph.n_edges * 24  # sort+segment intermediates: O(|E|)
        elif method == "mg":
            ws = graph.n_nodes * cfg.k * 16  # k-slot sketches: O(k|V|)
        else:
            ws = graph.n_nodes * 16  # one carry per vertex: O(|V|)
        name = {"exact": "exact", "mg": "vMG8", "bm": "vBM"}[method]
        print(f"{name:8s} {res.iterations:5d} {dt:8.2f} {q:10.4f} "
              f"{score:6.3f} {ws/1e6:10.1f}MB")

    print("\nνMG8 ~= exact quality at O(k|V|) instead of O(|E|) memory — the "
          "paper's claim, reproduced.")
    # The MG fold runs on hand-written CUDA kernels (README "Fold
    # engines"): fold_backend="auto" picks the fused engine or the
    # streamed, windowed engine from the graph's entry volume.
    print(f"fold_backend='auto' resolves to {resolve_auto(graph.n_edges)!r} "
          f"for this graph ({graph.n_edges} entries).")


if __name__ == "__main__":
    main()
