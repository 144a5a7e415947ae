"""Aggregate the port's dry-run JSON records (``launch.dryrun``) into
the reference's roofline table.

A copy of ``repro.launch.report`` over the port's records, the LM,
GNN, recsys and LPA cells' in one table per mesh: the same table, with
the fit threshold at an H100's 80 GB, and a summary that counts the
cells built (the port compiles nothing).

  PYTHONPATH=src python -m repro_torch.launch.report \\
      --results launch_results_torch/dryrun --mesh single_pod_16x16
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load", "fmt_s", "roofline_table", "summary", "main"]


def load(root, mesh):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, mesh, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        out[(d["arch"], d["shape"])] = d
    return out


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.2f}ms"


def roofline_table(recs, baseline=None):
    lines = [
        "| arch | shape | peak/dev | compute | memory | collective |"
        " bottleneck | t_lb | useful | t_lb baseline |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), d in sorted(recs.items()):
        if not d.get("ok"):
            lines.append(f"| {arch} | {shape} | FAILED: "
                         f"{d.get('error', '?')[:60]} | | | | | | |")
            continue
        r = d["roofline"]
        u = d.get("useful_flops_ratio")
        base = ""
        if baseline:
            b = baseline.get((arch, shape))
            if b and b.get("ok"):
                bt = b["roofline"]["step_time_lb_s"]
                cur = r["step_time_lb_s"]
                base = (f"{fmt_s(bt)}"
                        + (f" ({bt/cur:.1f}x)" if cur > 0 and bt / max(cur, 1e-12) >= 1.05
                           else ""))
        lines.append(
            f"| {arch} | {shape} | {d['memory']['peak_bytes_per_device']/1e9:.2f}GB"
            f" | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])}"
            f" | {fmt_s(r['collective_s'])} | {r['bottleneck']}"
            f" | {fmt_s(r['step_time_lb_s'])}"
            f" | {'-' if u is None else f'{u:.2f}'} | {base} |")
    return "\n".join(lines)


def summary(recs):
    ok = sum(1 for d in recs.values() if d.get("ok"))
    fits = sum(1 for d in recs.values()
               if d.get("ok") and d["memory"]["fits_80g_hbm"])
    return f"{ok}/{len(recs)} cells built; {fits}/{ok} fit 80 GB HBM/chip"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="launch_results_torch/dryrun")
    ap.add_argument("--baseline", default="launch_results_torch/baseline")
    ap.add_argument("--mesh", default="single_pod_16x16")
    args = ap.parse_args(argv)
    recs = load(args.results, args.mesh)
    base = load(args.baseline, args.mesh) if args.baseline else None
    print(summary(recs))
    print()
    print(roofline_table(recs, base))


if __name__ == "__main__":
    main()
