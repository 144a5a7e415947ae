"""Where the GNN serving and training paths' time goes on the card.

Runs the forwards of ``chip_smoke.py`` phase 7 on the cells of
``repro_torch.launch.serve``, which phase 7 drives too: PNA,
MeshGraphNet and EGNN at FULL width on the full-graph batch of the 2^18
graph (7b), PNA FULL on one ``minibatch_lg`` batch sampled from the 2^22
graph (7c) and Equiformer-v2 and EGNN FULL on the ``molecule`` cell (7d).
For each: the forward's time as phase 7 takes it (two warm-up forwards
under ``torch.inference_mode()``, the median of five between CUDA
events), then one forward under ``torch.profiler`` (CPU and CUDA
activities). It prints the kernels'
summed device time, its share of the event-timed forward (the device's
busy share; one less it is the idle share, the time the card waits on
the host), the kernel count, the device time by kernel class (matmul,
scatter, gather, copy, elementwise and reductions), the five longest
kernels and the eight operators whose kernels take longest.

Then one train step of phase 8's cells (``repro_torch.launch.
train_cells``): PNA FULL on the 2^18 graph, PNA and MeshGraphNet FULL on
a ``minibatch_lg`` tree batch, Equiformer-v2 FULL on ``molecule`` and
DCN-v2 FULL on ``train_batch`` (its tables drawn on a CUDA generator, as
phase 8e draws them). Each step is timed as phase 8 times it (the median
of two steps after one warm-up, CUDA events), then its two halves are
profiled apart: the loss's forward and backward
(``train.steps.value_and_grad``) and the AdamW update
(``optim.adamw.adamw_update``), each with the summary above against its
own event-timed span.

Usage, on a machine with a CUDA card::

    python3 scripts/gnn_profile.py [--skip-minibatch] [--out FILE]

Prints the card's name and power limit first. Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: kernel class by the first pattern its name matches
CLASSES = (("matmul", re.compile(r"gemm|cutlass|sm90_|ampere_|mma", re.I)),
           # index_add_ runs indexFuncSmallIndex / indexFuncLargeIndex
           ("scatter", re.compile(r"scatter|indexFunc|atomic|put_", re.I)),
           ("gather", re.compile(r"index|gather|take", re.I)),
           ("copy", re.compile(r"copy|cat|memcpy|memset|fill", re.I)),
           ("elementwise and reductions", re.compile(r".")))


def _classify(name: str) -> str:
    return next(c for c, pat in CLASSES if pat.search(name))


def _summary(prof, wall_ms: float) -> dict:
    """The profiled span's kernels against its event-timed ``wall_ms``."""
    import torch
    # the kernels' own rows (an operator's row repeats its kernels' time)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0]
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if e.device_type != cuda and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in kernels)
    by_class: dict = {}
    for name, ms, _ in kernels:
        by_class[_classify(name)] = by_class.get(_classify(name), 0.0) + ms
    return {"forward_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "kernel_launches": sum(n for _, _, n in kernels),
            "by_class_ms": dict(sorted(by_class.items(),
                                       key=lambda kv: -kv[1])),
            "top": [(name[:90], ms, n) for name, ms, n in
                    sorted(kernels, key=lambda k: -k[1])[:5]],
            "top_ops": sorted(ops, key=lambda k: -k[1])[:8]}


def _profiled(fn):
    """(fn's result, its ms between CUDA events, the profiler) of one
    call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    return out, start.elapsed_time(end), prof


def _profile(apply, model, batch) -> dict:
    import torch
    from repro_torch.launch.serve import serve
    forward_ms = serve(apply, model, [batch])["ms"][0]
    with torch.inference_mode():
        _, _, prof = _profiled(lambda: apply(model, batch))
    return _summary(prof, forward_ms)


def _profile_train(plan, batch, generator) -> dict:
    """One train step of ``plan`` timed as phase 8 times it, then its
    forward and backward, and its AdamW update, profiled apart."""
    from repro_torch.launch.train_cells import train_steps
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train.steps import value_and_grad
    model = plan.init(generator)
    r = train_steps(plan.fn, model, adamw_init(model), [batch] * 3)
    model, opt = r["model"], r["opt"]
    (_, grads), fb_ms, fb_prof = _profiled(
        lambda: value_and_grad(plan.loss, model, batch))
    lr = cosine_schedule(opt["step"], 3e-4, 100, 10000)
    _, opt_ms, opt_prof = _profiled(
        lambda: adamw_update(grads, opt, model, lr))
    return {"step_ms": r["median_ms"], "peak_bytes": r["peak_bytes"],
            "forward_backward": _summary(fb_prof, fb_ms),
            "adamw": _summary(opt_prof, opt_ms)}


def _report(tag: str, what: str, r: dict,
            timed: str = "forward {:.3f} ms (median of 5)") -> None:
    print(f"{tag} {what}: {timed.format(r['forward_ms'])}, "
          f"kernels {r['device_ms']:.3f} ms device time over "
          f"{r['kernel_launches']} launches, busy share "
          f"{r['busy_share']:.3f}; by class "
          + ", ".join(f"{c} {ms:.3f}" for c, ms in r["by_class_ms"].items())
          + "; longest: "
          + "; ".join(f"{name} {ms:.3f} ms x{n}" for name, ms, n in r["top"])
          + "; by operator: "
          + ", ".join(f"{name} {ms:.3f} x{n}" for name, ms, n in
                      r["top_ops"]), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--skip-minibatch", action="store_true",
                        help="skip 7c (its 2^22 graph takes ~30 s to make)")
    parser.add_argument("--out", default=None,
                        help="also write the results as JSON here")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gnn_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import dcn_batch
    from repro_torch.graphs.generators import powerlaw_communities
    from repro_torch.launch.serve import (EXAMPLE, MINIBATCH, MOLECULE,
                                          cell_config, example_batch,
                                          example_graph, gnn_model,
                                          minibatch_batch,
                                          molecule_cell_batch)
    from repro_torch.launch.train_cells import (example_plan, registry_cell,
                                                train_plan, tree_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{smi}]"
    print(smi, flush=True)
    out = {"device": smi}

    def run(cell, arch, d_feat, batch):
        model, apply = gnn_model(arch, cell_config(arch, d_feat))
        r = _profile(apply, model, batch)
        _report(tag, f"{cell}, {arch} FULL", r)
        out[f"{cell}/{arch}"] = r

    g = example_graph()
    batch = example_batch(g)
    for arch in ("pna", "meshgraphnet", "egnn"):
        run(f"2^{EXAMPLE['scale']} full graph", arch, EXAMPLE["d_feat"],
            batch)
    del g, batch
    mol = molecule_cell_batch()
    for arch in ("equiformer-v2", "egnn"):
        run("molecule", arch, MOLECULE["d_feat"], mol)
    graph = None
    if not args.skip_minibatch:
        t0 = time.perf_counter()
        graph, _ = powerlaw_communities(1 << MINIBATCH["scale"], p_in=0.5,
                                        mix=0.02, seed=1)
        print(f"{tag} 2^{MINIBATCH['scale']} graph made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        run("minibatch_lg", "pna", MINIBATCH["d_feat"],
            minibatch_batch(graph, 0))

    def train(what, plan, batch, generator=None):
        r = _profile_train(plan, batch, generator
                           or torch.Generator().manual_seed(0))
        print(f"{tag} {what}: train step {r['step_ms']:.3f} ms (median of "
              f"2 after 1 warm-up), peak {r['peak_bytes']} B", flush=True)
        _report(tag, f"{what}, forward + backward", r["forward_backward"],
                "{:.3f} ms (one profiled call)")
        _report(tag, f"{what}, AdamW update", r["adamw"],
                "{:.3f} ms (one profiled call)")
        out[f"train/{what}"] = r
        torch.cuda.empty_cache()

    g = example_graph()
    train(f"2^{EXAMPLE['scale']} full graph, pna FULL",
          example_plan("pna", g), example_batch(g))
    del g
    if graph is not None:
        trees = tree_batch(graph, 0)
        for arch in ("pna", "meshgraphnet"):
            train(f"minibatch_lg trees, {arch} FULL",
                  train_plan(arch, "minibatch_lg"), trees)
        del trees, graph
    train("molecule, equiformer-v2 FULL",
          train_plan("equiformer-v2", "molecule"), mol)
    cfg = get_arch("dcn-v2").config
    rows = registry_cell("dcn-v2", "train_batch").params["batch"]
    train("dcn-v2 FULL, train_batch", train_plan("dcn-v2", "train_batch"),
          dcn_batch(0, 0, rows, cfg.n_dense, cfg.n_sparse,
                    cfg.vocab_sizes),
          torch.Generator(device="cuda").manual_seed(0))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
