"""Hold the program's own spans against the benchmark's attribution, on
one cell at its size, and measure what the spans cost.

    python3 lpabench/spancheck.py --workload <cell> --seed <n> \\
        [--seconds 5] [--out <file.json>]

from the root of a checkout, on a card. One traced run of the cell
(``bench.run_cell`` with ``--trace 1``, its window ``--seconds`` long),
with each detection timed and its host reads kept, and the Chrome trace
that ``lpabench.trace.summarise`` reads also reduced by
``lpabench.program_spans.reduce``. Prints one JSON object: the pairs
that should agree, the readings of the program's spans (the marks, the
epilogue, the compaction, the idle behind host reads), the host reads by
site, the traced and untraced detection times, and the cost of a span
while the profiler is off.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() or "unknown"


def _span_off_cost(n: int = 200_000) -> float:
    """Seconds one ``span`` costs while the profiler is off: ``n`` empty
    spans less ``n`` empty loop turns."""
    from repro_torch.trace import span
    t = time.perf_counter()
    for _ in range(n):
        pass
    base = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        with span("gather"):
            pass
    return (time.perf_counter() - t - base) / n


def check(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """The check on ``device`` (the CPU only to rehearse it)."""
    import torch

    from lpabench import bench, program_spans, trace
    from repro_torch.core.lpa import lpa

    dev = torch.device(device)
    detections = []  # (traced, seconds, iterations, host reads by site)

    def detect(graph, config, ws):
        t = time.perf_counter()
        res = lpa(graph, config, ws=ws, device=dev)
        bench.sync(dev)
        detections.append((torch.autograd._profiler_enabled(),
                           time.perf_counter() - t, res.iterations,
                           res.host_reads))
        return res

    seen = {}
    summarise = trace.summarise

    def keep(events, rules, n):
        seen["spans"] = program_spans.reduce(events, n)
        seen["count"] = sum(1 for e in events if e.get("ph") == "X"
                            and e.get("cat") == "user_annotation"
                            and e["name"].startswith(program_spans.PREFIX))
        seen["summary"] = summarise(events, rules, n)
        return seen["summary"]

    trace.summarise = keep
    try:
        result = bench.run_cell(cell, seed, seconds, True,
                                time.perf_counter(), device=dev,
                                detect_fn=detect)
    finally:
        trace.summarise = summarise
    summary, spans = seen["summary"], seen["spans"]
    n_traced = summary.detections
    per = 1e3 / n_traced

    def layer_ms(name: str) -> float:
        return summary.layer_s.get(name, 0.0) * per

    paths = {(it, tuple(sorted(r.items()))) for _, _, it, r in detections}
    if len(paths) != 1:
        raise RuntimeError(f"the detections took different paths: {paths}")
    _, _, iterations, reads = detections[-1]
    # the first untraced detection is the warm-up
    plain_s = [s for traced, s, _, _ in detections if not traced][1:]
    traced_s = [s for traced, s, _, _ in detections if traced]
    return {
        "workload": cell.name, "seed": seed, "card": _card(),
        "correct": result["correct"], "checks": result["checks"],
        "iterations": iterations,
        "host_reads": reads,
        "host_reads_per_iter": sum(reads.values()) / iterations,
        "agree": {
            "gather_ms": [layer_ms("gather"), spans.ms("lpa.gather")],
            "frontier_ms": [layer_ms("frontier"),
                            spans.ms("lpa.mask", "lpa.marks",
                                     "lpa.read.mean")],
            "fold_epilogue": [layer_ms("fold_epilogue"),
                              spans.ms("lpa.fold.epilogue")],
            "fold_epilogue_with_compaction": [
                layer_ms("fold_epilogue"),
                spans.ms("lpa.fold.epilogue", "lpa.fold.compact")],
            "compaction": [layer_ms("compaction"),
                           spans.ms("lpa.fit", "lpa.read.fit")],
        },
        "layer_share": spans.layer_share(),
        "program": {
            "marks_ms": spans.ms("lpa.marks"),
            "epilogue_ms": spans.ms("lpa.fold.epilogue"),
            "compaction_ms": spans.ms("lpa.fit", "lpa.fold.compact"),
            "sync_idle_ms": spans.sync_idle_s * per,
            "span_ms": {k or "(none)": v * per
                        for k, v in sorted(spans.span_s.items(),
                                           key=lambda kv: -kv[1])},
        },
        "benchmark": {"layer_ms": {k: v * per for k, v
                                   in sorted(summary.layer_s.items())},
                      "idle_gaps": trace.top(summary.idle_s, 12),
                      "busy_s": summary.busy_s,
                      "window_s": summary.window_s,
                      "metrics": {k: v["value"] for k, v
                                  in result["metrics"].items()}},
        "spans_per_detection": seen["count"] / n_traced,
        "untraced_s": plain_s, "traced_s": traced_s,
        "untraced_median_s": (statistics.median(plain_s) if plain_s
                              else None),
        "traced_median_s": statistics.median(traced_s),
        "span_off_s": _span_off_cost(),
    }


def main(argv: list) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    from lpabench.bench import load_cell
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the check reads the card's trace",
              file=sys.stderr)
        return 2
    out = check(load_cell(args.workload, True), args.seed, args.seconds)
    text = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main(sys.argv[1:]))
