"""The harness: one run of one cell.

Everything particular to a cell is data that this module finds by name:
the cell in ``BENCHMARK.json``, its configuration (``configs/<name>.json``:
the graph's generator and parameters, the ``LPAConfig`` fields), its
traffic mix (``traffic/<name>.json``: the fields it sets on top, and how
many detections to trace), and one reader per metric
(``metrics/<name>.py``, ``read(run) -> float | None``).

A run: make the graph on the device from the seed; build the program's
workspace (``build_workspace``); warm up with one detection; then run
detections one after another on the resident graph, each ended by a
synchronise, for ``--seconds``. With ``--trace 1`` the first detections
of the window run under the profiler. Once the window has closed, the
program's state is freed and the plain reference runs the detection
again on the same arrays; every detection's iterations and histories,
and the labels of two of them (one drawn from the seed, and the last),
are held to it.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from lpabench import trace as trace_lib
from lpabench import yardstick
from lpabench.gen import make_graph
from lpabench.reference.lpa import detect as reference_detect

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    metrics: list           # the BENCHMARK.json entries this cell reports

    def lpa_fields(self) -> dict:
        return {**self.config["lpa"], **self.traffic["lpa"]}


def reports(metric: dict, cell: str) -> bool:
    """Does ``cell`` report ``metric``?"""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, trace: bool, spec: Optional[dict] = None) -> Cell:
    """Find cell ``name`` and read its files; the metrics are its
    per-layer ones with ``trace``, else its end-to-end ones."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    kind = "per_layer" if trace else "end_to_end"
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                metrics=[m for m in spec[kind] if reports(m, name)])


@dataclasses.dataclass
class Record:
    """One detection of the window, as the program reported it."""

    seconds: float          # host clock, launch to synchronise
    iterations: int
    changed: tuple
    frontier: tuple
    work_rows: int          # fold rows computed over the detection
    traced: bool            # ran under the profiler

    @classmethod
    def of(cls, res, seconds: float = 0.0, traced: bool = False):
        """The record of an ``LPAResult``, or of the reference's
        ``Detection`` (which counts no fold rows)."""
        return cls(seconds=seconds, iterations=res.iterations,
                   changed=tuple(res.changed_history),
                   frontier=tuple(res.frontier_history),
                   work_rows=int(sum(getattr(res, "work_rows_history", ()))),
                   traced=traced)


@dataclasses.dataclass
class Run:
    """What a metric reader may read: one run of one cell."""

    cell: Cell
    device_kind: str
    setup_s: float          # process start to the window's start
    plan_s: float           # build_workspace, host clock
    resident_bytes: int     # allocated once the workspace is built
    peak_bytes: int         # allocator peak from before build_workspace on
    window_peak_bytes: int  # allocator peak over the window alone
    dense_rows: int         # the program's fold rows of a dense iteration
    window_s: float         # untraced detections' span, host clock
    records: list           # [Record], in order
    trace: Optional[trace_lib.TraceSummary]
    fold_bytes: float       # yardstick bytes per detection: the fold
    detect_bytes: float     # yardstick bytes per detection: everything

    @property
    def untraced(self) -> list:
        return [r for r in self.records if not r.traced]


def info(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(run: Run, entries: list) -> dict:
    """Each metric's reader, found by name; a reader that finds nothing
    returns None and its metric is left out."""
    out = {}
    for m in entries:
        reader = importlib.import_module(f"lpabench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def compare(records: list, sampled: list, ref) -> tuple[dict, int]:
    """The numbers compared: vertices whose label differs from the
    reference's, the most over the sampled detections; and detections
    whose iterations, changed counts or frontier fractions differ from
    the reference's. Returns (numbers, detections that failed either)."""
    bad = {i for i, r in enumerate(records)
           if (r.iterations, list(r.changed), list(r.frontier))
           != (ref.iterations, ref.changed_history, ref.frontier_history)}
    runs_differ = len(bad)
    labels_differ = 0
    for idx, labels in sampled:
        diff = int((labels.to(ref.labels.device) != ref.labels).sum())
        labels_differ = max(labels_differ, diff)
        if diff:
            bad.add(idx)
    return ({"labels_differ": labels_differ, "runs_differ": runs_differ},
            len(bad))


def reference(cell: Cell, arrays: tuple, dtype: str, observe=None):
    """The plain reference's detection of ``cell``'s traffic on the graph
    ``arrays`` (offsets, indices, weights), its sums in ``dtype``."""
    f = cell.lpa_fields()
    return reference_detect(
        *arrays, k=f["k"], chunk=f["chunk"], rho=f["rho"], tau=f["tau"],
        max_iters=f["max_iters"], gate=f.get("frontier_gate", False),
        track_frontier=f.get("track_frontier", True),
        value_dtype=getattr(torch, dtype), observe=observe)


def control(cell: Cell, dtype: str):
    """A ``detect_fn`` that puts the reference, its sums in ``dtype``, in
    the program's place."""
    return lambda g, c, w: reference(
        cell, (g.offsets, g.indices, g.weights), dtype)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, detect_fn=None) -> dict:
    """One run; returns the result line's object. ``detect_fn(graph,
    config, ws)`` replaces the program's ``lpa`` (the tests put faults
    and controls there)."""
    from repro_torch.core.lpa import LPAConfig, build_workspace, lpa
    from repro_torch.graphs.csr import CSRGraph

    dev = torch.device("cuda" if device is None else device)
    detect = detect_fn if detect_fn is not None else (
        lambda g, c, w: lpa(g, c, ws=w, device=dev))
    conf = cell.config
    t0 = time.perf_counter()
    offsets, indices, weights = make_graph(conf["generator"], conf["graph"],
                                           seed, dev)
    sync(dev)
    n, m = offsets.numel() - 1, indices.numel()
    info(f"graph: {n} vertices, {m} slots, made in "
         f"{time.perf_counter() - t0:.3f} s")
    config = LPAConfig(**cell.lpa_fields())
    graph = CSRGraph(offsets=offsets, indices=indices, weights=weights,
                     n_nodes=n, n_edges=m)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ws = build_workspace(graph, config)
    sync(dev)
    plan_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated(dev) if cuda else 0
    dense_rows = ws.bundle.dense_work_rows()
    detect(graph, config, ws)  # warm-up: loads the kernels, every shape
    sync(dev)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    rng = np.random.default_rng(seed)
    records: list = []
    pick = None  # the window's detection whose labels are kept to check
    kept = None  # its (index, labels), copied to the host
    last = None  # the newest detection's (index, labels)

    def one(traced: bool) -> None:
        nonlocal pick, kept, last
        # no labels of the benchmark's stay on the card over a detection,
        # so that the peak is the program's alone
        last = None
        t = time.perf_counter()
        res = detect(graph, config, ws)
        sync(dev)
        took = time.perf_counter() - t
        records.append(Record.of(res, took, traced))
        idx = len(records) - 1
        if pick is None and not traced:
            # drawn from the seed over the detections the window will hold
            pick = idx + int(rng.integers(max(1, int(seconds / took))))
        if idx == pick:
            kept = (idx, res.labels.cpu())
        last = (idx, res.labels)

    summary = None
    n_traced = int(cell.traffic["trace_detections"]) if trace else 0
    if n_traced:
        summary = trace_lib.profile(lambda: one(True), n_traced)
    t_w = time.perf_counter()
    one(False)
    while time.perf_counter() - t_w < seconds:
        one(False)
    window_s = time.perf_counter() - t_w
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peak = max(setup_peak, window_peak)
    info(f"window: {len(records)} detections in {window_s:.3f} s; "
         f"iterations {sorted({r.iterations for r in records})}; "
         f"set-up {setup_s:.3f} s (plan {plan_s:.3f} s)")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded by the window: {found}")
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    # the program's state goes before the reference runs
    sampled = [last] if kept is None or kept[0] == last[0] else [kept, last]
    del ws, graph
    if cuda:
        torch.cuda.empty_cache()
    degrees = (offsets[1:] - offsets[:-1]).to(torch.int64)
    fold_b, det_b = [], []

    def observe(it: int, active: torch.Tensor) -> None:
        d = degrees[active]
        fold_b.append(yardstick.fold_bytes(d))
        det_b.append(yardstick.iteration_bytes(n, int(d.sum())))

    t_ref = time.perf_counter()
    ref = reference(cell, (offsets, indices, weights),
                    conf["value_dtype"], observe)
    info(f"reference: {ref.iterations} iterations in "
         f"{time.perf_counter() - t_ref:.3f} s, changed "
         f"{ref.changed_history}")
    numbers, failed = compare(records, sampled, ref)
    limits = load_json(HERE / "limits.json")
    correct = all(numbers[k] <= limits[k] for k in numbers)

    run = Run(cell=cell, device_kind=kind, setup_s=setup_s, plan_s=plan_s,
              resident_bytes=resident, peak_bytes=peak,
              window_peak_bytes=window_peak,
              dense_rows=dense_rows, window_s=window_s, records=records,
              trace=summary, fold_bytes=float(sum(fold_b)),
              detect_bytes=float(sum(det_b)))
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = summary.busy_s if summary else 0.0
        device_info["window_s"] = summary.window_s if summary else 0.0
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": int(failed),
              "metrics": read_metrics(run, cell.metrics),
              "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": trace_lib.top(summary.ops_s),
                               "idle_gaps": trace_lib.top(summary.idle_s)}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in numbers}
    return result


def parse_args(argv: list) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list, t_start: float) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
