"""The traced detections: spans from the benchmark's own wrappers, the
profiler's device trace, and the attribution of each device operation to
a layer.

``layers.json`` is data. Its ``spans`` name functions of the program that
are wrapped in a ``record_function`` span while the traced detections
run (and only then); its ``rules``, first match first, give each device
operation a layer from the kernel's name, the innermost benchmark span
around its launch, and the outermost aten op under that span. The
profiler's Chrome trace is read back: a kernel is tied to its launch by
the correlation id, and the launch to the host events that enclose it on
its thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import os
import tempfile
from pathlib import Path
from typing import Callable

import torch

LAYERS = Path(__file__).resolve().parent / "layers.json"
SPAN_PREFIX = "lpabench."
DETECT_SPAN = SPAN_PREFIX + "detect"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class TraceSummary:
    """What the traced detections showed."""

    detections: int         # detections traced
    window_s: float         # first detection's start to the last one's end
    busy_s: float           # seconds with a device operation running
    layer_s: dict           # device seconds by layer
    ops_s: dict             # device seconds by "layer:operation"
    idle_s: dict            # idle device seconds by what the host did


def _resolve(target: str):
    """'module:Attr.attr' -> (owner object, attribute name)."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, name = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name


@contextlib.contextmanager
def spans(table: dict):
    """Wrap each of ``table['spans']`` in a ``record_function`` span named
    ``lpabench.<name>``; restore the originals on exit."""
    saved = []
    try:
        for span in table["spans"]:
            owner, name = _resolve(span["target"])
            fn = getattr(owner, name)
            label = SPAN_PREFIX + span["name"]

            def wrapped(*args, __fn=fn, __label=label, **kwargs):
                with torch.profiler.record_function(__label):
                    return __fn(*args, **kwargs)

            saved.append((owner, name, fn))
            setattr(owner, name, functools.wraps(fn)(wrapped))
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def profile(detect: Callable[[], None], n: int) -> TraceSummary:
    """Run ``detect`` ``n`` times under the profiler, each inside the
    ``lpabench.detect`` span, with the program's functions wrapped, and
    summarise the trace."""
    table = json.loads(LAYERS.read_text())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with spans(table), torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            with torch.profiler.record_function(DETECT_SPAN):
                detect()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return summarise(events, table["rules"], n)


def _layer(rules: list, kernel: str, span: str, op: str) -> str:
    for r in rules:
        if ("kernel" in r and r["kernel"] not in kernel):
            continue
        if ("span" in r and r["span"] != span):
            continue
        if ("op" in r and r["op"] != op):
            continue
        return r["layer"]
    return "other"


def _short(name: str) -> str:
    name = name.removeprefix("void ")
    return name[:80]


def _contexts(host: list, times: list) -> list:
    """For each time in ``times``, (innermost benchmark span, outermost
    aten op under it, innermost host event) around it on one thread.
    ``host`` is that thread's events sorted by start (outer first on a
    tie); events on one thread nest, so one sweep with a stack serves
    every time."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [("", "", "")] * len(times)
    stack: list = []
    i = 0
    for q in order:
        ts = times[q]
        while i < len(host) and host[i]["ts"] <= ts:
            e = host[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < ts:
            stack.pop()
        span = op = inner = ""
        for e in stack:
            inner = e["name"]
            if inner.startswith(SPAN_PREFIX):
                span, op = inner[len(SPAN_PREFIX):], ""
            elif e["cat"] == "cpu_op" and not op:
                op = inner
        out[q] = (span, op, inner)
    return out


def summarise(events: list, rules: list, detections: int) -> TraceSummary:
    """Reduce a Chrome trace's events to a :class:`TraceSummary`."""
    ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in ev if e["name"] == DETECT_SPAN]
    if not windows:
        return TraceSummary(detections, 0.0, 0.0, {}, {}, {})
    t0 = min(e["ts"] for e in windows)
    t1 = max(e["ts"] + e["dur"] for e in windows)
    main_tid = windows[0]["tid"]
    host_by_tid: dict = {}
    for e in ev:
        if e.get("cat") in HOST_CATS:
            host_by_tid.setdefault(e["tid"], []).append(e)
    for hs in host_by_tid.values():
        hs.sort(key=lambda e: (e["ts"], -e["dur"]))
    # host-side CUDA API calls (cuda_runtime, and the lower-level API a
    # Triton launch goes through), keyed by the id their kernels carry
    launches = {}
    for e in ev:
        if e.get("cat", "").startswith("cuda_"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    device = sorted((e for e in ev if e.get("cat") in DEVICE_CATS
                     and t0 <= e["ts"] <= t1), key=lambda e: e["ts"])
    # each device operation's launch, grouped by the launching thread
    asked: dict = {}
    for j, e in enumerate(device):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            asked.setdefault(launch["tid"], []).append((j, launch["ts"]))
    where = [("", "", "")] * len(device)
    for tid, qs in asked.items():
        found = _contexts(host_by_tid.get(tid, []), [t for _, t in qs])
        for (j, _), ctx in zip(qs, found):
            where[j] = ctx
    layer_s: dict = {}
    ops_s: dict = {}
    for e, (span, op, _) in zip(device, where):
        layer = _layer(rules, e["name"], span, op)
        sec = e["dur"] * 1e-6
        layer_s[layer] = layer_s.get(layer, 0.0) + sec
        key = f"{layer}:{_short(e['name'])}"
        ops_s[key] = ops_s.get(key, 0.0) + sec
    # the device's busy time is the union of its operations' intervals;
    # each gap between them is labelled by what the main thread was doing
    busy = 0.0
    gaps = []
    end = t0
    for e in device + [{"ts": t1, "dur": 0.0}]:
        s, f = e["ts"], min(e["ts"] + e["dur"], t1)
        if s > end:
            gaps.append((end, s))
        if f > end:
            busy += (f - max(s, end)) * 1e-6
            end = f
    idle_s: dict = {}
    found = _contexts(host_by_tid.get(main_tid, []),
                      [(a + b) / 2 for a, b in gaps])
    for (a, b), (span, _, inner) in zip(gaps, found):
        key = f"{span or 'outside'}:{inner or 'idle'}"
        idle_s[key] = idle_s.get(key, 0.0) + (b - a) * 1e-6
    return TraceSummary(detections=detections, window_s=(t1 - t0) * 1e-6,
                        busy_s=busy, layer_s=layer_s, ops_s=ops_s,
                        idle_s=idle_s)


def top(table: dict, n: int = 10) -> list:
    """The ``n`` largest entries of a {name: seconds} table, largest
    first, as [name, seconds] pairs."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]

