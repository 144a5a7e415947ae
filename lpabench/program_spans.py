"""The program's own spans in a traced run: device time by the innermost
``lpa.*`` span around each operation's launch, and the device's idle
time behind the program's host reads.

The port marks its layers itself (``repro_torch.trace``): ``lpa.gather``,
``lpa.fold.epilogue``, ``lpa.marks``, ``lpa.read.<site>`` around each
value it reads back from the device, and so on, as ``record_function``
spans in the same Chrome trace as the kernels. :func:`reduce` reads them
from the events ``lpabench.trace`` reads, over the same window (the
benchmark's detection spans), so the two attributions can be held
against each other. A program without such spans reads as empty.
"""
from __future__ import annotations

import bisect
import dataclasses

from lpabench import trace

PREFIX = "lpa."
READ_PREFIX = PREFIX + "read."
#: program spans that are no layer: their device time is what no layer
#: span claims
NOT_LAYERS = ("lpa.detect", "lpa.iter", "lpa.move")


@dataclasses.dataclass
class ProgramSpans:
    """What the program's spans showed over the traced detections."""

    detections: int         # detections traced
    span_s: dict            # device seconds by innermost program span
    #                         around the launch ("" where none is open)
    sync_idle_s: float      # idle device seconds in gaps that overlap a
    #                         host read's span

    def ms(self, *names: str) -> float:
        """Device milliseconds per detection under any of ``names``."""
        if not self.detections:
            return 0.0
        return sum(self.span_s.get(n, 0.0) for n in names) \
            / self.detections * 1e3

    def layer_share(self) -> float:
        """The share of the device time launched inside the program's
        detections that a layer span claims (1.0 when there is none)."""
        inside = sum(v for k, v in self.span_s.items() if k)
        bare = sum(self.span_s.get(k, 0.0) for k in NOT_LAYERS)
        return 1.0 - bare / inside if inside else 1.0


def innermost(spans: list, times: list) -> list:
    """The name of the innermost of ``spans`` (one thread's program
    spans, which nest) open at each of ``times``, "" where none is."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    return [inner for _, _, inner in trace._contexts(spans, times)]


def reduce(events: list, detections: int) -> ProgramSpans:
    """Reduce a Chrome trace's events to :class:`ProgramSpans`."""
    ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in ev if e["name"] == trace.DETECT_SPAN]
    if not windows:
        return ProgramSpans(detections, {}, 0.0)
    t0 = min(e["ts"] for e in windows)
    t1 = max(e["ts"] + e["dur"] for e in windows)
    spans_by_tid: dict = {}
    for e in ev:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            spans_by_tid.setdefault(e["tid"], []).append(e)
    launches = {}
    for e in ev:
        if e.get("cat", "").startswith("cuda_"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    device = sorted((e for e in ev if e.get("cat") in trace.DEVICE_CATS
                     and t0 <= e["ts"] <= t1), key=lambda e: e["ts"])
    asked: dict = {}
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            asked.setdefault(launch["tid"], []).append((e, launch["ts"]))
    span_s: dict = {}
    for tid, qs in asked.items():
        names = innermost(spans_by_tid.get(tid, []), [t for _, t in qs])
        for (e, _), name in zip(qs, names):
            span_s[name] = span_s.get(name, 0.0) + e["dur"] * 1e-6
    # the gaps between the device's operations, as lpabench.trace
    # computes them; a gap counts whole when a read's span overlaps it:
    # the queue drained behind the read, and the relaunch after it
    gaps = []
    end = t0
    for e in device + [{"ts": t1, "dur": 0.0}]:
        s, f = e["ts"], min(e["ts"] + e["dur"], t1)
        if s > end:
            gaps.append((end, s))
        end = max(end, f)
    reads = sorted((e["ts"], e["ts"] + e["dur"]) for spans in
                   spans_by_tid.values() for e in spans
                   if e["name"].startswith(READ_PREFIX))
    starts = [s for s, _ in reads]
    ends = [f for _, f in reads]
    sync = 0.0
    for a, b in gaps:
        # reads run one after another on the loop's thread, so the last
        # one to start before the gap ends is the only one that can
        # still be open inside it
        j = bisect.bisect_left(starts, b) - 1
        if j >= 0 and ends[j] > a:
            sync += (b - a) * 1e-6
    return ProgramSpans(detections=detections, span_s=span_s,
                        sync_idle_s=sync)
