"""The program's spans in a made-up Chrome trace, interleaved with the
benchmark's: device time by the innermost program span around each
launch, the idle time in gaps a host read's span overlaps, and the
benchmark's own reduction unchanged by the added spans; the reader of
the program's host-read counter."""
import json
import sys

from conftest import ROOT
from lpabench import program_spans, trace
from lpabench.metrics import host_reads_per_iter

RULES = json.loads((ROOT / "lpabench" / "layers.json").read_text())["rules"]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _ua(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 0.2, correlation=corr)


BENCH = [
    _ua("lpabench.detect", 0, 100),
    _ua("lpabench.move", 1, 60),
    _x("cpu_op", "aten::index_select", 2, 5), _launch(3, 1),
    _ua("lpabench.fold", 10, 30),
    _launch(11, 2),
    _x("cpu_op", "aten::where", 20, 5), _launch(21, 3),
    _x("cpu_op", "aten::ne", 45, 5), _launch(46, 4),
    _x("cpu_op", "aten::sum", 62.5, 0.4), _launch(63, 6),
    _ua("lpabench.marks", 65, 20),
    _x("cpu_op", "aten::scatter_reduce_", 66, 5), _launch(67, 5),
    _x("cpu_op", "aten::bitwise_or", 85.3, 0.5), _launch(85.5, 7),
    _x("cpu_op", "aten::item", 90, 9),
    _x("kernel", "indexSelectLargeIndex", 10, 10, tid=7, correlation=1),
    _x("kernel", "void mg_fused_select_kernel<8>", 20, 20, tid=7,
       correlation=2),
    _x("kernel", "elementwise_kernel", 40, 5, tid=7, correlation=3),
    _x("kernel", "elementwise_kernel", 50, 5, tid=7, correlation=4),
    _x("gpu_memcpy", "Memcpy DtoH", 64, 2, tid=7, correlation=6),
    _x("kernel", "scatter_kernel", 70, 10, tid=7, correlation=5),
    _x("kernel", "elementwise_kernel", 86, 2, tid=7, correlation=7),
]
PROGRAM = [
    _ua("lpa.detect", 0.5, 99), _ua("lpa.iter", 0.6, 98.6),
    _ua("lpa.gather", 1.5, 6.5),
    _ua("lpa.fold", 10.2, 29.6), _ua("lpa.fold.select", 10.5, 8.5),
    _ua("lpa.fold.epilogue", 19.5, 10.5),
    _ua("lpa.mask", 44, 6),
    _ua("lpa.read.mean", 62, 5),
    _ua("lpa.marks", 65.5, 18.5),
    _ua("lpa.read.count", 88, 11),
]


def test_device_time_by_innermost_program_span():
    s = program_spans.reduce(BENCH + PROGRAM, detections=1)
    want = {"lpa.gather": 10, "lpa.fold.select": 20,
            "lpa.fold.epilogue": 5, "lpa.mask": 5, "lpa.read.mean": 2,
            "lpa.marks": 10, "lpa.iter": 2}
    assert s.span_s.keys() == want.keys()
    for name, us in want.items():
        assert abs(s.span_s[name] - us * 1e-6) < 1e-12, name
    assert abs(s.ms("lpa.mask", "lpa.marks", "lpa.read.mean")
               - 17e-3) < 1e-9
    # the bare frontier update (2 of 54 us) is the only time no layer
    # span claims
    assert abs(s.layer_share() - (1 - 2 / 54)) < 1e-12


def test_sync_idle_is_the_gaps_a_read_overlaps():
    # gaps: [0,10] [45,50] [55,64] [66,70] [80,86] [88,100]; read.mean
    # [62,67] overlaps [55,64] and [66,70], read.count [88,99] overlaps
    # [88,100]: 9 + 4 + 12 us
    s = program_spans.reduce(BENCH + PROGRAM, detections=1)
    assert abs(s.sync_idle_s - 25e-6) < 1e-12
    assert program_spans.reduce(BENCH, 1).sync_idle_s == 0.0


def test_the_benchmark_reads_the_same_with_the_program_spans():
    bare = trace.summarise(BENCH, RULES, detections=1)
    spanned = trace.summarise(BENCH + PROGRAM, RULES, detections=1)
    assert spanned.layer_s == bare.layer_s
    assert spanned.ops_s == bare.ops_s
    assert (spanned.busy_s, spanned.window_s) == (bare.busy_s,
                                                  bare.window_s)
    assert abs(bare.busy_s - 54e-6) < 1e-12
    # the idle gap [80,86] in the host's Python now names the program's
    # span around it
    assert abs(bare.idle_s["marks:lpabench.marks"] - 6e-6) < 1e-12
    assert "marks:lpabench.marks" not in spanned.idle_s
    assert abs(spanned.idle_s["marks:lpa.marks"] - 6e-6) < 1e-12


def test_no_detection_span_reads_nothing():
    s = program_spans.reduce(PROGRAM, detections=1)
    assert s.span_s == {} and s.sync_idle_s == 0.0 and s.ms("lpa.mask") == 0


def test_host_reads_per_iter_reads_the_program_counter(monkeypatch):
    from repro_torch import trace as program
    monkeypatch.setattr(program, "DETECTIONS",
                        {"iterations": 12, "host_reads": 30})
    assert host_reads_per_iter.read(None) == 2.5
    monkeypatch.setattr(program, "DETECTIONS",
                        {"iterations": 0, "host_reads": 0})
    assert host_reads_per_iter.read(None) is None
    # a program without the counter (the module absent) reads as nothing
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert host_reads_per_iter.read(None) is None


def test_spancheck_rehearses_on_the_cpu():
    """The cross-check end to end at a tiny size on the CPU, where the
    trace has no device operations: a correct run of the cell, the
    program's reads by site, and both attributions empty alike."""
    from conftest import TINY
    from lpabench.bench import load_cell
    from lpabench.spancheck import check
    cell = load_cell("europe_osm.mg8_pruned", True)
    cell.config["graph"].update(TINY["europe_osm"])
    out = check(cell, 2**31 + 77, 0, device="cpu")
    assert out["correct"]
    assert len(out["untraced_s"]) == 1
    assert len(out["traced_s"]) == cell.traffic["trace_detections"]
    it = out["iterations"]
    assert out["host_reads"] == {"dense_rows": 1, "cap_rows": 1, "fit": it,
                                 "mean": it, "count": it}
    assert out["host_reads_per_iter"] == (2 + 3 * it) / it
    assert all(a == b == 0.0 for a, b in out["agree"].values())
    assert out["spans_per_detection"] > 10 * it
