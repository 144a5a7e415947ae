"""The trace's reduction, on a made-up Chrome trace: each device
operation's layer from its kernel, the benchmark span around its launch
and the aten op under it; the device's busy time as the union of its
operations; each idle gap labelled by what the host was doing."""
import json

from conftest import ROOT
from lpabench import trace

RULES = json.loads((ROOT / "lpabench" / "layers.json").read_text())["rules"]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_layers_busy_and_idle():
    ev = [
        _x("user_annotation", "lpabench.detect", 0, 100),
        _x("user_annotation", "lpabench.move", 1, 60),
        _x("cpu_op", "aten::index_select", 2, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
        _x("user_annotation", "lpabench.fold", 10, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=2),
        _x("cpu_op", "aten::where", 20, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3),
        _x("cpu_op", "aten::ne", 45, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 46, 1, correlation=4),
        _x("user_annotation", "lpabench.marks", 65, 20),
        _x("cpu_op", "aten::scatter_reduce_", 66, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 67, 1, correlation=5),
        _x("cpu_op", "aten::item", 90, 9),
        _x("kernel", "indexSelectLargeIndex", 10, 10, tid=7, correlation=1),
        _x("kernel", "void mg_fused_select_kernel<8>", 20, 20, tid=7,
           correlation=2),
        _x("kernel", "elementwise_kernel", 40, 5, tid=7, correlation=3),
        _x("kernel", "elementwise_kernel", 50, 5, tid=7, correlation=4),
        _x("kernel", "scatter_kernel", 70, 10, tid=7, correlation=5),
    ]
    s = trace.summarise(ev, RULES, detections=1)
    assert abs(s.window_s - 100e-6) < 1e-12
    assert abs(s.busy_s - 50e-6) < 1e-12
    assert abs(s.layer_s["gather"] - 10e-6) < 1e-12
    assert abs(s.layer_s["fold_kernels"] - 20e-6) < 1e-12
    assert abs(s.layer_s["fold_epilogue"] - 5e-6) < 1e-12
    assert abs(s.layer_s["frontier"] - 15e-6) < 1e-12
    assert abs(s.idle_s["detect:aten::item"] - 20e-6) < 1e-12
    assert "fold_kernels:mg_fused_select_kernel<8>" in s.ops_s
    assert trace.top(s.ops_s, 1)[0][0] == "fold_kernels:mg_fused_select_"\
        "kernel<8>"


def test_no_detection_span_reads_nothing():
    s = trace.summarise([_x("kernel", "k", 0, 5, correlation=1)], RULES, 1)
    assert s.busy_s == 0 and s.layer_s == {}
