"""The program's spans and host-read counters (``repro_torch.trace``).

On the CPU: with the profiler off ``span`` is one shared null context; a
profiled detection, dense and pruned, exports the span tree (``lpa.detect``
around ``lpa.iter`` around the gather, fold, mask, marks and reads), and
every operation it runs has a layer span as its innermost program span; ``LPAResult.host_reads`` equals the count
worked out by hand; labels and histories are the same with the profiler
on and off.

Marked ``gpu`` (they skip without a CUDA device, decided inside the
``cuda`` fixture): over one detection on a graph of 2^16 vertices, dense
and pruned, the synchronising operations torch reports equal the
detection's ``host_reads``, and every device operation launched inside
``lpa.detect`` has a layer span as its innermost program span (read by
the benchmark's ``lpabench.program_spans``). On a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_trace.py``.
"""
import json
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lpabench import program_spans
from lpabench import trace as bench_trace
from repro_torch import trace
from repro_torch.core.lpa import LPAConfig, build_workspace, lpa
from repro_torch.graphs.generators import powerlaw_communities

SETTINGS = {"dense": {}, "pruned": {"frontier_gate": True,
                                    "frontier_sparse": True}}
#: a capacity every frontier fits, so that every pruned iteration on the
#: card is compacted
EVERY_ROW = 2**30


def _config(setting: str, **kw) -> LPAConfig:
    return LPAConfig(fold_backend="pallas_fused", **SETTINGS[setting], **kw)


def _events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _program_spans(events: list) -> list:
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(trace.PREFIX)]


def _same_run(a, b) -> None:
    assert torch.equal(a.labels, b.labels)
    assert (a.iterations, a.changed_history, a.frontier_history,
            a.work_rows_history, a.host_reads) == (
        b.iterations, b.changed_history, b.frontier_history,
        b.work_rows_history, b.host_reads)


@pytest.fixture(scope="module")
def small():
    """512 vertices folded in chunks of 16: two fold rounds, and with the
    default capacity the last two pruned iterations are compacted."""
    graph, _ = powerlaw_communities(512, p_in=0.5, mix=0.02, seed=1,
                                    device="cpu")
    return graph


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("iter"), trace.span("gather")
    assert a is b
    with a:
        pass
    trace.reset_host_reads()
    assert trace.host_read(torch.tensor(5), "test_site") == 5
    assert trace.host_read(lambda: torch.arange(3), "test_site") == [0, 1, 2]
    assert trace.HOST_READS == {"test_site": 2}


def test_span_on_names_the_span():
    with profile(activities=[ProfilerActivity.CPU]):
        s = trace.span("iter")
        assert (s.name, s.args) == ("lpa.iter", None)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_host_reads_counted_by_hand(small, setting):
    config = _config(setting, chunk=16)
    ws = build_workspace(small, config)
    rounds = len(ws.fused_plan.rounds)
    assert rounds == 2
    res = lpa(small, config, ws=ws, device="cpu")
    # one read a fold round for the dense row count and one for the
    # default capacity; one for the frontier's mean and one for the
    # changed count an iteration; the pruned loop adds one an iteration
    # for the fit of the frontier to the capacity
    want = {"dense_rows": rounds, "cap_rows": rounds,
            "mean": res.iterations, "count": res.iterations}
    if setting == "pruned":
        want["fit"] = res.iterations
        assert res.work_rows_history[-1] < res.work_rows_history[0]
    assert res.host_reads == want
    totals = dict(trace.DETECTIONS)
    again = lpa(small, config, ws=ws, device="cpu")
    assert trace.DETECTIONS == {
        "iterations": totals["iterations"] + again.iterations,
        "host_reads": totals["host_reads"] + sum(want.values())}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_profiled_detection_exports_the_span_tree(small, setting, tmp_path):
    config = _config(setting, chunk=16)
    ws = build_workspace(small, config)
    plain = lpa(small, config, ws=ws, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = lpa(small, config, ws=ws, device="cpu")
    _same_run(plain, traced)

    events = _events(prof, tmp_path)
    spans = _program_spans(events)
    (detect,) = [s for s in spans if s["name"] == "lpa.detect"]
    tid = detect["tid"]

    def inside(outer, name):
        return [s for s in spans if s["name"] == name and s["tid"] == tid
                and outer["ts"] <= s["ts"]
                and s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]]

    (init,) = inside(detect, "lpa.init")
    for name in ("lpa.read.dense_rows", "lpa.read.cap_rows"):
        assert len(inside(init, name)) == 2  # one a fold round
    iter_spans = inside(detect, "lpa.iter")
    assert len(iter_spans) == traced.iterations
    per_iter = ["lpa.gather", "lpa.fold", "lpa.fold.round",
                "lpa.fold.select", "lpa.fold.epilogue", "lpa.mask",
                "lpa.marks", "lpa.read.mean", "lpa.read.count"]
    if setting == "pruned":
        per_iter += ["lpa.fit", "lpa.read.fit"]
    for it in iter_spans:
        for name in per_iter:
            assert inside(it, name), (name, it["ts"])
    sparse = [w for w in traced.work_rows_history
              if w < traced.work_rows_history[0]]
    compact = [it for it in iter_spans if inside(it, "lpa.fold.compact")]
    assert len(compact) == len(sparse) == (2 if setting == "pruned" else 0)

    # every operation the detection runs (outermost aten op) has a layer
    # span as its innermost program span
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and e["tid"] == tid and detect["ts"] <= e["ts"]
                  <= detect["ts"] + detect["dur"]),
                 key=lambda e: (e["ts"], -e["dur"]))
    outermost, end = [], float("-inf")
    for e in ops:
        if e["ts"] >= end:
            outermost.append(e)
            end = e["ts"] + e["dur"]
    assert outermost
    mine = [sp for sp in spans if sp["tid"] == tid]
    inner = program_spans.innermost(mine, [e["ts"] for e in outermost])
    bare = [(e["name"], i) for e, i in zip(outermost, inner)
            if i in program_spans.NOT_LAYERS or not i]
    assert not bare, bare[:10]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the synchronisations and the "
                    "launches are the card's")
    return torch.device("cuda")


@pytest.fixture
def card_graph(cuda):
    """2^16 vertices in chunks of 128, with hubs: several fold rounds."""
    return powerlaw_communities(2**16, p_in=0.5, mix=0.02, seed=1,
                                device=cuda)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_every_card_sync_is_a_counted_host_read(card_graph, setting):
    config = _config(setting, frontier_cap_rows=(
        EVERY_ROW if setting == "pruned" else None))
    ws = build_workspace(card_graph, config)
    lpa(card_graph, config, ws=ws)  # builds the kernels, warms the caches
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = lpa(card_graph, config, ws=ws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == sum(res.host_reads.values()), (
        res.host_reads, [str(w.message) for w in syncs][:5])
    if setting == "pruned":  # every iteration compacted
        assert res.host_reads["fit"] == res.iterations


@pytest.mark.gpu
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_every_card_launch_has_a_layer_span(card_graph, setting, tmp_path):
    config = _config(setting, frontier_cap_rows=(
        EVERY_ROW if setting == "pruned" else None))
    ws = build_workspace(card_graph, config)
    plain = lpa(card_graph, config, ws=ws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(bench_trace.DETECT_SPAN):
            traced = lpa(card_graph, config, ws=ws)
            torch.cuda.synchronize()
    _same_run(plain, traced)
    spans = program_spans.reduce(_events(prof, tmp_path), detections=1)
    for name in ("lpa.gather", "lpa.fold.select", "lpa.fold.epilogue",
                 "lpa.mask", "lpa.marks"):
        assert spans.span_s.get(name, 0.0) > 0.0, (name, spans.span_s)
    if setting == "pruned":
        assert spans.span_s.get("lpa.fold.compact", 0.0) > 0.0
    bare = {k: v for k, v in spans.span_s.items()
            if k in program_spans.NOT_LAYERS or not k}
    assert not bare and spans.layer_share() == 1.0, bare
