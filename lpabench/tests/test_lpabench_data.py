"""``BENCHMARK.json`` and every file it names: the keys and limits of the
benchmark's contract, a configuration, traffic and reader file for each
name, and for each per-layer metric its layer (as ``PERF.md`` lists it)
and the one end-to-end metric it moves, reported by every cell that
reports the per-layer metric."""
import importlib
import json
import re

import pytest

from conftest import ROOT
from lpabench.bench import reports

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in SPEC["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_are_unique_and_well_formed():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in SPEC[k]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert _line(conf["source"]) and _line(conf["why"])
    assert any(conf["file"].startswith(p + "/") for p in SPEC["paths"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"]
    assert len(conf["reduced"]) <= 16
    assert all(NAME.match(k) for k in conf["reduced"])
    importlib.import_module(f"lpabench.gen.{data['generator']}")
    for key in ("graph", "lpa", "value_dtype", "control_dtype", "assumed"):
        assert key in data
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    assert NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    traffic = json.loads((ROOT / "lpabench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert "lpa" in traffic and traffic["trace_detections"] >= 1
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if reports(m, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell["name"]) for m in SPEC["per_layer"])


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    e2e = metric in SPEC["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if e2e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    reader = importlib.import_module(f"lpabench.metrics.{metric['name']}")
    assert callable(reader.read)


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_names_its_layer_and_what_it_moves(metric):
    assert _line(metric["layer"])
    assert f"`{metric['layer']}`" in (ROOT / "PERF.md").read_text()
    moved = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
    for cell in CELLS:
        if reports(metric, cell):
            assert reports(moved, cell), (metric["name"], cell)
    same = {m["layer"] for m in SPEC["per_layer"]
            if m["layer"].lower() == metric["layer"].lower()}
    assert len(same) == 1


def test_every_cell_has_a_bound_on_setup():
    setup = {m["name"]: m for m in SPEC["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25
