"""The harness's ``correct`` against a broken timed path: a run driven on
the CPU at a small size (the look for a card skipped), with the program
broken underneath, has to come out not correct; the sound program, and
only it, correct. The control (the reference computed in bfloat16) in the
program's place is not correct either."""
import importlib
import time

import pytest
import torch

from conftest import TINY
from lpabench.bench import control, load_cell, run_cell

# the module, not the function the package re-exports under its name
lpa_mod = importlib.import_module("repro_torch.core.lpa")
CELLS = ["uk2002.mg8", "europe_osm.mg8", "europe_osm.mg8_pruned"]


def _run(name, detect_fn=None):
    cell = load_cell(name, False)
    cell.config["graph"].update(TINY[name.split(".")[0]])
    return run_cell(cell, 2**32 + 77, 0.0, False, time.perf_counter(),
                    device="cpu", detect_fn=detect_fn)


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    result = _run(name)
    assert result["correct"] and result["failed"] == 0
    assert list(result["checks"]) == ["labels_differ", "runs_differ"]


@pytest.mark.parametrize("name", CELLS)
def test_step_that_returns_its_state_unchanged(name, monkeypatch):
    def frozen(ws, labels, *args, **kwargs):
        return labels.clone(), torch.zeros_like(labels, dtype=torch.bool)

    monkeypatch.setattr(lpa_mod, "lpa_move", frozen)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_vertices_left_out(name, monkeypatch):
    move = lpa_mod.lpa_move

    def half(ws, labels, *args, **kwargs):
        new, _ = move(ws, labels, *args, **kwargs)
        cut = labels.numel() // 2
        new[cut:] = labels[cut:]
        return new, new != labels

    monkeypatch.setattr(lpa_mod, "lpa_move", half)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_it_is_produced(name):
    def altered(graph, config, ws):
        res = lpa_mod.lpa(graph, config, ws=ws, device="cpu")
        res.labels[graph.n_nodes // 3] += 1
        return res

    result = _run(name, altered)
    assert not result["correct"]
    assert result["checks"]["labels_differ"]["value"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_programs_place(name):
    cell = load_cell(name, False)
    assert not _run(name, control(cell, cell.config["control_dtype"]))[
        "correct"]
