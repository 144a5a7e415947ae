"""The plain reference against the program, on the CPU at small sizes:
every label and every history of a detection equal, dense and gated with
the sparse compaction, with one fold round and with several. Then the
control: the reference computed in bfloat16 is told apart. A test marked
``gpu`` does the same on the card at a larger size."""
import json

import pytest
import torch

from conftest import ROOT, TINY
from lpabench.bench import Record, compare
from lpabench.gen import make_graph
from lpabench.reference.lpa import detect
from repro_torch.core.lpa import LPAConfig, lpa
from repro_torch.graphs.csr import CSRGraph

CELLS = [("uk2002", "mg8"), ("europe_osm", "mg8"),
         ("europe_osm", "mg8_pruned"), ("uk2002", "mg8_pruned")]


def _fields(config, traffic, **change):
    conf = json.loads((ROOT / "lpabench" / "configs" / f"{config}.json")
                      .read_text())
    tr = json.loads((ROOT / "lpabench" / "traffic" / f"{traffic}.json")
                    .read_text())
    return conf, {**conf["lpa"], **tr["lpa"], **change}


def _program_and_reference(config, traffic, graph_params, device, seed,
                           **change):
    conf, f = _fields(config, traffic, **change)
    conf["graph"].update(graph_params)
    o, i, w = make_graph(conf["generator"], conf["graph"], seed, device)
    g = CSRGraph(offsets=o, indices=i, weights=w, n_nodes=o.numel() - 1,
                 n_edges=i.numel())
    got = lpa(g, LPAConfig(**f), device=device)
    ref = detect(o, i, w, k=f["k"], chunk=f["chunk"], rho=f["rho"],
                 tau=f["tau"], max_iters=f["max_iters"],
                 gate=f["frontier_gate"], track_frontier=f["track_frontier"])
    return got, ref, (o, i, w), f


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("config,traffic", CELLS)
def test_reference_equals_program(config, traffic, chunk):
    got, ref, _, _ = _program_and_reference(config, traffic, TINY[config],
                                            "cpu", 2**33 + 1, chunk=chunk)
    numbers, failed = compare([Record.of(got)], [(0, got.labels)], ref)
    assert numbers == {"labels_differ": 0, "runs_differ": 0}
    assert failed == 0
    assert got.converged == ref.converged


@pytest.mark.parametrize("config,traffic", CELLS[:3])
def test_control_in_bfloat16_is_told_apart(config, traffic):
    got, ref, arrays, f = _program_and_reference(config, traffic,
                                                 TINY[config], "cpu", 99)
    low = detect(*arrays, k=f["k"], chunk=f["chunk"], rho=f["rho"],
                 tau=f["tau"], max_iters=f["max_iters"],
                 gate=f["frontier_gate"], track_frontier=f["track_frontier"],
                 value_dtype=torch.bfloat16)
    numbers, failed = compare([Record.of(low)], [(0, low.labels)], ref)
    assert numbers["labels_differ"] > 0 and failed == 1


def test_pruned_traffic_takes_the_sparse_path():
    got, _, _, _ = _program_and_reference("europe_osm", "mg8_pruned",
                                          TINY["europe_osm"], "cpu", 5)
    dense = got.work_rows_history[0]
    assert min(got.work_rows_history) < dense


@pytest.mark.gpu
@pytest.mark.parametrize("config,traffic", CELLS[:3])
def test_reference_equals_program_on_the_card(config, traffic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    size = {"uk2002": {"n_nodes": 400_000},
            "europe_osm": {"n_nodes": 1_000_000, "n_slots": 2 * 1_060_000,
                           "lattice_rows": 250, "lattice_cols": 250}}
    got, ref, _, _ = _program_and_reference(config, traffic, size[config],
                                            "cuda", 2**33 + 3)
    numbers, _ = compare([Record.of(got)], [(0, got.labels)], ref)
    assert numbers == {"labels_differ": 0, "runs_differ": 0}
