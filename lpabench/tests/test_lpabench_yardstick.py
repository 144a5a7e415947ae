"""The yardstick's fold count: each input byte read once and each output
byte written once, never more than what the program's fold moves, so
that ``fold_roofline`` cannot pass 100% while its time is whole."""
import numpy as np
import pytest
import torch

from lpabench.yardstick import fold_bytes, iteration_bytes


def test_fold_counts_each_slot_and_vertex_once():
    degrees = torch.tensor([0, 1, 3, 128, 129, 40_000])
    assert fold_bytes(degrees) == 8 * 40_261 + 12 * 5
    assert fold_bytes(torch.zeros(4, dtype=torch.int64)) == 0


def test_iteration_counts_slots_offsets_and_labels_once():
    assert iteration_bytes(10, 30) == 8 * 30 + 4 * 11 + 8 * 10


@pytest.mark.parametrize("hubs", [0, 3])
def test_fold_count_is_below_the_programs_schedule(hubs):
    from repro_torch.graphs.csr import build_fused_fold_plan

    rng = np.random.default_rng(5)
    degrees = rng.integers(0, 9, 5000)
    degrees[:hubs] = [300, 5000, 70_000][:hubs]
    k = 8
    plan = build_fused_fold_plan(degrees, k=k, chunk=128, device="cpu")
    moved = 0
    for i, rnd in enumerate(plan.rounds):
        rows = int((rnd.row_count > 0).sum())
        out = 8 if i == len(plan.rounds) - 1 else 8 * k
        moved += 8 * rnd.n_entries_in + 8 * rows + out * rows
    counted = fold_bytes(torch.from_numpy(degrees))
    assert counted <= moved
    assert (len(plan.rounds) > 1) == (hubs > 0)
