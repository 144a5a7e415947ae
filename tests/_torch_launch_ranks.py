"""Rank function of ``tests/test_torch_launch.py``'s collective test.

It runs in processes that ``repro_torch.core.distributed.spawn_ranks``
starts, so it lives in an importable module, and it imports numpy and
torch only (never jax). On each exchange's workspace it runs one step of
the LPA cell's step (``build_lpa_cell(...).fn``) and raises
``AssertionError`` when the collectives ``ShardComm`` recorded differ
from ``lpa_collective_bytes`` of the workspace, or when the step held
more bytes than ``lpa_step_temp_bytes`` says (``LiveBytes``).
"""
from __future__ import annotations

from repro_torch.configs.registry import get_arch
from repro_torch.core.distributed import (build_dist_workspace,
                                          lpa_collective_bytes)
from repro_torch.graphs.csr import graph_from_arrays
from repro_torch.kernels.mg_sketch.ref import mg_fold_ref
from repro_torch.launch.cells import build_lpa_cell
from repro_torch.launch.dryrun import lpa_step_temp_bytes
from repro_torch.launch.roofline import collective_bytes

from _torch_live_bytes import LiveBytes, kernel_outputs

#: exchange mode -> build_dist_workspace flag
HALO = {"full": False, "halo": True}


def collectives_of_one_step(comm, arrays, k, chunk):
    offsets, indices, weights, n = arrays
    graph = graph_from_arrays(offsets, indices, weights, n, device="cpu")
    spec = get_arch("lpa-mg8")
    plan = build_lpa_cell(spec, spec.cells[0], comm.world_size)
    for tag, halo in HALO.items():
        ws = build_dist_workspace(graph, comm.world_size, k=k, chunk=chunk,
                                  halo=halo)
        # the plain tile fold, holding only its outputs, as K9 does
        step = plan.fn(comm, ws, fold_tile=kernel_outputs(mg_fold_ref))
        labels = ws.init_labels[comm.rank].clone()
        comm.reset_counts()
        with LiveBytes() as live:
            step(labels, True, 1)
        want = lpa_collective_bytes(ws)
        per_op = {op: b for op, b in want.items() if op != "total"}
        assert comm.bytes_by_op == per_op, (tag, comm.rank,
                                            comm.bytes_by_op, want)
        assert collective_bytes(comm.bytes_by_op) == want, (tag, want)
        calls = dict.fromkeys(per_op, 1)
        assert comm.calls_by_op == calls, (tag, comm.calls_by_op)
        model = lpa_step_temp_bytes(ws, "pallas")
        # the model counts the fullest rank; CPU wrapped scalars add 512 B
        assert 0.99 * model <= live.peak <= model + 1024, (
            tag, comm.rank, live.peak, model)
