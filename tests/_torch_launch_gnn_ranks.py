"""Rank function of ``tests/test_torch_launch_gnn.py``'s rank-step test.

It runs in processes that ``repro_torch.core.distributed.spawn_ranks``
starts, so it lives in an importable module, and it imports numpy and
torch only (never jax). For each run it builds the SMOKE cell's plan on
the run's mesh, loads the reference's weights, and records the one-card
step's loss on the whole batch and ``cells.rank_step``'s loss on this
rank's shards (``train.elastic.remesh`` under the plan's specs).
"""
from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.launch.cells import build_cell, rank_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import load_jax_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.elastic import remesh
from repro_torch.tree import param_tree

#: the runs' cells, by kind (the batches' sizes)
CELLS = {"gnn_full": {"n_nodes": 64, "n_edges": 256, "d_feat": 8},
         "gnn_sampled": {"batch_nodes": 8, "fanouts": (3, 2), "d_feat": 8},
         "recsys_train": {"batch": 32}}


def rank_losses(comm, runs, out_dir):
    out = []
    for arch, kind, shape, params, batch in runs:
        spec = get_arch(arch)
        spec = dataclasses.replace(spec, config=spec.smoke)
        m = make_mesh(shape, ("data", "model"))
        plan = build_cell(spec, ShapeCell("r", kind, CELLS[kind]), m)
        model = load_jax_params(plan.init(torch.Generator(), device="cpu"),
                                params)
        whole = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, _, metrics = plan.fn(copy.deepcopy(model), adamw_init(model),
                                whole)
        one_card = float(metrics["loss"])
        mine = remesh(param_tree(model), plan.specs[0], m, comm.rank,
                      device="cpu")
        if hasattr(model, "tables"):
            for name, t in mine["tables"].items():
                model.tables[name] = torch.nn.Parameter(t)
        shard = remesh(whole, plan.specs[2], m, comm.rank, device="cpu")
        fn = rank_step(plan, m, comms={"all": comm, "data": comm,
                                       "model": comm},
                       index={"model": comm.rank % shape[1]})
        _, _, metrics = fn(model, adamw_init(model), shard)
        out.append([one_card, float(metrics["loss"])])
    Path(out_dir, f"rank{comm.rank}.json").write_text(json.dumps(out))
