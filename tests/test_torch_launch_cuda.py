"""The LPA cells' step on the card (``repro_torch.launch``).

Marked ``gpu``: without a CUDA device every test here skips (the decision
is taken inside the ``nccl_rank`` fixture, never at import). On a
machine with one: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_launch_cuda.py``. Imports torch and numpy only (the
card's machine has no JAX).

On a one-rank NCCL group: the bytes one step of the cell's step holds
above its inputs (``torch.cuda.max_memory_allocated``) within 5% of
``launch.dryrun.lpa_step_temp_bytes`` at 2^18 vertices, on the bucketed
(K9) and the fused (K1) layout; K9 on the cell's bucketed rounds equal
to its plain version (int32 bits); the step's collectives equal to
``lpa_collective_bytes``. The LM half (the ``card`` fixture): a SMOKE
layer's ``CostCounter`` totals on the card equal to meta's, and
``LiveBytes`` on meta within 5% of the allocator over a SMOKE train
step. The GNN and recsys half: a one-rank dry-run record's argument and
temp bytes within 5% of the allocator over the same step on the card.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.core.distributed import (ShardComm, build_dist_workspace,
                                          lpa_collective_bytes)
from repro_torch.graphs.generators import powerlaw_communities
from repro_torch.kernels.launches import LAUNCH_COUNTS, reset_launch_counts
from repro_torch.kernels.mg_sketch import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_lpa_cell

pytestmark = pytest.mark.gpu

SPEC = get_arch("lpa-mg8")
SCALE = 18
TEMP_TOL = 0.05


@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the LPA cell's "
                    "step on the card")
    store = tmp_path_factory.mktemp("nccl") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield ShardComm("cuda:0")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def graph():
    return powerlaw_communities(1 << SCALE, p_in=0.5, mix=0.02, seed=1,
                                device="cpu")[0]


def _cell_step(comm, ws, **kw):
    return build_lpa_cell(SPEC, SPEC.cells[1], 1).fn(comm, ws, **kw)


@pytest.mark.parametrize("engine", ["pallas", "pallas_fused"])
def test_step_temporaries_match_the_byte_model(nccl_rank, graph, engine):
    cfg = SPEC.config.lpa
    ws = build_dist_workspace(graph, 1, k=cfg.k, chunk=cfg.chunk,
                              fused=engine == "pallas_fused")
    step = _cell_step(nccl_rank, ws)
    labels = ws.init_labels[0].cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    nccl_rank.reset_counts()
    step(labels, True, 1)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - before
    model = dryrun.lpa_step_temp_bytes(ws, engine)
    assert abs(held / model - 1) <= TEMP_TOL, (held, model)
    key = "fused_fold" if engine == "pallas_fused" else "tile_mg_fold"
    assert {k: n for k, n in LAUNCH_COUNTS.items() if n} == \
        {key: ws.n_rounds}
    want = lpa_collective_bytes(ws)
    assert nccl_rank.bytes_by_op == {op: b for op, b in want.items()
                                     if op != "total"}


def test_k9_on_the_cell_rounds_equals_plain(nccl_rank, graph):
    cfg = SPEC.config.lpa
    ws = build_dist_workspace(graph, 1, k=cfg.k, chunk=cfg.chunk)
    tiles = []

    def checked(gl, gw, k):
        got = ops.mg_fold_tile_pallas(gl, gw, k)
        want = ref.mg_fold_ref(gl, gw, k)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
        tiles.append(tuple(gl.shape))
        return got

    labels = ws.init_labels[0].cuda()
    reset_launch_counts()
    new, _ = _cell_step(nccl_rank, ws, fold_tile=checked)(labels, True, 1)
    assert LAUNCH_COUNTS["tile_mg_fold"] == ws.n_rounds == len(tiles)
    assert tiles == [tuple(g.shape[1:]) for g in ws.round_gathers]
    plain, _ = _cell_step(nccl_rank, ws, fold_tile=ref.mg_fold_ref)(
        labels, True, 1)
    assert torch.equal(new, plain)


# ---------------------------------------------------------------------------
# the LM half: the op counter and the bytes tracer against the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run LM layers and a "
                    "train step on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_cost_counter_on_the_card_equals_meta(card, arch):
    """A SMOKE layer's ``CostCounter`` totals on CUDA tensors equal those
    of the same call on meta tensors (shapes and dtypes alone)."""
    import dataclasses
    from repro_torch.launch.cost import CostCounter
    from repro_torch.models import transformer as tr
    cfg = dataclasses.replace(get_arch(arch).smoke, n_layers=1)
    totals = {}
    for dev in ("meta", "cuda"):
        if dev == "meta":
            layers = tr.param_structs(cfg)["layers"]
        else:
            layers = tr.init_params(torch.Generator().manual_seed(0), cfg,
                                    device=card).layers
        lp = tr._unstack(layers, 1)[0]
        x = torch.randn(2, 16, cfg.d_model).to(cfg.dtype).to(dev)
        pos = torch.arange(16, device=dev)[None].expand(2, 16)
        with torch.no_grad(), CostCounter() as cc:
            tr._layer(lp, x, cfg, pos)
        totals[dev] = cc.totals()
    assert totals["cuda"] == totals["meta"]


def test_live_bytes_on_meta_matches_the_allocator(card):
    """One SMOKE train step (loss, backward, AdamW on a module in place):
    the most bytes ``LiveBytes`` sees it hold on meta within 5% of what
    the allocator holds above the resident state on the card."""
    import dataclasses
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch.cells import build_lm_train
    from repro_torch.launch.live_bytes import LiveBytes
    from repro_torch.models.common import Params
    from repro_torch.models.transformer import param_structs
    from repro_torch.optim.adamw import adamw_init
    spec = get_arch("qwen3-1.7b")
    cfg = dataclasses.replace(spec.smoke, n_layers=4)
    plan = build_lm_train(dataclasses.replace(spec, config=cfg),
                          ShapeCell("t", "train", {"batch": 8, "seq": 256}))
    params = Params(param_structs(cfg))
    batch = {k: torch.empty((8, 256), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    opt = adamw_init(params)
    with LiveBytes() as live:
        plan.fn(params, opt, batch)
    model = plan.init(torch.Generator().manual_seed(0), device=card)
    opt = adamw_init(model)
    batch = {k: torch.randint(0, cfg.vocab, (8, 256), dtype=torch.int32,
                              device=card) for k in ("tokens", "targets")}
    plan.fn(model, opt, batch)  # warm-up: cuBLAS workspaces
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan.fn(model, opt, batch)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - resident
    assert abs(held / live.peak - 1) <= TEMP_TOL, (held, live.peak)


# ---------------------------------------------------------------------------
# the GNN and recsys half: a one-rank record against the allocator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["pna", "dcn-v2"])
def test_model_record_bytes_match_the_allocator(card, arch):
    """The one-rank dry-run record of a SMOKE cell (PNA on a 4,096-node
    full graph, DCN-v2's train step on 4,096 rows): ``argument_bytes``
    within 5% of the bytes its inputs hold on the card, ``temp_bytes``
    within 5% of the allocator's peak above them over a step after a
    warm-up."""
    import dataclasses
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.data.synthetic import dcn_batch
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import adamw_init
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke)
    n, e = 4096, 32768
    cell = (ShapeCell("c", "gnn_full", {"n_nodes": n, "n_edges": e,
                                        "d_feat": 8}) if arch == "pna"
            else ShapeCell("c", "recsys_train", {"batch": 4096}))
    rec = dryrun.run_cell(spec, cell, make_mesh((1, 1), ("data", "model")),
                          "ranks_1")
    assert rec["ok"], rec.get("error")
    plan = build_cell(spec, cell)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=card).manual_seed(0)
    model = plan.init(torch.Generator().manual_seed(0), device=card)
    opt = adamw_init(model)
    if arch == "pna":
        batch = {"node_feat": torch.randn(n, 8, device=card, generator=gen),
                 "labels": torch.randint(0, 16, (n,), device=card,
                                         generator=gen, dtype=torch.int32),
                 "edge_src": torch.randint(0, n, (e,), device=card,
                                           generator=gen, dtype=torch.int32),
                 "edge_dst": torch.randint(0, n, (e,), device=card,
                                           generator=gen, dtype=torch.int32)}
    else:
        cfg = spec.config
        batch = dcn_batch(0, 0, 4096, cfg.n_dense, cfg.n_sparse,
                          cfg.vocab_sizes, device=card)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    model, opt, _ = plan.fn(model, opt, batch)  # warm-up: cuBLAS workspaces
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plan.fn(model, opt, batch)
    torch.cuda.synchronize()
    working = torch.cuda.max_memory_allocated() - held
    mem = rec["memory"]
    assert abs(mem["argument_bytes"] / resident - 1) <= TEMP_TOL, (
        mem["argument_bytes"], resident)
    assert abs(mem["temp_bytes"] / working - 1) <= TEMP_TOL, (
        mem["temp_bytes"], working)
