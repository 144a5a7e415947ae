"""The LPA half of the port's ``launch/`` (``repro_torch.launch``: mesh,
roofline, the LPA cells of ``cells``, ``dryrun`` and ``report``) against
the reference's ``repro.launch``.

The reference's cells are built, and two of them compiled, in one
subprocess on 512 forced XLA host devices (``ref_cells``): the
workspace shapes of every cell at 1, 4, 256 and 512 ranks, the meta, the
production meshes, and, at the SMOKE sizes on 4 devices, the collective
bytes ``repro.launch.roofline.collective_bytes`` parses out of the
compiled step's HLO and XLA's argument size. The port's counts must give
the same numbers. The collectives are also held to what ``ShardComm``
records over 4 gloo ranks, and the step byte model to the bytes the
port's step holds (``_torch_live_bytes.LiveBytes``).

The LM half: the reference's plans on the production mesh, its remesh,
and the collectives of its SMOKE LM cells (``HLO_CELLS``: every layout
the LM dry run counts, on (2, 2) and (2, 4) meshes), compiled in
``HLO_PROCS`` more subprocesses beside the first, which
``dryrun.lm_collective_bytes`` must give within 1%. Run those alone
with ``-k lm_collective`` (about 100 s).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_arch as ref_get_arch
from repro.launch.cells import lpa_dist_spec as ref_lpa_dist_spec
from repro.launch import report as ref_report
from repro.launch.roofline import roofline as ref_roofline
from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.core import distributed
from repro_torch.core.distributed import (ShardComm, build_dist_workspace,
                                          dist_lpa, lpa_collective_bytes,
                                          spawn_ranks)
from repro_torch.core.lpa import lpa
from repro_torch.graphs.generators import powerlaw_communities
from repro_torch.kernels.mg_sketch.fused import fused_fold_round_plain
from repro_torch.kernels.mg_sketch.ref import mg_fold_ref
from repro_torch.launch import dryrun, mesh, report
from repro_torch.launch.cells import (build_cell, build_lpa_cell,
                                      lpa_cell_engine, lpa_dist_spec)
from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                         collective_bytes, roofline)
from repro_torch.train.elastic import check_divisibility
import _torch_launch_ranks as ranks
from _torch_live_bytes import LiveBytes, kernel_outputs
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPEC = get_arch("lpa-mg8")
RANKS = (1, 4, 256, 512)
LM_ARCHS = ("qwen3-1.7b", "glm4-9b", "deepseek-v2-lite-16b", "granite-34b",
            "qwen3-moe-235b-a22b")
#: the SMOKE LM cells compiled for their HLO collectives, (arch, kind,
#: mesh shape): every arch's train (cp), prefill, decode and tp train
#: (``sp_mode="none"``, kind ``train_tp``), and both trains with remat
#: (``_remat``: the published configs' setting), on a (2, 2) mesh and on
#: a (2, 4) mesh, where every arch's KV heads split along dh but
#: deepseek's (MLA)
HLO_KINDS = ("train", "prefill", "decode", "train_tp", "train_remat",
             "train_tp_remat")
HLO_CELLS = tuple((arch, kind, shape) for shape in ((2, 2), (2, 4))
                  for arch in LM_ARCHS for kind in HLO_KINDS)
#: the subprocesses that compile them side by side, each a share of the
#: train cells (about 5 s each) and of the serving ones (about 1 s)
HLO_PROCS = 3
HLO_SHARES = tuple(sorted(HLO_CELLS, key=lambda c: not c[1].startswith(
    "train"))[i::HLO_PROCS] for i in range(HLO_PROCS))

_REF_CELLS = """
    import dataclasses, json
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import ShapeCell, get_arch
    from repro.launch.cells import build_lpa_cell
    from repro.launch.mesh import batch_axes, make_production_mesh
    from repro.launch.roofline import collective_bytes

    def shapes(v):
        if isinstance(v, tuple):
            return [shapes(x) for x in v]
        return [list(v.shape), str(v.dtype)]

    spec = get_arch("lpa-mg8")
    out = {"cells": {}, "meshes": {}, "smoke": {}}
    for name, m in (("single", make_production_mesh()),
                    ("multi", make_production_mesh(multi_pod=True))):
        out["meshes"][name] = {"axis_names": list(m.axis_names),
                               "devices_shape": list(m.devices.shape),
                               "batch_axes": list(batch_axes(m))}
    for p in RANKS:
        m = Mesh(np.array(jax.devices()[:p]), ("shard",))
        for cell in spec.cells:
            plan = build_lpa_cell(spec, cell, m)
            out["cells"][f"{cell.name}/{p}"] = {"meta": plan.meta,
                                                "args": shapes(plan.args)}
    smoke = dataclasses.replace(spec, config=spec.smoke)
    m = Mesh(np.array(jax.devices()[:4]), ("shard",))
    for tag, extra in (("full", {}), ("halo", {"halo": True})):
        cell = ShapeCell("smoke", "lpa", {"n_nodes": spec.smoke.n_nodes,
                                          "n_edges": spec.smoke.n_edges,
                                          **extra})
        plan = build_lpa_cell(smoke, cell, m)
        with m:
            compiled = jax.jit(plan.fn, in_shardings=plan.in_shardings
                               ).lower(*plan.args).compile()
        out["smoke"][tag] = {
            "collectives": collective_bytes(compiled.as_text()),
            "argument_bytes":
                int(compiled.memory_analysis().argument_size_in_bytes),
            "meta": plan.meta}

    # the LM cells: plans on the single-pod mesh (specs, meta, per-rank
    # argument bytes), the SMOKE cells compiled on a (2, 2) mesh of 4
    # devices (the collectives their HLO parses to), and remesh there
    from jax.sharding import NamedSharding
    from repro.launch.cells import build_cell, lm_param_specs, _lm_structs
    from repro.train.elastic import remesh

    def spec_json(sp):
        return [list(e) if isinstance(e, tuple) else e for e in sp]

    def is_sharding(x):
        return isinstance(x, NamedSharding)

    out["lm"] = {}
    m16 = make_production_mesh()
    for arch in LM_ARCHS:
        spec = get_arch(arch)
        for cell in spec.cells:
            plan = build_cell(spec, cell, m16)
            leaves = jax.tree.leaves(plan.args)
            shardings = jax.tree.leaves(plan.in_shardings,
                                        is_leaf=is_sharding)
            out["lm"][f"{arch}/{cell.name}"] = {
                "meta": plan.meta,
                "argument_bytes": sum(
                    int(np.prod(sh.shard_shape(a.shape)))
                    * np.dtype(a.dtype).itemsize
                    for a, sh in zip(leaves, shardings)),
                "specs": [spec_json(sh.spec) for sh in shardings],
                "shapes": [list(a.shape) for a in leaves]}
    m4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    smoke = get_arch("qwen3-1.7b").smoke
    structs = _lm_structs(smoke)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), structs)
    position = {d: i for i, d in enumerate(m4.devices.flat)}
    shards = {}
    for mode in ("tp", "fsdp"):
        placed = remesh(tree, lm_param_specs(smoke, structs, m4, mode), m4)
        for i, leaf in enumerate(jax.tree.leaves(placed)):
            for sh in leaf.addressable_shards:
                shards[f"{mode}/{position[sh.device]}/{i}"] = np.asarray(
                    sh.data)
    np.savez(OUT + ".npz", **shards)
    with open(OUT, "w") as f:
        json.dump(out, f)
"""

_REF_HLO = """
    import dataclasses, json
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import ShapeCell, get_arch
    from repro.launch.cells import build_cell
    from repro.launch.roofline import collective_bytes

    out = {}
    for arch, kind, shape in HLO_CELLS:
        smoke = get_arch(arch).smoke
        smoke = dataclasses.replace(smoke, remat=kind.endswith("_remat"))
        if kind.startswith("train_tp"):
            smoke = dataclasses.replace(smoke, sp_mode="none")
        spec = dataclasses.replace(get_arch(arch), config=smoke)
        m = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        plan = build_cell(spec, ShapeCell("smoke", kind.split("_")[0],
                                          {"batch": 4, "seq": 64}), m)
        with m:
            compiled = jax.jit(
                plan.fn, in_shardings=plan.in_shardings,
                donate_argnums=plan.donate_argnums).lower(
                    *plan.args).compile()
        out[f"{arch}/{kind}/{shape[0]}x{shape[1]}"] = {
            "meta": plan.meta,
            "collectives": collective_bytes(
                compiled.as_text(),
                loop_factor=float(spec.config.n_layers))}
    with open(OUT, "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    """The reference's LPA and LM cells, built (and at SMOKE compiled) on
    512 forced host devices in a subprocess, and its remesh of a SMOKE LM
    tree on 4 of them; beside it, ``HLO_PROCS`` subprocesses compile the
    SMOKE LM cells of ``HLO_CELLS`` on 8 forced host devices."""
    tmp = tmp_path_factory.mktemp("ref_cells")
    out = tmp / "cells.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    code = (f"OUT = {str(out)!r}\nRANKS = {RANKS!r}\n"
            f"LM_ARCHS = {LM_ARCHS!r}\n" + textwrap.dedent(_REF_CELLS))
    procs = [(subprocess.Popen([sys.executable, "-c", code], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True), out)]
    env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for i in range(HLO_PROCS):
        hlo = tmp / f"hlo_{i}.json"
        code = (f"OUT = {str(hlo)!r}\n"
                f"HLO_CELLS = {HLO_SHARES[i]!r}\n"
                + textwrap.dedent(_REF_HLO))
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), hlo))
    try:
        for proc, _ in procs:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc, _ in procs:
            proc.kill()
    cells = json.loads(out.read_text())
    cells["lm_hlo"] = {}
    for _, hlo in procs[1:]:
        cells["lm_hlo"].update(json.loads(hlo.read_text()))
    with np.load(str(out) + ".npz") as z:
        cells["remesh"] = {k: z[k] for k in z.files}
    return cells


def _shape(t):
    return [list(t.shape), str(t.dtype).replace("torch.", "")]


def _smoke_cell(**extra):
    return ShapeCell("smoke", "lpa", {"n_nodes": SPEC.smoke.n_nodes,
                                      "n_edges": SPEC.smoke.n_edges, **extra})


def _smoke_plan(n_shards, **extra):
    return build_lpa_cell(dataclasses.replace(SPEC, config=SPEC.smoke),
                          _smoke_cell(**extra), n_shards)


# ---------------------------------------------------------------------------
# lpa_dist_spec and build_lpa_cell against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", RANKS)
def test_lpa_dist_spec_equals_the_reference(p):
    """Shapes, dtypes and sizes of every cell's spec (and SMOKE's)."""
    sizes = [(c.params["n_nodes"], c.params["n_edges"], SPEC.config)
             for c in SPEC.cells]
    sizes.append((SPEC.smoke.n_nodes, SPEC.smoke.n_edges, SPEC.smoke))
    for n, e, cfg in sizes:
        args = (n, e, p, cfg.lpa.k, cfg.lpa.chunk,
                cfg.frac_high_degree_edges)
        ref, got = ref_lpa_dist_spec(*args), lpa_dist_spec(*args)
        for name in ("nbr_pos", "weights", "final_row_vertex",
                     "init_labels"):
            r, g = getattr(ref, name), getattr(got, name)
            assert g.is_meta, name
            assert _shape(g) == [list(r.shape), str(r.dtype)], (name, n, p)
        assert [_shape(g) for g in got.round_gathers] == \
            [[list(r.shape), str(r.dtype)] for r in ref.round_gathers]
        assert got.n_rounds == len(ref.round_gathers)
        assert (got.n_nodes, got.v_pad, got.k, got.chunk) == \
            (ref.n_nodes, ref.v_pad, ref.k, ref.chunk)
        assert got.n_shards == p


@pytest.mark.parametrize("p", RANKS)
def test_build_lpa_cell_equals_the_reference(ref_cells, p):
    """Meta, and the step's workspace arrays in the reference's argument
    order (halo tables included), at every rank count."""
    for cell in SPEC.cells:
        ref = ref_cells["cells"][f"{cell.name}/{p}"]
        plan = build_cell(SPEC, cell, p)
        assert plan.meta == ref["meta"]
        ws = plan.workspace
        args = [_shape(ws.nbr_pos), _shape(ws.weights),
                [_shape(g) for g in ws.round_gathers],
                _shape(ws.final_row_vertex), _shape(ws.init_labels)]
        if ws.send_idx is not None:
            args += [_shape(ws.send_idx), _shape(ws.hub_idx)]
        want = ref["args"][:5] + ref["args"][7:]  # less the two scalars
        assert args == want, cell.name
        assert ws.h_pad == (ref["args"][7][0][2] if ref["meta"]["halo"]
                            else 0)


def test_collective_bytes_equal_the_reference_hlo(ref_cells):
    """Per op, ``lpa_collective_bytes`` equals what the reference's
    roofline parses out of its compiled SMOKE cell on 4 devices (full
    gather and halo), and the workspace's bytes equal XLA's argument
    size less the step's two scalars (a bool and an int32)."""
    for tag, extra in (("full", {}), ("halo", {"halo": True})):
        ref = ref_cells["smoke"][tag]
        plan = _smoke_plan(4, **extra)
        assert plan.meta == ref["meta"]
        assert lpa_collective_bytes(plan.workspace) == ref["collectives"]
        assert dryrun.workspace_bytes(plan.workspace) == \
            ref["argument_bytes"] - 5


def test_shard_comm_counts_equal_lpa_collective_bytes():
    """4 gloo ranks, one step of the cell's step on each exchange's
    workspace of a real graph: ``ShardComm.bytes_by_op`` equals
    ``lpa_collective_bytes``, and the step holds what the byte model
    says (the rank function asserts both)."""
    g, _ = powerlaw_communities(512, p_in=0.5, mix=0.02, seed=5,
                                device="cpu")
    arrays = (g.offsets.numpy(), g.indices.numpy(), g.weights.numpy(),
              g.n_nodes)
    spawn_ranks(ranks.collectives_of_one_step, 4, (arrays, 4, 16),
                device="cpu")


# ---------------------------------------------------------------------------
# the cell's step on one rank
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield ShardComm("cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def g12():
    return powerlaw_communities(1 << 12, p_in=0.5, mix=0.02, seed=1,
                                device="cpu")[0]


@pytest.mark.parametrize("engine", ["pallas", "pallas_fused"])
def test_cell_step_runs_to_single_host_lpa(one_rank, g12, engine):
    """``dist_lpa`` through the cell's step (SMOKE config) on one rank
    equals the single-host ``lpa()`` on the engine the cell picks."""
    cfg = SPEC.smoke.lpa
    plan = _smoke_plan(1)
    ws = build_dist_workspace(g12, 1, k=cfg.k, chunk=cfg.chunk,
                              fused=engine == "pallas_fused")
    assert lpa_cell_engine(ws) == engine
    assert lpa_cell_engine(plan.workspace) == "pallas"
    labels, iters = dist_lpa(one_rank, ws, rho=cfg.rho, tau=cfg.tau,
                             max_iters=cfg.max_iters,
                             step=plan.fn(one_rank, ws))
    ref = lpa(g12, dataclasses.replace(cfg, fold_backend=engine),
              device="cpu")
    assert torch.equal(labels, ref.labels)
    assert iters == ref.iterations


@pytest.mark.parametrize("engine", ["pallas", "pallas_fused"])
def test_step_temp_bytes_model_equals_the_step(one_rank, g12, engine,
                                               monkeypatch):
    """``lpa_step_temp_bytes`` equals the most bytes the port's step
    holds at once (its kernels standing in as allocations of their
    outputs), within the CPU's 512 B wrapped scalars; one step moves
    ``lpa_collective_bytes``."""
    fused = engine == "pallas_fused"
    ws = build_dist_workspace(g12, 1, k=8, chunk=128, fused=fused)
    kw = {}
    if fused:
        monkeypatch.setattr(distributed, "fused_fold_round",
                            kernel_outputs(fused_fold_round_plain))
    else:
        kw["fold_tile"] = kernel_outputs(mg_fold_ref)
    step = build_lpa_cell(SPEC, SPEC.cells[1], 1).fn(one_rank, ws, **kw)
    labels = ws.init_labels[0].clone()
    for it in range(2):
        one_rank.reset_counts()
        with LiveBytes() as live:
            labels, _ = step(labels, it == 0, it + 1)
        model = dryrun.lpa_step_temp_bytes(ws, engine)
        assert model <= live.peak <= model + 1024, (it, live.peak, model)
        assert collective_bytes(one_rank.bytes_by_op) == \
            lpa_collective_bytes(ws)


def test_step_models_refuse_what_they_do_not_cover(g12):
    ws = build_dist_workspace(g12, 1, k=8, chunk=128)
    with pytest.raises(ValueError, match="pallas and pallas_fused"):
        dryrun.lpa_step_temp_bytes(ws, "jnp")
    with pytest.raises(ValueError, match="does not fold"):
        dryrun.lpa_step_bytes(ws, "pallas_fused")


# ---------------------------------------------------------------------------
# mesh, roofline, dry run and report
# ---------------------------------------------------------------------------

def test_mesh_descriptors_equal_the_reference(ref_cells):
    """The production meshes' axes and shapes, and check_divisibility
    takes them; importing the module touches no device."""
    import importlib
    importlib.reload(mesh)
    for name, multi in (("single", False), ("multi", True)):
        m = mesh.make_production_mesh(multi_pod=multi)
        ref = ref_cells["meshes"][name]
        assert list(m.axis_names) == ref["axis_names"]
        assert list(m.devices.shape) == ref["devices_shape"]
        assert list(mesh.batch_axes(m)) == ref["batch_axes"]
        assert mesh.all_axes(m) == tuple(ref["axis_names"])
        assert m.size == int(np.prod(ref["devices_shape"]))
        assert m.shape == dict(zip(ref["axis_names"], ref["devices_shape"]))
    m = mesh.make_production_mesh()
    check_divisibility({"w": np.zeros((32, 48))}, {"w": ("data", "model")},
                       m)
    with pytest.raises(ValueError, match="not divisible by mesh extent 256"):
        check_divisibility({"w": np.zeros((32, 48))},
                           {"w": (("data", "model"), None)}, m)
    with pytest.raises(ValueError):
        mesh.make_mesh((2, 2), ("data",))


def test_roofline_terms_and_bottleneck():
    """The reference's test of the terms, at the card's rates, and the
    same arithmetic as the reference's roofline at its own."""
    t = roofline(flops_chip=PEAK_FLOPS, bytes_chip=HBM_BW / 2,
                 coll_bytes_chip=NVLINK_BW / 4)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(0.25)
    assert t.bottleneck == "compute"
    assert t.step_time_s == pytest.approx(1.0)
    r = ref_roofline(197e12, 819e9 / 2, 50e9 / 4)
    assert t.to_dict().keys() == r.to_dict().keys()
    assert t.to_dict()["bottleneck"] == r.to_dict()["bottleneck"]
    assert collective_bytes({"all-gather": 16, "all-reduce": 8,
                             "total": 1}) == \
        {"all-gather": 16.0, "all-reduce": 8.0, "total": 24.0}


def test_hardware_constants_are_h100():
    assert PEAK_FLOPS == 989e12
    assert HBM_BW == 3.35e12
    assert NVLINK_BW == 450e9
    assert dryrun.HBM_PER_CHIP == 80e9


def _records():
    """Hand-made records: two cells that fit, one that does not, one
    failed; both fit keys, so either package's report reads them."""
    def rec(shape, peak, fits, t):
        return {"arch": "lpa-mg8", "shape": shape, "ok": True,
                "memory": {"peak_bytes_per_device": peak,
                           "fits_16g_hbm": fits, "fits_80g_hbm": fits},
                "useful_flops_ratio": 1.0,
                "roofline": {"compute_s": t / 10, "memory_s": t,
                             "collective_s": t / 3, "bottleneck": "memory",
                             "step_time_lb_s": t}}
    recs = {("lpa-mg8", "a"): rec("a", 4.2e9, True, 2e-3),
            ("lpa-mg8", "b"): rec("b", 1.1e11, False, 1.5),
            ("lpa-mg8", "c"): rec("c", 3e8, True, 4e-4),
            ("lpa-mg8", "d"): {"arch": "lpa-mg8", "shape": "d", "ok": False,
                               "error": "int32 positions cannot index"}}
    base = {("lpa-mg8", "a"): rec("a", 4.2e9, True, 5e-3)}
    return recs, base


def test_report_gives_the_reference_text():
    recs, base = _records()
    assert report.roofline_table(recs, base) == \
        ref_report.roofline_table(recs, base)
    assert report.summary(recs) == ref_report.summary(recs).replace(
        "compile", "built").replace("16 GB", "80 GB")
    assert report.summary(recs) == "3/4 cells built; 2/3 fit 80 GB HBM/chip"
    assert report.fmt_s(None) == ref_report.fmt_s(None) == "-"


#: (cell, ranks) -> (per-rank workspace bytes, spec rounds)
WORKED = {("web_560m", 1): (24_500_245_572, 2),
          ("web_560m", 256): (95_705_316, 2),
          ("web_4b", 1): (164_431_875_000, 1),
          ("web_4b", 512): (321_156_024, 1)}


def test_dryrun_records_hold_the_worked_numbers(tmp_path, capsys):
    """The dry run at 256, 512 and 1 rank writes one record per cell and
    mesh, from meta workspaces, with the worked per-rank bytes; web_4b
    on one rank is not ok (int32 positions); the report says built."""
    rc = dryrun.main(["--arch", "lpa-mg8", "--mesh", "both", "--ranks", "1",
                      "--out", str(tmp_path)])
    assert rc == 1  # web_4b and web_4b_halo cannot run on one rank
    meshes = {"single_pod_16x16": 256, "multi_pod_2x16x16": 512,
              "ranks_1": 1}
    assert sorted(os.listdir(tmp_path)) == sorted(meshes)
    for mesh_name, p in meshes.items():
        recs = report.load(str(tmp_path), mesh_name)
        assert sorted(s for _, s in recs) == sorted(c.name
                                                    for c in SPEC.cells)
        for (_, shape), d in recs.items():
            cell = next(c for c in SPEC.cells if c.name == shape)
            assert d["n_devices"] == p and d["engine"] == "pallas"
            assert d["ok"] == (p > 1 or shape == "web_560m"), shape
            if (shape, p) in WORKED:
                nbytes, rounds = WORKED[(shape, p)]
                assert d["memory"]["argument_bytes"] == nbytes
                assert d["n_rounds"] == rounds
            if not d["ok"]:
                assert "int32 positions" in d["error"]
            mem = d["memory"]
            assert mem["peak_bytes_per_device"] == (
                mem["argument_bytes"] + mem["output_bytes"]
                + mem["temp_bytes"])
            assert mem["fits_80g_hbm"] == (mem["peak_bytes_per_device"]
                                           < 80e9)
            e = cell.params["n_edges"]
            assert d["flops_per_chip"] == pytest.approx(e / p * 48)
            assert d["useful_flops_ratio"] == pytest.approx(1.0)
            ws = build_lpa_cell(SPEC, cell, p).workspace
            assert d["collectives"] == lpa_collective_bytes(ws)
            r = d["roofline"]
            assert r["memory_s"] == pytest.approx(d["bytes_per_chip"]
                                                  / 3.35e12)
            assert r["collective_s"] == pytest.approx(
                d["collectives"]["total"] / 450e9)
    # web_560m at 256 ranks: 4 · 72,266 B of labels gathered, 8 B summed
    rec = report.load(str(tmp_path), "single_pod_16x16")[("lpa-mg8",
                                                          "web_560m")]
    assert rec["collectives"] == {"all-gather": 4.0 * 256 * 72_266,
                                  "all-reduce": 8.0,
                                  "total": 4.0 * 256 * 72_266 + 8}
    capsys.readouterr()
    report.main(["--results", str(tmp_path), "--mesh", "ranks_1"])
    out = capsys.readouterr().out
    assert out.startswith("1/3 cells built; 0/1 fit 80 GB HBM/chip")
    assert "compile" not in out


def test_dryrun_refuses_another_family(tmp_path, capsys):
    """An arch id of no family the registry knows exits 2, naming the
    ids it knows, and writes nothing (every family of the reference's
    dry run is ported: tests/test_torch_launch_gnn.py)."""
    rc = dryrun.main(["--arch", "no-such-arch", "--out", str(tmp_path)])
    assert rc == 2
    err = capsys.readouterr().err
    assert "no-such-arch" in err and "dcn-v2" in err and "pna" in err
    assert os.listdir(tmp_path) == []


def test_ref_registry_has_the_same_lpa_cells():
    ref = ref_get_arch("lpa-mg8")
    assert [(c.name, c.kind, c.params) for c in ref.cells] == \
        [(c.name, c.kind, c.params) for c in SPEC.cells]


# ---------------------------------------------------------------------------
# the LM cells: layouts, plans, collectives, remesh, the LM dry run
# ---------------------------------------------------------------------------

def _duck_mesh(shape, axes):
    """What the reference's layout code reads of a mesh."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


DUCK_MESHES = {"single": ((16, 16), ("data", "model")),
               "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_spec_dict(specs) -> dict:
    from jax.sharding import PartitionSpec
    import jax
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(k.key for k in path): tuple(sp) for path, sp in flat}


def _spec_dict(specs, path=()) -> dict:
    if isinstance(specs, dict):
        return {k: v for key in specs
                for k, v in _spec_dict(specs[key], path + (key,)).items()}
    return {"/".join(path): specs}


def _flat_specs(args, specs) -> list:
    """(shape, spec) of every input leaf in the reference's leaf order
    (dict keys sorted), specs as JSON gives them."""
    from repro_torch.train.elastic import leaves_with_specs
    return [(list(t.shape), [list(e) if isinstance(e, tuple) else e
                             for e in sp])
            for _, t, sp in leaves_with_specs(args, specs)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_equal_the_reference(arch):
    """The four layouts on both production meshes, leaf for leaf, and
    the longest prefix of the mesh's axes a batch divides over."""
    from repro.launch.cells import _lm_structs, lm_param_specs as ref_specs
    from repro_torch.launch.cells import lm_param_specs
    from repro_torch.models.transformer import param_structs
    from repro.launch.cells import _best_batch_axes as ref_best
    from repro_torch.launch.cells import _best_batch_axes
    cfg, ref_cfg = get_arch(arch).config, ref_get_arch(arch).config
    structs, ref_structs = param_structs(cfg), _lm_structs(ref_cfg)
    for shape, axes in DUCK_MESHES.values():
        m = _duck_mesh(shape, axes)
        for b in (1, 3, 16, 32, 256, 512):
            assert _best_batch_axes(m, b) == ref_best(m, b)
        for mode in ("tp", "fsdp", "ep_fsdp", "cp"):
            want = _ref_spec_dict(ref_specs(ref_cfg, ref_structs, m, mode))
            got = _spec_dict(lm_param_specs(cfg, structs, m, mode))
            assert got == want, (mode, shape)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_plans_equal_the_reference(ref_cells, arch):
    """Each cell's plan on the 16 x 16 mesh: the reference's meta
    (mode, probe extents, kv_len), every input's shape and spec in its
    leaf order, and the per-rank argument bytes of its shard shapes."""
    spec = get_arch(arch)
    m = mesh.make_production_mesh()
    for cell in spec.cells:
        ref = ref_cells["lm"][f"{arch}/{cell.name}"]
        plan = build_cell(spec, cell, m)
        assert {k: plan.meta[k] for k in ref["meta"]} == ref["meta"]
        flat = _flat_specs(plan.args, plan.specs)
        assert [s for s, _ in flat] == ref["shapes"], cell.name
        assert [sp for _, sp in flat] == ref["specs"], cell.name
        assert dryrun.spec_bytes(plan.args, plan.specs, m) == \
            ref["argument_bytes"], cell.name
    # the one-card plans are unchanged
    plan = build_cell(spec, spec.cells[0])
    assert plan.args is None and plan.specs is None
    assert plan.config is spec.config


def _smoke_plan_lm(arch, kind, shape):
    """The port's plan of the SMOKE cell ``kind`` of ``HLO_KINDS`` (batch
    4, sequence 64) on a ``shape`` ("data", "model") mesh, and the mesh."""
    smoke = dataclasses.replace(get_arch(arch).smoke,
                                remat=kind.endswith("_remat"))
    if kind.startswith("train_tp"):
        smoke = dataclasses.replace(smoke, sp_mode="none")
    spec = dataclasses.replace(get_arch(arch), config=smoke)
    m = mesh.make_mesh(shape, ("data", "model"))
    cell = ShapeCell("smoke", kind.split("_")[0], {"batch": 4, "seq": 64})
    return spec, cell, build_cell(spec, cell, m), m


@pytest.mark.parametrize("arch,kind,shape", HLO_CELLS)
def test_lm_collective_bytes_equal_the_reference_hlo(ref_cells, arch, kind,
                                                     shape):
    """A SMOKE cell on a (2, 2) or (2, 4) mesh: the total and every op
    that holds at least 1% of it within 1% of what the reference's
    roofline parses out of the compiled step's HLO (GQA, MQA, MLA and
    MoE layouts, KV heads whole or split along dh; context-parallel and
    tensor-parallel train, with and without remat, and tensor-parallel
    serving)."""
    ref = ref_cells["lm_hlo"][f"{arch}/{kind}/{shape[0]}x{shape[1]}"]
    _, _, plan, m = _smoke_plan_lm(arch, kind, shape)
    assert {k: plan.meta[k] for k in ref["meta"]} == ref["meta"]
    got = dryrun.lm_collective_bytes(plan, m)
    want = ref["collectives"]
    print(arch, kind, shape, got, want)
    assert got["total"] == pytest.approx(want["total"], rel=0.01)
    for op, b in want.items():
        if b >= 0.01 * want["total"]:
            assert got.get(op, 0.0) == pytest.approx(b, rel=0.01), op


@pytest.mark.parametrize("arch,kind", [
    ("deepseek-v2-lite-16b", "train"), ("granite-34b", "train_tp"),
    ("qwen3-moe-235b-a22b", "train_tp_remat")])
def test_lm_train_parts_on_tensors_give_the_record(arch, kind):
    """What chip_smoke.py's phase 11e does on the card, on the CPU at a
    SMOKE cell deepened to 6 layers on a (2, 2) mesh: the rank's train
    step at 2 and 3 layers on drawn tensors counts what it counts on
    meta, with the same ``P_act``; those two points, extrapolated to 6
    layers and completed by ``lm_train_total``, give ``lm_local_run``'s
    ``raw_cost`` and ``temp_bytes`` (measured on meta at 2, 3 and 4)."""
    spec, cell, _, m = _smoke_plan_lm(arch, kind, (2, 2))
    spec = dataclasses.replace(spec, config=dataclasses.replace(
        spec.config, n_layers=6))
    plan = build_cell(spec, cell, m)
    local = dryrun.lm_local_run(spec, cell, plan, m)
    assert local["layers_run"] == "extrapolated from (2, 3, 4)"
    lcfg, b, s = dryrun.lm_local_step(plan, m)
    points = {}
    for n in (2, 3):
        ncfg = dataclasses.replace(lcfg, n_layers=n)
        gen = torch.Generator().manual_seed(n)
        peak, cc = dryrun.lm_train_measure(
            ncfg, *dryrun.lm_train_inputs(ncfg, b, s, "cpu", gen))
        points[n] = (peak, dryrun._cost_record(cc))
        assert points[n] == local["points"][n], n
    peak, cost = dryrun.lm_extrapolate(points, 6)
    temp, cost = dryrun.lm_train_total(plan, m, peak, cost)
    assert cost == local["raw_cost"]
    assert temp == local["temp_bytes"]


def test_remesh_equals_the_reference_shards(ref_cells):
    """Every rank's shard of a SMOKE LM tree under tp and fsdp on a
    (2, 2) mesh equals the reference's addressable shard on the device at
    the same mesh position; a mesh that does not divide raises first."""
    from repro_torch.launch.cells import lm_param_specs
    from repro_torch.models.transformer import param_structs
    from repro_torch.train.elastic import remesh
    from repro_torch.tree import tree_leaves, tree_unflatten
    smoke = get_arch("qwen3-1.7b").smoke
    structs = param_structs(smoke)
    rng = np.random.default_rng(0)
    tree = tree_unflatten(structs, [
        rng.standard_normal(tuple(a.shape)).astype(np.float32)
        for a in tree_leaves(structs)])
    m = mesh.make_mesh((2, 2), ("data", "model"))
    for mode in ("tp", "fsdp"):
        specs = lm_param_specs(smoke, structs, m, mode)
        for rank in range(4):
            shards = tree_leaves(remesh(tree, specs, m, rank, device="cpu"))
            for i, got in enumerate(shards):
                want = ref_cells["remesh"][f"{mode}/{rank}/{i}"]
                assert torch.equal(got, torch.from_numpy(want)), \
                    (mode, rank, i)
    bad = mesh.make_mesh((1, 3), ("data", "model"))
    with pytest.raises(ValueError, match="not divisible"):
        remesh(tree, lm_param_specs(smoke, structs, bad, "tp"), bad, 0,
               device="cpu")


#: qwen3-1.7b's per-rank argument bytes on the 16 x 16 mesh, from the
#: reference's shard shapes
QWEN3_ARG_BYTES = {"train_4k": 532_933_380, "prefill_32k": 508_661_760,
                   "decode_32k": 2_387_447_872, "long_500k": 743_280_648}
LM_KEYS = {"arch", "shape", "kind", "mesh", "n_devices", "note", "ok",
           "mode", "memory", "raw_cost", "flops_per_chip", "bytes_per_chip",
           "model_flops_global", "useful_flops_ratio", "collectives",
           "hlo_collective_loop_factor", "roofline"}


def test_dryrun_writes_the_lm_records(tmp_path, capsys):
    """``--arch qwen3-1.7b --mesh single``: four records with the
    reference's keys, the worked argument bytes, the probe's FLOPs, the
    collectives' total in the roofline; the report and perf_lab read
    them."""
    from repro_torch.launch import perf_lab
    from repro_torch.launch.probes import lm_cell_cost
    rc = dryrun.main(["--arch", "qwen3-1.7b", "--mesh", "single", "--out",
                      str(tmp_path)])
    assert rc == 0
    recs = report.load(str(tmp_path), "single_pod_16x16")
    assert sorted(s for _, s in recs) == sorted(QWEN3_ARG_BYTES)
    cfg = get_arch("qwen3-1.7b").config
    for (_, shape), d in recs.items():
        assert LM_KEYS <= set(d) and d["ok"], shape
        mem = d["memory"]
        assert mem["argument_bytes"] == QWEN3_ARG_BYTES[shape]
        assert mem["peak_bytes_per_device"] == (
            mem["argument_bytes"] + mem["temp_bytes"])
        assert mem["temp_bytes"] > 0 and mem["fits_80g_hbm"]
        assert d["mode"] == ("cp" if d["kind"] == "train" else "tp")
        want = lm_cell_cost(cfg, d["kind"], *{
            "train_4k": (256, 4096, 1, 256),
            "prefill_32k": (32, 32768, 16, 16),
            "decode_32k": (128, 32768, 16, 16),
            "long_500k": (1, 524288, 16, 16)}[shape])
        assert d["flops_per_chip"] == want["flops"]
        assert d["flops_per_chip_xla_cpu"] == want["flops_xla_cpu"]
        assert d["flops_per_chip"] < d["flops_per_chip_xla_cpu"]
        assert d["roofline"]["compute_s"] == pytest.approx(
            d["flops_per_chip"] / PEAK_FLOPS)
        assert d["collectives_checked"] is True
        assert set(d["collectives_moved"]) == set(d["collectives"])
        assert d["collectives_moved"]["total"] >= d["collectives"]["total"]
        assert d["hlo_collective_loop_factor"] == cfg.n_layers
        assert d["roofline"]["collective_s"] == pytest.approx(
            d["collectives"]["total"] / 450e9)
    capsys.readouterr()
    report.main(["--results", str(tmp_path), "--mesh", "single_pod_16x16"])
    out = capsys.readouterr().out
    assert out.startswith("4/4 cells built; 4/4 fit 80 GB HBM/chip")
    perf_lab.main(["--arch", "qwen3-1.7b", "--shape", "train_4k"])
    out = capsys.readouterr().out
    assert "qwen3-1.7b/train_4k mode=cp" in out and "->" in out
    assert "GB moved" in out and "unverified" not in out


def test_dryrun_marks_the_collectives_not_held_to_the_reference(
        monkeypatch, capsys):
    """No LM layout is left whose collective count is not held to the
    reference's HLO: every LM record the dry run writes, on the 16 x 16
    and 2 x 16 x 16 meshes and on one rank, is marked
    ``collectives_checked`` (one rank runs no collective), and so is
    every SMOKE tp and cp train on (2, 2) and (2, 4), with and without
    remat, each a cell of ``HLO_CELLS``; perf_lab prints no
    "unverified". The bytes moved are never below the parse's count, and
    above it in every cp train across ranks (the weight and embedding
    gradients' tuples the parse reads as 0). The rank's local run and
    the probe are stubbed: their figures are held elsewhere."""
    from repro_torch.launch import perf_lab
    monkeypatch.setattr(dryrun, "lm_local_run", lambda *a: {
        "temp_bytes": 0, "raw_cost": {}, "layers_run": 0})
    monkeypatch.setattr(dryrun, "lm_cell_cost", lambda *a: {
        "flops": 1.0, "flops_xla_cpu": 1.0, "bytes": 1.0})
    meshes = {"single_pod_16x16": mesh.make_production_mesh(),
              "multi_pod_2x16x16": mesh.make_production_mesh(
                  multi_pod=True),
              "ranks_1": mesh.make_mesh((1, 1), ("data", "model"))}
    for name, m in meshes.items():
        for arch in LM_ARCHS:
            spec = get_arch(arch)
            for cell in spec.cells:
                rec = dryrun.run_lm_cell(spec, cell, m, name)
                assert rec["ok"], (name, arch, cell.name, rec.get("error"))
                assert rec["collectives_checked"] is True
                assert "collectives_unchecked" not in rec
                assert (rec["collectives"]["total"] > 0) == (m.size > 1)
                moved = rec["collectives_moved"]["total"]
                counted = rec["collectives"]["total"]
                if rec["mode"] == "cp" and m.size > 1:
                    assert moved > counted, (name, arch, cell.name)
                else:
                    assert moved >= counted, (name, arch, cell.name)
    for shape in ((2, 2), (2, 4)):
        for arch in LM_ARCHS:
            for kind in ("train", "train_tp", "train_remat",
                         "train_tp_remat"):
                assert (arch, kind, shape) in HLO_CELLS
                spec, cell, plan, m = _smoke_plan_lm(arch, kind, shape)
                assert plan.meta["mode"] == (
                    "tp" if kind.startswith("train_tp") else "cp")
                rec = dryrun.run_lm_cell(spec, cell, m, "smoke")
                assert rec["ok"] and rec["collectives_checked"] is True
    capsys.readouterr()
    perf_lab.main(["--arch", "deepseek-v2-lite-16b", "--shape", "train_4k"])
    out = capsys.readouterr().out
    assert "deepseek-v2-lite-16b/train_4k mode=cp" in out
    assert "unverified" not in out
