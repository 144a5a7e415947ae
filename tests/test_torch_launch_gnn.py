"""The GNN and recsys half of the port's dry run (``repro_torch.launch``:
the mesh layouts of ``cells.build_gnn_cell``, ``build_gnn_sampled_cell``
and ``build_recsys_cell``, ``cells.rank_step``, and the GNN and recsys
branch of ``dryrun``) against the reference's ``repro.launch``.

One subprocess on 512 forced XLA host devices (``ref_model_cells``)
builds the reference's plans of every GNN and DCN-v2 cell on both
production meshes and compiles the SMOKE cells on (2, 2) meshes (every
arch) and (2, 4) meshes (PNA and DCN-v2): the collective bytes its
roofline parses out of the HLO, XLA's argument size and its FLOPs. The
rank-local steps run over 2 gloo ranks (``_torch_launch_gnn_ranks``)
from weights carried from the reference.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.registry import get_arch as ref_get_arch
from repro.launch.cells import build_cell as ref_build_cell
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.core.distributed import spawn_ranks
from repro_torch.launch import dryrun, mesh, report
from repro_torch.launch.cells import build_cell, rank_step
from repro_torch.train.elastic import leaves_with_specs
import _torch_launch_gnn_ranks as ranks
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GNN_ARCHS = ("pna", "meshgraphnet", "egnn", "equiformer-v2")
ARCHS = GNN_ARCHS + ("dcn-v2",)
#: the SMOKE cells compiled for their HLO: kind -> cell params
SMOKE_CELLS = {
    "gnn_full": {"n_nodes": 62, "n_edges": 250, "d_feat": 8},
    "gnn_sampled": {"batch_nodes": 6, "fanouts": (3, 2), "d_feat": 8},
    "recsys_train": {"batch": 96},
    "recsys_serve": {"batch": 96},
    "retrieval": {"batch": 1, "n_candidates": 62},
}
HLO_CELLS = tuple(
    [(a, k, (2, 2)) for a in GNN_ARCHS for k in ("gnn_full", "gnn_sampled")]
    + [("dcn-v2", k, (2, 2))
       for k in ("recsys_train", "recsys_serve", "retrieval")]
    + [("pna", k, (2, 4)) for k in ("gnn_full", "gnn_sampled")]
    + [("dcn-v2", k, (2, 4))
       for k in ("recsys_train", "recsys_serve", "retrieval")])

_REF = """
    import dataclasses, json
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs.registry import ShapeCell, get_arch
    from repro.launch.cells import build_cell
    from repro.launch.mesh import make_production_mesh
    from repro.launch.roofline import collective_bytes

    def spec_json(sp):
        return [list(e) if isinstance(e, tuple) else e for e in sp]

    def is_sharding(x):
        return isinstance(x, NamedSharding)

    out = {"plans": {}, "hlo": {}}
    for name, m in (("single", make_production_mesh()),
                    ("multi", make_production_mesh(multi_pod=True))):
        for arch in ARCHS:
            spec = get_arch(arch)
            for cell in spec.cells:
                plan = build_cell(spec, cell, m)
                leaves = jax.tree.leaves(plan.args)
                shardings = jax.tree.leaves(plan.in_shardings,
                                            is_leaf=is_sharding)
                out["plans"][f"{name}/{arch}/{cell.name}"] = {
                    "meta": plan.meta,
                    "argument_bytes": sum(
                        int(np.prod(sh.shard_shape(a.shape)))
                        * np.dtype(a.dtype).itemsize
                        for a, sh in zip(leaves, shardings)),
                    "specs": [spec_json(sh.spec) for sh in shardings],
                    "shapes": [[list(a.shape), str(a.dtype)]
                               for a in leaves]}
    for arch, kind, shape in HLO_CELLS:
        spec = get_arch(arch)
        spec = dataclasses.replace(spec, config=spec.smoke)
        m = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(
            shape), ("data", "model"))
        plan = build_cell(spec, ShapeCell("smoke", kind, SMOKE_CELLS[kind]),
                          m)
        with m:
            compiled = jax.jit(
                plan.fn, in_shardings=plan.in_shardings,
                donate_argnums=plan.donate_argnums).lower(
                    *plan.args).compile()
        out["hlo"][f"{arch}/{kind}/{shape[0]}x{shape[1]}"] = {
            "meta": plan.meta,
            "collectives": collective_bytes(compiled.as_text()),
            "flops": float(compiled.cost_analysis()["flops"]),
            "argument_bytes":
                int(compiled.memory_analysis().argument_size_in_bytes)}
    with open(OUT, "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref_model_cells(tmp_path_factory):
    """The reference's GNN and DCN-v2 plans on both production meshes,
    and its SMOKE cells compiled on (2, 2) and (2, 4) meshes."""
    out = tmp_path_factory.mktemp("ref_model_cells") / "cells.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    code = (f"OUT = {str(out)!r}\nARCHS = {ARCHS!r}\n"
            f"HLO_CELLS = {HLO_CELLS!r}\nSMOKE_CELLS = {SMOKE_CELLS!r}\n"
            + textwrap.dedent(_REF))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _flat(args, specs) -> list:
    """(shape and dtype, spec) of every input leaf in the reference's leaf
    order, specs as JSON gives them."""
    return [([list(t.shape), str(t.dtype).replace("torch.", "")],
             [list(e) if isinstance(e, tuple) else e for e in sp])
            for _, t, sp in leaves_with_specs(args, specs)]


def _smoke(arch: str, kind: str):
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke)
    return spec, ShapeCell("smoke", kind, dict(SMOKE_CELLS[kind]))


# ---------------------------------------------------------------------------
# the plans on the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_plans_equal_the_reference(ref_model_cells, arch):
    """Every cell's plan on the 16 x 16 and 2 x 16 x 16 meshes: the
    reference's meta (padded counts, layout, batch, candidates), every
    input's shape, dtype and spec in its leaf order, and the per-rank
    argument bytes of its shard shapes; without a mesh the plan is the
    one-card plan it was."""
    spec = get_arch(arch)
    for name, m in (("single", mesh.make_production_mesh()),
                    ("multi", mesh.make_production_mesh(multi_pod=True))):
        for cell in spec.cells:
            ref = ref_model_cells["plans"][f"{name}/{arch}/{cell.name}"]
            plan = build_cell(spec, cell, m)
            assert plan.meta == ref["meta"], (name, cell.name)
            flat = _flat(plan.args, plan.specs)
            assert [s for s, _ in flat] == ref["shapes"], (name, cell.name)
            assert [sp for _, sp in flat] == ref["specs"], (name, cell.name)
            assert dryrun.spec_bytes(plan.args, plan.specs, m) == \
                ref["argument_bytes"], (name, cell.name)
    for cell in spec.cells:
        plan = build_cell(spec, cell)
        assert plan.args is None and plan.specs is None


# ---------------------------------------------------------------------------
# the SMOKE cells against the reference's compiled HLO
# ---------------------------------------------------------------------------

#: how far the port's FLOPs of a rank's step may sit from XLA's
#: ``cost_analysis`` of the reference's (relative). They count different
#: programs: a rank of the port gathers the node tables and then runs
#: its N/P nodes and E/P edges and its AdamW leaf by leaf, each aten op
#: in ``CostCounter``'s conventions; XLA counts the HLO of GSPMD's
#: partitioned module, with the selects, compares and index arithmetic
#: of its resharding and of its own gathers and scatters. On these cells
#: the port's figure is 0.76-0.99 of XLA's (0.93 for PNA's tree step on
#: one device, where no partitioning is involved).
FLOPS_TOL = 0.25


@pytest.mark.parametrize("arch,kind,shape", HLO_CELLS,
                         ids=[f"{a}-{k}-{s[0]}x{s[1]}"
                              for a, k, s in HLO_CELLS])
def test_model_collectives_equal_the_reference_hlo(ref_model_cells, arch,
                                                    kind, shape):
    """The SMOKE cell on a (2, 2) or (2, 4) mesh: the count's total and
    each op of at least 1% of it within 1% of what the reference's
    roofline parses out of the compiled step; the argument bytes equal
    XLA's argument size; the rank's FLOPs within ``FLOPS_TOL``."""
    ref = ref_model_cells["hlo"][f"{arch}/{kind}/{shape[0]}x{shape[1]}"]
    m = mesh.make_mesh(shape, ("data", "model"))
    spec, cell = _smoke(arch, kind)
    plan = build_cell(spec, cell, m)
    assert plan.meta == ref["meta"]
    count = (dryrun.gnn_collective_bytes if arch != "dcn-v2"
             else dryrun.recsys_collective_bytes)
    got, want = count(plan, m), ref["collectives"]
    assert got["total"] == pytest.approx(want["total"], rel=0.01, abs=1e-9)
    for op, b in want.items():
        if b >= 0.01 * want["total"]:
            assert got.get(op, 0.0) == pytest.approx(b, rel=0.01), op
    unused = 0
    if kind == "retrieval":
        # jax.jit drops the inputs a step never reads (keep_unused=False):
        # retrieval scores the query without the logit head
        head = plan.args[0]["head"]
        unused = head.numel() * head.element_size()
    assert dryrun.spec_bytes(plan.args, plan.specs, m) == \
        ref["argument_bytes"] + unused
    flops = dryrun.model_local_run(plan, m)["raw_cost"]["flops"]
    print(arch, kind, shape, "flops port/ref", flops / ref["flops"])
    assert flops == pytest.approx(ref["flops"], rel=FLOPS_TOL)


def test_collectives_move_what_the_parse_drops():
    """The tree layout's one all-reduce (every gradient and the loss in
    a tuple of more than five) parses to 0; ``moved`` counts it whole,
    which is what the data-parallel step's ``ShardComm`` records."""
    m = mesh.make_mesh((4, 1), ("data", "model"))
    spec, cell = _smoke("pna", "gnn_sampled")
    plan = build_cell(spec, cell, m)
    colls = dryrun._gnn_collectives(plan, m)
    n_params = sum(t.numel() for _, t, _ in
                   leaves_with_specs(plan.args[0], plan.specs[0]))
    assert colls.totals() == {"total": 0.0, "all-reduce": 0.0}
    assert colls.moved() == {"all-reduce": 8.0 * (n_params + 1),
                             "total": 8.0 * (n_params + 1)}
    one = mesh.make_mesh((1, 1), ("data", "model"))
    assert dryrun._gnn_collectives(build_cell(spec, cell, one),
                                   one).moved() == {"total": 0}


# ---------------------------------------------------------------------------
# the rank-local steps
# ---------------------------------------------------------------------------

#: the rank steps' loss against the one-card step's (rtol = atol)
LOSS_TOL = {"pna": 1e-4, "meshgraphnet": 1e-4, "egnn": 1e-4,
            "equiformer-v2": 1e-3, "dcn-v2": 1e-4}
#: the gloo runs: (arch, kind, mesh shape)
RANK_RUNS = tuple((a, "gnn_full", (2, 1)) for a in GNN_ARCHS) + (
    ("pna", "gnn_sampled", (2, 1)), ("dcn-v2", "recsys_train", (1, 2)),
    ("dcn-v2", "recsys_train", (2, 1)))


def _ref_inputs(arch: str, kind: str, rng) -> tuple:
    """The reference's SMOKE params (numpy) and a batch for ``kind``
    (2-rank sizes), and the reference's one-card loss on them."""
    spec = ref_get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke)
    one = ref_make_mesh((1, 1), ("data", "model"))
    f32 = np.float32
    if kind == "gnn_full":
        n, e = 64, 256
        cell = ref_build_cell(spec, ShapeCell("r", kind, {
            "n_nodes": n, "n_edges": e, "d_feat": 8}), one)
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        src[-5:] = n            # padded edges at the dump row
        batch = {"node_feat": rng.normal(size=(n, 8)).astype(f32),
                 "labels": rng.integers(0, 16, n).astype(np.int32),
                 "edge_src": src.astype(np.int32),
                 "edge_dst": dst.astype(np.int32),
                 "coords": rng.normal(size=(n, 3)).astype(f32),
                 "edge_feat": rng.normal(size=(e, 4)).astype(f32)}
    elif kind == "gnn_sampled":
        b, (v_t, e_t) = 8, (10, 9)
        cell = ref_build_cell(spec, ShapeCell("r", kind, {
            "batch_nodes": b, "fanouts": (3, 2), "d_feat": 8}), one)
        batch = {"node_feat": rng.normal(size=(b, v_t, 8)).astype(f32),
                 "labels": rng.integers(0, 16, (b, v_t)).astype(np.int32),
                 "edge_src": rng.integers(0, v_t + 1, (b, e_t)
                                          ).astype(np.int32),
                 "edge_dst": rng.integers(0, v_t, (b, e_t)).astype(np.int32)}
    else:
        cfg = spec.config
        cell = ref_build_cell(spec, ShapeCell("r", kind, {"batch": 32}), one)
        batch = {"dense": rng.normal(size=(32, cfg.n_dense)).astype(f32),
                 "sparse": np.stack([rng.integers(0, v, 32)
                                     for v in cfg.vocab_sizes],
                                    1).astype(np.int32),
                 "labels": rng.integers(0, 2, 32).astype(f32)}
    batch = {k: v for k, v in batch.items() if k in cell.args[2]}
    from repro.optim.adamw import adamw_init
    key = jax.random.PRNGKey(0)
    if arch == "dcn-v2":
        from repro.models.recsys.dcn_v2 import init_dcn
        params = init_dcn(key, spec.config)
    else:
        from repro.launch.cells import _gnn_init
        params = _gnn_init(spec, _cell_config(arch, spec))(key)
    _, _, metrics = jax.jit(cell.fn)(params, adamw_init(params),
                                     jax.tree.map(np.asarray, batch))
    return (jax.tree.map(np.asarray, params), batch,
            float(metrics["loss"]))


def _cell_config(arch, spec):
    if arch == "meshgraphnet":
        return dataclasses.replace(spec.config, d_node_in=8, d_edge_in=4,
                                   d_out=16)
    return dataclasses.replace(spec.config, d_in=8, d_out=16)


@pytest.fixture(scope="module")
def rank_losses():
    """Every run of ``RANK_RUNS`` over 2 gloo ranks, from the reference's
    weights: ``{(arch, kind, shape): (reference loss, [(one-card loss,
    rank-step loss)] per rank)}``."""
    rng = np.random.default_rng(0)
    runs = [(arch, kind, shape) + _ref_inputs(arch, kind, rng)
            for arch, kind, shape in RANK_RUNS]
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(ranks.rank_losses, 2, ([r[:5] for r in runs], tmp),
                    device="cpu")
        got = [json.loads(Path(tmp, f"rank{k}.json").read_text())
               for k in range(2)]
    return {r[:3]: (r[5], [got[k][i] for k in range(2)])
            for i, r in enumerate(runs)}


@pytest.mark.parametrize("arch,kind,shape", RANK_RUNS,
                         ids=[f"{a}-{k}-{s[0]}x{s[1]}"
                              for a, k, s in RANK_RUNS])
def test_rank_step_loss_equals_the_one_card_step(rank_losses, arch, kind,
                                                  shape):
    """``cells.rank_step`` on each of 2 gloo ranks (the full graph's
    node and edge shards, the tree layout's trees, DCN-v2's table rows on
    'model' or its batch on 'data') gives the one-card step's loss, and
    the reference's, from weights carried from the reference."""
    ref, per_rank = rank_losses[(arch, kind, shape)]
    tol = LOSS_TOL[arch]
    for one_card, ranked in per_rank:
        assert one_card == pytest.approx(ref, rel=tol, abs=tol)
        assert ranked == pytest.approx(one_card, rel=tol, abs=tol)


def test_rank_step_on_one_rank_is_the_plain_step():
    m = mesh.make_mesh((1, 1), ("data", "model"))
    spec, cell = _smoke("pna", "gnn_full")
    plan = build_cell(spec, cell, m)
    assert rank_step(plan, m) is plan.fn


# ---------------------------------------------------------------------------
# the dry run and its report
# ---------------------------------------------------------------------------

MODEL_KEYS = {"arch", "shape", "kind", "mesh", "n_devices", "note", "ok",
              "meta", "memory", "raw_cost", "flops_per_chip",
              "bytes_per_chip", "model_flops_global", "useful_flops_ratio",
              "collectives", "collectives_moved", "collective_ops",
              "collectives_checked", "hlo_collective_loop_factor",
              "roofline", "build_s"}


def test_dryrun_all_families_on_one_rank(tmp_path, capsys, monkeypatch):
    """``--arch all --mesh single --ranks 1`` writes a record for every
    cell of the four families (no arch exits 2); with a small
    ``HBM_PER_CHIP`` the fit is false; the GNN and recsys records carry
    the reference's keys, no collective on one rank, and the report
    tabulates them beside the LM and LPA rows."""
    from repro_torch.configs import registry
    monkeypatch.setattr(dryrun, "HBM_PER_CHIP", 1e6)
    # the LM archs at one cell each (all four take minutes here;
    # tests/test_torch_launch.py runs them)
    for arch in registry.all_arch_ids():
        spec = registry.ARCHS[arch]
        if spec.family == "lm":
            monkeypatch.setitem(registry.ARCHS, arch, dataclasses.replace(
                spec, cells=[c for c in spec.cells
                             if c.name == "decode_32k"]))
    rc = dryrun.main(["--arch", "all", "--mesh", "single", "--ranks", "1",
                      "--out", str(tmp_path)])
    assert rc == 1  # web_4b and web_4b_halo cannot run on one rank
    for mesh_name in ("single_pod_16x16", "ranks_1"):
        recs = report.load(str(tmp_path), mesh_name)
        families = {get_arch(a).family for a, _ in recs}
        assert families == {"lm", "lpa", "gnn", "recsys"}, mesh_name
        for arch in ARCHS:
            cells = sorted(c.name for c in get_arch(arch).cells)
            assert sorted(s for a, s in recs if a == arch) == cells
        for (arch, shape), d in recs.items():
            if not d["ok"]:
                assert d["error"], (arch, shape)
                continue
            if arch in ARCHS:
                assert not d["memory"]["fits_80g_hbm"]
                assert set(d) == MODEL_KEYS, (arch, shape)
                if mesh_name == "ranks_1":
                    assert d["collectives"] == {"total": 0}
    out = capsys.readouterr()
    report.main(["--results", str(tmp_path), "--mesh", "ranks_1"])
    table = capsys.readouterr().out
    for arch in ARCHS + ("qwen3-1.7b", "lpa-mg8"):
        assert f"| {arch} |" in table
    assert "exit" not in out.err


def test_dryrun_model_record_on_a_mesh(tmp_path):
    """``--arch pna --mesh single``: the roofline's collective term is
    the parse's total, the FLOPs are the rank's count times P."""
    rc = dryrun.main(["--arch", "pna", "--mesh", "single", "--out",
                      str(tmp_path)])
    assert rc == 0
    recs = report.load(str(tmp_path), "single_pod_16x16")
    assert len(recs) == 4
    for (_, shape), d in recs.items():
        assert d["n_devices"] == 256 and d["collectives_checked"]
        assert d["model_flops_global"] == d["flops_per_chip"] * 256
        assert d["roofline"]["collective_s"] == pytest.approx(
            d["collectives"]["total"] / 450e9)
        assert d["collectives_moved"]["total"] >= d["collectives"]["total"]
        mem = d["memory"]
        assert mem["peak_bytes_per_device"] == (
            mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])
