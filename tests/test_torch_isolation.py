"""repro_torch stands alone: no import of jax or of the repro package, an
import that leaves jax unloaded, CUDA by default with no silent move to
the CPU, every configuration the reference accepts running (the per-bucket
backend, sparse frontier mode and the exact weighted variant, once
refused, now equal to the reference's runs), and "auto" past the budget
running the streamed engine."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.lpa import LPAConfig as JConfig
from repro.core.lpa import lpa as jlpa
from repro.graphs import generators as jgen
from repro_torch.core.fold_engine import get_engine
from repro_torch.core.lpa import LPAConfig, lpa, lpa_move, build_workspace
from repro_torch.device import resolve_device
from repro_torch.graphs import generators as tgen
from repro_torch.graphs.csr import build_csr
from test_torch_lpa import _assert_same_run
from _torch_parity import CPU, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_import_in_the_port():
    """The package, ``chip_smoke.py`` (run where JAX is not installed),
    the port's examples and the tests' rank helpers import neither JAX
    nor the JAX package."""
    root = SRC.parent
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    scripts = [root / "chip_smoke.py"] + sorted(
        (root / "examples").glob("*_torch.py")) + sorted(
        (root / "tests").glob("_torch_*ranks.py"))
    assert len(scripts) >= 2
    bad = [(str(f.relative_to(root)), name) for f in files + scripts
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_import_leaves_jax_unloaded():
    # the kernel module first: it must import without a cycle on its own
    code = ("import sys, repro_torch.kernels.mg_sketch.fused, "
            "repro_torch.kernels.frontier, "
            "repro_torch.kernels.mg_sketch.streaming, "
            "repro_torch.kernels.mg_sketch.ops, "
            "repro_torch.kernels.mg_sketch.mg_sketch, "
            "repro_torch.kernels.mg_sketch.ref, repro_torch.core, "
            "repro_torch.core.distributed, "
            "repro_torch.graphs.generators, repro_torch.kernels.build, "
            "repro_torch.graphs.sampler, repro_torch.data.synthetic, "
            "repro_torch.models.common, repro_torch.models.convert, "
            "repro_torch.models.gnn, repro_torch.models.gnn.wigner, "
            "repro_torch.configs.pna, repro_torch.configs.meshgraphnet, "
            "repro_torch.configs.egnn, repro_torch.configs.equiformer_v2, "
            "repro_torch.configs.lpa_graphs, repro_torch.launch.cells, "
            "repro_torch.launch.serve, repro_torch.tree, "
            "repro_torch.optim, repro_torch.optim.adamw, "
            "repro_torch.optim.schedule, repro_torch.optim.compression, "
            "repro_torch.checkpoint, repro_torch.checkpoint.manager, "
            "repro_torch.train, repro_torch.train.steps, "
            "repro_torch.train.loop, repro_torch.models.recsys, "
            "repro_torch.models.recsys.embedding, "
            "repro_torch.models.recsys.dcn_v2, repro_torch.configs.dcn_v2, "
            "repro_torch.launch.train, repro_torch.launch.train_cells, "
            "repro_torch.train.elastic, repro_torch.models.moe, "
            "repro_torch.models.transformer, repro_torch.configs.qwen3_1p7b, "
            "repro_torch.configs.qwen3_moe_235b_a22b, "
            "repro_torch.configs.deepseek_v2_lite_16b, "
            "repro_torch.configs.granite_34b, repro_torch.configs.glm4_9b, "
            "repro_torch.launch.mesh, repro_torch.launch.roofline, "
            "repro_torch.launch.dryrun, repro_torch.launch.report, "
            "repro_torch.launch.cost, repro_torch.launch.live_bytes, "
            "repro_torch.launch.probes, repro_torch.launch.perf_lab, "
            "repro_torch.models.sharding; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "[]"


def test_cuda_is_the_default_device():
    """device=None means CUDA: without a card that raises; with one the
    graph lands on it. Nothing moves to the CPU unasked."""
    edges = np.asarray([[0, 1], [1, 2]])
    if torch.cuda.is_available():
        assert build_csr(edges, 3).offsets.device.type == "cuda"
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_csr(edges, 3)
        with pytest.raises(RuntimeError):
            tgen.chain_kmer(50)
        with pytest.raises(RuntimeError):
            resolve_device()
    assert build_csr(edges, 3, device=CPU).offsets.device.type == "cpu"


def test_lpa_refuses_a_graph_on_another_device():
    g = tgen.ring_of_cliques(4, 4, device=CPU)[0]
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            lpa(g, LPAConfig(), device="cuda")
    else:
        with pytest.raises(RuntimeError):
            lpa(g, LPAConfig())
    assert lpa(g, LPAConfig(), device=CPU).labels.device.type == "cpu"


@pytest.mark.parametrize("overrides", [
    {"fold_backend": "pallas"},
    {"frontier_gate": True, "frontier_sparse": True},
    {"mg_variant": "exact_weighted"},
])
def test_unported_configs_raise(overrides):
    """The configurations this package once refused run now, and give
    the JAX package's run (labels, iterations and every history)."""
    gj = jgen.ring_of_cliques(4, 4)[0]
    ref = jlpa(gj, JConfig(rho=2, **overrides))
    got = lpa(carry_graph(gj), LPAConfig(rho=2, **overrides), device=CPU)
    _assert_same_run(ref, got)


def _large_chain():
    """A chain whose 2·(n-1) directed entries put 8·|E| past the
    reference's 8 MiB budget."""
    n = 600_000
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    g = build_csr(edges, n, device=CPU)
    assert 8 * g.n_edges > 8 * 2**20
    return g


def test_auto_on_a_large_graph_raises():
    """Past the budget "auto" resolves to the streamed engine, sparse
    frontier mode included (equal to the dense gated run there); what
    still raises is "auto" without the entry volume to resolve it."""
    g = _large_chain()
    cfg = dict(fold_backend="auto", frontier_gate=True, k=4, chunk=16,
               max_iters=3, track_frontier=False)
    ws = build_workspace(g, LPAConfig(**cfg))
    assert ws.bundle.spec.backend == "pallas_stream"
    dense = lpa(g, LPAConfig(**cfg), ws=ws, device=CPU)
    sparse = lpa(g, LPAConfig(frontier_sparse=True, **cfg), ws=ws,
                 device=CPU)
    assert torch.equal(dense.labels, sparse.labels)
    assert dense.changed_history == sparse.changed_history
    with pytest.raises(ValueError, match="n_entries"):
        get_engine("auto")
    assert get_engine("auto", n_entries=g.n_edges).name == "pallas_stream"
    assert get_engine("auto", n_entries=1000).name == "pallas_fused"


def test_auto_on_a_large_graph_streams():
    """8·|E| past the reference's budget resolves "auto" to the streamed
    engine, which runs and equals the fused engine's run."""
    g = _large_chain()
    cfg = dict(k=4, chunk=16, max_iters=2, track_frontier=False)
    ws = build_workspace(g, LPAConfig(fold_backend="auto", **cfg))
    assert ws.bundle.spec.backend == "pallas_stream"
    assert ws.stream_plan is not None and ws.fused_plan is None
    got = lpa(g, LPAConfig(fold_backend="auto", **cfg), ws=ws, device=CPU)
    ref = lpa(g, LPAConfig(fold_backend="pallas_fused", **cfg), device=CPU)
    assert torch.equal(got.labels, ref.labels)
    assert got.changed_history == ref.changed_history
    assert got.iterations == ref.iterations == 2


def test_unported_engines_and_requests_raise():
    """Every backend name resolves (``pallas`` to the per-bucket engine,
    ``exact_weighted`` to the plain engine's variant); an unknown name
    raises; a sparse request and an ``exact_weighted`` config run on the
    fused engine, the first equal to the dense move on the frontier, the
    second computing the paper's rule, as the reference's engines do."""
    assert get_engine("pallas").name == "pallas"
    assert get_engine("jnp", mg_variant="exact_weighted").mg_variant == \
        "exact_weighted"
    with pytest.raises(ValueError):
        get_engine("nope")
    g = tgen.ring_of_cliques(4, 4, device=CPU)[0]
    cfg = LPAConfig(fold_backend="pallas_fused")
    ws = build_workspace(g, cfg)
    labels = torch.arange(g.n_nodes, dtype=torch.int32)
    frontier = torch.zeros(g.n_nodes, dtype=torch.bool)
    frontier[::3] = True
    dense, _ = lpa_move(ws, labels, True, 1, cfg, frontier=frontier)
    sparse, _ = lpa_move(ws, labels, True, 1, cfg, frontier=frontier,
                         sparse=True, cap_rows=4)
    assert torch.equal(dense, sparse)
    paper, _ = lpa_move(ws, labels, True, 1, cfg)
    variant, _ = lpa_move(ws, labels, True, 1,
                          LPAConfig(fold_backend="pallas_fused",
                                    mg_variant="exact_weighted"))
    assert torch.equal(paper, variant)
