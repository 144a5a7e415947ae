"""repro_torch stands alone: no import of jax or of the repro package, an
import that leaves jax unloaded, CUDA by default with no silent move to
the CPU, and NotImplementedError (never a fallback) for what is not
ported yet."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.fold_engine import get_engine
from repro_torch.core.lpa import LPAConfig, lpa, lpa_move, build_workspace
from repro_torch.device import resolve_device
from repro_torch.graphs import generators as tgen
from repro_torch.graphs.csr import build_csr
from _torch_parity import CPU

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
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    bad = [(str(f.relative_to(SRC)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_import_leaves_jax_unloaded():
    # the kernel module first: it must import without a cycle on its own
    code = ("import sys, repro_torch.kernels.mg_sketch.fused, repro_torch.core, "
            "repro_torch.graphs.generators, repro_torch.kernels.build; "
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
    {"fold_backend": "pallas_stream"},
    {"method": "exact"},
    {"method": "bm"},
    {"rescan": True},
    {"frontier_gate": True, "frontier_sparse": True},
    {"mg_variant": "exact_weighted"},
])
def test_unported_configs_raise(overrides):
    g = tgen.ring_of_cliques(4, 4, device=CPU)[0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lpa(g, LPAConfig(**overrides), device=CPU)


def test_auto_on_a_large_graph_raises():
    """8·|E| past the reference's 8 MiB budget resolves "auto" to the
    unported streamed engine: that raises, it does not fall back."""
    n = 600_000  # a chain: 2·(n-1) > 2**20 directed entries
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    g = build_csr(edges, n, device=CPU)
    assert 8 * g.n_edges > 8 * 2**20
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        lpa(g, LPAConfig(fold_backend="auto"), device=CPU)
    with pytest.raises(NotImplementedError):
        get_engine("auto", n_entries=g.n_edges)
    assert get_engine("auto", n_entries=1000).name == "pallas_fused"


def test_unported_engines_and_requests_raise():
    with pytest.raises(NotImplementedError):
        get_engine("pallas")
    with pytest.raises(NotImplementedError):
        get_engine("jnp", mg_variant="exact_weighted")
    with pytest.raises(ValueError):
        get_engine("nope")
    g = tgen.ring_of_cliques(4, 4, device=CPU)[0]
    ws = build_workspace(g, LPAConfig(fold_backend="pallas_fused"))
    labels = torch.arange(g.n_nodes, dtype=torch.int32)
    frontier = torch.ones(g.n_nodes, dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        lpa_move(ws, labels, True, 1, LPAConfig(fold_backend="pallas_fused"),
                 frontier=frontier, sparse=True, cap_rows=4)
    with pytest.raises(NotImplementedError):
        lpa_move(ws, labels, True, 1,
                 LPAConfig(method="bm", fold_backend="pallas_fused"))
