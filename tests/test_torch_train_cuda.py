"""The training path on the card against the CPU (``repro_torch``).

Marked ``gpu``: without a CUDA device every test here skips (the decision
is taken inside the ``cuda`` fixture, never at import). On a machine with
one: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_train_cuda.py``. Imports torch and numpy only (the
card's machine has no JAX).

Each GNN arch's and DCN-v2's SMOKE train step (``launch.cells``), three
steps from one state dict, on the card and on the CPU: losses, grad
norms and every parameter within rtol 1e-4, atol 1e-4 (Equiformer-v2:
1e-3), with TF32 off; ``index_add_`` on CUDA adds in no fixed order, so
the bits may differ. The batched AdamW update equals its leaf-by-leaf
form bit for bit on the card too. The launcher on the card (``python -m
repro_torch.launch.train``, deterministic algorithms on) resumes a run
killed at step 6 to the uninterrupted run's losses, bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.data.synthetic import (dcn_batch, gnn_full_batch,
                                        molecule_batch)
from repro_torch.graphs import generators as tgen
from repro_torch.launch.cells import build_cell
from repro_torch.optim.adamw import adamw_init
from repro_torch.tree import tree_leaves
from _torch_adamw_oracle import check_batched_update

pytestmark = pytest.mark.gpu

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["pna", "meshgraphnet", "egnn", "equiformer-v2", "dcn-v2"]
TOL = {"pna": 1e-4, "meshgraphnet": 1e-4, "egnn": 1e-4,
       "equiformer-v2": 1e-3, "dcn-v2": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the training "
                    "path on the card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old[0]
    torch.set_float32_matmul_precision(old[1])


def _batches(arch, cuda):
    """Three (CPU batch, card batch) pairs and the cell of ``arch``."""
    if arch == "dcn-v2":
        cfg = get_arch(arch).smoke
        pairs = [tuple(dcn_batch(0, s, 128, cfg.n_dense, cfg.n_sparse,
                                 cfg.vocab_sizes, device=d)
                       for d in ("cpu", cuda)) for s in range(3)]
        return pairs, ShapeCell("smoke", "recsys_train", {"batch": 128})
    if arch == "equiformer-v2":
        cpu = molecule_batch(0, 8, 30, 64, 8, device="cpu")
    else:
        g, _ = tgen.powerlaw_communities(1 << 9, p_in=0.5, mix=0.02, seed=1,
                                         device="cpu")
        cpu = gnn_full_batch(0, g, d_feat=8)
    card = {k: v.to(cuda) for k, v in cpu.items()}
    cell = ShapeCell("smoke", "gnn_full",
                     {"n_nodes": cpu["node_feat"].shape[0],
                      "n_edges": cpu["edge_src"].shape[0], "d_feat": 8})
    return [(cpu, card)] * 3, cell


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_steps_on_the_card_equal_the_cpu(cuda, arch):
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke)
    pairs, cell = _batches(arch, cuda)
    plan = build_cell(spec, cell)
    model = plan.init(torch.Generator().manual_seed(0), device="cpu")
    card = plan.init(torch.Generator().manual_seed(1), device=cuda)
    card.load_state_dict(model.state_dict())
    opt, card_opt = adamw_init(model), adamw_init(card)
    assert card_opt["step"].device.type == "cuda"
    tol = TOL[arch]
    for cpu_b, card_b in pairs:
        model, opt, m = plan.fn(model, opt, cpu_b)
        card, card_opt, cm = plan.fn(card, card_opt, card_b)
        for key in ("loss", "grad_norm"):
            assert cm[key].device.type == "cuda"
            torch.testing.assert_close(cm[key].cpu(), m[key], rtol=tol,
                                       atol=tol)
    for a, b in zip(tree_leaves(card), tree_leaves(model)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=tol,
                                   atol=tol)
    for a, b in zip(tree_leaves(card_opt), tree_leaves(opt)):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)


def test_batched_adamw_equals_the_leaf_by_leaf_form_on_the_card(cuda):
    check_batched_update(cuda)


def _launch(ckpt, *extra):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dcn-v2", "--steps", "12", "--ckpt-every", "4", "--batch", "64",
         "--ckpt-dir", str(ckpt), *extra], env=env, capture_output=True,
        text=True, timeout=600)
    return proc


def test_launcher_resumes_bitwise_on_the_card(cuda, tmp_path):
    ref = _launch(tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr[-3000:]
    crash = _launch(tmp_path / "crash", "--fail-at", "6")
    assert crash.returncode != 0
    assert "injected failure at step 6" in crash.stderr
    resumed = _launch(tmp_path / "crash")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    hist = json.loads(ref.stdout.strip().splitlines()[-1])["history"]
    tail = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert tail["start"] == 4
    assert tail["history"] == hist[4:]
