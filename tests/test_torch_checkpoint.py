"""The port's checkpoint manager (``repro_torch.checkpoint.manager``): the
claims of the reference's ``tests/test_checkpoint.py`` but elasticity
(atomicity, retention, auto-resume, the manifest), and the layout on disk
shared with the JAX package's manager, both ways, bit for bit:

  * a checkpoint the JAX manager wrote for ``{"params": ..., "opt":
    adamw_init(...)}`` of DCN-v2 SMOKE restores into the port's template
    of the same model (a module and its AdamW state);
  * one the port wrote restores into the JAX template.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.registry import get_arch as j_get_arch
from repro.models.recsys.dcn_v2 import init_dcn as j_init_dcn
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.models.convert import load_jax_params
from repro_torch.models.recsys.dcn_v2 import init_dcn
from repro_torch.optim.adamw import adamw_init
from repro_torch.tree import tree_leaves, tree_map


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.normal(size=(4, 8)).astype(np.float32)),
                       "b": torch.from_numpy(
                rng.normal(size=(8,)).astype(np.float32))},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(100, tree)
    restored, step = mgr.restore(tree_map(torch.zeros_like, tree))
    assert step == 100
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [30, 40]
    assert mgr.latest_step() == 40


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(10, _tree())
    # simulate a crash mid-write: a step dir without MANIFEST
    os.makedirs(tmp_path / "step_00000020")
    (tmp_path / "step_00000020" / "host_0.npz").write_bytes(b"junk")
    assert mgr.latest_step() == 10
    _, step = mgr.restore(tree_map(torch.zeros_like, _tree()))
    assert step == 10


def test_tmp_dirs_never_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree())
    assert all(not n.startswith(".tmp") for n in os.listdir(tmp_path))
    assert all(not n.startswith(".tmp")
               for n in os.listdir(tmp_path / "step_00000005"))


def test_leaf_count_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"only": torch.zeros(3)})


def test_manifest_extra(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(), extra={"loss": 1.5})
    assert mgr.manifest(3)["extra"]["loss"] == 1.5
    assert mgr.manifest(3)["n_leaves"] == 3


def _jax_state():
    cfg = j_get_arch("dcn-v2").smoke
    params = j_init_dcn(jax.random.PRNGKey(3), cfg)
    opt = j_adamw_init(params)
    rng = np.random.default_rng(4)
    # moments and a step that are not zeros, so the order shows
    opt = {"m": jax.tree.map(lambda x: jnp.asarray(rng.normal(
               size=x.shape).astype(np.float32)), opt["m"]),
           "v": jax.tree.map(lambda x: jnp.asarray(rng.random(
               size=x.shape).astype(np.float32)), opt["v"]),
           "step": jnp.int32(11)}
    return {"params": params, "opt": opt}


def _port_template():
    model = init_dcn(torch.Generator().manual_seed(0),
                     get_arch("dcn-v2").smoke, device="cpu")
    return {"params": model, "opt": adamw_init(model)}


def _assert_same_state(jstate, tstate):
    ref = jax.tree.leaves(jstate)
    got = tree_leaves(tstate)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        a = np.asarray(a)
        b = b.detach().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b.view(np.int32) if b.size else b,
                                      a.view(np.int32) if a.size else a)


def test_a_jax_checkpoint_restores_into_the_port(tmp_path):
    jstate = _jax_state()
    JManager(str(tmp_path), keep=2).save(40, jstate)
    template = _port_template()
    model = template["params"]
    restored, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 40
    assert restored["params"] is model  # a module restores in place
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 11
    _assert_same_state(jstate, restored)
    # and the parameters equal the JAX ones carried by load_jax_params
    carried = load_jax_params(init_dcn(torch.Generator().manual_seed(1),
                                       get_arch("dcn-v2").smoke,
                                       device="cpu"),
                              jax.tree.map(np.asarray, jstate["params"]))
    for a, b in zip(tree_leaves(carried), tree_leaves(model)):
        assert torch.equal(a, b)


def test_a_port_checkpoint_restores_into_jax(tmp_path):
    jstate = _jax_state()
    template = _port_template()
    JManager(str(tmp_path / "j"), keep=2).save(1, jstate)
    state, _ = CheckpointManager(str(tmp_path / "j")).restore(template)
    CheckpointManager(str(tmp_path / "t")).save(2, state)
    back, step = JManager(str(tmp_path / "t")).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == 2
    _assert_same_state(back, state)


def test_leaf_order_is_the_references():
    """Trees flatten as ``jax.tree`` flattens them: dict keys sorted as
    strings (``table_10`` before ``table_2``), lists in index order (12
    layers: 10 and 11 last), and a module as the tree its state-dict
    paths spell."""
    from repro_torch.models.gnn.common import Dense
    from repro_torch.tree import param_tree

    rng = np.random.default_rng(5)
    tree = {"tables": {f"table_{i}": rng.normal(size=(2,)).astype(
                np.float32) for i in range(12)},
            "layers": [{"w": rng.normal(size=(3,)).astype(np.float32),
                        "b": rng.normal(size=(1,)).astype(np.float32)}
                       for _ in range(12)],
            "head": rng.normal(size=(4,)).astype(np.float32)}
    ref = jax.tree.leaves(tree)
    got = tree_leaves(tree)
    assert len(ref) == len(got)
    assert all(a is b for a, b in zip(ref, got))
    module = torch.nn.Module()
    module.tables = torch.nn.ParameterDict({k: torch.nn.Parameter(
        torch.from_numpy(v)) for k, v in tree["tables"].items()})
    module.layers = torch.nn.ModuleList(
        Dense(torch.from_numpy(lp["w"]), torch.from_numpy(lp["b"]))
        for lp in tree["layers"])
    module.head = torch.nn.Parameter(torch.from_numpy(tree["head"]))
    shape = param_tree(module)
    assert isinstance(shape["layers"], list) and len(shape["layers"]) == 12
    for a, b in zip(ref, tree_leaves(module)):
        assert np.array_equal(a, b.detach().numpy())
