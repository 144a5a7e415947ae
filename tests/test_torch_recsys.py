"""The port's recsys family (``repro_torch.models.recsys``) against the
JAX package's, on the CPU, from the JAX init carried over by
``load_jax_params`` and batches made with numpy:

  * DCN-v2 SMOKE forward, loss, retrieval scores and the gradient of the
    loss for every parameter: rtol 1e-5 (atol 1e-6; gradients atol 1e-6
    times the parameter's largest reference gradient);
  * ``embedding_bag`` single-hot, sum, mean and per-sample weights: rtol
    1e-6, atol 1e-6;
  * the reference's train step (``build_recsys_cell(...).fn`` for the
    ``train_batch`` cell at SMOKE) against the port's for 3 steps: losses
    rtol 1e-5, parameters rtol 1e-5 and atol 2 Σ lr_t (an element whose
    gradient is near 0 may flip the sign of its Adam step), and the
    serving and retrieval cells' outputs rtol 1e-5;

then the reference's own claims (``tests/test_recsys.py``) on the port,
the planted rule learned included.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.launch import cells as jcells
from repro.launch.mesh import make_mesh
from repro.models.recsys import dcn_v2 as jdcn
from repro.models.recsys.embedding import embedding_bag as j_embedding_bag
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.data.synthetic import dcn_batch
from repro_torch.launch import cells
from repro_torch.models.convert import load_jax_opt_state, load_jax_params
from repro_torch.models.recsys.dcn_v2 import (dcn_forward, dcn_loss,
                                              dcn_retrieval_scores, init_dcn)
from repro_torch.models.recsys.embedding import embedding_bag
from repro_torch.train.steps import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"


def _smoke():
    return get_arch("dcn-v2").smoke


def _carried(seed=0):
    """(jax params, port model with the same weights)."""
    jparams = jdcn.init_dcn(jax.random.PRNGKey(seed), _smoke())
    model = init_dcn(torch.Generator().manual_seed(1), _smoke(), device=CPU)
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


def _batch(rng, b, cfg):
    dense = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],
                      axis=1).astype(np.int32)
    labels = rng.integers(0, 2, b).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_loss_and_grads_equal_the_reference():
    cfg = _smoke()
    jparams, model = _carried()
    batch = _batch(np.random.default_rng(0), 64, cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _t(batch)
    ref = jax.jit(lambda p: jdcn.dcn_forward(p, jb["dense"], jb["sparse"],
                                             cfg))(jparams)
    got = dcn_forward(model, tb["dense"], tb["sparse"], cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jdcn.dcn_loss(p, jb["dense"], jb["sparse"], jb["labels"],
                                cfg)))(jparams)
    tloss, tgrad = value_and_grad(
        lambda m, b: dcn_loss(m, b["dense"], b["sparse"], b["labels"], cfg),
        model, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref_g, got_g = jax.tree.leaves(jgrad), tree_leaves(tgrad)
    assert len(ref_g) == len(got_g) == 13
    for a, b in zip(ref_g, got_g):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(a).max()))


def test_retrieval_scores_equal_the_reference():
    cfg = _smoke()
    jparams, model = _carried(2)
    rng = np.random.default_rng(2)
    q = _batch(rng, 2, cfg)
    cand = rng.normal(size=(300, cfg.d_interact + cfg.mlp_dims[-1])
                      ).astype(np.float32)
    ref = jdcn.dcn_retrieval_scores(jparams, jnp.asarray(q["dense"]),
                                    jnp.asarray(q["sparse"]),
                                    jnp.asarray(cand), cfg)
    with torch.no_grad():
        got = dcn_retrieval_scores(model, torch.from_numpy(q["dense"]),
                                   torch.from_numpy(q["sparse"]),
                                   torch.from_numpy(cand), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False),
                                           ("sum", True), ("mean", True)])
def test_embedding_bag_equals_the_reference(mode, weighted):
    rng = np.random.default_rng(3)
    v, d, b = 17, 3, 6
    table = rng.normal(size=(v, d)).astype(np.float32)
    lens = rng.integers(0, 5, b)  # an empty bag among them
    lens[2] = 0
    ids = rng.integers(0, v, int(lens.sum())).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    w = rng.random(len(ids)).astype(np.float32) if weighted else None
    ref = j_embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                          offsets=jnp.asarray(offsets),
                          weights=None if w is None else jnp.asarray(w),
                          mode=mode)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        offsets=torch.from_numpy(offsets),
                        weights=None if w is None else torch.from_numpy(w),
                        mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    single = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(
        single.numpy(), np.asarray(j_embedding_bag(jnp.asarray(table),
                                                   jnp.asarray(ids))))


def _smoke_spec(get):
    spec = get("dcn-v2")
    return dataclasses.replace(spec, config=spec.smoke)


def test_recsys_cells_equal_the_reference():
    """``build_recsys_cell`` at SMOKE: the train step (3 steps), the
    serving forward and the retrieval scores."""
    jspec, tspec = _smoke_spec(j_get_arch), _smoke_spec(get_arch)
    mesh = make_mesh((1, 1), ("data", "model"))
    cell = [c for c in jspec.cells if c.kind == "recsys_train"][0]
    small = dataclasses.replace(cell, params={"batch": 128})
    jplan = jcells.build_recsys_cell(jspec, small, mesh)
    tplan = cells.build_recsys_cell(
        tspec, ShapeCell(small.name, small.kind, dict(small.params)))
    assert tplan.config == tspec.smoke
    jparams, model = _carried(4)
    jopt = j_adamw_init(jparams)
    topt = load_jax_opt_state(model, jax.tree.map(np.asarray, jopt))
    jstep = jax.jit(jplan.fn)
    rng = np.random.default_rng(4)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(rng, 128, tspec.smoke)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
        model, topt, tm = tplan.fn(model, topt, _t(batch))
        lr_sum += float(tm["lr"])
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for a, b in zip(jax.tree.leaves(jparams), tree_leaves(model)):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=1e-5, atol=2 * lr_sum)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    q = _batch(rng, 4, tspec.smoke)
    for kind in ("recsys_serve", "retrieval"):
        jc = [c for c in jspec.cells if c.kind == kind][0]
        jc = dataclasses.replace(jc, params={**jc.params, "batch": 4,
                                             "n_candidates": 50})
        jp = jcells.build_recsys_cell(jspec, jc, mesh)
        tp = cells.build_recsys_cell(tspec, ShapeCell(jc.name, jc.kind,
                                                      dict(jc.params)))
        args = [q["dense"], q["sparse"]]
        if kind == "retrieval":
            d_q = tspec.smoke.d_interact + tspec.smoke.mlp_dims[-1]
            args.append(rng.normal(size=(50, d_q)).astype(np.float32))
        ref = jp.fn(jparams, *map(jnp.asarray, args))
        with torch.no_grad():
            got = tp.fn(model, *map(torch.from_numpy, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


# -- the reference's claims (tests/test_recsys.py) on the port ---------------

def test_embedding_bag_single_hot_is_gather():
    table = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    ids = torch.tensor([3, 0, 3], dtype=torch.int32)
    assert torch.equal(embedding_bag(table, ids), table[[3, 0, 3]])


def test_embedding_bag_per_sample_weights():
    table = torch.eye(4)
    out = embedding_bag(table, torch.tensor([0, 1, 2]),
                        offsets=torch.tensor([0, 2]),
                        weights=torch.tensor([0.5, 2.0, 3.0]))
    np.testing.assert_allclose(out.numpy(),
                               [[0.5, 2.0, 0.0, 0.0], [0, 0, 3.0, 0]])


def test_cross_layer_formula():
    """x_{l+1} = x0 * (W x_l + b) + x_l, checked against explicit numpy."""
    cfg = _smoke()
    model = init_dcn(torch.Generator().manual_seed(0), cfg, device=CPU)
    rng = np.random.default_rng(0)
    b = 5
    dense = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],
                      axis=1).astype(np.int32)
    with torch.no_grad():
        logits = dcn_forward(model, torch.from_numpy(dense),
                             torch.from_numpy(sparse), cfg).numpy()
    assert logits.shape == (b,)
    p = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    x0 = np.concatenate([dense] + [p[f"tables.table_{i}"][sparse[:, i]]
                                   for i in range(cfg.n_sparse)], axis=1)
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * (x @ p[f"cross.{i}.w"] + p[f"cross.{i}.b"]) + x
    h = x0
    for i in range(len(cfg.mlp_dims)):
        h = np.maximum(h @ p[f"mlp.{i}.w"] + p[f"mlp.{i}.b"], 0.0)
    ref = np.concatenate([x, h], axis=1) @ p["head"]
    np.testing.assert_allclose(logits, ref[:, 0], rtol=1e-4, atol=1e-4)


def test_dcn_loss_is_bce():
    cfg = _smoke()
    model = init_dcn(torch.Generator().manual_seed(0), cfg, device=CPU)
    tb = _t(_batch(np.random.default_rng(1), 8, cfg))
    with torch.no_grad():
        loss = dcn_loss(model, tb["dense"], tb["sparse"], tb["labels"], cfg)
        logits = dcn_forward(model, tb["dense"], tb["sparse"]).double()
    y = tb["labels"].double()
    p = torch.sigmoid(logits)
    ref = -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-4)


def test_dcn_training_learns_planted_rule():
    cfg = _smoke()
    init, step = make_train_step(
        lambda p, b: dcn_loss(p, b["dense"], b["sparse"], b["labels"], cfg),
        peak_lr=3e-3, warmup=5, total=300)
    model = init_dcn(torch.Generator().manual_seed(0), cfg, device=CPU)
    opt = init(model)
    losses = []
    for i in range(80):
        batch = dcn_batch(0, i, 256, cfg.n_dense, cfg.n_sparse,
                          cfg.vocab_sizes, device=CPU)
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    # average the last/first 5 steps (per-batch noise)
    assert np.mean(losses[-5:]) < 0.75 * np.mean(losses[:5]), losses


def test_retrieval_scores_no_loop():
    cfg = _smoke()
    model = init_dcn(torch.Generator().manual_seed(0), cfg, device=CPU)
    rng = np.random.default_rng(2)
    nc = 1000
    q = _t(_batch(rng, 1, cfg))
    cand = torch.from_numpy(rng.normal(
        size=(nc, cfg.d_interact + cfg.mlp_dims[-1])).astype(np.float32))
    with torch.no_grad():
        scores = dcn_retrieval_scores(model, q["dense"], q["sparse"], cand,
                                      cfg)
    assert scores.shape == (1, nc)
    # query is L2-normalized: scores bounded by candidate norms
    assert float(scores.abs().max()) <= float(
        torch.linalg.norm(cand, dim=1).max()) + 1e-3


def test_device_rule_and_cfg_check():
    cfg = _smoke()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_dcn(torch.Generator(), cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dcn_batch(0, 0, 4, 13, 4, cfg.vocab_sizes)
    model = init_dcn(torch.Generator().manual_seed(0), cfg, device=CPU)
    tb = _t(_batch(np.random.default_rng(5), 3, cfg))
    with pytest.raises(ValueError, match="not the model's"):
        dcn_forward(model, tb["dense"], tb["sparse"], get_arch("dcn-v2").config)
