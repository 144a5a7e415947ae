"""The port's optimizer, schedule and gradient compression
(``repro_torch.optim``) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances (float32 in another order of sums, and XLA may contract a
multiply and an add into one rounding):

  * ``adamw_update``, 5 steps from one state: parameters, moments and the
    grad norm rtol 1e-6 (atol 1e-7 for values near zero), ``step`` equal
    (and bit for bit the leaf-by-leaf form of the update, which the
    batched one replaces);
  * ``cosine_schedule`` over steps 0-120: rtol 1e-6;
  * ``compress_int8``: ``q`` equal, ``scale`` and ``err`` rtol 1e-6
    (atol 1e-7), and ``decompress_int8`` likewise.

Then the reference's own claims (``tests/test_optim.py``) on the port:
convergence, decay, clipping, the norm, and error feedback.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim.schedule import cosine_schedule as j_cosine
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import tree_leaves
from _torch_adamw_oracle import check_batched_update
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _tree(rng):
    """A parameter-shaped tree: dicts (keys not in sorted order), a list,
    and leaves of several shapes."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(5, 4)).astype(np.float32),
                        "b": rng.normal(size=(4,)).astype(np.float32)}
                       for _ in range(2)],
            "a_bias": rng.normal(size=(3,)).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(ref, got, rtol=1e-6, atol=1e-7, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("cfg", [AdamWConfig(),
                                 AdamWConfig(clip_norm=1e3,
                                             weight_decay=0.0)],
                         ids=["clipped", "unclipped"])
def test_adamw_update_equals_the_reference(cfg):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jcfg = jadamw.AdamWConfig(**cfg.__dict__)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    jupd = jax.jit(lambda g, s, p, lr: jadamw.adamw_update(g, s, p, lr, jcfg))
    for i in range(5):
        grads = jax.tree.map(lambda x: (3 * rng.normal(size=x.shape))
                             .astype(np.float32), params)
        lr = np.float32(1e-2 * (i + 1))
        jp, js, jst = jupd(jax.tree.map(jnp.asarray, grads), js, jp, lr)
        tp, ts, tst = adamw_update(_to_torch(grads), ts, tp,
                                   torch.tensor(lr), cfg)
        _close(jst["grad_norm"], tst["grad_norm"], what=f"norm, step {i}")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for name, ref, got in (("params", jp, tp), ("m", js["m"], ts["m"]),
                               ("v", js["v"], ts["v"])):
            for a, b in zip(jax.tree.leaves(ref), tree_leaves(got)):
                _close(a, b.numpy(), what=f"{name}, step {i}")


def test_batched_update_equals_the_leaf_by_leaf_form(monkeypatch):
    """One multi-tensor launch per operation changes no rounding, over
    all the leaves at once or in groups of leaves (a leaf larger than a
    group alone)."""
    check_batched_update("cpu")
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "GROUP_ELEMS", 32)
    assert adamw._groups([3, 4, 296, 30]) == [(0, 2), (2, 3), (3, 4)]
    check_batched_update("cpu")


def test_global_norm_takes_the_reference_leaf_order():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    ref = jadamw.global_norm(jax.tree.map(jnp.asarray, tree))
    _close(ref, global_norm(_to_torch(tree)).numpy())
    assert [tuple(x.shape) for x in tree_leaves(_to_torch(tree))] == \
        [x.shape for x in jax.tree.leaves(tree)]


def test_cosine_schedule_equals_the_reference():
    for peak, warmup, total in ((1e-3, 10, 100), (3e-4, 100, 10000),
                                (3e-3, 0, 50)):
        steps = np.arange(121, dtype=np.int32)
        ref = jax.vmap(lambda s: j_cosine(s, peak, warmup, total))(steps)
        got = torch.stack([cosine_schedule(torch.tensor(s), peak, warmup,
                                           total) for s in steps])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert float(cosine_schedule(0, 1e-3, 10, 100)) == 0.0


def test_compress_int8_equals_the_reference():
    rng = np.random.default_rng(2)
    g = (rng.normal(size=(512,)) * 5).astype(np.float32)
    err = (rng.normal(size=(512,)) * 0.01).astype(np.float32)
    g[:4] = [127.0, -63.5, 0.5, -0.5]  # halves: rounding to even
    jq, js, je = jcomp.compress_int8(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(js, ts.numpy())
    _close(je, te.numpy())
    _close(jcomp.decompress_int8(jq, js), decompress_int8(tq, ts).numpy())
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])),
                       torch.tensor([0.0, 2.0, 2.0, -0.0]))


# -- the reference's claims (tests/test_optim.py) on the port ---------------

def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.0)
    target = torch.tensor([1.0, 2.0, -1.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(g, state, params, 0.05, cfg)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 2.0, -1.0],
                               atol=0.05)


def test_adamw_weight_decay_shrinks():
    params = {"w": torch.tensor([10.0])}
    state = adamw_init(params)
    cfg = AdamWConfig(weight_decay=0.5)
    p2, _, _ = adamw_update({"w": torch.zeros(1)}, state, params, 0.1, cfg)
    assert float(p2["w"][0]) < 10.0


def test_grad_clipping():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    g = {"w": torch.full((4,), 100.0)}
    _, state2, stats = adamw_update(g, state, params, 0.1, cfg)
    assert float(stats["grad_norm"]) == 200.0
    # post-clip first moment magnitude bounded by (1-b1)*clipped
    m = state2["m"]["w"].numpy()
    assert np.abs(m).max() <= (1 - cfg.b1) * 1.0 / 2 + 1e-6


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == 5.0


def test_cosine_schedule_shape():
    lr0 = float(cosine_schedule(torch.tensor(0, dtype=torch.int32), 1e-3,
                                10, 100))
    lr_w = float(cosine_schedule(torch.tensor(10, dtype=torch.int32), 1e-3,
                                 10, 100))
    lr_end = float(cosine_schedule(torch.tensor(100, dtype=torch.int32),
                                   1e-3, 10, 100))
    assert lr0 < 2e-4
    assert lr_w == max(lr0, lr_w, lr_end)
    assert lr_end < 0.2 * lr_w


def test_int8_compression_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, scale, new_err = compress_int8(g, torch.zeros_like(g))
    deq = decompress_int8(q, scale)
    # quantization error bounded by one step
    assert float(torch.max(torch.abs(deq - g))) <= float(scale) + 1e-6
    # error feedback carries the exact residual
    np.testing.assert_allclose(new_err.numpy(), (g - deq).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_error_feedback_accumulates_small_gradients():
    """A gradient far below one quantization step is not lost: error
    feedback accumulates it until it crosses a step."""
    g = torch.tensor([127.0, 0.3])
    err = torch.zeros(2)
    sent = np.zeros(2)
    for _ in range(10):
        q, scale, err = compress_int8(g, err)
        sent += decompress_int8(q, scale).numpy()
    assert abs(sent[1] - 3.0) < 1.1  # within one quantization step


def test_a_module_is_updated_in_place_and_its_state_is_its_tree(
        monkeypatch):
    """A module's state is shaped like its parameter tree (the reference's
    paths), and the update writes the module's own parameters, group by
    group, to the values a tree of the same leaves gets."""
    from repro_torch.models.recsys.dcn_v2 import init_dcn
    from repro_torch.configs.registry import get_arch
    model = init_dcn(torch.Generator().manual_seed(0),
                     get_arch("dcn-v2").smoke, device="cpu")
    state = adamw_init(model)
    assert sorted(state["m"]) == ["cross", "head", "mlp", "tables"]
    assert state["m"]["cross"][1]["w"].shape == model.cross[1].w.shape
    before = model.head.detach().clone()
    grads = {k: v for k, v in state["m"].items()}
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    monkeypatch.setattr(adamw, "GROUP_ELEMS", 64)
    tree = tree_map(lambda x: x.detach().clone(), model)
    want, _, _ = adamw_update(grads, state, tree, 0.1)
    new, state, _ = adamw_update(grads, state, model, 0.1)
    assert new is model
    assert not torch.equal(model.head, before)  # decayed in place
    assert int(state["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(want),
                                                 tree_leaves(model)))
