"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the CPU: the reference's ``init_moe(PRNGKey(0), ...)``
carried by ``load_jax_params``, inputs made with numpy.

  * ``moe_ffn`` in float32 (rtol 1e-5, atol 1e-5) without drops, with
    drops (capacity factor 0.5), with ``n_groups=2`` (a group's capacity
    is its own), with shared experts, and the gradients of a loss
    through it for every parameter and the input (rtol 1e-4, atol 1e-5);
    in bfloat16 within a relative L2 error of 2e-2;
  * the group dispatch and combine, field for field (slots, keep flags,
    tokens exact; the dispatched rows and probabilities exact copies);
  * ``router_aux_loss`` (rtol 1e-6);

then the reference's own claims (``tests/test_models_lm.py``) on the
port: permutation equivariance without drops, finite outputs with
drops; and ``ep_mesh`` raising.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.models.convert import load_jax_params
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
CASES = {
    "no_drops": dict(n_experts=8, top_k=2, d_expert_ff=16,
                     capacity_factor=8.0),
    "drops": dict(n_experts=4, top_k=1, d_expert_ff=8, capacity_factor=0.5),
    "groups": dict(n_experts=8, top_k=2, d_expert_ff=16,
                   capacity_factor=1.0, n_groups=2),
    "shared": dict(n_experts=8, top_k=3, d_expert_ff=16, n_shared=2,
                   d_shared_ff=24, capacity_factor=1.25),
    "unnormed": dict(n_experts=6, top_k=2, d_expert_ff=8,
                     router_norm_topk=False),
}
D = 32


def _carried(case, seed=0):
    jcfg, tcfg = jmoe.MoEConfig(**CASES[case]), moe.MoEConfig(**CASES[case])
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, D)
    tp = moe.init_moe(torch.Generator().manual_seed(seed), tcfg, D,
                      device=CPU)
    return jcfg, tcfg, jp, load_jax_params(tp, jax.tree.map(np.asarray, jp))


def _x(shape=(2, 16, D), seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_equals_the_reference(case):
    jcfg, tcfg, jp, tp = _carried(case)
    x = _x()
    w = _x(seed=2)
    jfn = jax.jit(lambda p, xx: jmoe.moe_ffn(p, xx, jcfg))
    jgrads = jax.jit(jax.grad(lambda p, xx: jnp.sum(jfn(p, xx) * w),
                              argnums=(0, 1)))(jp, x)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_ffn(tp, tx, tcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfn(jp, x)),
                               rtol=1e-5, atol=1e-5)
    loss = torch.sum(out * torch.from_numpy(w))
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(loss, [*tp.parameters(), tx])
    for name, g in zip(names + ["x"], grads):
        want = jgrads[1] if name == "x" else jgrads[0][name]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # bfloat16 activations (the experts cast to them at each product)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    refb = np.asarray(jfn(jp, xb).astype(jnp.float32))
    gotb = moe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert gotb.dtype == torch.bfloat16
    gotb = gotb.detach().float().numpy()
    assert np.linalg.norm(gotb - refb) / np.linalg.norm(refb) < 2e-2


@pytest.mark.parametrize("case", ["drops", "groups", "shared"])
def test_dispatch_and_combine_equal_the_reference(case):
    """One group through ``_dispatch_group`` and ``_combine_group``: the
    stable sort's order, the capacity's drops (to the dump slot) and the
    float32 scatter-add, against the reference's."""
    cfg = CASES[case]
    e, k = cfg["n_experts"], cfg["top_k"]
    rng = np.random.default_rng(5)
    t = 16
    xt = rng.normal(size=(t, D)).astype(np.float32)
    # ties in the expert ids: the stable order decides who drops
    top_e = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    top_p = rng.random((t, k)).astype(np.float32)
    cap = max(1, int(np.ceil(t * k / e * cfg.get("capacity_factor", 1.25))))
    ref = jmoe._dispatch_group(xt, top_e, top_p, e, cap)
    got = moe._dispatch_group(*(torch.from_numpy(a) for a in
                                (xt, top_e, top_p)), e, cap)
    for name, a, b in zip(("dispatched", "slot", "keep", "token", "prob"),
                          ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    assert not bool(got[2].all()) or case == "shared"
    y = rng.normal(size=(e, cap, D)).astype(np.float32)
    ref_c = jmoe._combine_group(y, *ref[1:], t)
    got_c = moe._combine_group(torch.from_numpy(y), *got[1:], t)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-6,
                               atol=1e-6)


def test_router_aux_loss_equals_the_reference():
    jcfg, tcfg, jp, tp = _carried("shared")
    x = _x(seed=3)
    np.testing.assert_allclose(
        float(moe.router_aux_loss(tp, torch.from_numpy(x), tcfg)),
        float(jmoe.router_aux_loss(jp, x, jcfg)), rtol=1e-6)


def test_moe_routing_conservation():
    """Without drops, permuting the tokens of a sequence permutes the
    outputs (the dispatch is bookkeeping)."""
    _, cfg, _, params = _carried("no_drops")
    x = torch.from_numpy(_x((2, 8, D)))
    with torch.no_grad():
        y = moe.moe_ffn(params, x, cfg)
        perm = torch.tensor([3, 1, 0, 2, 7, 5, 6, 4])
        y_perm = moe.moe_ffn(params, x[:, perm], cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y_perm.numpy(), y[:, perm].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_moe_capacity_drops_are_bounded():
    """A capacity factor of 0.5 drops assignments: dropped tokens give
    zeros, not NaN, and equal the reference's."""
    jcfg, cfg, jp, params = _carried("drops")
    x = _x((1, 16, D))
    with torch.no_grad():
        y = moe.moe_ffn(params, torch.from_numpy(x), cfg)
    assert bool(torch.isfinite(y).all())
    assert int((y.abs().sum(-1) == 0).sum()) > 0  # some tokens dropped
    np.testing.assert_allclose(y.numpy(), np.asarray(jmoe.moe_ffn(
        jp, x, jcfg)), rtol=1e-5, atol=1e-5)


def test_ep_mesh_raises():
    """The reference's shard_map path has no one-card meaning: setting
    ``ep_mesh`` raises, never falls back."""
    _, cfg, _, params = _carried("groups")
    import dataclasses
    cfg = dataclasses.replace(cfg, ep_mesh=object(), hint_expert_axis="model")
    with pytest.raises(ValueError, match="ep_mesh"):
        moe.moe_ffn(params, torch.from_numpy(_x()), cfg)
