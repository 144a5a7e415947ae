"""The port's LM family (``repro_torch.models.transformer``, the five LM
configs, ``token_batch``, the LM cells and launcher) against the JAX
package's, on the CPU. Parameters are the reference's
``init_params(PRNGKey(0), cfg)`` carried by ``load_jax_params``; tokens
are the reference's ``token_batch``, handed over as numpy.

Tolerances. float32: rtol 1e-5, atol 1e-4 (hidden states and logits of
magnitude ~1-5; the two differ by ~5e-6, from the order of the sums in
the products). bfloat16 (the configs' default): the loss within rtol
2e-2 on all five archs; the hidden states within a relative L2 error of
2e-2 on the three dense archs. An MoE arch's router can pick another
expert for a token whose top-k scores tie within a bf16 rounding, which
moves that token's state by O(1) (qwen3-moe's SMOKE model does so for
one of 32 tokens), so its bf16 states are not compared element-wise.
Train steps: losses rtol 1e-5, parameters rtol 1e-5 and atol 2 Σ lr_t
(an element whose gradient is near 0 can flip the sign of its Adam
step). Decode against the port's own forward: 2e-4 (dense), 5e-4 (MLA),
with the MoE capacity raised so that no assignment drops (a forward of
S tokens and S one-token decodes then route alike).
"""
import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.data.synthetic import token_batch as j_token_batch
from repro.launch import cells as jcells
from repro.launch.mesh import make_mesh
from repro.models import transformer as jtr
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.elastic import check_divisibility as j_check_divisibility
from repro_torch.configs.registry import ShapeCell, get_arch
from repro_torch.data.synthetic import token_batch
from repro_torch.launch import cells
from repro_torch.models import transformer as tr
from repro_torch.models.common import hint
from repro_torch.models.convert import load_jax_opt_state, load_jax_params
from repro_torch.train.elastic import check_divisibility
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_leaves
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"
LM_ARCHS = ["deepseek-v2-lite-16b", "glm4-9b", "granite-34b", "qwen3-1.7b",
            "qwen3-moe-235b-a22b"]
DENSE = ["glm4-9b", "granite-34b", "qwen3-1.7b"]
F32 = dict(rtol=1e-5, atol=1e-4)
BF16 = 2e-2
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _configs(arch, dtype=torch.float32, **overrides):
    """(JAX config, port config) of ``arch``'s SMOKE at ``dtype``."""
    j = dataclasses.replace(j_get_arch(arch).smoke, dtype=JDTYPE[dtype],
                            **overrides)
    t = dataclasses.replace(get_arch(arch).smoke, dtype=dtype, **overrides)
    return j, t


def _no_drops(cfg):
    """``cfg`` with a capacity every expert assignment fits."""
    if cfg.moe is None:
        return cfg
    cf = max(8.0, cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _carry(jparams, tcfg):
    model = tr.init_params(torch.Generator().manual_seed(5), tcfg,
                           device=CPU)
    return load_jax_params(model, jax.tree.map(np.asarray, jparams))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jtr.init_params(jax.random.PRNGKey(0), j_get_arch(arch).smoke)


def _batch(vocab, b=2, s=16, step=0):
    jb = j_token_batch(0, step, b, s, vocab)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(ref, got):
    ref, got = _np(ref), _np(got)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# registry, parameters, batches
# ---------------------------------------------------------------------------

def test_five_lm_archs_assigned():
    from repro_torch.configs.registry import all_arch_ids
    assert [a for a in all_arch_ids() if get_arch(a).family == "lm"] == \
        LM_ARCHS


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_equal_the_reference(arch):
    for attr in ("config", "smoke"):
        ref, got = getattr(j_get_arch(arch), attr), getattr(get_arch(arch),
                                                            attr)
        assert got.n_params == ref.n_params
        assert got.n_active_params == ref.n_active_params
    assert get_arch(arch).smoke.dtype is torch.bfloat16


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_has_the_reference_paths_and_law(arch):
    """State-dict keys are the reference's paths, shapes equal, the law
    (norms at 1, ``embed`` std ~0.02, a weight's std ~ its fan-in
    scale) is the reference's; and the count is ``n_params``."""
    cfg = get_arch(arch).smoke
    model = tr.init_params(torch.Generator().manual_seed(0), cfg,
                           device=CPU)
    ref = jax.tree_util.tree_flatten_with_path(_jax_params(arch))[0]
    want = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in ref}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    assert torch.equal(model.layers.ln1, torch.ones_like(model.layers.ln1))
    assert abs(float(model.embed.detach().std()) - 0.02 * 0.88) < 0.002
    wq = model.layers.wq.detach()
    assert abs(float(wq.std()) * math.sqrt(wq.shape[1]) - 0.88) < 0.05
    assert float(wq.abs().max()) * math.sqrt(wq.shape[1]) <= 2.0 + 1e-5
    assert sum(v.numel() for k, v in model.state_dict().items()
               if "ln" not in k and "norm" not in k) == cfg.n_params


def test_token_batch_law_and_determinism():
    """A pure function of (seed, step); targets shifted by one; rows are
    progressions mod vocab with strides in [1, 7), ~5% noised by +13;
    another step or seed gives another batch."""
    vocab, b, s = 97, 64, 40
    one = token_batch(3, 5, b, s, vocab, device=CPU)
    two = token_batch(3, 5, b, s, vocab, device=CPU)
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert one["tokens"].dtype == one["targets"].dtype == torch.int32
    assert one["tokens"].shape == (b, s)
    assert torch.equal(one["tokens"][:, 1:], one["targets"][:, :-1])
    toks = torch.cat([one["tokens"], one["targets"][:, -1:]], 1).long()
    assert int(toks.min()) >= 0 and int(toks.max()) < vocab
    # the clean step between neighbours is the row's stride: its mode
    steps = (toks[:, 1:] - toks[:, :-1]) % vocab
    stride = torch.mode(steps, dim=1).values
    assert int(stride.min()) >= 1 and int(stride.max()) <= 6
    assert len(set(stride.tolist())) == 6
    ramp = stride[:, None] * torch.arange(s + 1)
    start = torch.mode((toks - ramp) % vocab, dim=1).values
    clean = (start[:, None] + ramp) % vocab
    noised = toks != clean
    assert torch.equal(toks[noised], (clean[noised] + 13) % vocab)
    assert 0.03 < float(noised.float().mean()) < 0.07
    assert not torch.equal(one["tokens"],
                           token_batch(3, 6, b, s, vocab, device=CPU)["tokens"])
    assert not torch.equal(one["tokens"],
                           token_batch(4, 5, b, s, vocab, device=CPU)["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            token_batch(3, 5, b, s, vocab)


# ---------------------------------------------------------------------------
# forward, loss, decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward_loss(arch, dtype):
    jcfg, _ = _configs(arch, dtype)
    jb, _ = _batch(jcfg.vocab)
    params = _jax_params(arch)
    h = jax.jit(lambda p, t: jtr.forward(p, t, jcfg))(params, jb["tokens"])
    loss = jax.jit(lambda p, t, g: jtr.loss_fn(p, t, g, jcfg))(
        params, jb["tokens"], jb["targets"])
    return np.asarray(h.astype(jnp.float32)), float(loss)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss_equal_the_reference(arch):
    for dtype in (torch.float32, torch.bfloat16):
        _, tcfg = _configs(arch, dtype)
        model = _carry(_jax_params(arch), tcfg)
        _, tb = _batch(tcfg.vocab)
        ref_h, ref_loss = _jax_forward_loss(arch, dtype)
        with torch.no_grad():
            h = tr.forward(model, tb["tokens"], tcfg)
            loss = tr.loss_fn(model, tb["tokens"], tb["targets"], tcfg)
        assert h.dtype == dtype and h.shape == (2, 16, tcfg.d_model)
        assert loss.dtype == torch.float32
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(h), ref_h, **F32)
            np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
        else:
            np.testing.assert_allclose(float(loss), ref_loss, rtol=BF16)
            if arch in DENSE:
                assert _rel_l2(ref_h, h) < BF16


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_equals_the_reference_and_the_forward(arch):
    """12 tokens one at a time through the cache (float32): the logits
    and the cache equal the reference's decode, and the last logits
    equal the port's own forward's next-token logits."""
    jcfg, tcfg = _configs(arch)
    jcfg, tcfg = _no_drops(jcfg), _no_drops(tcfg)
    model = _carry(_jax_params(arch), tcfg)
    s = 12
    jb, tb = _batch(tcfg.vocab, b=3, s=s, step=1)
    jcache = jtr.init_cache(jcfg, 3, s, dtype=jnp.float32)
    tcache = tr.init_cache(tcfg, 3, s, dtype=torch.float32, device=CPU)
    dec = jax.jit(lambda p, c, t, n: jtr.decode_step(p, c, t, n, jcfg))
    for i in range(s):
        jlog, jcache = dec(_jax_params(arch), jcache, jb["tokens"][:, i],
                           jnp.full((3,), i, jnp.int32))
        tlog, out = tr.decode_step(model, tcache, tb["tokens"][:, i],
                                   torch.full((3,), i, dtype=torch.int32),
                                   tcfg)
        assert out is tcache  # written in place
        np.testing.assert_allclose(_np(tlog), _np(jlog), **F32,
                                   err_msg=f"token {i}")
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **F32, err_msg=name)
    with torch.no_grad():
        h = tr.forward(model, tb["tokens"], tcfg)
    tol = 5e-4 if tcfg.mla is not None else 2e-4
    np.testing.assert_allclose(_np(tlog), _np(h[:, -1] @ model.lm_head),
                               rtol=tol, atol=tol)


def test_loss_chunks_and_truncation_equal_the_reference():
    """Chunked cross-entropy equals the unchunked one; at S = 20 with
    chunk 16 only the first 16 positions count (attention blocks of 4
    tile S), as in the reference."""
    arch = "qwen3-1.7b"
    _, tcfg = _configs(arch)
    model = _carry(_jax_params(arch), tcfg)
    _, tb = _batch(tcfg.vocab)
    with torch.no_grad():
        l16 = tr.loss_fn(model, tb["tokens"], tb["targets"], tcfg)
        l4 = tr.loss_fn(model, tb["tokens"], tb["targets"],
                        dataclasses.replace(tcfg, loss_chunk=4))
    np.testing.assert_allclose(float(l4), float(l16), rtol=1e-5)

    jcfg, tcfg = _configs(arch, q_chunk=4, kv_chunk=4, loss_chunk=16)
    jb, tb = _batch(tcfg.vocab, s=20)
    ref = jtr.loss_fn(_jax_params(arch), jb["tokens"], jb["targets"], jcfg)
    with torch.no_grad():
        got = tr.loss_fn(model, tb["tokens"], tb["targets"], tcfg)
        h = tr.forward(model, tb["tokens"], tcfg)
        logits = h[:, :16] @ model.lm_head
        first16 = torch.nn.functional.cross_entropy(
            logits.reshape(-1, tcfg.vocab), tb["targets"][:, :16].reshape(-1)
            .long())
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(first16), rtol=1e-5)
    with pytest.raises(ValueError, match="not a multiple"):
        tr.forward(model, tb["tokens"], dataclasses.replace(tcfg, q_chunk=16))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _naive_attention(q, k, v):
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    scores = torch.einsum("bqkgd,bckd->bkgqc", qg, k) / dh ** 0.5
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool))
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bkgqc,bckd->bqkgd", p, v).reshape(b, s, h, -1)


@pytest.mark.parametrize("form", ["blockwise", "direct"])
def test_attention_forms_equal_dense_and_the_reference(form, monkeypatch):
    """Online-softmax attention (both forms) == naive causal softmax ==
    the reference's function, values and the gradient of a loss through
    q, k and v; with the score tile cut to one, two and three KV chunks
    of rows, so the port's row tiles, the tiles past a chunk (no mask),
    the rows before it (all masked) and the skipped chunks all run."""
    rng = np.random.default_rng(3)
    b, s, h, kv, dh = 2, 64, 8, 2, 16
    q, k, v = (rng.normal(size=(b, s, n, dh)).astype(np.float32)
               for n in (h, kv, kv))
    w = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    if form == "blockwise":
        chunks = {"q_chunk": 8, "kv_chunk": 16}
        jfn = functools.partial(jtr.blockwise_attention, **chunks)
        tfn = functools.partial(tr.blockwise_attention, **chunks)
    else:
        jfn = functools.partial(jtr.direct_attention, kv_chunk=16)
        tfn = functools.partial(tr.direct_attention, kv_chunk=16)
    ref, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(jfn(*a) * w), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    for tile in (tr.ATTN_TILE_ELEMS, b * h * 16 * 16, 2 * b * h * 16 * 16,
                 3 * b * h * 16 * 16):
        monkeypatch.setattr(tr, "ATTN_TILE_ELEMS", tile)
        out = tfn(tq, tk, tv)
        np.testing.assert_allclose(_np(out), _np(_naive_attention(
            tq, tk, tv)), rtol=1e-5, atol=1e-5)
        terms = out * torch.from_numpy(w)
        loss = torch.sum(terms)
        grads = torch.autograd.grad(loss, (tq, tk, tv))
        # a sum of 16,384 terms: 1e-5 of their absolute sum
        np.testing.assert_allclose(float(loss), float(ref), rtol=0, atol=1e-5
                                   * float(terms.detach().abs().sum()))
        for a, g in zip(jgrads, grads):
            np.testing.assert_allclose(_np(g), np.asarray(a), rtol=1e-4,
                                       atol=1e-4)
    with pytest.raises(ValueError, match="not a multiple"):
        tfn(tq[:, :60], tk[:, :60], tv[:, :60])


def test_decode_attention_equals_the_reference():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 8, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, 10, 2, 16)).astype(np.float32)
              for _ in range(2))
    n = np.array([1, 6, 10], np.int32)
    ref = jtr.decode_attention(q, kc, vc, n)
    got = tr.decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc, n)))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_steps_equal_the_reference(arch):
    """The port's train cell (``build_lm_train``) against the reference's
    (``baseline=True`` on a one-device mesh: the config unchanged), three
    steps of the cell's schedule from one state, float32."""
    jspec, tspec = (dataclasses.replace(s, config=dataclasses.replace(
        s.smoke, dtype=dt)) for s, dt in ((j_get_arch(arch), jnp.float32),
                                          (get_arch(arch), torch.float32)))
    cell = ShapeCell("t", "train", {"seq": 16, "batch": 2})
    jplan = jcells.build_lm_train(jspec, cell, make_mesh((1, 1),
                                                         ("data", "model")),
                                  baseline=True)
    tplan = cells.build_cell(tspec, cell)
    assert tplan.meta == {"kind": "train", "tokens": 32, "layers": 2,
                          "batch": 2, "seq": 16}
    jparams = _jax_params(arch)
    model = load_jax_params(tplan.init(torch.Generator().manual_seed(1),
                                       device=CPU),
                            jax.tree.map(np.asarray, jparams))
    jopt = j_adamw_init(jparams)
    topt = load_jax_opt_state(model, jax.tree.map(np.asarray, jopt))
    jstep = jax.jit(jplan.fn)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(tspec.config.vocab, step=i)
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        model, topt, tm = tplan.fn(model, topt, tb)
        lr_sum += float(tm["lr"])
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        ref, got = jax.tree.leaves(jparams), tree_leaves(model)
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-5,
                                       atol=2 * lr_sum, err_msg=f"step {i}")
    assert int(topt["step"]) == 3 and lr_sum > 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_train_step_reduces_loss(arch):
    """The reference's claim on the port: 8 steps (peak lr 1e-2) over two
    repeating batches lower the loss, every loss finite; the layers run
    under checkpointing (remat) here."""
    cfg = dataclasses.replace(get_arch(arch).smoke, remat=True)

    def loss(params, batch):
        return tr.loss_fn(params, batch["tokens"], batch["targets"], cfg)

    init, step = make_train_step(loss, peak_lr=1e-2, warmup=1, total=100)
    model = tr.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    opt = init(model)
    losses = []
    for i in range(8):
        batch = token_batch(0, i % 2, 4, 16, cfg.vocab, device=CPU)
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


def test_remat_changes_no_gradient():
    """``remat=True`` (each layer and loss chunk checkpointed) gives the
    gradients of the plain run, bit for bit."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").smoke,
                              dtype=torch.float32)
    model = tr.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    batch = token_batch(0, 0, 2, 16, cfg.vocab, device=CPU)
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss = tr.loss_fn(model, batch["tokens"], batch["targets"], c)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------------------
# cells, the launcher's helpers, elastic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_prefill_and_decode_cells_equal_the_reference(arch):
    jspec, tspec = (dataclasses.replace(s, config=dataclasses.replace(
        s.smoke, dtype=dt)) for s, dt in ((j_get_arch(arch), jnp.float32),
                                          (get_arch(arch), torch.float32)))
    mesh = make_mesh((1, 1), ("data", "model"))
    jparams = _jax_params(arch)
    model = _carry(jparams, tspec.config)
    pre = ShapeCell("p", "prefill", {"seq": 16, "batch": 2})
    jb, tb = _batch(tspec.config.vocab)
    ref = jcells.build_lm_prefill(jspec, pre, mesh).fn(jparams, jb["tokens"])
    with torch.no_grad():
        got = cells.build_cell(tspec, pre).fn(model, tb["tokens"])
    np.testing.assert_allclose(_np(got), _np(ref), **F32)
    dec = ShapeCell("d", "decode", {"seq": 8, "batch": 2})
    jplan, tplan = jcells.build_lm_decode(jspec, dec, mesh), \
        cells.build_cell(tspec, dec)
    assert tplan.meta["kv_len"] == 8 and tplan.meta["kind"] == "decode"
    jcache = jtr.init_cache(jspec.config, 2, 8)
    tcache = tr.init_cache(tspec.config, 2, 8, device=CPU)
    n = np.array([0, 3], np.int32)
    jlog, jcache = jplan.fn(jparams, jcache, jb["tokens"][:, 0], n)
    tlog, tcache = tplan.fn(model, tcache, tb["tokens"][:, 0],
                            torch.from_numpy(n))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **F32)
    for name in jcache:
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **F32)


def test_hint_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert hint(x, ("data",), "model") is x
    assert hint(x, None, None) is x


class FakeMesh:
    axis_names = ("data", "model")
    devices = np.empty((2, 4))


@pytest.mark.parametrize("spec,raises", [
    ((None, None), False), (("model", None), False), ((None, "data"), False),
    ((None, "model"), True), ((("data", "model"), None), False),
    ((None, ("data", "model")), True), (("data", "model"), True)])
def test_check_divisibility_raises_where_the_reference_does(spec, raises):
    """The reference's cases (``tests/test_checkpoint.py``: a (7, 4) leaf
    against an extent of 2) and more, on a mesh and on a mapping; the
    message is the reference's."""
    from jax.sharding import PartitionSpec as P
    tree = {"a": {"w": np.zeros((8, 6))}, "b": [np.zeros((16, 7))]}
    jspecs = {"a": {"w": P(*spec)}, "b": [P("model", None)]}
    specs = {"a": {"w": spec}, "b": [("model", None)]}
    try:
        j_check_divisibility(tree, jspecs, FakeMesh())
        ref = None
    except ValueError as e:
        ref = str(e)
    assert (ref is not None) == raises
    ttree = {"a": {"w": torch.zeros(8, 6)}, "b": [torch.zeros(16, 7)]}
    for mesh in (FakeMesh(), {"data": 2, "model": 4}):
        if raises:
            with pytest.raises(ValueError) as err:
                check_divisibility(ttree, specs, mesh)
            assert str(err.value) == ref
            assert "not divisible by mesh extent" in ref
        else:
            check_divisibility(ttree, specs, mesh)


def test_check_divisibility_the_reference_case_and_a_module():
    class Mesh1:
        axis_names = ("model",)
        devices = np.empty((2,))

    with pytest.raises(ValueError, match=r"\['w'\]: dim 0 of shape \(7, 4\) "
                                         r"not divisible by mesh extent 2"):
        check_divisibility({"w": torch.zeros(7, 4)}, {"w": ("model", None)},
                           Mesh1())
    check_divisibility({"w": torch.zeros(7, 4)}, {"w": ("model", None)},
                       {"model": 1})
    model = tr.init_params(torch.Generator().manual_seed(0),
                           get_arch("glm4-9b").smoke, device=CPU)
    specs = {"embed": ("model", None), "lm_head": (None, "model"),
             "final_ln": None, "layers": None}
    check_divisibility(model, specs, {"model": 8})
    with pytest.raises(ValueError, match=r"\['embed'\]: dim 0"):
        check_divisibility(model, specs, {"model": 3})
