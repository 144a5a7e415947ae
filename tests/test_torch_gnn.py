"""The port's GNN models against the JAX package's, on the CPU.

Every case makes its inputs with numpy from a seed and runs both
packages. Tolerances (float32 sums in another order; the reference
promises no bits here):

  * ``segment_agg``: sum, mean, max and min rtol 1e-6 (atol 1e-6 for
    sums near zero), std rtol 1e-5;
  * Wigner blocks for every l <= 6: atol 1e-5;
  * each model at its SMOKE config, from the JAX init carried over by
    ``load_jax_params``: outputs rtol 1e-4, atol 1e-5 (EGNN: h and the
    coordinates; Equiformer-v2 rtol 1e-4, atol 1e-4); the gradient of
    ``sum(out**2)`` for every parameter rtol 1e-3, atol 1e-4 times that
    parameter's largest reference gradient (observed: below 1e-5 of it);
  * the shared helpers of ``models.common``: rtol 1e-5, atol 1e-5.

The JAX side runs under ``jax.jit`` (one compile per case, not one per
op).

Then the reference's property tests on the port alone (EGNN E(n)
equivariance, Equiformer SO(3) invariance, Wigner orthogonality and
edge-to-pole, the PNA molecule shape) and the device rule."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.launch.cells import _gnn_apply as j_gnn_apply
from repro.launch.cells import _gnn_init as j_gnn_init
from repro.models import common as jcommon
from repro.models.gnn import equiformer_v2 as jeq
from repro.models.gnn import wigner as jwigner
from repro.models.gnn.common import segment_agg as j_segment_agg
from repro.models.gnn.egnn import egnn_forward as j_egnn_forward
from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import molecule_batch
from repro_torch.launch import serve
from repro_torch.launch.cells import _gnn_apply, _gnn_cell_config, _gnn_init
from repro_torch.models import common
from repro_torch.models.convert import flatten_tree, load_jax_params
from repro_torch.models.gnn import equiformer_v2 as teq
from repro_torch.models.gnn import wigner
from repro_torch.models.gnn.common import segment_agg
from repro_torch.models import gnn as tgnn
from repro_torch.models.gnn.egnn import egnn_forward
from repro_torch.models.gnn.pna import init_pna, pna_forward
from _torch_parity import CPU
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["pna", "meshgraphnet", "egnn", "equiformer-v2"]
#: forward tolerance (rtol, atol) per arch
FWD_TOL = {"pna": (1e-4, 1e-5), "meshgraphnet": (1e-4, 1e-5),
           "egnn": (1e-4, 1e-5), "equiformer-v2": (1e-4, 1e-4)}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _rand_graph(rng, n=24, e=80, d_feat=8, n_pad=4):
    """The reference tests' random graph, with its last ``n_pad`` edges
    padded (src = dst = n, the dump slot)."""
    b = {"node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
         "coords": rng.normal(size=(n, 3)).astype(np.float32),
         "edge_src": rng.integers(0, n, e).astype(np.int32),
         "edge_dst": rng.integers(0, n, e).astype(np.int32),
         "edge_feat": rng.normal(size=(e, 4)).astype(np.float32)}
    if n_pad:
        b["edge_src"][-n_pad:] = n
        b["edge_dst"][-n_pad:] = n
    return b


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _d_in(cfg):
    return getattr(cfg, "d_in", 0) or getattr(cfg, "d_node_in", 0) or 8


# -- segment aggregation and the Wigner blocks ------------------------------

@pytest.mark.parametrize("reduction", ["sum", "mean", "max", "min", "std"])
def test_segment_agg_equals_the_reference(reduction):
    rng = np.random.default_rng(1)
    e, n, f = 96, 14, 5
    msg = rng.normal(size=(e, f)).astype(np.float32)
    # segments 0..3 empty, some edges on the dump row n
    dst = rng.integers(4, n + 1, e).astype(np.int32)
    assert (dst == n).any()
    ref = j_segment_agg(jnp.asarray(msg), jnp.asarray(dst), n, (reduction,))
    got = segment_agg(torch.from_numpy(msg), torch.from_numpy(dst), n,
                      (reduction,))
    assert sorted(ref) == sorted(got)
    rtol = 1e-5 if reduction == "std" else 1e-6
    for key in ref:
        assert tuple(got[key].shape) == ref[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=rtol, atol=1e-6, err_msg=key)
    if reduction in ("max", "min", "sum"):
        assert not got[reduction][:4].any()  # empty segments read 0


def test_edge_rotations_equal_the_reference():
    """Every block l <= 6 (not only the smoke's l <= 2), on random edges,
    both poles and a zero vector; and wigner_d_real at three free angles."""
    rng = np.random.default_rng(0)
    vec = rng.normal(size=(64, 3)).astype(np.float32)
    vec[:3] = [[0, 0, 1], [0, 0, -2], [0, 0, 0]]
    ref = jax.jit(lambda v: jwigner.edge_rotations(v, 6))(jnp.asarray(vec))
    got = wigner.edge_rotations(torch.from_numpy(vec), 6)
    assert len(got) == 7
    for l, (a, b) in enumerate(zip(ref, got)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5, err_msg=f"l={l}")
    ang = rng.uniform(-np.pi, np.pi, size=(3, 16)).astype(np.float32)
    ref = jax.jit(lambda a, b, c: [jwigner.wigner_d_real(l, a, b, c)
                                   for l in range(7)])(*map(jnp.asarray, ang))
    for l, a in enumerate(ref):
        b = wigner.wigner_d_real(l, *map(torch.from_numpy, ang))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5, err_msg=f"l={l}")


def test_segment_softmax_and_so2_conv_equal_the_reference():
    """The per-head segment softmax (pad edges at -inf on the dump
    segment) and the SO(2) conv, which leaves its input as it was."""
    rng = np.random.default_rng(2)
    e, n, h = 40, 9, 3
    seg = rng.integers(0, n, e).astype(np.int32)
    seg[-5:] = n
    scores = rng.normal(size=(e, h)).astype(np.float32)
    scores[-5:] = -np.inf
    ref = jax.jit(jax.vmap(
        lambda s: jeq._segment_softmax(s, jnp.asarray(seg), n + 1),
        in_axes=1, out_axes=1))(jnp.asarray(scores))
    got = teq._segment_softmax(torch.from_numpy(scores),
                               torch.from_numpy(seg).long(), n + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert not got[-5:].any()

    cfg = j_get_arch("equiformer-v2").smoke
    params = j_gnn_init(j_get_arch("equiformer-v2"), cfg)(
        jax.random.PRNGKey(1))
    model = _gnn_init(get_arch("equiformer-v2"), cfg)(_gen(), device=CPU)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    f = rng.normal(size=(e, cfg.n_sph, cfg.d_hidden)).astype(np.float32)
    rad = rng.normal(size=(e, cfg.m_max + 1, cfg.l_max + 1)).astype(
        np.float32)
    ref = jax.jit(lambda lp, f, rad: jeq._so2_conv(lp, f, rad, cfg))(
        params["layers"][0], jnp.asarray(f), jnp.asarray(rad))
    f_t = torch.from_numpy(f.copy())
    got = teq._so2_conv(model.layers[0], f_t, torch.from_numpy(rad), cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    assert np.array_equal(f_t.numpy(), f)


# -- the four models from carried weights ------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """One arch at SMOKE: the JAX init, its forward and its gradients of
    sum(out**2), and the port's module loaded with the same weights."""
    arch = request.param
    spec, tspec = j_get_arch(arch), get_arch(arch)
    cfg = spec.smoke
    batch = _rand_graph(np.random.default_rng(0), d_feat=_d_in(cfg))
    params = j_gnn_init(spec, cfg)(jax.random.PRNGKey(0))
    apply = j_gnn_apply(spec, cfg)
    jb = _jax(batch)
    out = np.asarray(jax.jit(apply)(params, jb))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(apply(p, jb) ** 2)))(params)
    model = _gnn_init(tspec, tspec.smoke)(_gen(), device=CPU)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return {"arch": arch, "cfg": cfg, "batch": batch, "params": params,
            "out": out, "grads": flatten_tree(jax.tree.map(np.asarray, grads)),
            "model": model, "apply": _gnn_apply(tspec, tspec.smoke)}


def test_forward_equals_the_reference(carried):
    rtol, atol = FWD_TOL[carried["arch"]]
    got = carried["apply"](carried["model"], _torch(carried["batch"]))
    assert got.shape == carried["out"].shape
    np.testing.assert_allclose(got.detach().numpy(), carried["out"],
                               rtol=rtol, atol=atol)
    if carried["arch"] == "egnn":
        # both outputs: the features and the moved coordinates
        cfg = carried["cfg"]
        h_ref, x_ref = jax.jit(lambda p, b: j_egnn_forward(p, b, cfg))(
            carried["params"], _jax(carried["batch"]))
        h, x = egnn_forward(carried["model"], _torch(carried["batch"]),
                            carried["cfg"])
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_ref),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(x_ref),
                                   rtol=rtol, atol=atol)


def test_gradients_equal_the_reference(carried):
    model = carried["model"]
    model.zero_grad()
    out = carried["apply"](model, _torch(carried["batch"]))
    torch.sum(out ** 2).backward()
    grads = carried["grads"]
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(grads)
    for name, p in names.items():
        ref = grads[name]
        # a parameter the loss does not reach (EGNN's last phi_x) has no
        # gradient in torch and a zero one in JAX
        got = (p.grad.numpy() if p.grad is not None else np.zeros_like(ref))
        np.testing.assert_allclose(
            got, ref, rtol=1e-3,
            atol=1e-4 * max(float(np.abs(ref).max()), 1e-30), err_msg=name)
    assert any(float(np.abs(g).max()) > 0 for g in grads.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_reference_tree(arch):
    """The port's init gives the reference's names and shapes; each weight
    lies inside ±2·scale (scale = fan_in^-1/2), biases are 0 and the
    norm scales 1."""
    spec = j_get_arch(arch)
    ref = flatten_tree(jax.tree.map(
        np.asarray, j_gnn_init(spec, spec.smoke)(jax.random.PRNGKey(0))))
    model = _gnn_init(get_arch(arch), get_arch(arch).smoke)(_gen(3),
                                                           device=CPU)
    state = model.state_dict()
    assert sorted(state) == sorted(ref)
    for name, t in state.items():
        assert tuple(t.shape) == ref[name].shape, name
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "b":
            assert not t.any(), name
        elif leaf.startswith("ln_scale"):
            assert bool((t == 1).all()), name
        else:
            bound = 2.0 / t.shape[0] ** 0.5
            assert float(t.abs().max()) <= bound * (1 + 1e-6), name
            assert float(t.std()) > 0.3 * bound / 2, name
    # the same generator seed gives the same weights
    again = _gnn_init(get_arch(arch), get_arch(arch).smoke)(_gen(3),
                                                           device=CPU)
    assert all(torch.equal(state[k], v) for k, v in
               again.state_dict().items())


def test_load_jax_params_is_strict():
    spec = j_get_arch("pna")
    tree = jax.tree.map(np.asarray,
                        j_gnn_init(spec, spec.smoke)(jax.random.PRNGKey(0)))
    model = init_pna(_gen(), get_arch("pna").smoke, device=CPU)
    load_jax_params(model, tree)
    assert np.array_equal(model.layers[0]["msg"][1].w.detach().numpy(),
                          tree["layers"][0]["msg"][1]["w"])
    missing = dict(tree, decode=tree["decode"][:0])
    with pytest.raises(RuntimeError, match="Missing"):
        load_jax_params(model, missing)
    wrong = dict(tree, encode=[{"w": np.zeros((3, 3), np.float32),
                                "b": tree["encode"][0]["b"]}])
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_jax_params(model, wrong)


def test_common_helpers_equal_the_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 3, 8)).astype(np.float32)   # [B, S, H, D]
    gamma = rng.normal(size=(8,)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0)

    def close(got, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)

    close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    cos, sin = common.rope_angles(torch.from_numpy(pos), 8)
    jcos, jsin = jcommon.rope_angles(jnp.asarray(pos), 8)
    close(cos, jcos)
    close(sin, jsin)
    close(common.apply_rope(torch.from_numpy(x), cos, sin),
          jcommon.apply_rope(jnp.asarray(x), jcos, jsin))
    w = [rng.normal(size=s).astype(np.float32) for s in
         ((8, 12), (8, 12), (12, 8))]
    close(common.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w)),
          jcommon.swiglu(jnp.asarray(x), *map(jnp.asarray, w)))
    logits = rng.normal(size=(4, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 5)).astype(np.int32)
    close(common.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels)),
          jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    w = common.dense_init(_gen(), (64, 32))
    assert w.shape == (64, 32) and float(w.abs().max()) <= 2 / 8


# -- the reference's property tests, on the port alone ----------------------

def _rotation(rng):
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def test_egnn_equivariance():
    """h invariant, coords equivariant under rotation + translation."""
    cfg = get_arch("egnn").smoke
    rng = np.random.default_rng(2)
    batch = _rand_graph(rng, d_feat=cfg.d_in, n_pad=0)
    model = _gnn_init(get_arch("egnn"), cfg)(_gen(), device=CPU)
    with torch.no_grad():
        h1, x1 = egnn_forward(model, _torch(batch), cfg)
        rot = _rotation(rng)
        t = rng.normal(size=(1, 3)).astype(np.float32)
        moved = dict(batch, coords=batch["coords"] @ rot.T + t)
        h2, x2 = egnn_forward(model, _torch(moved), cfg)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x2.numpy(), x1.numpy() @ rot.T + t,
                               rtol=1e-3, atol=1e-3)


def test_equiformer_rotation_invariance():
    """Scalar outputs are SO(3)-invariant when the Wigner blocks are
    right: the end-to-end test of wigner.py."""
    cfg = get_arch("equiformer-v2").smoke
    rng = np.random.default_rng(3)
    batch = _rand_graph(rng, n=12, e=36, d_feat=cfg.d_in, n_pad=0)
    model = _gnn_init(get_arch("equiformer-v2"), cfg)(_gen(), device=CPU)
    with torch.no_grad():
        out1 = model(_torch(batch))
        rot = _rotation(rng)
        out2 = model(_torch(dict(batch, coords=batch["coords"] @ rot.T)))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_wigner_blocks_are_orthogonal():
    rng = np.random.default_rng(4)
    vec = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    for l, b in enumerate(wigner.edge_rotations(vec, 6)):
        eye = torch.eye(2 * l + 1).expand(8, -1, -1)
        np.testing.assert_allclose((b @ b.transpose(1, 2)).numpy(),
                                   eye.numpy(), rtol=1e-4, atol=1e-4)


def test_wigner_rotates_edge_to_pole():
    """D^1 maps the edge direction onto the canonical axis (the eSCN
    frame), in the (y, z, x) real-SH order."""
    rng = np.random.default_rng(5)
    vec = rng.normal(size=(16, 3)).astype(np.float32)
    d1 = wigner.edge_rotations(torch.from_numpy(vec), 1)[1].numpy()
    unit = vec / np.linalg.norm(vec, axis=1, keepdims=True)
    sh1 = np.stack([unit[:, 1], unit[:, 2], unit[:, 0]], axis=1)
    rotated = np.einsum("eij,ej->ei", d1, sh1)
    canonical = np.zeros_like(rotated)
    canonical[:, np.argmax(np.abs(rotated).mean(0))] = 1.0
    np.testing.assert_allclose(np.abs(rotated), canonical, atol=1e-4)
    # and D^1 is the rotation matrix of rot_mat_zyz in that order
    r = wigner.rot_mat_zyz(0.3, 1.1, -0.7)
    perm = [1, 2, 0]
    d = wigner.wigner_d_real(1, torch.tensor([0.3]), torch.tensor([1.1]),
                             torch.tensor([-0.7]))[0].numpy()
    np.testing.assert_allclose(d, r[np.ix_(perm, perm)], atol=1e-5)


def test_pna_molecule_batched_shape():
    """The molecule cell's layout: 16 disjoint 30-node graphs in one
    batch."""
    cfg = get_arch("pna").smoke
    n = 16 * 30
    batch = molecule_batch(6, 16, 30, 64, cfg.d_in, device=CPU)
    assert batch["edge_src"].shape == (16 * 64,)
    # no edge leaves its molecule
    assert bool((batch["edge_src"] // 30 == batch["edge_dst"] // 30).all())
    model = init_pna(_gen(), cfg, device=CPU)
    with torch.no_grad():
        out = pna_forward(model, batch, cfg)
    assert out.shape == (n, cfg.d_out)
    assert bool(torch.isfinite(out).all())


def test_init_defaults_to_the_card():
    """device=None means CUDA: without a card init raises; nothing moves
    to the CPU unasked."""
    cfg = get_arch("pna").smoke
    if torch.cuda.is_available():
        assert init_pna(_gen(), cfg).encode[0].w.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_pna(_gen(), cfg)
    assert init_pna(_gen(), cfg, device=CPU).encode[0].w.device.type == "cpu"


#: the reference-named forwards, by arch
FORWARDS = {"pna": "pna_forward", "meshgraphnet": "mgn_forward",
            "egnn": "egnn_forward", "equiformer-v2": "equiformer_forward"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_alias_runs_the_module_with_its_own_cfg(arch):
    """``*_forward(model, batch, cfg)`` is ``model(batch)``; a cfg whose
    fields differ from the model's raises, so the two cannot disagree."""
    spec = get_arch(arch)
    cfg = spec.smoke
    model = _gnn_init(spec, cfg)(_gen(), device=CPU)
    batch = _torch(_rand_graph(np.random.default_rng(5), d_feat=_d_in(cfg)))
    forward = getattr(tgnn, FORWARDS[arch])
    with torch.no_grad():
        want = model(batch)
        want = want if isinstance(want, tuple) else (want,)
        for got in (forward(model, batch), forward(model, batch, cfg)):
            got = got if isinstance(got, tuple) else (got,)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    other = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    with pytest.raises(ValueError, match="is not the model's"):
        forward(model, batch, other)


def test_serve_cells_are_the_registry_cells():
    """``launch.serve``'s cells: each arch's FULL config at the cell's
    width (``_gnn_cell_config``), and the molecule cell's batch shapes."""
    for arch in ARCHS:
        assert serve.cell_config(arch, 100) == _gnn_cell_config(
            get_arch(arch), 100, serve.CLASSES)
    mc = serve.MOLECULE
    batch = serve.molecule_cell_batch(device=CPU)
    n, e = mc["n_mol"] * mc["n_per"], mc["n_mol"] * mc["e_per"]
    assert batch["node_feat"].shape == (n, mc["d_feat"])
    assert batch["coords"].shape == (n, 3)
    assert batch["edge_src"].shape == batch["edge_dst"].shape == (e,)
    model, apply = serve.gnn_model("egnn", get_arch("egnn").smoke, CPU)
    assert model.encode[0].w.device.type == "cpu"
