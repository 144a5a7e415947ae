"""The port's data-parallel train step (``repro_torch.train.steps.
make_dp_train_step``) over 4 ``gloo`` ranks on the CPU (``spawn_ranks``;
the rank body is ``tests/_torch_dp_ranks.py``) against the JAX package's
``make_dp_train_step`` (shard_map) on 4 forced XLA host devices, run in a
subprocess, as ``tests/test_torch_distributed.py`` runs JAX's
``dist_lpa``.

DCN-v2 SMOKE from the JAX init, 5 steps of 4 x 32 rows (batches made
with numpy and handed to both), peak lr 1e-3 after 2 warm-up steps, with
the int8 error-feedback all-reduce and with the plain float32 mean.
Tolerances: losses rtol 1e-5; parameters rtol 1e-5, atol 1e-6 but for
at most 0.5% of them, which stay within 2 Σ lr_t: a float32 difference
in a gradient can move it across a rounding boundary of the int8 grid
(or flip the sign of an Adam step whose gradient is near 0), and that
element's step then differs by up to an Adam step's worth (observed: 1
element of 8,121, off by 4.7e-6). Every rank's parameters equal rank 0's
bit for bit.

Then the collectives on one rank: ``ShardComm.all_reduce`` (sum and
max) and ``compressed_psum``, which there is compress then decompress.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import pytest
import torch
import torch.distributed as dist

from repro.models.recsys.dcn_v2 import init_dcn as j_init_dcn
from repro_torch.configs.registry import get_arch
from repro_torch.core.distributed import ShardComm, spawn_ranks
from repro_torch.optim.compression import compressed_psum
from repro_torch.optim.schedule import cosine_schedule
import _torch_dp_ranks as ranks
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
P, ROWS, STEPS = 4, 32, 5
SCHEDULE = {"peak_lr": 1e-3, "warmup": 2, "total": 100}
TOL = {"loss": 1e-5, "rtol": 1e-5, "atol": 1e-6, "outliers": 0.005,
       "outlier_atol": 2 * sum(float(cosine_schedule(s, **SCHEDULE))
                               for s in range(STEPS))}

_JAX_DP = """
    import numpy as np
    import jax
    from repro.configs.registry import get_arch
    from repro.launch.mesh import make_mesh
    from repro.models.recsys.dcn_v2 import dcn_loss, init_dcn
    from repro.train.steps import make_dp_train_step
    cfg = get_arch("dcn-v2").smoke
    mesh = make_mesh((4,), ("data",))
    data = np.load(IN)
    batches = [{k: data[f"{k}_{s}"] for k in ("dense", "sparse", "labels")}
               for s in range(STEPS)]
    params0 = init_dcn(jax.random.PRNGKey(0), cfg)
    out = {}
    loss = lambda p, b: dcn_loss(p, b["dense"], b["sparse"], b["labels"], cfg)
    for tag, compress in (("int8", True), ("plain", False)):
        init, step = make_dp_train_step(loss, mesh, compress=compress,
                                        **SCHEDULE)
        params = params0
        opt, err = init(params)
        losses = []
        for b in batches:
            params, opt, err, m = step(params, opt, err, b)
            losses.append(float(m["loss"]))
        out[tag + "_loss"] = np.asarray(losses)
        for i, x in enumerate(jax.tree.leaves(params)):
            out[f"{tag}_{i}"] = np.asarray(x)
    np.savez(OUT, **out)
"""


def _batches(cfg):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        b = P * ROWS
        out.append({
            "dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            "sparse": np.stack([rng.integers(0, v, b)
                                for v in cfg.vocab_sizes],
                               axis=1).astype(np.int32),
            "labels": rng.integers(0, 2, b).astype(np.float32)})
    return out


def test_dp_train_step_matches_jax(tmp_path):
    cfg = get_arch("dcn-v2").smoke
    batches = _batches(cfg)
    np.savez(tmp_path / "in.npz", **{f"{k}_{s}": v
                                     for s, b in enumerate(batches)
                                     for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = (f"IN = {str(tmp_path / 'in.npz')!r}\n"
            f"OUT = {str(tmp_path / 'out.npz')!r}\n"
            f"STEPS = {STEPS}\nSCHEDULE = {SCHEDULE!r}\n"
            + textwrap.dedent(_JAX_DP))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    # the same init in this process (a pure function of the key)
    params0 = jax.tree.map(np.asarray,
                           j_init_dcn(jax.random.PRNGKey(0), cfg))
    n_leaves = len(jax.tree.leaves(params0))
    with np.load(tmp_path / "out.npz") as ref:
        expected = {tag: (ref[tag + "_loss"],
                          [ref[f"{tag}_{i}"] for i in range(n_leaves)])
                    for tag in ("int8", "plain")}
    spawn_ranks(ranks.dp_matches_reference, P,
                (params0, batches, expected, SCHEDULE, TOL), device="cpu")


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield ShardComm("cpu")
    finally:
        dist.destroy_process_group()


def test_all_reduce_and_compressed_psum_on_one_rank(one_rank_group):
    """One rank: the all-reduce returns a copy of its input, and
    ``compressed_psum`` is ``compress_int8`` then ``decompress_int8``."""
    from repro_torch.optim.compression import compress_int8, decompress_int8
    comm = one_rank_group
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for op in ("sum", "max"):
        y = comm.all_reduce(x, op)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="sum or max"):
        comm.all_reduce(x, "mean")
    rng = np.random.default_rng(0)
    grads = {"b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)),
             "a": [torch.from_numpy(rng.normal(size=(3, 2))
                                    .astype(np.float32))]}
    errs = {"b": torch.full((5,), 0.01), "a": [torch.zeros(3, 2)]}
    mean, new_err = compressed_psum(grads, errs, comm)
    for key, g, e in (("b", grads["b"], errs["b"]),
                      ("a", grads["a"][0], errs["a"][0])):
        q, s, want_err = compress_int8(g, e)
        got = mean[key] if key == "b" else mean[key][0]
        got_e = new_err[key] if key == "b" else new_err[key][0]
        assert torch.equal(got, decompress_int8(q, s))
        assert torch.equal(got_e, want_err)
    assert comm.calls == 4
