"""The port's distributed LPA (``repro_torch.core.distributed.dist_lpa``)
over 4 ``gloo`` ranks on the CPU, each rank a process started by
``spawn_ranks`` (the rank body is ``tests/_torch_dist_ranks.py``).

Every run must give the port's single-host ``lpa()`` of the same method,
labels and iteration count, as ``tests/test_distributed.py`` requires of
the reference: mg, bm and the rescan ablation on every engine (``jnp``,
``pallas``, ``pallas_fused``, ``pallas_stream`` unaligned and aligned),
with the full-gather and the halo exchange; the frontier-gated runs; the
halo exchange on a workspace renumbered by the partitioner; and JAX's own
``dist_lpa`` on 4 host devices. The graphs are small and the chunk narrow
(k=4, chunk=16: three fold rounds), which keeps the plain folds fast.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.distributed import (ShardComm, _reorder_csr,
                                          build_dist_workspace,
                                          dist_lpa_step, spawn_ranks)
from repro_torch.core.lpa import LPAConfig, lpa
from repro_torch.graphs.csr import graph_from_arrays
from repro_torch.graphs.generators import powerlaw_communities
from repro_torch.graphs.partition import lpa_partition
import _torch_dist_ranks as ranks
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
P = 4
K, CHUNK, RHO = 4, 16, 2
METHODS = {"mg": ("mg", False), "bm": ("bm", False), "rescan": ("mg", True)}


@pytest.fixture(scope="module")
def graph():
    g, _ = powerlaw_communities(512, p_in=0.5, mix=0.02, seed=5,
                                device="cpu")
    return g


def _arrays(g):
    return (g.offsets.numpy(), g.indices.numpy(), g.weights.numpy(),
            g.n_nodes)


def _single_host(g, method, rescan=False, gated=False):
    res = lpa(g, LPAConfig(method=method, rescan=rescan, k=K, chunk=CHUNK,
                           rho=RHO, frontier_gate=gated), device="cpu")
    return res.labels.numpy(), res.iterations


@pytest.mark.parametrize("name", sorted(METHODS))
def test_dist_lpa_equals_single_host(graph, name):
    """One method on every engine and both exchanges (10 runs)."""
    method, rescan = METHODS[name]
    expected = {name: _single_host(graph, method, rescan)}
    runs = [(name, engine, exchange, method, rescan, False)
            for engine in ranks.ENGINES for exchange in ranks.HALO]
    spawn_ranks(ranks.run_matrix, P,
                (_arrays(graph), runs, expected, RHO, K, CHUNK),
                device="cpu")


def test_dist_frontier_gate_equals_single_host(graph):
    """Gated mg on jnp and fused, gated bm on jnp, both exchanges."""
    expected = {"mg": _single_host(graph, "mg", gated=True),
                "bm": _single_host(graph, "bm", gated=True)}
    runs = [(tag, engine, exchange, tag, False, True)
            for tag, engine in (("mg", "jnp"), ("mg", "fused"),
                                ("bm", "jnp"))
            for exchange in ranks.HALO]
    spawn_ranks(ranks.run_matrix, P,
                (_arrays(graph), runs, expected, RHO, K, CHUNK),
                device="cpu")


def test_halo_equals_full_gather_on_partitioned_order(graph):
    """The workspace renumbered by the port's partitioner: the full-gather
    and the halo runs both give the single-host run on the renumbered
    graph (so the halo run equals the full-gather one)."""
    order = lpa_partition(graph, P, LPAConfig(method="mg",
                                              fold_backend="jnp")).order
    offsets, indices, weights = _reorder_csr(
        graph.offsets.numpy().astype(np.int64),
        graph.indices.numpy().astype(np.int64), graph.weights.numpy(),
        order)
    renumbered = graph_from_arrays(offsets, indices, weights, graph.n_nodes,
                                   device="cpu")
    expected = {"mg": _single_host(renumbered, "mg"),
                "bm": _single_host(renumbered, "bm")}
    runs = [(tag, engine, exchange, tag, False, False)
            for tag, engine in (("mg", "fused"), ("bm", "jnp"))
            for exchange in ranks.HALO]
    full = build_dist_workspace(graph, P, k=K, chunk=CHUNK, order=order)
    halo = build_dist_workspace(graph, P, k=K, chunk=CHUNK, order=order,
                                halo=True)
    # the halo exchange moves fewer label slots than the full gather
    assert (halo.h_pad + halo.hub_pad) * P < full.v_pad * P
    spawn_ranks(ranks.run_matrix, P,
                (_arrays(graph), runs, expected, RHO, K, CHUNK, order),
                device="cpu")


_JAX_DIST = """
    import numpy as np
    from repro.graphs.generators import powerlaw_communities
    from repro.core.distributed import build_dist_workspace, dist_lpa
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((4,), ("shard",))
    g, _ = powerlaw_communities(512, p_in=0.5, mix=0.02, seed=5)
    out = {}
    for tag, halo in (("full", False), ("halo", True)):
        ws = build_dist_workspace(g, 4, k=4, chunk=16, halo=halo)
        labels, iters = dist_lpa(mesh, ws, rho=2, engine="jnp")
        out[tag] = np.asarray(labels)
        out[tag + "_iterations"] = np.asarray(iters)
    np.savez(OUT, **out)
"""


def test_dist_lpa_matches_jax_dist_lpa(graph, tmp_path):
    """JAX's own dist_lpa on 4 forced XLA host devices (the jnp engine:
    no interpret-mode Pallas), mg with the full gather and the halo
    exchange, against the port's on the same graph."""
    out = tmp_path / "jax_dist.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = f"OUT = {str(out)!r}\n" + textwrap.dedent(_JAX_DIST)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(out)
    expected = {tag: (ref[tag], int(ref[tag + "_iterations"]))
                for tag in ranks.HALO}
    runs = [(tag, "jnp", tag, "mg", False, False) for tag in ranks.HALO]
    spawn_ranks(ranks.run_matrix, P,
                (_arrays(graph), runs, expected, RHO, K, CHUNK),
                device="cpu")


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_step_errors_match_reference(graph, one_rank_group):
    """The reference's ValueErrors (repro/core/distributed.py
    dist_lpa_step), and a workspace whose shard count is not the
    group's."""
    comm = ShardComm("cpu")
    assert (comm.rank, comm.world_size, comm.backend, comm.staged) == \
        (0, 1, "gloo", False)
    ws = build_dist_workspace(graph, 1, k=K, chunk=CHUNK)
    cases = [
        (dict(method="exact"), "unknown method"),
        (dict(method="bm", rescan=True), "rescan=True is an MG-family"),
        (dict(engine="pallas_fused"), "requires build_dist_workspace"),
        (dict(engine="pallas_stream"), "requires build_dist_workspace"),
        (dict(engine="nope"), "unknown fold backend"),
    ]
    for kw, message in cases:
        with pytest.raises(ValueError, match=message):
            dist_lpa_step(comm, ws, **kw)
    with pytest.raises(ValueError, match="entry_vertex"):
        dist_lpa_step(comm, ws.__class__(**{**ws.__dict__,
                                           "entry_vertex": None}),
                      frontier_gate=True)
    # the bucketed engines need the round gathers a fused or streamed
    # workspace leaves out
    fused_ws = build_dist_workspace(graph, 1, k=K, chunk=CHUNK, fused=True,
                                    tile_r=32)
    for engine in (None, "jnp", "pallas"):
        with pytest.raises(ValueError, match="bucketed round gathers"):
            dist_lpa_step(comm, fused_ws, engine=engine)
    with pytest.raises(ValueError, match="2 shards, the group 1"):
        dist_lpa_step(comm, build_dist_workspace(graph, 2, k=K,
                                                 chunk=CHUNK))
    # one rank: the step is the single-host move, and the collectives
    # are identities
    step = dist_lpa_step(comm, ws, engine="jnp")
    labels = ws.init_labels[0]
    ref = lpa(graph, LPAConfig(k=K, chunk=CHUNK, rho=RHO, max_iters=1),
              device="cpu")
    new, delta = step(labels, True, 1)
    assert torch.equal(new, ref.labels)
    assert int(delta) == ref.changed_history[0]
    assert comm.calls == 2 and comm.staged_bytes == 0


def test_cuda_without_a_card_raises(one_rank_group):
    """No silent move to the CPU: a CUDA rank without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardComm("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardComm()
