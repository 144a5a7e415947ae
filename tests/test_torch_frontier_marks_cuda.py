"""The frontier-marks kernel (``csrc/frontier_marks.cu``) on the card: its
``marked`` equals the plain version's bit for bit on a vertex count that is
no multiple of a block, with flags off their 8-byte alignment, a
194,944-slot hub, rows at each side of the block's degree (256), several
long rows in one block, a degree-<= 4 chain graph, and no, every and a
drawn set of changed vertices; in one ``lpa()`` run with
``track_frontier`` it launches once an iteration, the run equals the
CPU's, and (νMG, dense and pruned) the card synchronises only at the
detection's counted host reads.

Marked ``gpu``: without a CUDA device every test here skips (the decision
is taken inside the ``cuda`` fixture, never at import). On a machine with
a card: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_frontier_marks_cuda.py``.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.lpa import LPAConfig, build_workspace, lpa
from repro_torch.graphs import generators as tgen
from repro_torch.graphs.csr import graph_from_arrays
from repro_torch.kernels import frontier, launches

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests launch the CUDA kernel")
    return torch.device("cuda")


def _rows(degrees, seed=0):
    """CSR arrays (offsets, indices) with the given row degrees and
    destinations drawn uniformly: the kernel reads nothing else."""
    degrees = np.asarray(degrees, np.int64)
    n = len(degrees)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(degrees, out=offsets[1:])
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, n, int(offsets[-1])).astype(np.int32)
    return offsets.astype(np.int32), indices


def _hub(n=200_001):
    """One 194,944-slot hub at vertex 5, the rest of degree 1 to 8."""
    rng = np.random.default_rng(1)
    degrees = rng.integers(1, 9, n)
    degrees[5] = 194_944
    return _rows(degrees, 2)


def _tiers():
    """Rows at each side of the block's degree (256), several long rows in
    one block and two in one thread's 8 vertices (claimed in turn), a warp
    whose 256 rows are all long, isolated vertices; N = 2 blocks of 2,048
    vertices + 37, so the last thread holds 5."""
    n = 2 * 2048 + 37
    degrees = np.random.default_rng(3).integers(0, 40, n)
    degrees[[0, 1, 7, 300, 2100]] = (256, 255, 4096, 257, 1000)
    degrees[[2, 3, 4, 5, 6]] = (31, 32, 33, 0, 0)
    degrees[512:768] = 300
    return _rows(degrees, 4)


def _chain():
    g = tgen.chain_kmer(100_003, seed=3, device="cpu")
    return g.offsets.numpy(), g.indices.numpy()


GRAPHS = {"odd_n": lambda: _rows(np.random.default_rng(5).integers(
              0, 64, 10_007), 6),
          "hub": _hub, "tiers": _tiers, "chain": _chain}
CHANGED = {"none": lambda n, rng: np.zeros(n, bool),
           "every": lambda n, rng: np.ones(n, bool),
           "drawn": lambda n, rng: rng.random(n) < 0.3}


@pytest.mark.parametrize("changed_by", sorted(CHANGED))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_kernel_matches_plain(cuda, graph, changed_by):
    offsets, indices = GRAPHS[graph]()
    n = len(offsets) - 1
    changed = CHANGED[changed_by](n, np.random.default_rng(n))
    args = [torch.from_numpy(a).to(cuda) for a in (changed, offsets,
                                                   indices)]
    if graph == "odd_n":  # flags not 8-byte aligned: read byte by byte
        args[0] = torch.cat([args[0][:1], args[0]])[1:]
    launches.reset_launch_counts()
    got = frontier.frontier_marks(*args)
    torch.cuda.synchronize()
    assert launches.LAUNCH_COUNTS["frontier_marks"] == 1
    want = frontier.frontier_marks_plain(*args)
    assert got.dtype == torch.bool and torch.equal(got, want)
    if changed_by == "every":  # every vertex with an in-slot is marked
        assert int(got.sum()) == np.unique(indices).size


@pytest.mark.parametrize("config", [
    dict(fold_backend="pallas_fused"),
    dict(fold_backend="pallas_fused", frontier_gate=True,
         frontier_sparse=True),
    dict(method="exact", fold_backend="jnp")])
def test_lpa_launches_once_an_iteration(cuda, config):
    g, _ = tgen.powerlaw_communities(2**14, p_in=0.5, mix=0.02, seed=1,
                                     device="cpu")
    card = graph_from_arrays(g.offsets.numpy(), g.indices.numpy(),
                             g.weights.numpy(), g.n_nodes, device=cuda)
    cfg = LPAConfig(rho=2, **config)
    ref = lpa(g, cfg, device="cpu")
    ws = build_workspace(card, cfg)
    lpa(card, cfg, ws=ws)  # builds the kernels, warms the caches
    torch.cuda.synchronize()
    launches.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = lpa(card, cfg, ws=ws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert launches.LAUNCH_COUNTS["frontier_marks"] == got.iterations
    assert torch.equal(got.labels.cpu(), ref.labels)
    assert (got.iterations, got.changed_history, got.frontier_history) == (
        ref.iterations, ref.changed_history, ref.frontier_history)
    if cfg.method != "exact":  # the exact fold's nonzero synchronises
        syncs = [w for w in caught
                 if "called a synchronizing" in str(w.message)]
        assert len(syncs) == sum(got.host_reads.values()), got.host_reads
