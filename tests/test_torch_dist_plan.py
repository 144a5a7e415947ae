"""The shard half of the plan bundle and the distributed workspace
(``repro_torch.core.plan_bundle``'s ``ShardSlice`` .. ``stack_aligned_windows``
and ``repro_torch.core.distributed.build_dist_workspace``) against the JAX
package's, in one process: on the same graph and flags the two give the
same arrays, shapes and dtypes, field for field, and the same scalars,
apart from the bucketed round gathers, which the port builds only for
the engines that read them (``jnp``, ``pallas``) and carries their count
as ``n_rounds``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import plan_bundle as jpb
from repro.core.lpa import LPAConfig as JConfig
from repro.graphs import partition as jpart
from repro.graphs.generators import powerlaw_communities
from repro_torch.core import distributed as tdist
from repro_torch.core import plan_bundle as tpb
from _torch_parity import assert_same, assert_same_array, carry_graph
from _torch_parity import one_torch_thread  # noqa: F401 (autouse)

#: build_dist_workspace flag sets; "order" adds the partitioner's order
FLAGS = {
    "full": {},
    "halo": {"halo": True},
    "fused": {"fused": True, "tile_r": 32},
    "fused_halo": {"fused": True, "tile_r": 32, "halo": True},
    "stream": {"stream": True, "tile_r": 32, "window_entries": 512},
    "stream_aligned": {"stream": True, "tile_r": 32, "window_entries": 512,
                       "aligned": True},
    "stream_aligned_halo": {"stream": True, "tile_r": 32,
                            "window_entries": 512, "aligned": True,
                            "halo": True},
    "order": {"order": True},
    "order_halo": {"order": True, "halo": True},
    "order_fused_small_chunk": {"order": True, "fused": True, "tile_r": 16,
                                "k": 4, "chunk": 16},
}


def assert_same_plans(ref, got, path):
    """Field for field (``ref``: the JAX workspace or stacked plans), the
    round gathers compared only where the port builds them: a fused or
    streamed ``got`` has ``None`` there, and its ``n_rounds`` is their
    count."""
    assert got.n_rounds == len(ref.round_gathers), path
    if ref.fused_starts is not None or ref.stream_gathers is not None:
        assert got.round_gathers is None, path
        ref = dataclasses.replace(ref, round_gathers=None)
    assert_same(ref, got, path)


@pytest.fixture(scope="module")
def graphs():
    jg, _ = powerlaw_communities(768, p_in=0.5, mix=0.02, seed=5)
    return jg, carry_graph(jg)


@pytest.fixture(scope="module")
def order(graphs):
    jg, _ = graphs
    # the JAX partitioner's order; tests/test_torch_partition.py holds the
    # port's lpa_partition to the same order
    return jpart.lpa_partition(jg, 4,
                               JConfig(method="mg", fold_backend="jnp")).order


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_workspace_matches_reference(graphs, order, name):
    jg, tg = graphs
    flags = dict(FLAGS[name])
    if flags.pop("order", False):
        flags["order"] = np.asarray(order)
    ref = jdist.build_dist_workspace(jg, 4, **flags)
    got = tdist.build_dist_workspace(tg, 4, **flags)
    assert_same_plans(ref, got, f"ws[{name}]")
    assert got.n_shards == ref.n_shards == 4
    # the stacked workspace lives on the CPU
    assert got.nbr_pos.device.type == "cpu"


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_workspace_matches_reference_across_shard_counts(graphs, n_shards):
    jg, tg = graphs
    flags = {"halo": True, "stream": True, "tile_r": 32,
             "window_entries": 256, "aligned": True}
    assert_same_plans(jdist.build_dist_workspace(jg, n_shards, **flags),
                      tdist.build_dist_workspace(tg, n_shards, **flags),
                      f"ws[P={n_shards}]")


def _reorder_loop(offsets, indices, weights, order):
    """The reference's per-vertex copy loop (repro/core/distributed.py
    build_dist_workspace), the oracle of the port's vectorised reorder."""
    n = len(order)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    new_deg = (offsets[1:] - offsets[:-1])[inv]
    new_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_deg, out=new_off[1:])
    new_idx = np.empty_like(indices)
    new_wgt = np.empty_like(weights)
    for v_new in range(n):
        v_old = inv[v_new]
        s, e = offsets[v_old], offsets[v_old + 1]
        ns = new_off[v_new]
        new_idx[ns:ns + e - s] = order[indices[s:e]]
        new_wgt[ns:ns + e - s] = weights[s:e]
    return new_off, new_idx, new_wgt


@pytest.mark.parametrize("seed", [0, 1])
def test_vectorised_reorder_equals_the_loop(graphs, seed):
    _, tg = graphs
    offsets = tg.offsets.numpy().astype(np.int64)
    indices = tg.indices.numpy().astype(np.int64)
    weights = (np.random.default_rng(seed).random(len(indices)) + 0.5
               ).astype(np.float32)
    order = np.random.default_rng(seed).permutation(tg.n_nodes)
    for ref, got in zip(_reorder_loop(offsets, indices, weights, order),
                        tdist._reorder_csr(offsets, indices, weights, order)):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(got, ref)


def _shard_slices(tg, n_shards, k=8, chunk=128):
    degrees = tg.degrees.numpy().astype(np.int64)
    bounds = tdist._edge_balanced_ranges(degrees, n_shards)
    counts = [degrees[bounds[p]:bounds[p + 1]] for p in range(n_shards)]
    offsets = tg.offsets.numpy().astype(np.int64)
    m_pad = int(max(offsets[bounds[p + 1]] - offsets[bounds[p]]
                    for p in range(n_shards)))
    return counts, m_pad


@pytest.mark.parametrize("k,chunk", [(8, 128), (4, 16), (4, 8)])
def test_uniform_round_count_matches_reference(graphs, k, chunk):
    _, tg = graphs
    counts, _ = _shard_slices(tg, 4)
    want = jpb.uniform_round_count(counts, k=k, chunk=chunk)
    assert tpb.uniform_round_count(counts, k=k, chunk=chunk) == want
    # an empty shard and an all-zero shard need one round
    assert tpb.uniform_round_count([np.zeros(0, np.int64),
                                    np.zeros(3, np.int64)],
                                   k=k, chunk=chunk) == 1


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused", "pallas_stream",
                                     "auto"])
def test_shard_bundles_and_stack_match_reference(graphs, backend):
    _, tg = graphs
    counts, m_pad = _shard_slices(tg, 4, k=4, chunk=16)
    n_rounds = jpb.uniform_round_count(counts, k=4, chunk=16)
    kw = dict(backend=backend, k=4, chunk=16, tile_r=16, stream_window=256,
              vmem_budget_bytes=1024)
    jb = [jpb.build_plan_bundle(jpb.ShardSlice(counts=c, n_entries=m_pad,
                                               n_rounds=n_rounds),
                                jpb.PlanSpec(**kw)) for c in counts]
    tb = [tpb.build_plan_bundle(tpb.ShardSlice(counts=c, n_entries=m_pad,
                                               n_rounds=n_rounds),
                                tpb.PlanSpec(**kw)) for c in counts]
    for p, (a, b) in enumerate(zip(jb, tb)):
        assert isinstance(b, tpb.ShardPlanBundle)
        # the spec is each package's own class; compare its fields
        assert dataclasses.asdict(a.spec) == dataclasses.asdict(b.spec)
        for f in dataclasses.fields(a):
            ref, got = getattr(a, f.name), getattr(b, f.name)
            if f.name == "spec":
                continue
            if f.name == "rounds":
                # the [R, chunk] gather only on the bucketed backends
                bucketed = b.spec.backend in tpb.BUCKETED
                assert len(ref) == len(got)
                for r, (tr, tg_) in enumerate(zip(ref, got)):
                    assert (tg_[0] is not None) == bucketed, (p, r)
                    assert_same(tr if bucketed else tr[1:],
                                tg_ if bucketed else tg_[1:],
                                f"bundle[{p}].rounds[{r}]")
                continue
            if f.name == "stream_rounds" and ref is not None:
                # one dict of StreamedRound fields per round
                assert len(ref) == len(got)
                for r, (dr, dg) in enumerate(zip(ref, got)):
                    assert sorted(dr) == sorted(dg)
                    for key in dr:
                        assert_same(dr[key], dg[key],
                                    f"bundle[{p}].stream_rounds[{r}].{key}")
                continue
            assert_same(ref, got, f"bundle[{p}].{f.name}")
    assert_same_plans(jpb.stack_shard_bundles(jb),
                      tpb.stack_shard_bundles(tb), "stacked")


def test_stack_aligned_windows_matches_reference(graphs):
    _, tg = graphs
    counts, m_pad = _shard_slices(tg, 4)
    n_rounds = jpb.uniform_round_count(counts, k=8, chunk=128)
    kw = dict(backend="pallas_stream", tile_r=32, stream_window=512,
              aligned=True)
    jb = [jpb.build_plan_bundle(jpb.ShardSlice(c, m_pad, n_rounds),
                                jpb.PlanSpec(**kw)) for c in counts]
    tb = [tpb.build_plan_bundle(tpb.ShardSlice(c, m_pad, n_rounds),
                                tpb.PlanSpec(**kw)) for c in counts]
    rng = np.random.default_rng(3)
    tables = rng.integers(-1, 4000, (4, m_pad)).astype(np.int32)
    wts = rng.random((4, m_pad)).astype(np.float32)
    ref = jpb.stack_aligned_windows(jb, tables, wts)
    got = tpb.stack_aligned_windows(tb, tables, wts)
    for a, b, what in zip(ref, got, ("positions", "weights")):
        assert isinstance(b, torch.Tensor)
        assert_same_array(a, b, what)
    for p in range(4):
        for a, b in zip(jb[p].remap_labels(tables[p], wts[p]),
                        tb[p].remap_labels(tables[p], wts[p])):
            assert_same_array(a, b, f"remap_labels[{p}]")


@pytest.mark.parametrize("flags,message", [
    ({"aligned": True}, "aligned=True requires stream=True"),
    ({"fused": True, "stream": True}, "mutually exclusive")])
def test_workspace_flag_errors_match_reference(graphs, flags, message):
    jg, tg = graphs
    with pytest.raises(ValueError, match=message):
        jdist.build_dist_workspace(jg, 4, **flags)
    with pytest.raises(ValueError, match=message):
        tdist.build_dist_workspace(tg, 4, **flags)


def test_shard_takes_one_ranks_blocks(graphs):
    _, tg = graphs
    ws = tdist.build_dist_workspace(tg, 4, halo=True, fused=True, tile_r=32)
    for rank in range(4):
        sh = ws.shard(rank, "cpu")
        assert torch.equal(sh.nbr_pos, ws.nbr_pos[rank])
        assert torch.equal(sh.send_idx, ws.send_idx[rank])
        assert sh.send_idx.shape == (4, ws.h_pad)
        assert sh.hub_idx.shape == (ws.hub_pad,)
        assert len(sh.fused_starts) == len(ws.fused_starts)
        for a, b in zip(sh.fused_dmax, ws.fused_dmax):
            assert torch.equal(a, b[rank])
        assert sh.fused_entries == ws.fused_entries
        assert (sh.v_pad, sh.k, sh.chunk, sh.max_rows0) == \
            (ws.v_pad, ws.k, ws.chunk, ws.max_rows0)
        assert sh.stream_gathers is None and sh.round_gathers is None
        assert sh.n_rounds == ws.n_rounds == len(sh.fused_starts)
    with pytest.raises(ValueError, match="outside"):
        ws.shard(4, "cpu")
