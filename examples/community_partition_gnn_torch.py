"""The paper's technique as a framework feature, on the PyTorch/CUDA port
(``src/repro_torch``): νMG8-LPA communities drive the graph partitioner;
the locality-aware order feeds (a) distributed LPA itself, whose halo
label exchange shrinks with the edge cut, and (b) a full-graph PNA
forward. The port's counterpart of ``community_partition_gnn.py``.

  PYTHONPATH=src python examples/community_partition_gnn_torch.py              # on the card
  PYTHONPATH=src python examples/community_partition_gnn_torch.py --device cpu

The distributed step spawns one process per shard (``spawn_ranks``,
``gloo``); on a machine with one card they share it.
"""
import argparse

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.distributed import (build_dist_workspace, dist_lpa,
                                          spawn_ranks)
from repro_torch.core.lpa import LPAConfig
from repro_torch.core.modularity import modularity
from repro_torch.data.synthetic import gnn_full_batch
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import graph_from_arrays
from repro_torch.graphs.generators import powerlaw_communities
from repro_torch.graphs.partition import (contiguous_parts, edge_cut_fraction,
                                          lpa_partition)
from repro_torch.models.gnn.pna import init_pna, pna_forward

ENGINE = "pallas_fused"


def dist_step(comm, arrays, order):
    """Rank body of step 2: distributed LPA on the partition order, with
    the full label gather and with the halo exchange; equal labels."""
    g = graph_from_arrays(*arrays, device="cpu")
    p = comm.world_size
    ws_full = build_dist_workspace(g, p, order=order, fused=True)
    ws_halo = build_dist_workspace(g, p, order=order, halo=True, fused=True)
    labels_full, _ = dist_lpa(comm, ws_full, rho=2, engine=ENGINE)
    labels_halo, iters = dist_lpa(comm, ws_halo, rho=2, engine=ENGINE)
    if not torch.equal(labels_full, labels_halo):
        raise AssertionError("full gather and halo exchange disagree")
    if comm.rank == 0:
        full_b = 4 * ws_full.v_pad * p
        halo_b = 4 * (ws_halo.h_pad + ws_halo.hub_pad) * p
        # the labels are indexed by the partition's ids: new_id = order[old]
        labels = labels_halo.cpu()[torch.from_numpy(order)]
        q = float(modularity(g, labels))
        print(f"label exchange/iter/rank: full gather {full_b / 1e3:.1f}KB "
              f"-> hub+halo {halo_b / 1e3:.1f}KB ({full_b / halo_b:.2f}x "
              f"less), labels identical after {iters} iterations; "
              f"Q={q:.3f}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or cuda (the default)")
    parser.add_argument("--nodes", type=int, default=8192)
    parser.add_argument("--shards", type=int, default=4)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    p = args.shards
    graph, _ = powerlaw_communities(args.nodes, p_in=0.5, mix=0.02, seed=1,
                                    device=dev)
    print(f"graph: {graph.n_nodes} vertices / {graph.n_edges} edges on "
          f"{dev}; {p} shards\n")

    # 1. partition by νMG8-LPA communities
    cfg = LPAConfig(method="mg", k=8, chunk=128, fold_backend=ENGINE)
    part = lpa_partition(graph, p, cfg)
    cut_naive = edge_cut_fraction(graph, contiguous_parts(graph, p))
    print(f"edge cut: contiguous {cut_naive:.1%} -> LPA-partitioned "
          f"{part.edge_cut:.1%} ({part.n_communities} communities)")

    # 2. distributed LPA with halo label exchange on the partitioned layout
    arrays = tuple(t.cpu().numpy() for t in
                   (graph.offsets, graph.indices, graph.weights))
    spawn_ranks(dist_step, p, (arrays + (graph.n_nodes,), part.order),
                backend="gloo", device=dev.type)

    # 3. one full-graph PNA forward on the same graph
    pcfg = get_arch("pna").smoke
    batch = gnn_full_batch(0, graph, d_feat=pcfg.d_in, n_classes=4)
    model = init_pna(torch.Generator().manual_seed(0), pcfg, device=dev)
    with torch.inference_mode():
        out = pna_forward(model, batch, pcfg)
    print(f"\nfull-graph PNA forward: out {tuple(out.shape)} on "
          f"{out.device}, finite={bool(torch.isfinite(out).all())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
