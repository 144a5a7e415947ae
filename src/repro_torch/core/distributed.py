"""Multi-process LPA: vertex-sharded ranks with an explicit label exchange.

A copy of ``repro.core.distributed`` over ``torch.distributed``, one rank
per shard. Distribution model:

  * vertices are split into P contiguous, edge-balanced ranges (optionally
    after a locality reorder from ``repro_torch.graphs.partition``);
  * every shard owns its CSR rows, a single-width virtual-vertex fold plan
    (width = ``chunk``), and its slice of the label vector;
  * per iteration the only collective of the fold is one exchange of the
    label vector: a full all-gather (4·|V| bytes per rank), or the halo
    exchange (a small hub all-gather plus one all-to-all of the labels
    each peer references) — sketches, folds, selection and the
    Pick-Less/hash-tie move rule are shard-local;
  * ΔN convergence uses an all-reduce.

Label *values* are real global vertex ids (so Pick-Less comparisons agree
across shards); label *positions* live in a padded global layout
[P · V_pad], which is what the all-gather produces and what the remapped
neighbor ids index into.

All per-shard arrays are padded to the max across shards, so the stacked
[P, ...] workspace has uniform shapes; pad lanes fold to empty sketches
(weight 0 entries are no-ops by construction).

The reference runs the shard body inside ``shard_map``; here each rank
runs it on its own blocks (:meth:`DistLPAWorkspace.shard`) and
:class:`ShardComm` stands for the mesh axis: ``all_gather``,
``all_to_all`` and ``psum`` become ``dist.all_gather_into_tensor``,
``dist.all_to_all_single`` and ``dist.all_reduce``. The folds go through
the port's round wrappers, so on CUDA each shard's rounds launch the
kernels (K1/K3/K4 on ``pallas_fused``, K5/K7/K8 on ``pallas_stream``,
K9/K10 on ``pallas``) and on the CPU they run the plain versions.

With the ``gloo`` backend and a CUDA device (several ranks sharing one
card: NCCL refuses two ranks on one GPU) every exchanged vector is copied
to the host and back (``ShardComm.staged``); the folds stay on the card.
:func:`spawn_ranks` starts the ranks of one machine.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import sketch as sketch_lib
from repro_torch.core.fold_program import FoldRequest
from repro_torch.core.plan_bundle import (PlanSpec, ShardSlice,
                                          build_plan_bundle,
                                          stack_aligned_windows,
                                          stack_shard_bundles,
                                          uniform_round_count)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import CSRGraph, FusedRound, StreamedRound
from repro_torch.kernels.mg_sketch.fused import (bm_fold_round_fused,
                                                 fused_fold_round,
                                                 rescan_round_fused)
from repro_torch.kernels.mg_sketch.streaming import (bm_fold_round_stream,
                                                     rescan_round_stream,
                                                     stream_fold_round)

__all__ = ["DistLPAWorkspace", "ShardComm", "build_dist_workspace",
           "dist_lpa_step", "dist_lpa", "lpa_collective_bytes",
           "spawn_ranks"]

PAD = -1


@dataclasses.dataclass
class DistLPAWorkspace:
    """Stacked per-shard arrays (leading axis P), CPU tensors.

    Two label-exchange modes:
      full gather (send_idx None): nbr_pos indexes the padded-global label
        layout produced by one all-gather of 4·|V| bytes per iteration.
      halo (send_idx set): nbr_pos indexes a LOCAL table [own labels ++
        hub slots ++ halo slots]; per iteration each shard sends only the
        labels its peers actually reference (all-to-all of [P, H_pad]),
        cutting the exchanged bytes by the boundary fraction of the
        partition.

    :meth:`shard` takes one rank's blocks to its device.

    ``round_gathers`` is built only for the engines that read it (``jnp``,
    ``pallas``); a fused or streamed workspace has ``None`` there and the
    round count in ``n_rounds``.
    """

    nbr_pos: torch.Tensor      # [P, M_pad] int32 — label positions (see above)
    weights: torch.Tensor      # [P, M_pad] float32
    n_rounds: int              # fold rounds (uniform across shards)
    # per round: [P, R_pad_r, chunk] int32 (bucketed workspaces only)
    round_gathers: Optional[Tuple[torch.Tensor, ...]]
    final_row_vertex: torch.Tensor  # [P, R_last] int32 — local vertex per final row (-1 pad)
    init_labels: torch.Tensor  # [P, V_pad] int32 — real global ids (-1 on pad slots)
    n_nodes: int               # |V| — real (unpadded) global vertex count
    v_pad: int                 # per-shard label-slot count (max shard size)
    k: int                     # sketch width (candidate slots per vertex)
    chunk: int                 # fold-plan row width (entries per chunk row)
    send_idx: Optional[torch.Tensor] = None  # [P(owner), P(dest), H_pad] int32 local slots
    h_pad: int = 0             # halo-exchange pad width (slots per shard pair)
    hub_idx: Optional[torch.Tensor] = None   # [P, HUB_pad] int32 local slots of hubs
    hub_pad: int = 0           # hub all-gather pad width (hubs per shard)
    # fused-engine metadata ((start, count) ranges in the single-width
    # row order, tiled into tile_r steps):
    fused_starts: Optional[Tuple[torch.Tensor, ...]] = None  # per round [P, S_r, tile_r] int32
    fused_counts: Optional[Tuple[torch.Tensor, ...]] = None  # per round [P, S_r, tile_r] int32
    fused_dmax: Optional[Tuple[torch.Tensor, ...]] = None    # per round [P, S_r, 1] int32
    fused_entries: Tuple[int, ...] = ()  # per round: flat entry-array length
    # streaming-engine metadata (windowed layout per
    # repro_torch.graphs.csr.build_streamed_rounds, padded across shards):
    stream_gathers: Optional[Tuple[torch.Tensor, ...]] = None  # per round [P, n_win_r, W_r] int32
    stream_starts: Optional[Tuple[torch.Tensor, ...]] = None   # per round [P, n_win_r, tile_r] int32
    stream_counts: Optional[Tuple[torch.Tensor, ...]] = None   # per round [P, n_win_r, tile_r] int32
    stream_dmax: Optional[Tuple[torch.Tensor, ...]] = None     # per round [P, n_win_r, 1] int32
    stream_final_rv: Optional[torch.Tensor] = None  # [P, n_win_last * tile_r] int32 local vertex (-1 pad)
    # round-0 row -> local vertex maps, one per plan encoding (the BM fold
    # and the rescan second pass walk only round 0; -1 on pad rows/slots):
    row_vertex0: Optional[torch.Tensor] = None  # [P, R_pad_0] int32 bucketed rows
    fused_rv0: Optional[torch.Tensor] = None    # [P, S_0 * tile_r] int32 fused rows
    stream_rv0: Optional[torch.Tensor] = None   # [P, n_win_0 * tile_r] int32 slots
    # round-0 row -> chunk-rank maps matching the rv0 maps above (0 on pad
    # rows; the rescan merge reduces each row's exact partial at its
    # (vertex, rank) coordinate — sketch.merge_rescan_partials):
    bucket_rank0: Optional[torch.Tensor] = None  # [P, R_pad_0] int32 bucketed rows
    fused_rank0: Optional[torch.Tensor] = None   # [P, S_0 * tile_r] int32 fused rows
    stream_rank0: Optional[torch.Tensor] = None  # [P, n_win_0 * tile_r] int32 slots
    # max round-0 chunk rows any vertex owns (across shards) — the rescan
    # merge's rank-table depth
    max_rows0: int = 1
    # [P, M_pad] int32 — owning LOCAL vertex of each edge slot (-1 pads);
    # the gated step segment-maxes neighbor changed flags over it to mark
    # next iteration's per-shard frontier (dist_lpa_step(frontier_gate=))
    entry_vertex: Optional[torch.Tensor] = None
    # window-aligned round-0 entries (build_dist_workspace(aligned=True)):
    # label-table position / edge weight per round-0 window slot. Built
    # AFTER the halo remap, so the positions index whichever label table
    # (padded-global or local+halo) the exchange mode produces.
    stream_aligned_pos: Optional[torch.Tensor] = None  # [P, n_win_0 * W] int32 (-1 pads)
    stream_aligned_w: Optional[torch.Tensor] = None    # [P, n_win_0 * W] float32 (0.0 pads)

    @property
    def n_shards(self) -> int:
        """P, the stacked arrays' leading axis."""
        return self.nbr_pos.shape[0]

    def shard(self, rank: int, device) -> "DistLPAWorkspace":
        """One rank's blocks: every array (and every array of a per-round
        tuple) indexed ``[rank]`` along its leading P axis and copied to
        ``device``; the scalars are kept. What ``shard_map``'s in_specs
        hand the reference's shard body."""
        if not 0 <= rank < self.n_shards:
            raise ValueError(f"rank {rank} outside [0, {self.n_shards})")
        dev = resolve_device(device)

        def take(value):
            if isinstance(value, torch.Tensor):
                return value[rank].to(dev, copy=True)
            if isinstance(value, tuple) and value \
                    and isinstance(value[0], torch.Tensor):
                return tuple(v[rank].to(dev, copy=True) for v in value)
            return value

        return dataclasses.replace(self, **{
            f.name: take(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def _edge_balanced_ranges(degrees: np.ndarray, p: int) -> np.ndarray:
    """[P+1] vertex range boundaries with roughly equal edge counts."""
    cum = np.concatenate([[0], np.cumsum(degrees)])
    targets = np.linspace(0, cum[-1], p + 1)
    bounds = np.searchsorted(cum, targets[1:-1])
    return np.concatenate([[0], bounds, [len(degrees)]]).astype(np.int64)


def _reorder_csr(offsets: np.ndarray, indices: np.ndarray,
                 weights: np.ndarray, order: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The CSR under the numbering new_id = order[old_id]: new vertex v
    takes old vertex inv[v]'s edge list, in its order, with the neighbor
    ids renumbered. The reference's per-vertex copy loop, as one gather of
    each new slot's old position."""
    n = len(order)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    new_deg = (offsets[1:] - offsets[:-1])[inv]
    new_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_deg, out=new_off[1:])
    src = (np.repeat(offsets[:-1][inv] - new_off[:-1], new_deg)
           + np.arange(int(new_off[-1]), dtype=np.int64))
    return new_off, order[indices[src]], weights[src]


def build_dist_workspace(graph: CSRGraph, n_shards: int, k: int = 8,
                         chunk: int = 128, order: np.ndarray | None = None,
                         halo: bool = False, fused: bool = False,
                         tile_r: int = 128, stream: bool = False,
                         window_entries: int = 8192,
                         aligned: bool = False) -> DistLPAWorkspace:
    """Host-side construction of the stacked distributed workspace.

    The graph is read once to numpy (from any device); the result holds
    CPU tensors with the reference's shapes and dtypes.

    ``order`` optionally renumbers vertices first (e.g. the LPA-community
    locality order from repro_torch.graphs.partition) — new_id =
    order[old_id]. ``halo=True`` builds the halo-exchange tables (see
    DistLPAWorkspace). ``fused=True`` additionally builds the (start,
    count) range metadata the ``pallas_fused`` engine folds from.
    ``stream=True`` builds the per-shard windowed metadata for
    ``engine="pallas_stream"`` — each shard folds through entry windows of
    at most ``window_entries`` entries (padded uniformly across shards).
    ``aligned=True`` (requires ``stream=True``) additionally stores each
    shard's round-0 entry metadata window-aligned
    (``stream_aligned_pos``/``stream_aligned_w``): the streamed shard mover
    then gathers labels straight into window order and skips the
    per-iteration round-0 re-layout gather, bit-identically.
    """
    if aligned and not stream:
        raise ValueError("aligned=True requires stream=True (the aligned "
                         "layout is a property of the windowed plan)")
    offsets = graph.offsets.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy().astype(np.int64)
    weights = graph.weights.cpu().numpy().astype(np.float32)
    n = graph.n_nodes
    if order is not None:
        offsets, indices, weights = _reorder_csr(
            offsets, indices, weights, np.asarray(order, dtype=np.int64))

    degrees = offsets[1:] - offsets[:-1]
    bounds = _edge_balanced_ranges(degrees, n_shards)
    v_pad = int(np.max(bounds[1:] - bounds[:-1])) if n else 1
    # map global vertex id -> padded-global position p * v_pad + local slot
    shard_of = np.repeat(np.arange(n_shards), bounds[1:] - bounds[:-1])
    local_slot = np.arange(n) - bounds[shard_of]
    padded_pos = shard_of * v_pad + local_slot

    m_pad = int(max(offsets[bounds[p + 1]] - offsets[bounds[p]]
                    for p in range(n_shards))) if n else 1

    # one declarative plan build per shard: the spec names the fold
    # backend the caller's requests will run on, and every stacked
    # per-engine plan array comes out of stack_shard_bundles
    if fused and stream:
        raise ValueError("fused=True and stream=True are mutually "
                         "exclusive (one fold backend per workspace)")
    backend = ("pallas_stream" if stream
               else "pallas_fused" if fused else "jnp")
    spec = PlanSpec(backend=backend, k=k, chunk=chunk, tile_r=tile_r,
                    aligned=aligned, stream_window=window_entries)
    shard_counts = [degrees[bounds[p]:bounds[p + 1]]
                    for p in range(n_shards)]
    n_rounds = uniform_round_count(shard_counts, k=k, chunk=chunk)
    bundles = [build_plan_bundle(
        ShardSlice(counts=c, n_entries=m_pad, n_rounds=n_rounds), spec)
        for c in shard_counts]
    plans = stack_shard_bundles(bundles)

    nbr_pos = np.full((n_shards, m_pad), PAD, dtype=np.int32)
    wgts = np.zeros((n_shards, m_pad), dtype=np.float32)
    entry_vertex = np.full((n_shards, m_pad), PAD, dtype=np.int32)
    init_labels = np.full((n_shards, v_pad), PAD, dtype=np.int32)
    for p in range(n_shards):
        lo, hi = bounds[p], bounds[p + 1]
        e0, e1 = offsets[lo], offsets[hi]
        nbr_pos[p, :e1 - e0] = padded_pos[indices[e0:e1]]
        wgts[p, :e1 - e0] = weights[e0:e1]
        entry_vertex[p, :e1 - e0] = np.repeat(
            np.arange(hi - lo, dtype=np.int64), degrees[lo:hi])
        init_labels[p, :hi - lo] = np.arange(lo, hi)

    send_idx = hub_idx_arr = None
    h_pad = hub_pad = 0
    if halo:
        # reference count: how many shards' edge lists touch each vertex
        ref = np.zeros(n, dtype=np.int32)
        needs = []
        for p in range(n_shards):
            lo, hi = bounds[p], bounds[p + 1]
            idx_p = indices[offsets[lo]:offsets[hi]]
            owners = shard_of[idx_p]
            remote = np.unique(idx_p[owners != p])
            ref[remote] += 1
            needs.append(remote)
        # hubs (referenced by >= max(3, P/2) shards) go through a small
        # all-gather; per-pair all-to-all padding would otherwise be
        # dominated by them
        hub_min = max(3, n_shards // 2)
        is_hub = ref >= hub_min
        hub_pad = max(int(np.bincount(shard_of[is_hub],
                                      minlength=n_shards).max())
                      if is_hub.any() else 0, 1)
        hub_idx_arr = np.full((n_shards, hub_pad), PAD, dtype=np.int32)
        hub_rank = np.full(n, -1, dtype=np.int64)
        for p in range(n_shards):
            hubs_p = np.nonzero(is_hub & (shard_of == p))[0]
            hub_idx_arr[p, :len(hubs_p)] = local_slot[hubs_p]
            hub_rank[hubs_p] = np.arange(len(hubs_p))
        # need[p][q] = sorted q-local slots (non-hub) shard p references
        need = [[np.zeros(0, np.int64)] * n_shards for _ in range(n_shards)]
        for p in range(n_shards):
            remote = needs[p]
            remote = remote[~is_hub[remote]]
            owners = shard_of[remote]
            for q in np.unique(owners):
                need[p][q] = np.sort(local_slot[remote[owners == q]])
        h_pad = max((len(need[p][q]) for p in range(n_shards)
                     for q in range(n_shards)), default=0)
        h_pad = max(int(h_pad), 1)
        send_idx = np.full((n_shards, n_shards, h_pad), PAD, dtype=np.int32)
        for p in range(n_shards):
            for q in range(n_shards):
                if len(need[p][q]):
                    send_idx[q, p, :len(need[p][q])] = need[p][q]
        # remap nbr_pos to the local table
        # [v_pad own ++ P*hub_pad hubs ++ P*h_pad halo]
        hub_base = v_pad
        halo_base = v_pad + n_shards * hub_pad
        for p in range(n_shards):
            lo, hi = bounds[p], bounds[p + 1]
            e0, e1 = offsets[lo], offsets[hi]
            idx_p = indices[e0:e1]
            owners = shard_of[idx_p]
            pos = np.empty(e1 - e0, dtype=np.int32)
            own = owners == p
            pos[own] = local_slot[idx_p[own]]
            hub_sel = is_hub[idx_p] & ~own
            pos[hub_sel] = (hub_base + owners[hub_sel] * hub_pad
                            + hub_rank[idx_p[hub_sel]])
            for q in range(n_shards):
                if q == p or not len(need[p][q]):
                    continue
                sel = (owners == q) & ~is_hub[idx_p] & ~own
                rank = np.searchsorted(need[p][q], local_slot[idx_p[sel]])
                pos[sel] = halo_base + q * h_pad + rank
            nbr_pos[p, :e1 - e0] = pos

    stream_apos = stream_aw = None
    if stream and aligned:
        # each shard bundle's remap_labels transform, applied AFTER the
        # halo remap above so the stored positions index the exchange
        # mode's actual label table (padded-global or local+halo)
        stream_apos, stream_aw = stack_aligned_windows(bundles, nbr_pos,
                                                       wgts)

    return DistLPAWorkspace(
        nbr_pos=torch.from_numpy(nbr_pos), weights=torch.from_numpy(wgts),
        n_rounds=plans.n_rounds, round_gathers=plans.round_gathers,
        final_row_vertex=plans.final_row_vertex,
        init_labels=torch.from_numpy(init_labels),
        n_nodes=int(n), v_pad=int(v_pad), k=int(k), chunk=int(chunk),
        send_idx=None if send_idx is None else torch.from_numpy(send_idx),
        h_pad=int(h_pad),
        hub_idx=(None if hub_idx_arr is None
                 else torch.from_numpy(hub_idx_arr)),
        hub_pad=int(hub_pad),
        fused_starts=plans.fused_starts, fused_counts=plans.fused_counts,
        fused_dmax=plans.fused_dmax, fused_entries=plans.fused_entries,
        stream_gathers=plans.stream_gathers,
        stream_starts=plans.stream_starts,
        stream_counts=plans.stream_counts, stream_dmax=plans.stream_dmax,
        stream_final_rv=plans.stream_final_rv,
        row_vertex0=plans.row_vertex0, fused_rv0=plans.fused_rv0,
        stream_rv0=plans.stream_rv0,
        entry_vertex=torch.from_numpy(entry_vertex),
        stream_aligned_pos=stream_apos, stream_aligned_w=stream_aw,
        bucket_rank0=plans.bucket_rank0, fused_rank0=plans.fused_rank0,
        stream_rank0=plans.stream_rank0, max_rows0=plans.max_rows0)


class ShardComm:
    """One rank's end of the shard axis: the three collectives of the
    reference's shard body over an initialised ``torch.distributed``
    process group, and the tensor all-reduce (sum, max) of the
    data-parallel train step (``repro_torch.train.steps``).

    ``staged`` is fixed here, from the group's backend and the device: a
    ``gloo`` group cannot gather CUDA tensors, so on a CUDA device every
    exchanged vector is copied to the host, exchanged there and copied
    back (the folds stay on the card). ``staged_bytes`` counts the bytes
    those copies move (both directions), ``exchanged_bytes`` the bytes the
    collectives deliver to this rank, and ``calls`` the collectives made.

    ``bytes_by_op`` and ``calls_by_op`` split the collectives by op, under
    their HLO names ("all-gather", "all-to-all", "all-reduce"; an op not
    yet called has no key), in the convention of the reference's roofline
    (``repro.launch.roofline.collective_bytes``, which parses them out of
    a compiled step): the bytes of each op's result on this rank, an
    all-reduce counted twice (a ring moves a reduce-scatter and an
    all-gather of it). One ``dist_lpa_step`` adds
    :func:`lpa_collective_bytes` of its workspace.

    Every collective returns once the backend holds neither of its
    tensors (:meth:`_call`), so the bytes a step holds do not depend on
    a backend thread's timing.
    """

    def __init__(self, device=None):
        if not dist.is_initialized():
            raise RuntimeError("ShardComm needs an initialised process "
                               "group (torch.distributed.init_process_group)")
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl group exchanges CUDA tensors; got "
                             f"device {self.device}")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.reset_counts()

    def reset_counts(self) -> None:
        self.staged_bytes = self.exchanged_bytes = self.calls = 0
        self.bytes_by_op: dict = {}
        self.calls_by_op: dict = {}

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return t.contiguous()
        self.staged_bytes += t.numel() * t.element_size()
        return t.cpu()

    def _from_wire(self, t: torch.Tensor, op: str) -> torch.Tensor:
        n_bytes = t.numel() * t.element_size()
        self.exchanged_bytes += n_bytes
        self.calls += 1
        ring = 2 if op == "all-reduce" else 1
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + ring * n_bytes
        self.calls_by_op[op] = self.calls_by_op.get(op, 0) + 1
        if not self.staged:
            return t
        self.staged_bytes += n_bytes
        return t.to(self.device)

    def _call(self, collective: Callable, out: torch.Tensor,
              src: torch.Tensor) -> None:
        """``collective(out, src)``, returned from once the backend holds
        neither tensor. gloo runs a call on a worker thread, which keeps
        the call's tensors until it has done its bookkeeping after the
        result is delivered: for that while (about 1 call in 100 on an
        idle host, more under load) they stay allocated past the point
        where the caller drops them, so wait for the worker to let go."""
        held = [(t, t._use_count()) for t in {id(out): out,
                                              id(src): src}.values()]
        collective(out, src)
        if self.backend == "gloo":
            while any(t._use_count() > n for t, n in held):
                time.sleep(0)

    def all_gather(self, vec: torch.Tensor) -> torch.Tensor:
        """[n] on every rank -> [P * n], rank-major (the reference's
        ``all_gather(..., tiled=True)``)."""
        src = self._to_wire(vec)
        out = src.new_empty((self.world_size * src.shape[0],))
        self._call(dist.all_gather_into_tensor, out, src)
        return self._from_wire(out, "all-gather")

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """[P, H] -> [P, H]: row q goes to rank q, and row q of the result
        came from rank q (the reference's ``all_to_all(split_axis=0,
        concat_axis=0, tiled=True)``)."""
        if buf.shape[0] != self.world_size:
            raise ValueError(f"all_to_all takes [P={self.world_size}, H], "
                             f"got {tuple(buf.shape)}")
        src = self._to_wire(buf)
        out = torch.empty_like(src)
        self._call(dist.all_to_all_single, out, src)
        return self._from_wire(out, "all-to-all")

    def psum(self, value: torch.Tensor) -> torch.Tensor:
        """The sum of an int32 scalar over the ranks."""
        src = self._to_wire(value.to(torch.int32).reshape(1)).clone()
        self._call(lambda out, _: dist.all_reduce(out, op=dist.ReduceOp.SUM),
                   src, src)
        return self._from_wire(src, "all-reduce").reshape(())

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``"sum"`` or ``"max"`` of ``t`` (any shape and
        dtype) over the ranks, as a new tensor on this rank's device."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"all_reduce op {op!r}; expected sum or max")
        src = self._to_wire(t).clone()
        self._call(lambda out, _: dist.all_reduce(out, op=ops[op]), src, src)
        return self._from_wire(src, "all-reduce")


def _exchange(comm: ShardComm, sh: DistLPAWorkspace, vec: torch.Tensor,
              fill: int) -> torch.Tensor:
    """Local [V_pad] vector -> the table this shard's nbr_pos indexes."""
    if sh.send_idx is None:
        # THE collective: one all-gather per exchanged vector
        return comm.all_gather(vec)
    # hub values: small all-gather (vertices referenced by many shards)
    hidx = sh.hub_idx             # [HUB_pad]
    hub_buf = torch.where(hidx >= 0, vec[hidx.clamp_min(0).long()], fill)
    hub_all = comm.all_gather(hub_buf)
    # halo exchange: send each peer exactly the values it references
    sidx = sh.send_idx            # [P, H_pad]
    buf = torch.where(sidx >= 0, vec[sidx.clamp_min(0).long()], fill)
    recv = comm.all_to_all(buf)   # [P, H_pad]
    return torch.cat([vec, hub_all, recv.reshape(-1)])


def _move_epilogue(comm: ShardComm, want: torch.Tensor, labels: torch.Tensor,
                   pick_less: bool, frontier: Optional[torch.Tensor] = None):
    """Shared per-shard move rule: apply the Pick-Less/changed gating to
    the wanted labels (pad slots excluded) and sum the global ΔN. One
    copy for every method. ``frontier`` ([V_pad] bool) additionally masks
    off-frontier moves."""
    allowed = (want < labels) if pick_less else (want != labels)
    if frontier is not None:
        allowed = allowed & frontier
    is_real = labels >= 0
    new_labels = torch.where(allowed & is_real, want, labels)
    changed = (new_labels != labels) & is_real
    delta = comm.psum(torch.sum(changed, dtype=torch.int32))
    return new_labels, changed, delta


def _stream_round(sh: DistLPAWorkspace, r: int, el: torch.Tensor,
                  aligned: bool) -> StreamedRound:
    """Round ``r`` of this shard's windowed plan; ``n_entries_in`` is the
    real length of the source arrays ``el`` the round reads (M_pad on an
    unaligned round 0, n_win_0 * W on an aligned one, the previous
    round's rows * k after round 0)."""
    g = sh.stream_gathers[r]
    return StreamedRound(entry_gather=g.reshape(-1),
                         row_start=sh.stream_starts[r],
                         row_count=sh.stream_counts[r],
                         step_dmax=sh.stream_dmax[r],
                         n_entries_in=el.shape[0],
                         window_entries=g.shape[-1], aligned=aligned)


def _fused_round(sh: DistLPAWorkspace, r: int) -> FusedRound:
    return FusedRound(row_start=sh.fused_starts[r],
                      row_count=sh.fused_counts[r],
                      step_dmax=sh.fused_dmax[r],
                      n_entries_in=sh.fused_entries[r])


def _shard_move(comm: ShardComm, sh: DistLPAWorkspace, labels: torch.Tensor,
                pick_less: bool, seed: int, *, fold_tile: Callable,
                request: FoldRequest, fused: bool, stream: bool,
                final_rows: torch.Tensor, final_vertex: torch.Tensor,
                frontier: Optional[torch.Tensor] = None):
    """Per-shard body of one distributed LPA iteration, on one rank's
    blocks ``sh`` (``DistLPAWorkspace.shard``) and its [V_pad] labels.

    ``fused`` folds every round with the fused kernel (K1; K3 for BM, K4
    for the rescan), ``stream`` with the windowed one (K5; K7, K8),
    neither with ``fold_tile`` over each round's padded [R_pad, chunk]
    tile (K9/K10 on ``engine="pallas"``). ``request.family == "bm"`` folds
    round 0 only and merges the per-row partial states shard-locally;
    ``request.rescan`` re-scores the MG candidates exactly against round 0
    before selecting. ``final_rows``/``final_vertex`` are the real rows of
    the final round and their local vertices (each vertex owns at most
    one), so the sketch scatter writes real rows only.

    ``frontier`` ([V_pad] bool) turns on dense frontier gating: off-
    frontier moves are masked and the step returns a third value, next
    iteration's marked frontier, built by exchanging this iteration's
    changed flags through the same exchange as the labels and
    segment-maxing them over the shard's own edge slots. Returns
    (new_labels, delta[, marked]).
    """
    k, v_pad, chunk = sh.k, sh.v_pad, sh.chunk
    nbr_pos = sh.nbr_pos
    label_table = _exchange(comm, sh, labels, -1)
    valid = nbr_pos >= 0
    safe = nbr_pos.clamp_min(0).long()
    entry_labels = torch.where(valid, label_table[safe], -1)
    entry_weights = torch.where(valid, sh.weights, 0.0)
    # the fold loops below consume these round by round; the rescan
    # second pass re-reads round 0, so keep the originals
    entry_labels0, entry_weights0 = entry_labels, entry_weights
    is_aligned = stream and sh.stream_aligned_pos is not None

    def round0_entries():
        """Round 0's source arrays: with the aligned layout, the label
        table gathered straight into window-slot order (pad slots -> label
        -1, weight 0.0, exactly what the re-layout gather would give)."""
        if not is_aligned:
            return entry_labels0, entry_weights0
        sap = sh.stream_aligned_pos
        wl = torch.where(sap >= 0, label_table[sap.clamp_min(0).long()], -1)
        return wl, sh.stream_aligned_w

    def finish(want):
        new_labels, changed, delta = _move_epilogue(comm, want, labels,
                                                    pick_less, frontier)
        if frontier is None:
            return new_labels, delta
        # mark next iteration's frontier: a vertex is queued iff any of its
        # neighbors changed — the shard-local segment-max over its own edge
        # slots, fed by one changed-flag exchange (paper Alg. 1 l. 31)
        changed_table = _exchange(comm, sh, changed.to(torch.int32), 0)
        ent = torch.where(valid, changed_table[safe], 0)
        ev = sh.entry_vertex
        tgt = torch.where(ev >= 0, ev, v_pad).long()
        marked = torch.zeros((v_pad + 1,), dtype=torch.int32,
                             device=labels.device)
        marked.scatter_reduce_(0, tgt, ent, "amax")
        return new_labels, delta, marked[:v_pad] > 0

    if request.family == "bm":
        rv0 = (sh.stream_rv0 if stream else sh.fused_rv0 if fused
               else sh.row_vertex0)
        init = sketch_lib.bm_init_rows(rv0, labels)
        if stream:
            el0, ew0 = round0_entries()
            ck, wk = bm_fold_round_stream(
                _stream_round(sh, 0, el0, is_aligned), el0, ew0, init,
                chunk=chunk)
        elif fused:
            ck, wk = bm_fold_round_fused(_fused_round(sh, 0), entry_labels,
                                         entry_weights, init, chunk=chunk)
        else:
            gl, gw = sketch_lib._gather_entries(sh.round_gathers[0],
                                                entry_labels, entry_weights)
            ck, wk = fold_tile(gl, gw, init)
        best_c, _ = sketch_lib.bm_merge_rows(v_pad, labels, rv0, ck, wk)
        return finish(torch.where(best_c >= 0, best_c, labels))

    n_rounds = sh.n_rounds
    if stream:
        # one launch per round, one window of entries per block
        for r in range(n_rounds):
            el, ew = ((round0_entries() if r == 0
                       else (entry_labels, entry_weights)))
            s_k, s_v = stream_fold_round(
                _stream_round(sh, r, el, r == 0 and is_aligned), el, ew,
                k=k, chunk=chunk)
            entry_labels, entry_weights = s_k.reshape(-1), s_v.reshape(-1)
    elif fused:
        # one launch per round, the (start, count) gather inside the kernel
        for r in range(n_rounds):
            s_k, s_v = fused_fold_round(_fused_round(sh, r), entry_labels,
                                        entry_weights, k=k, chunk=chunk)
            entry_labels, entry_weights = s_k.reshape(-1), s_v.reshape(-1)
    else:
        for gather in sh.round_gathers:
            gl, gw = sketch_lib._gather_entries(gather, entry_labels,
                                                entry_weights)
            s_k, s_v = fold_tile(gl, gw, k)
            entry_labels, entry_weights = s_k.reshape(-1), s_v.reshape(-1)

    # scatter the final sketches of the real rows to their local vertices
    cand_c = torch.full((v_pad, k), -1, dtype=torch.int32,
                        device=labels.device)
    cand_c[final_vertex] = s_k[final_rows]

    if request.rescan:
        # double-scan second pass (paper §4.4): re-score the consolidated
        # candidates exactly against round 0 — one launch on the fused and
        # streamed engines, the plain sequential partials on the bucketed
        # tile path. Candidates stay unmasked here (a decimated zero-weight
        # slot can win on its exact weight), and the merge and selection
        # reduce through the same sketch helpers in the same order as the
        # single-host rescan.
        rv0, rank0 = ((sh.stream_rv0, sh.stream_rank0) if stream
                      else (sh.fused_rv0, sh.fused_rank0) if fused
                      else (sh.row_vertex0, sh.bucket_rank0))
        cand_ext = torch.cat([cand_c, cand_c.new_full((1, k), -1)])
        cand_rows = cand_ext[torch.where(rv0 >= 0, rv0, v_pad).long()]
        if stream:
            el0, ew0 = round0_entries()
            parts = rescan_round_stream(
                _stream_round(sh, 0, el0, is_aligned), el0, ew0, cand_rows,
                k=k, chunk=chunk)
        elif fused:
            parts = rescan_round_fused(_fused_round(sh, 0), entry_labels0,
                                       entry_weights0, cand_rows, k=k,
                                       chunk=chunk)
        else:
            gl0, gw0 = sketch_lib._gather_entries(sh.round_gathers[0],
                                                  entry_labels0,
                                                  entry_weights0)
            parts = sketch_lib.rescan_row_partials(gl0, gw0, cand_rows)
        acc = sketch_lib.merge_rescan_partials(v_pad, k, sh.max_rows0, rv0,
                                               rank0, parts)
        return finish(sketch_lib.choose_from_candidates(
            torch.where(acc > 0, cand_c, -1), acc, labels, seed))

    cand_w = torch.zeros((v_pad, k), dtype=torch.float32,
                         device=labels.device)
    cand_w[final_vertex] = s_v[final_rows]
    cand_c = torch.where(cand_w > 0, cand_c, -1)
    return finish(sketch_lib.choose_from_candidates(cand_c, cand_w, labels,
                                                    seed))


def dist_lpa_step(comm: ShardComm, ws: DistLPAWorkspace, *,
                  fold_tile: Optional[Callable] = None,
                  engine: str | None = None, method: str = "mg",
                  rescan: bool = False, frontier_gate: bool = False):
    """Build this rank's single-iteration function over its blocks of the
    stacked workspace ``ws`` (taken once, to ``comm.device``, by
    :meth:`DistLPAWorkspace.shard`).

    Returns ``step(labels [V_pad], pick_less, seed, frontier=None) ->
    (labels, delta_n)``; every rank calls it in step with the others.

    ``engine`` selects the fold backend uniformly with the single-host
    driver ("jnp" | "pallas" | "pallas_fused" | "pallas_stream" — see
    repro_torch.core.fold_engine); "pallas_fused" needs a workspace built
    with ``fused=True``, "pallas_stream" one built with ``stream=True``,
    and the bucketed engines one built with neither.
    An explicit ``fold_tile`` overrides the engine's tile fold.

    ``method``/``rescan`` select the sketch family uniformly with the
    single-host driver — the same ``FoldRequest`` routing key ``lpa_move``
    builds (``family`` "mg" | "bm", ``rescan`` the MG double-scan
    ablation); every combination runs on every engine, and halo or
    full-gather label exchange is orthogonal.

    ``frontier_gate=True`` builds the dense-gated step: it takes
    ``frontier`` ([V_pad] bool) and returns (labels, delta_n, marked) —
    ``marked`` is next iteration's frontier of this shard (``dist_lpa``
    keeps Pick-Less iterations' deferred vertices queued by unioning).
    """
    if method not in ("mg", "bm"):
        raise ValueError(f"unknown method {method!r}; expected 'mg' | 'bm'")
    # the request is static routing state (seed and frontier are operands
    # of the step); construction validates the combination
    request = FoldRequest(family=method, rescan=rescan)
    if frontier_gate and ws.entry_vertex is None:
        raise ValueError("frontier_gate=True requires a workspace with "
                         "entry_vertex (rebuild via build_dist_workspace)")
    fused = engine == "pallas_fused"
    stream = engine == "pallas_stream"
    if engine is not None and not (fused or stream) and fold_tile is None:
        from repro_torch.core.fold_engine import get_engine
        eng = get_engine(engine, checked=False)
        fold_tile = eng.bm_fold_tile if method == "bm" else eng.mg_fold_tile
    fold_tile = fold_tile or (sketch_lib.bm_fold_tile if method == "bm"
                              else sketch_lib.mg_fold_tile)
    if fused and ws.fused_starts is None:
        raise ValueError("engine='pallas_fused' requires "
                         "build_dist_workspace(..., fused=True)")
    if stream and ws.stream_gathers is None:
        raise ValueError("engine='pallas_stream' requires "
                         "build_dist_workspace(..., stream=True)")
    if not (fused or stream) and ws.round_gathers is None:
        raise ValueError(f"engine={engine!r} folds the bucketed round "
                         "gathers, which a fused or streamed workspace "
                         "leaves out (build_dist_workspace(..., "
                         "fused=False, stream=False))")
    if rescan and (ws.stream_rank0 is None if stream else
                   ws.fused_rank0 is None if fused else
                   ws.bucket_rank0 is None):
        raise ValueError("rescan=True needs the workspace's round-0 rank "
                         "metadata (rebuild via build_dist_workspace)")
    if ws.n_shards != comm.world_size:
        raise ValueError(f"the workspace has {ws.n_shards} shards, the "
                         f"group {comm.world_size} ranks")
    sh = ws.shard(comm.rank, comm.device)
    # the final round's real rows (fixed by the plan): scatter those only
    frv = sh.stream_final_rv if stream else sh.final_row_vertex
    final_rows = torch.nonzero(frv >= 0).squeeze(1)
    final_vertex = frv[final_rows].long()

    def step(labels, pick_less, seed, frontier=None):
        if frontier_gate and frontier is None:
            raise ValueError("the gated step needs this shard's frontier")
        return _shard_move(comm, sh, labels, bool(pick_less), int(seed),
                           fold_tile=fold_tile, request=request,
                           fused=fused, stream=stream, final_rows=final_rows,
                           final_vertex=final_vertex,
                           frontier=frontier if frontier_gate else None)

    return step


def lpa_collective_bytes(ws: DistLPAWorkspace) -> dict:
    """The collective bytes one ``dist_lpa_step`` (ungated) moves on each
    rank of ``ws``, by op, with their ``"total"``.

    The counterpart of what ``repro.launch.dryrun`` parses out of the
    reference's compiled step (``repro.launch.roofline.collective_bytes``
    of its HLO), in that convention: the bytes of each op's result on a
    rank, an all-reduce counted twice. The full gather moves one
    all-gather of the [P · V_pad] int32 label table; the halo exchange an
    all-gather of the [P · HUB_pad] hub labels and an all-to-all of the
    [P, H_pad] halo labels; both sum the changed count, an int32 psum
    (4 B, twice). ``ShardComm.bytes_by_op`` records the same per step.
    """
    p = ws.n_shards
    if ws.send_idx is None:
        out = {"all-gather": 4 * p * ws.v_pad}
    else:
        out = {"all-gather": 4 * p * ws.hub_pad,
               "all-to-all": 4 * p * ws.h_pad}
    out["all-reduce"] = 2 * 4
    out["total"] = sum(out.values())
    return out


def dist_lpa(comm: ShardComm, ws: DistLPAWorkspace, rho: int = 8,
             tau: float = 0.05, max_iters: int = 20,
             engine: str | None = None, method: str = "mg",
             rescan: bool = False, frontier_gate: bool = False,
             step: Optional[Callable] = None):
    """Run distributed LPA to convergence on every rank of ``comm``'s group.

    ``ws`` is the stacked workspace (see :func:`dist_lpa_step`). Returns
    (labels [N] int32 on ``comm.device``, iterations) on every rank; the
    labels are assembled with one final all-gather. ``method``
    selects the sketch ("mg" | "bm"), ``rescan`` the MG double-scan
    ablation, ``engine`` the fold backend — all uniform with the
    single-host driver. ``frontier_gate`` turns on per-shard dense frontier
    gating: settled vertices keep their label, and Pick-Less iterations
    union the previous frontier into the marks so deferred vertices stay
    queued. ``step`` runs a step already built for this rank over ``ws``
    (a cell's, ``repro_torch.launch.cells.build_lpa_cell(...).fn``) in
    place of the one ``engine``, ``method`` and ``rescan`` would build;
    ``frontier_gate`` must say whether it is gated."""
    if step is None:
        step = dist_lpa_step(comm, ws, engine=engine, method=method,
                             rescan=rescan, frontier_gate=frontier_gate)
    labels = slots0 = ws.init_labels[comm.rank].to(comm.device)
    n = ws.n_nodes
    frontier = torch.ones(labels.shape, dtype=torch.bool,
                          device=comm.device)
    it = 0
    for it in range(max_iters):
        pl_on = (it % rho) == 0
        if frontier_gate:
            labels, delta, marked = step(labels, pl_on, it + 1,
                                         frontier=frontier)
            frontier = (frontier | marked) if pl_on else marked
        else:
            labels, delta = step(labels, pl_on, it + 1)
        if not pl_on and int(delta) / max(n, 1) < tau:
            break
    # every shard's labels and global ids (-1 on pad slots), rank-major
    flat = comm.all_gather(labels)
    slots = comm.all_gather(slots0)
    real = slots >= 0
    out = torch.empty(n, dtype=torch.int32, device=comm.device)
    out[slots[real].long()] = flat[real]
    return out, it + 1


def _rank_main(rank: int, world_size: int, store: str, backend: str,
               device, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    try:
        dev = device
        if dev is None or (isinstance(dev, str) and dev == "cuda"):
            # one card per rank where there are several, else all share one
            n_dev = torch.cuda.device_count()
            dev = f"cuda:{rank % n_dev}" if n_dev else "cuda"
        fn(ShardComm(dev), *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), *,
                backend: str = "gloo", device=None) -> None:
    """Run ``fn(comm, *args)`` on ``world_size`` new processes of this
    machine, one rank each, joined by a ``file://`` store in a temporary
    directory.

    ``fn`` must be importable (a module-level function: the ranks start
    with ``spawn``, not ``fork``, which CUDA needs). ``device=None`` (or
    ``"cuda"``) puts rank r on card ``r % device_count()``, so ranks share
    the cards when there are fewer cards than ranks (use ``backend="gloo"``
    then: NCCL refuses two ranks on one card); ``device="cpu"`` keeps
    them on the CPU. Every rank runs torch on one thread. A rank that
    raises makes this call raise.
    """
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_dist_") as tmp:
        mp.spawn(_rank_main,
                 args=(world_size, os.path.join(tmp, "store"), backend,
                       device, fn, args),
                 nprocs=world_size, join=True)
