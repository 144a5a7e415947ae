"""The GNN and LM serving cells on the card, and their timed calls.

One definition of the GNN cells that ``chip_smoke.py`` phase 7 drives and
``scripts/gnn_profile.py`` profiles: their sizes, the model of an arch
at a cell's config, the cells' batches, and ``serve``, which times
forwards under ``torch.inference_mode()`` between CUDA events and reads
the peak device memory. The LM cells of phase 9 are at the end:
``LM_CELLS`` (each arch's depth and each cell's batch on one card),
``lm_plan``, ``lm_model``, ``lm_cost`` (the FLOPs and bytes a call
needs) and ``time_calls``.

- ``example``: the full-graph batch of ``powerlaw_communities(2^18)``
  (the example's path), ``d_feat`` = the ``ogb_products`` cell's 100;
- ``minibatch_lg``: ``sample_fanout`` batches of 1,024 seeds with fanouts
  (15, 10) from the 2^22 graph, ``d_feat`` 602;
- ``molecule``: 128 disjoint molecules of 30 nodes and 64 edges,
  ``d_feat`` 16, with coordinates.
"""
from __future__ import annotations

import dataclasses
import statistics

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import (gnn_full_batch, gnn_sampled_batch,
                                        molecule_batch)
from repro_torch.graphs.generators import powerlaw_communities
from repro_torch.graphs.sampler import sample_fanout
from repro_torch.launch.cells import _gnn_apply, _gnn_cell_config, _gnn_init

__all__ = ["CLASSES", "EXAMPLE", "MINIBATCH", "MOLECULE", "gnn_model",
           "cell_config", "example_graph", "example_batch",
           "minibatch_batch", "molecule_cell_batch", "serve", "LM_CELLS",
           "lm_config", "lm_plan", "lm_model", "lm_cost", "time_calls"]

#: output classes of every cell (``_gnn_cell_config``'s default)
CLASSES = 16
#: the example's full graph: log2 vertices, feature width
EXAMPLE = {"scale": 18, "d_feat": 100}
#: the minibatch_lg cell, sampled from the 2^22 graph
MINIBATCH = {"scale": 22, "batch_nodes": 1024, "fanouts": (15, 10),
             "d_feat": 602, "steps": 3}
#: the molecule cell (128 molecules of 30 nodes and 64 edges)
MOLECULE = {"n_mol": 128, "n_per": 30, "e_per": 64, "d_feat": 16}


def gnn_model(arch: str, cfg, device=None, seed: int = 0):
    """``(model, apply)``: the arch at ``cfg``, its weights drawn from a
    CPU generator seeded with ``seed``, on ``device`` (``None``: CUDA)."""
    spec = get_arch(arch)
    model = _gnn_init(spec, cfg)(torch.Generator().manual_seed(seed),
                                 device=device)
    return model, _gnn_apply(spec, cfg)


def cell_config(arch: str, d_feat: int):
    """The arch's FULL config at a cell's feature width."""
    return _gnn_cell_config(get_arch(arch), d_feat, CLASSES)


def example_graph(device=None):
    """The example's graph, ``powerlaw_communities(2^18)``."""
    g, _ = powerlaw_communities(1 << EXAMPLE["scale"], p_in=0.5, mix=0.02,
                                seed=1, device=device)
    return g


def example_batch(graph) -> dict:
    """The full-graph batch of ``graph`` at the example's width."""
    return gnn_full_batch(0, graph, d_feat=EXAMPLE["d_feat"],
                          n_classes=CLASSES)


def minibatch_batch(graph, step: int, sampler=sample_fanout) -> dict:
    """Step ``step``'s ``minibatch_lg`` batch of ``graph``."""
    mb = MINIBATCH
    return gnn_sampled_batch(0, step, graph, sampler, mb["batch_nodes"],
                             mb["fanouts"], d_feat=mb["d_feat"],
                             n_classes=CLASSES)


def molecule_cell_batch(device=None) -> dict:
    """The molecule cell's batch."""
    mc = MOLECULE
    return molecule_batch(0, mc["n_mol"], mc["n_per"], mc["e_per"],
                          mc["d_feat"], device=device)


def serve(apply, model, batches: list, *, warmup: int = 2,
          reps: int = 5) -> dict:
    """Forward ``model`` (on the card) under ``torch.inference_mode()``:
    ``warmup`` calls on the first batch, then ``reps`` calls on each batch,
    each between its own CUDA events (host launch work included: a
    serving call pays it). Returns the median ms of each batch, the peak
    device memory over all of it (after ``reset_peak_memory_stats``), the
    memory resident before it, and the first output's shape and
    finiteness; a non-finite output raises."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = apply(model, batches[0])
        for _ in range(warmup - 1):
            apply(model, batches[0])
        ms = []
        for batch in batches:
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                apply(model, batch)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms.append(statistics.median(times))
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(out).all())
    if not finite:
        raise AssertionError("a forward gave a non-finite value")
    return {"ms": ms, "peak_bytes": peak, "resident_bytes": resident,
            "working_bytes": peak - resident, "shape": list(out.shape),
            "finite": finite}


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------

#: The LM cells on one 80 GB card: per arch, the layers run (FULL widths
#: always) and, per cell, the (batch, seq) run, each cut from the
#: registry's cell (``configs.registry._lm_cells``: train_4k 256 x 4,096,
#: prefill_32k 32 x 32,768, decode_32k 128 x 32,768, long_500k 1 x
#: 524,288) to what fits beside the float32 parameters. A ``prefill``
#: or ``decode`` entry names the registry cell it cuts.
LM_CELLS = {
    # 28 layers, 2.03 B parameters (8.1 GB): all cells, cut batches
    "qwen3-1.7b": {"layers": 28, "cells": {
        "prefill_32k": (2, 32768), "decode_32k": (16, 32768),
        "long_500k": (1, 524288), "train_4k": (8, 4096)}},
    # 40 layers, 9.4 B parameters (37.6 GB)
    "glm4-9b": {"layers": 40, "cells": {
        "prefill_32k": (1, 32768), "decode_32k": (16, 32768)}},
    # 27 layers, 16.2 B parameters (64.8 GB): prefill cut to seq 4,096
    "deepseek-v2-lite-16b": {"layers": 27, "cells": {
        "prefill_32k": (2, 4096), "decode_32k": (8, 32768)}},
    # 40 of 88 layers: 15.2 + 0.6 B parameters (60.6 + 2.4 GB)
    "granite-34b": {"layers": 40, "cells": {
        "prefill_32k": (2, 4096), "decode_32k": (8, 32768)}},
    # 4 of 94 layers: 9.9 + 1.2 B parameters (39.8 + 5.0 GB)
    "qwen3-moe-235b-a22b": {"layers": 4, "cells": {
        "prefill_32k": (2, 4096), "decode_32k": (16, 32768)}},
}


def lm_config(arch: str, layers: int | None = None, **overrides):
    """The arch's FULL config at ``layers`` layers (default
    ``LM_CELLS``'), with ``overrides``."""
    cfg = get_arch(arch).config
    n = layers if layers is not None else LM_CELLS[arch]["layers"]
    return dataclasses.replace(cfg, n_layers=n, **overrides)


def lm_plan(arch: str, cell: str, cfg=None):
    """The cell's plan (``launch.cells``) at ``cfg`` (default
    ``lm_config(arch)``) and the (batch, seq) of ``LM_CELLS``."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch.cells import build_cell
    spec = get_arch(arch)
    ref = next(c for c in spec.cells if c.name == cell)
    b, s = LM_CELLS[arch]["cells"][cell]
    spec = dataclasses.replace(spec, config=cfg or lm_config(arch))
    return build_cell(spec, ShapeCell(cell, ref.kind, {"seq": s,
                                                       "batch": b}))


def lm_model(cfg, device=None, seed: int = 0):
    """The model at ``cfg``, drawn from a generator on ``device``
    (``None``: CUDA) seeded with ``seed``."""
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_params
    dev = resolve_device(device)
    return init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                       device=dev)


def lm_cost(cfg, kind: str, batch: int, seq: int) -> dict:
    """The FLOPs and bytes one call of an LM cell needs, from the shapes.

    FLOPs: 2 per multiply-add of every product a token's path needs (the
    active parameters: routed top-k experts, not the capacity slots), the
    causal attention pairs (each query row against the keys at or before
    it; decode: one row against ``seq`` keys; MLA's absorbed form against
    the latent cache), and the LM head (prefill and decode: one position
    a row). A train step is three forwards' worth (forward and backward;
    the remat recompute not counted). Bytes: every weight read as float32
    and, as the reference casts it at each step, written and read once as
    ``cfg.dtype``; decode reads the whole cache; a train step also writes
    the gradients and runs AdamW's passes (p, g, m, v read; p, m, v
    written)."""
    d, l, v = cfg.d_model, cfg.n_layers, cfg.vocab
    emb = v * d
    layer_active = (cfg.n_active_params - 2 * emb) // l
    layer_all = (cfg.n_params - 2 * emb) // l
    h = cfg.n_heads
    if cfg.mla is None:
        pair = 2 * h * 2 * cfg.d_head
        kv_token = 2 * cfg.n_kv_heads * cfg.d_head
    else:
        m = cfg.mla
        kv_token = m.kv_lora_rank + m.qk_rope_dim
        pair = (2 * h * (2 * m.kv_lora_rank + m.qk_rope_dim) if kind ==
                "decode" else 2 * h * (m.qk_nope_dim + m.qk_rope_dim
                                       + m.v_head_dim))
    act = torch.tensor([], dtype=cfg.dtype).element_size()
    weights = (l * layer_all + emb) * (4 + 2 * act)
    if kind == "decode":
        flops = batch * (2 * l * layer_active + l * pair * seq + 2 * emb)
        n_bytes = weights + l * batch * seq * kv_token * act
    else:
        tokens = batch * seq
        flops = (2 * tokens * l * layer_active
                 + l * batch * pair * seq * (seq + 1) // 2)
        if kind == "prefill":
            flops += 2 * batch * emb
            n_bytes = weights + tokens * d * 4
        else:
            flops = 3 * (flops + 2 * tokens * emb)
            n_bytes = weights + 8 * 4 * cfg.n_params
    return {"flops": flops, "bytes": n_bytes}


def time_calls(fn, *args, warmup: int = 1, reps: int = 3,
               warmup_args: tuple | None = None) -> dict:
    """Call ``fn(*args)`` on the card under ``torch.inference_mode()``:
    ``warmup`` calls (on ``warmup_args`` if given: a shorter input warms
    the same kernels up when a call takes seconds), then ``reps`` calls
    each between its own CUDA events (host launch work included).
    Returns each timed call's ms, their median, the peak device memory
    (after ``reset_peak_memory_stats``), the memory resident before, and
    the last output."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        for _ in range(warmup):
            fn(*(warmup_args or args))
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
    return {"ms_all": times, "ms": statistics.median(times),
            "peak_bytes": peak, "resident_bytes": resident,
            "working_bytes": peak - resident, "out": out}
