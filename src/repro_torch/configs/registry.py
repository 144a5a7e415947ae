"""Architecture registry: each ported architecture with its exact full
config, a reduced smoke config, and its assigned input-shape cells.

A copy of ``repro.configs.registry``: the reference's eleven ids, the
five LMs, the four GNNs, DCN-v2 and the paper's own LPA workload. An
unknown id raises ``KeyError``, naming the ids it knows.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List

__all__ = ["ShapeCell", "ArchSpec", "ARCHS", "register", "get_arch",
           "all_arch_ids"]

#: the config modules of the ported architectures, imported on first use
CONFIG_MODULES = ("qwen3_moe_235b_a22b", "deepseek_v2_lite_16b",
                  "granite_34b", "qwen3_1p7b", "glm4_9b", "pna",
                  "meshgraphnet", "egnn", "equiformer_v2", "dcn_v2",
                  "lpa_graphs")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""

    name: str
    kind: str          # train | prefill | decode | gnn_full | gnn_sampled |
                       # recsys_train | recsys_serve | retrieval | lpa
    params: Dict[str, Any]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str        # lm | gnn | recsys | lpa
    config: Any        # full production config
    smoke: Any         # reduced CPU-testable config
    cells: List[ShapeCell]
    notes: str = ""


def _lm_cells(decode_note: str = "") -> List[ShapeCell]:
    return [
        ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
        ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
        ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
        ShapeCell("long_500k", "decode", {"seq": 524288, "batch": 1},
                  note="full-attn(flagged): decode vs 500k KV is O(S)/token; "
                       "cell runs, flagged per the assignment rule"
                       + decode_note),
    ]


def _gnn_cells() -> List[ShapeCell]:
    return [
        ShapeCell("full_graph_sm", "gnn_full",
                  {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
        ShapeCell("minibatch_lg", "gnn_sampled",
                  {"n_nodes": 232965, "n_edges": 114615892,
                   "batch_nodes": 1024, "fanouts": (15, 10)}),
        ShapeCell("ogb_products", "gnn_full",
                  {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
        ShapeCell("molecule", "gnn_full",
                  {"n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 16,
                   "batched": 128}),
    ]


def _recsys_cells() -> List[ShapeCell]:
    return [
        ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
        ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
        ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
        ShapeCell("retrieval_cand", "retrieval",
                  {"batch": 1, "n_candidates": 1000000}),
    ]


ARCHS: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    ARCHS[spec.arch_id] = spec
    return spec


def _populate() -> None:
    for name in CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        _populate()  # on first use
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_arch_ids() -> List[str]:
    _populate()
    return sorted(ARCHS)
