"""The yardstick: the chip's published peaks and the bytes a detection
needs, counted from the graph's degree sequence alone (never from the
program's plan, so it stays put when the program changes).

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again or writes between its own passes: a
slot's (label, weight), a vertex's offset and incumbent label, its
chosen label. Bytes that only the program's schedule needs, such as the
row sketches of a fold in several rounds, are not counted, so a share of
a peak computed from these counts cannot pass 100% unless the time
leaves out part of the work.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    """The device's published memory bandwidth, or None for a device the
    table does not list."""
    return json.loads(_PEAKS.read_text())["hbm_bytes_per_s"].get(kind)


def fold_bytes(degrees: torch.Tensor) -> int:
    """Bytes the sketch fold and select of the vertices with these
    degrees need in one iteration: each slot's gathered label and weight
    read (8 B), and for each vertex with a slot its offset read (4 B),
    its incumbent label read and its choice written (8 B). A hub's rows
    may be folded in several rounds; their sketches stay the
    program's."""
    d = degrees[degrees > 0]
    return 8 * int(d.sum()) + 12 * d.numel()


def iteration_bytes(n_nodes: int, active_slots: int) -> int:
    """Bytes one iteration of a detection needs: the active vertices'
    slots (int32 neighbour id, float32 weight), the offsets, and every
    label read once and written once. What a fused detection could not
    do without, whatever its kernels."""
    return 8 * active_slots + 4 * (n_nodes + 1) + 8 * n_nodes
