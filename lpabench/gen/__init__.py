"""Graph generators, one module each, found by the configuration's
``generator`` key: ``make(params, seed, device)`` returns (offsets int32
[N+1], indices int32 [M], weights float32 [M]) on ``device``."""
from __future__ import annotations

import importlib


def make_graph(name: str, params: dict, seed: int, device):
    """Run generator ``lpabench.gen.<name>`` for ``seed`` on ``device``."""
    return importlib.import_module(f"lpabench.gen.{name}").make(
        params, seed, device)
