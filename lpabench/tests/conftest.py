"""Shared set-up of the benchmark's own tests (not collected by the
repository's ``pytest`` run, whose ``testpaths`` is ``tests``): run them
with ``python -m pytest lpabench/tests`` from the root of a checkout."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: small stand-ins of each configuration's graph, for the CPU
TINY = {
    "uk2002": {"n_nodes": 3000},
    "europe_osm": {"n_nodes": 4000, "n_slots": 2 * 4245,
                   "lattice_rows": 18, "lattice_cols": 18},
}
