"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; the port's name only begins with
it), compared whole: a whole run, traced, is driven on the CPU at a small
size in a fresh interpreter, after importing every module of the
harness."""
import json
import subprocess
import sys

from conftest import ROOT, TINY

SCRIPT = r"""
import importlib, json, pkgutil, sys, time
sys.path[:0] = [{src!r}, {root!r}]
import lpabench
for m in pkgutil.walk_packages(lpabench.__path__, "lpabench."):
    if ".tests" not in m.name and m.name != "lpabench.run":
        importlib.import_module(m.name)
from lpabench.bench import load_cell, run_cell
TINY = json.loads({tiny!r})
for name in ("uk2002.mg8", "europe_osm.mg8_pruned"):
    cell = load_cell(name, True)
    cell.config["graph"].update(TINY[name.split(".")[0]])
    run_cell(cell, 3, 0.0, True, time.perf_counter(), device="cpu")
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    code = SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT),
                         tiny=json.dumps(TINY))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""},
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "lpabench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded
