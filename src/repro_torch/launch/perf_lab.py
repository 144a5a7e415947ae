"""Perf-iteration lab: one LM cell's three roofline terms and its largest
collectives, from the port's dry-run record.

A copy of ``repro.launch.perf_lab``'s ``report``. The reference's
``lower_cell`` lowers and compiles the cell with XLA and ``report`` reads
the compiled module (memory analysis, HLO); nothing compiles here, so
``lower_cell`` has no counterpart: the record is ``launch.dryrun``'s
(``run_cell``: host arithmetic on meta tensors), and the collectives are
its ``collective_ops``, each op's instances as the reference's HLO lists
them (a loop's op once). Not part of the public API.

  PYTHONPATH=src python -m repro_torch.launch.perf_lab --arch qwen3-1.7b \\
      --shape train_4k
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import RooflineTerms

__all__ = ["report", "main"]


def report(arch: str, shape: str, mesh=None) -> RooflineTerms:
    """Print the cell's per-rank peak, its roofline terms and bottleneck,
    and its eight largest collectives by bytes x instances, on ``mesh``
    (default: the single-pod 16 x 16 production mesh); return the
    terms."""
    spec = get_arch(arch)
    cell = next(c for c in spec.cells if c.name == shape)
    mesh = mesh if mesh is not None else make_production_mesh()
    rec = dryrun.run_cell(spec, cell, mesh, "perf_lab")
    if not rec["ok"]:
        raise RuntimeError(f"{arch}/{shape}: {rec['error']}")
    r = rec["roofline"]
    terms = RooflineTerms(r["compute_s"], r["memory_s"], r["collective_s"])
    print(f"{arch}/{shape} mode={rec.get('mode')}")
    print(f"  peak {rec['memory']['peak_bytes_per_device']/1e9:.1f} GB | "
          f"compute {terms.compute_s:.2f}s memory {terms.memory_s:.2f}s "
          f"collective {terms.collective_s:.2f}s -> {terms.bottleneck}")
    print(f"  collectives {rec['collectives']['total']/1e9:.3f} GB a rank "
          f"as the reference's parse counts them (the roofline's), "
          f"{rec['collectives_moved']['total']/1e9:.3f} GB moved")
    for op, b, n in rec.get("collective_ops", [])[:8]:
        print(f"    {op:20s} {b/1e6:10.1f} MB x{n}")
    return terms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    report(args.arch, args.shape)


if __name__ == "__main__":
    main()
