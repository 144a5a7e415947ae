"""Run one part of ``chip_smoke.py``'s phase 11 alone on the card.

``11d``: qwen3-1.7b drawn on the card, saved by the checkpoint manager
and restored by ``remesh`` over 4 gloo ranks sharing the card
(``chip_smoke._remesh``). ``11e``: the rank-local train steps of
``chip_smoke.LOCAL_TRAINS``; the dry run's meta records of those layouts
(``dryrun.lm_local_run``, which ``chip_smoke.py`` makes in its
``--lm-dryrun`` processes) are made here first, then
``chip_smoke._local_train`` holds the card to them.

Usage, from the root of the repo on a machine with a CUDA card::

    PYTHONPATH=.:src python3 scripts/chip_phase11.py 11e [11d]

Prints the card's name and power limit, each part's lines as
``chip_smoke.py`` prints them, and each part's seconds.
"""
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from repro_torch.launch import dryrun


def part_11d() -> None:
    t0 = time.perf_counter()
    r = cs._remesh("[11d]")
    print(f"[11d] save {r['save_s']:.1f} s, ranks {r['spawn_s']:.1f} s, "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)


def part_11e() -> None:
    t0 = time.perf_counter()
    local = {}
    for arch, mode in cs.LOCAL_TRAINS:
        spec, cell, plan, mesh = cs._local_train_plan(arch, mode)
        rec = dryrun.lm_local_run(spec, cell, plan, mesh)
        rec["points"] = {n: list(pc) for n, pc in rec["points"].items()}
        local[f"{arch}/{mode}"] = json.loads(json.dumps(rec))
    print(f"[11e] meta records {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for arch, mode in cs.LOCAL_TRAINS:
        cs._local_train(arch, mode, local[f"{arch}/{mode}"], "[11e]")
    print(f"[11e] total {time.perf_counter() - t0:.1f} s", flush=True)


def main(parts) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    for part in parts or ["11e"]:
        {"11d": part_11d, "11e": part_11e}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
