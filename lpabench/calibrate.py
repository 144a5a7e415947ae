"""The readings that set the limits of ``correct``, at a cell's own size.

    python3 lpabench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control] [--out FILE]

For each seed, one run of the cell through the harness's own path
(``bench.run_cell``, with a window of one detection): the program, whose
numbers are the lower readings; or, with ``--control``, the reference
computed in the configuration's ``control_dtype`` in the program's place,
whose numbers are the upper readings. Prints, and appends to ``--out``,
one JSON line per seed with the numbers ``correct`` compares.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from lpabench.bench import control, load_cell, run_cell  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = load_cell(args.workload, False)
    side = "control" if args.control else "program"
    detect_fn = (control(cell, cell.config["control_dtype"])
                 if args.control else None)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run_cell(cell, seed, 0.0, False, time.perf_counter(),
                          detect_fn=detect_fn)
        line = json.dumps({"workload": cell.name, "seed": seed, "side": side,
                           "checks": result["checks"],
                           "failed": result["failed"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
