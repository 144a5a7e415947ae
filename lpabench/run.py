"""Run one cell of the benchmark and print its result line.

    python3 lpabench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared for ``correct`` are the last lines of
standard error. Exits 2 without a result when the card the cell needs is
not there.
"""
import time

_T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# kernel caches at fixed places inside the checkout, so that only the
# first run of a cell builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "lpabench" / sub))

from lpabench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], _T_START))
