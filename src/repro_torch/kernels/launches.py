"""One table of kernel launch counts for every CUDA kernel of the port.

Each kernel wrapper adds one to its entry where it launches its kernel,
and nowhere else (a wrapper that runs its plain version on the CPU counts
nothing). A run sets the counts to 0 just before a path and reads them
just after, so it can show which kernels the path went through, and that
it ran none of the others.
"""
from __future__ import annotations

__all__ = ["LAUNCH_COUNTS", "reset_launch_counts"]

#: kernel launches per wrapper since the last reset_launch_counts():
#: fused K1–K4 (kernels.mg_sketch.fused), streamed K5–K8
#: (kernels.mg_sketch.streaming), per-bucket tile K9–K10
#: (kernels.mg_sketch.mg_sketch)
LAUNCH_COUNTS = {"fused_fold": 0, "fused_select": 0, "bm_fold": 0,
                 "rescan": 0, "stream_fold": 0, "stream_select": 0,
                 "stream_bm": 0, "stream_rescan": 0, "tile_mg_fold": 0,
                 "tile_bm_fold": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
