"""frontier_ms: device time of the move mask and the frontier marks
(what ``lpa_move`` does after the fold, ``mark_frontier``, ``_mean_f32``)
per traced detection (ms), from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or "frontier" not in t.layer_s:
        return None
    return t.layer_s["frontier"] / t.detections * 1e3
