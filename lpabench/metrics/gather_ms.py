"""gather_ms: device time of the neighbour-label gather (``lpa_move``'s
``index_select``) per traced detection (ms), from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or "gather" not in t.layer_s:
        return None
    return t.layer_s["gather"] / t.detections * 1e3
