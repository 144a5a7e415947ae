"""device_idle_pct: the share of the traced detections' window in which
no operation ran on the device (%), from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return (1 - t.busy_s / t.window_s) * 100
