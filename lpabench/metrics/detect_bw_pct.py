"""detect_bw_pct: the least time a detection's bytes (the yardstick's
count: each iteration's active slots, the offsets, every label read and
written once) take at the card's published bandwidth, over the time per
detection of the traced run's untraced detections (%). It holds whatever
later fuses or removes the kernels."""
from lpabench.yardstick import hbm_bytes_per_s


def read(run):
    bw = hbm_bytes_per_s(run.device_kind)
    done = run.untraced
    if bw is None or not done or run.trace is None:
        return None
    return run.detect_bytes / bw / (run.window_s / len(done)) * 100
