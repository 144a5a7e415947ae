"""detect_p95_s: the 95th percentile of the window's detection times (s),
host clock, over every detection of the window."""
import numpy as np


def read(run):
    done = run.untraced
    if not done:
        return None
    return float(np.percentile([r.seconds for r in done], 95))
