"""fold_roofline: the least time the fold's bytes (the yardstick's
count from the degree sequence: each slot's label and weight, each
vertex's offset, incumbent and choice, once) take at the card's published
bandwidth, over the fold kernels' device time per traced detection (%).
The fold is bound by bytes: it does a compare and a select per slot and
entry."""
from lpabench.yardstick import hbm_bytes_per_s


def read(run):
    t = run.trace
    bw = hbm_bytes_per_s(run.device_kind)
    if t is None or bw is None or not t.layer_s.get("fold_kernels"):
        return None
    kernel_s = t.layer_s["fold_kernels"] / t.detections
    return run.fold_bytes / bw / kernel_s * 100
