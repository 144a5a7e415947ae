"""host_reads_per_iter: values the program read back from the device per
LPA iteration (a count): each read waits for the device to drain its
queue. The program's own counter, ``repro_torch.trace.DETECTIONS``: the
reads and the iterations of every detection the run's process ended.
That is a process-wide sum, not the window's untraced detections alone:
it takes in the warm-up and the traced detections too, which read the
same as the window's only because a cell's detections all take the same
path. A program that keeps no such counter reads as nothing."""


def read(run):
    try:
        from repro_torch.trace import DETECTIONS
    except ImportError:
        return None
    if not DETECTIONS["iterations"]:
        return None
    return DETECTIONS["host_reads"] / DETECTIONS["iterations"]
