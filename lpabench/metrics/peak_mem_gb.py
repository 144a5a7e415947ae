"""peak_mem_gb: the allocator's peak from just before the program's
workspace is built to the window's close (GB, 1e9 bytes): the graph, the
plans and every detection's temporaries; not the generator's
temporaries, nor the labels the benchmark keeps to check, which go to the
host."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
