"""working_gb: the allocator's peak over the window less what was
resident once the workspace was built (GB): the LPA loop's temporaries.
The benchmark holds no labels of its own on the card over a detection."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return (run.window_peak_bytes - run.resident_bytes) / 1e9
