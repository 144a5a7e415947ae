"""setup_s: process start to the window's start (s), host clock: imports,
the graph made on the card, the program's workspace, and one warm-up
detection, which builds and loads the kernels on a checkout's first run."""


def read(run):
    return run.setup_s
