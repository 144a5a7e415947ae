"""detect_s: the window's seconds over the detections completed in it
(s), host clock; every detection ends in a synchronise."""


def read(run):
    done = run.untraced
    return run.window_s / len(done) if done else None
