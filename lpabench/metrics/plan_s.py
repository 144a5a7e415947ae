"""plan_s: ``build_workspace`` (the plan bundle and the edge sources) on
the host clock, ending in a synchronise (s)."""


def read(run):
    return run.plan_s
