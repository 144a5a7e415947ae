"""plan_gb: the bytes of the fold plans the program's workspace holds on
the device (GB, 1e9 bytes), read from the program's counter
``repro_torch.trace.PLAN_BYTES`` (each plan of the newest bundle, by
kind), summed. None where the program keeps no such counter."""


def read(run):
    from repro_torch import trace
    plans = getattr(trace, "PLAN_BYTES", None)
    if not plans:
        return None
    return sum(plans.values()) / 1e9
