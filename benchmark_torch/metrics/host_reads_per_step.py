"""host_reads_per_step: the program's own count of its reads of device
values back to the host (``cfd_demo_tpu_torch.trace.host_reads``: the
tolerance exits, the substep count), its change over the traced window
a step. Each read waits for the device; dtoh_copies_per_step sees the
same reads from the trace. None where the program has no such counter."""

import importlib


def install(ctx):
    try:
        trace = importlib.import_module("cfd_demo_tpu_torch.trace")
    except ImportError:
        return lambda: None
    if not hasattr(trace, "host_reads"):
        return lambda: None
    start = trace.host_reads

    def undo():
        ctx.store["host_reads"] = trace.host_reads - start

    return undo


def read(ctx):
    n = ctx.store.get("host_reads")
    return n / ctx.steps if n is not None and ctx.steps else None
