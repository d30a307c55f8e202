"""chain_sweeps_per_step: Jacobi sweeps a step on the kernel chain, the
program's own count (``cfd_demo_tpu_torch.trace.chain_sweeps``: the
sweeps ``kernels/jacobi.py`` ``jacobi_chain`` ran, a host int it adds to
with no device read), its change over the traced window a step. None
where the program has no such counter, or where the window ran no chain
(another solver or route)."""

import importlib


def install(ctx):
    try:
        trace = importlib.import_module("cfd_demo_tpu_torch.trace")
    except ImportError:
        return lambda: None
    if not hasattr(trace, "chain_sweeps"):
        return lambda: None
    start = trace.chain_sweeps

    def undo():
        ctx.store["chain_sweeps"] = trace.chain_sweeps - start

    return undo


def read(ctx):
    n = ctx.store.get("chain_sweeps")
    return n / ctx.steps if n and ctx.steps else None
