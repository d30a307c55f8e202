"""fused_rounds_per_step: outer corrector rounds a step in the host-read
round loops, the program's own count
(``cfd_demo_tpu_torch.trace.outer_rounds``: the rounds ``solver/piso.py``
``_outer_rounds``' early-exit branch and the fused route's
``rounds_impl="pallas"`` loop ran, host ints they keep, added with no
device read), its change over the traced window a step; 0 where the
loops ran no round. None where the program has no such counter. The
rounds kernel's rounds are outer_rounds_per_step's."""

import importlib


def install(ctx):
    try:
        trace = importlib.import_module("cfd_demo_tpu_torch.trace")
    except ImportError:
        return lambda: None
    if not hasattr(trace, "outer_rounds"):
        return lambda: None
    start = trace.outer_rounds

    def undo():
        ctx.store["outer_rounds"] = trace.outer_rounds - start

    return undo


def read(ctx):
    n = ctx.store.get("outer_rounds")
    return n / ctx.steps if n is not None and ctx.steps else None
