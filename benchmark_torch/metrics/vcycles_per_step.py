"""vcycles_per_step: multigrid V-cycles a step, the program's own count
(``cfd_demo_tpu_torch.trace.vcycles``: every cycle MG_PRODUCTION runs,
in either form, a cycle that is FDM alone on a small interior among
them, and every cycle of the vertex MULTIGRID), its change over the
traced window a step. None where the program has no such counter, or where
the window ran no cycle (a cell without multigrid)."""

import importlib


def install(ctx):
    try:
        trace = importlib.import_module("cfd_demo_tpu_torch.trace")
    except ImportError:
        return lambda: None
    if not hasattr(trace, "vcycles"):
        return lambda: None
    start = trace.vcycles

    def undo():
        ctx.store["vcycles"] = trace.vcycles - start

    return undo


def read(ctx):
    n = ctx.store.get("vcycles")
    return n / ctx.steps if n and ctx.steps else None
