"""sor_iters_per_step: red/black SOR iterations a step, the program's own
count (``cfd_demo_tpu_torch.trace.sor_iterations``: the iterations the
two SOR kernel chains ran, a host int they add to with no device read),
its change over the traced window a step. None where the program has no
such counter, or where the window ran no SOR chain (another solver, or
the plain ``sor``, which counts on the device and is not counted)."""

import importlib


def install(ctx):
    try:
        trace = importlib.import_module("cfd_demo_tpu_torch.trace")
    except ImportError:
        return lambda: None
    if not hasattr(trace, "sor_iterations"):
        return lambda: None
    start = trace.sor_iterations

    def undo():
        ctx.store["sor_iterations"] = trace.sor_iterations - start

    return undo


def read(ctx):
    n = ctx.store.get("sor_iterations")
    return n / ctx.steps if n and ctx.steps else None
