"""outer_rounds_per_step: outer corrector rounds a step, the program's
own count (``cfd_demo_tpu_torch.trace.rounds``: the (outer rounds,
sweeps) count tensor of each single-scene substep of the rounds route,
kept on the device while a profiler records), summed over the traced
window after it closes, a step. None where the program has no such
counter, or where the window kept no count (a route without rounds).

The window's counts are taken out of the program's list when the window
closes and kept in the run's store (``ctx.store["rounds"]``), where
cavity_rounds_roofline reads them too."""

import importlib


def install(ctx):
    try:
        trace = importlib.import_module("cfd_demo_tpu_torch.trace")
    except ImportError:
        return lambda: None
    if not hasattr(trace, "rounds"):
        return lambda: None
    start = len(trace.rounds)

    def undo():
        if "rounds" not in ctx.store:  # another reader of the counts took them
            ctx.store["rounds"] = trace.rounds[start:]
            del trace.rounds[start:]

    return undo


def kept(ctx):
    """(outer rounds, sweeps) summed over the window's count tensors, or
    None where there were none."""
    counts = ctx.store.get("rounds")
    if not counts:
        return None
    import cfd_demo_tpu_torch.trace as trace

    return trace.rounds_total(counts), len(counts)


def read(ctx):
    got = kept(ctx)
    if got is None or not ctx.steps:
        return None
    (rounds, _), _ = got
    return rounds / ctx.steps
