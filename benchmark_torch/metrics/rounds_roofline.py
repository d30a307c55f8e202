"""rounds_roofline: the rounds kernel (kernel 4: a Rust substep's
whole projection in one launch) against its roofline, for the rounds
and sweeps the state needs.

As chip_smoke.py's bound counts it: bytes are u*, v*, p, p' and rhs
read once and u, v, p and p' written once; float32 operations are 12 a
cell a sweep (the damped sweep 9, its largest change 3) and 15 a cell a
round (the divergence 6, the corrector 9; the first corrector counts as
a round). The rounds and sweeps are the kernel's own returned counts,
kept on the device during the window; the time is the device time of
the operations launched inside the step's ``solve_correct_rounds``
calls, which the traced run marks with a profiler range."""

from benchmark_torch import peaks

_TARGET = "solve_correct_rounds"
RANGE = "bench.rounds"
SWEEP, SWEEP_ERR, ROUND = 9, 3, 15


def install(ctx):
    from cfd_demo_tpu_torch.solver import piso
    import torch

    inner = getattr(piso, _TARGET, None)
    if inner is None:
        return lambda: None
    kept = ctx.store.setdefault("rounds_counts", [])

    def marked(*args, **kwargs):
        with torch.profiler.record_function(RANGE):
            out = inner(*args, **kwargs)
        kept.append(out[-1])
        return out

    setattr(piso, _TARGET, marked)
    return lambda: setattr(piso, _TARGET, inner)


def read(ctx):
    counts = ctx.store.get("rounds_counts")
    if not counts:
        return None
    g = ctx.config["grid"]
    nx, ny = g["nx"], g["ny"]
    flops = 0.0
    for c in counts:
        rounds, sweeps = (int(x) for x in c.tolist())
        flops += (sweeps * (SWEEP + SWEEP_ERR) + (rounds + 1) * ROUND) * nx * ny
    bytes_moved = len(counts) * 4 * (2 * ny * (nx + 1) + 7 * ny * nx)
    return peaks.roofline_share(bytes_moved, flops, ctx.device_s_in(RANGE))
