"""jacobi_roofline: the step's fixed Jacobi solve (jacobi_tol 0:
exactly jacobi_iters sweeps) against its roofline.

The least time the solve needs is the larger of its bytes over the
memory rate (p' and rhs read once, p' written once: 12 bytes a cell)
and its float32 operations over the float32 peak (9 a cell a damped
sweep, and the last sweep's largest change, which the step reports as
its residual, 3 a cell). The work is counted from the algorithm and
the shapes, whatever implements it; the time is the device time of the
operations launched inside the step's ``_solve_pressure``, which the
traced run marks with a profiler range."""

from benchmark_torch import peaks

_TARGET = "_solve_pressure"
RANGE = "bench.pressure_solve"
SWEEP, SWEEP_ERR = 9, 3


def install(ctx):
    from cfd_demo_tpu_torch.solver import piso
    import torch

    inner = getattr(piso, _TARGET, None)
    if inner is None:
        return lambda: None

    def marked(*args, **kwargs):
        with torch.profiler.record_function(RANGE):
            return inner(*args, **kwargs)

    setattr(piso, _TARGET, marked)
    return lambda: setattr(piso, _TARGET, inner)


def read(ctx):
    opts = ctx.traffic["solver"]["options"]
    if (ctx.traffic["solver"]["pressure_solver"] != "jacobi" or opts["jacobi_tol"] != 0
            or ctx.traffic.get("batch")):
        return None
    device_s = ctx.device_s_in(RANGE)
    g = ctx.config["grid"]
    cells = g["nx"] * g["ny"]
    flops = ctx.steps * (opts["jacobi_iters"] * SWEEP + SWEEP_ERR) * cells
    return peaks.roofline_share(ctx.steps * 12 * cells, flops, device_s)
