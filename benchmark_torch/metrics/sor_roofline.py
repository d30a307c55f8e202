"""sor_roofline: the step's fixed red/black SOR solve (jacobi_tol 0:
exactly jacobi_iters iterations, no outer round) against its roofline.

The least time the solve needs is the larger of its bytes over the
memory rate and its float32 operations over the float32 peak. Bytes: p'
and rhs read once, p' written once, 12 a cell. Operations, counted from
the update (1 - omega) c + omega ((E + W) / dx^2 + (N + S) / dy^2 - rhs)
/ (2 / dx^2 + 2 / dy^2) with its constants taken once: two neighbour
sums, their two scalings, their sum, the rhs subtracted, the division
by the diagonal, the scaling by omega, (1 - omega) c and the final sum,
10 a cell an iteration; and the last iteration's largest change, which
the step reports as its residual (a subtraction, an absolute value, a
maximum), 3 a cell. The work is counted from the algorithm and the
shapes, whatever implements it: a form that drops the colour split, the
join or the clones reads the same work in less time. The time is the
device time of the operations launched inside the program's
``cfd.solve`` span. None for another solver, a live tolerance, outer
rounds or a batch, and where the window launched nothing inside that
span."""

from benchmark_torch import peaks

SPAN = "cfd.solve"
ITERATION, LAST_CHANGE = 10, 3
BYTES_A_CELL = 12


def work(solves: int, iters: int, nx: int, ny: int):
    """(bytes, float32 operations) of ``solves`` fixed solves of
    ``iters`` iterations on an (ny, nx) grid."""
    cells = nx * ny
    return solves * BYTES_A_CELL * cells, solves * (iters * ITERATION + LAST_CHANGE) * cells


def read(ctx):
    opts = ctx.traffic["solver"]["options"]
    if (ctx.traffic["solver"]["pressure_solver"] != "sor" or opts["jacobi_tol"] != 0
            or opts["outer_corrector_rounds"] or ctx.traffic.get("batch")):
        return None
    g = ctx.config["grid"]
    bytes_moved, flops = work(ctx.steps, opts["jacobi_iters"], g["nx"], g["ny"])
    return peaks.roofline_share(bytes_moved, flops, ctx.device_s_in(SPAN))
