"""chain_tol_roofline: the step's Jacobi solves under a tolerance (the
solve and every outer round's) against their roofline, for the sweeps
they ran.

The least time the solves need is the larger of their bytes over the
memory rate and their float32 operations over the float32 peak, with
jacobi_roofline's constants: p' and rhs read once and p' written once,
12 bytes a cell a solve; 9 operations a cell a damped sweep, and 3 a
cell for each largest change the exit rule tests (a subtraction, an
absolute value, a maximum). The exit rule is the configuration's: the
change is tested after each whole chunk of k sweeps (the traffic's
pallas_fuse_k, 0 meaning 16), and the ``jacobi_iters % k`` remainder's
change, the solve's error, once more. The sweeps are the program's own
count (``trace.chain_sweeps``, as chain_sweeps_per_step reads it), the
solves one a step and one an outer round (``trace.outer_rounds``, as
fused_rounds_per_step reads it; the configuration's one Rust substep).
The work is counted from the algorithm and the counts, whatever
implements it: a device-side exit or another launch shape reads the
same work in its own time. The time is the device time of the
operations launched inside the program's ``cfd.solve`` spans (the
launches, the exits' comparisons and copies). None for another solver,
no live tolerance or a batch, where the program keeps either count, or
where the window launched nothing inside that span."""

from benchmark_torch import manifest, peaks

SPAN = "cfd.solve"
_sweeps = manifest.reader("chain_sweeps_per_step")
_rounds = manifest.reader("fused_rounds_per_step")
_constants = manifest.reader("jacobi_roofline")
BYTES_A_CELL = 12
DEFAULT_K = 16


def install(ctx):
    undo = [_sweeps.install(ctx), _rounds.install(ctx)]
    return lambda: [u() for u in reversed(undo)]


def tests(sweeps: int, solves: int, iters: int, k: int) -> int:
    """The largest changes tested over ``solves`` solves that ran
    ``sweeps`` sweeps in all: one a whole chunk run, and one for each
    solve's remainder."""
    rem = iters % k
    return (sweeps - solves * rem) // k + (solves if rem else 0)


def work(sweeps: int, solves: int, iters: int, k: int, nx: int, ny: int):
    """(bytes, float32 operations) of ``solves`` chunked-exit solves that
    ran ``sweeps`` sweeps in all on an (ny, nx) grid."""
    c, cells = _constants, nx * ny
    flops = (sweeps * c.SWEEP + tests(sweeps, solves, iters, k) * c.SWEEP_ERR) * cells
    return solves * BYTES_A_CELL * cells, flops


def read(ctx):
    opts = ctx.traffic["solver"]["options"]
    if (ctx.traffic["solver"]["pressure_solver"] != "jacobi" or opts["jacobi_tol"] == 0
            or ctx.traffic.get("batch")):
        return None
    sweeps, rounds = ctx.store.get("chain_sweeps"), ctx.store.get("outer_rounds")
    if not sweeps or rounds is None or not ctx.steps:
        return None
    g = ctx.config["grid"]
    k = opts.get("pallas_fuse_k") or DEFAULT_K
    bytes_moved, flops = work(sweeps, ctx.steps + rounds, opts["jacobi_iters"], k,
                              g["nx"], g["ny"])
    return peaks.roofline_share(bytes_moved, flops, ctx.device_s_in(SPAN))
