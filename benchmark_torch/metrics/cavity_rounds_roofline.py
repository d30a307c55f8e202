"""cavity_rounds_roofline: the rounds kernel (kernel 4: a Rust
substep's whole projection in one launch) against its roofline on the
cavity's cells, for the rounds and sweeps the state needs.

The work is the program's own count of what its solves ran
(``cfd_demo_tpu_torch.trace.rounds``, as outer_rounds_per_step reads
it), counted with rounds_roofline's constants a cell: 12 float32
operations a sweep (the damped sweep 9, its largest change 3) and 15 a
round (the divergence 6, the corrector 9; each solve's first corrector
counts as a round). The bytes are the real fields read once and written
once a solve: u* and u (ny, nx + 1), v*, p, p' and rhs read, v, p and p'
written (ny, nx), float32. The time is the device time of the
operations launched inside the program's ``cfd.kernel.solve_correct_rounds``
span. The count is of the work, not of the kernel's form: a later form
reads the same work. None where the program keeps no such count or the
window launched nothing inside that span."""

from benchmark_torch import manifest, peaks

SPAN = "cfd.kernel.solve_correct_rounds"
_counts = manifest.reader("outer_rounds_per_step")
_constants = manifest.reader("rounds_roofline")
install = _counts.install


def work(rounds: int, sweeps: int, solves: int, nx: int, ny: int):
    """(bytes, float32 operations) of ``solves`` rounds-route solves that
    ran ``rounds`` outer rounds and ``sweeps`` sweeps in all."""
    c = _constants
    flops = (sweeps * (c.SWEEP + c.SWEEP_ERR) + (rounds + solves) * c.ROUND) * nx * ny
    bytes_moved = solves * 4 * (2 * ny * (nx + 1) + 7 * ny * nx)
    return bytes_moved, flops


def read(ctx):
    got = _counts.kept(ctx)
    if got is None:
        return None
    (rounds, sweeps), solves = got
    g = ctx.config["grid"]
    bytes_moved, flops = work(rounds, sweeps, solves, g["nx"], g["ny"])
    return peaks.roofline_share(bytes_moved, flops, ctx.device_s_in(SPAN))
