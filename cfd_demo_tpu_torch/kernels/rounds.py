"""The whole projection of one scene in one CUDA launch
(↔ cfd_demo_tpu/kernels/rounds_pallas.py with ensemble_pallas.make_jacobi_solve).

``solve_correct_rounds`` replaces ``solve_correct_rounds_pallas``
(rounds_pallas.py:132, body ``_kernel_rounds`` :59, in-kernel solver
``make_jacobi_solve`` ensemble_pallas.py:69), csrc/rounds.cu. After the
predictor, a Rust substep runs a do-while Jacobi that exits at the exact
sweep its error drops below tol, the corrector, then up to 20 outer
rounds of divergence, warm-started Jacobi and corrector, each exiting
exactly, then the BCs (model.rs:696-724). A JS substep (the JS twin's
400x132 scene) has no outer rounds and arrives with a zero warm start;
its BC masks and a parabolic inlet come in as the correct_bc kernel's
do (kernels/substep.py). In CAVITY flow (rounds_pallas.py:64 hands
``cavity`` to make_jacobi_solve, ensemble_pallas.py:127, :141) every
form takes its CAVITY instance: the east neighbour of column nx-2
reads the cell itself, the p' BCs copy column nx-2 into column nx-1 and
pin (0, 0) to 0, and the velocity BCs are the lid's and the walls'. On the reference's 800x264
scene that is about a hundred sweeps per step, and each sweep needs a
barrier across the whole field and a global max.

What bounds it on the H100 is the barrier a sweep and the global max,
and the sweep's own work. The kernel has three forms, with the same bits
and counts; kernels.cluster ``plan`` chooses one before each launch
(never after a failure). The cluster form (``rounds_cluster_kernel``)
keeps p' in the shared memory of one thread-block cluster of C CTAs
(csrc/cluster.cuh's slabs, a thread's 4-column strip of rows in
registers, each sweep's max and edge rows pushed by ``st.async`` onto
the receivers' mbarriers: 14 CTAs at 800x264); the slab form
(``rounds_slab_kernel``) lays the same slabs over the whole card, one
block of 1024 threads an SM (128 blocks of 8 rows at 1024²), with no
grid barrier a sweep: the edge rows go through device memory, each
block waiting only on its neighbours' flags, and the max through a
rotating slot read one sweep late, the sweep run meanwhile dropped
where the solve had ended; the cooperative form (``rounds_kernel``)
takes the rest (more than 1024 columns, or more rows than 6-row strips
cover on the card), sweeping p' from L2 with a grid-wide barrier and a
rotating three-slot ``atomicMax`` a sweep. PERF.md has their times, and
a single-block form's, 30x slower.

In every form the exits are decided on the device with no host read.
``solve_correct_rounds.launches`` counts launches of any form,
``.cluster_launches`` and ``.slab_launches`` those of the cluster and
slab forms, ``.cavity_launches`` those of a CAVITY instance. While a
profiler records, ``trace.dropped`` keeps each slab launch's count of
dropped speculative sweeps (an int32 (1,) tensor the kernel writes: one
for each solve that met its tolerance before ``jacobi_iters`` sweeps).

Both versions also return how many outer rounds and Jacobi sweeps ran,
so a check can hold the kernel's exits against the plain version's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.masks import masks_traced
from ..core.config import FlowCase
from ..ops.bc import apply_bcs
from ..ops.corrector import correct
from ..ops.divergence import divergence_rhs
from ..ops.poisson import jacobi, pprime_bc_fn
from .. import trace
from ..trace import traced
from ._build import check, device_scalars, load, mask_ptrs, on_cpu, stream_of
from .cluster import plan
from .jacobi import _multipliers
from .substep import inlet_args


def solve_correct_rounds_plain(u_star, v_star, p, pp0, rhs, dt_sub, inlet,
                               scene):
    """ops.poisson.jacobi (exact exit) + correct + outer rounds +
    apply_bcs, as tests/test_ensemble_pallas.py builds the reference.
    The exits read the error on the host; the p' BCs are the scene's
    flow case's."""
    g, opts = scene.grid, scene.opts
    bc = pprime_bc_fn(scene.params.flow_case)
    sweeps = 0

    def solve(pp, rhs_):
        nonlocal sweeps
        pp, err, n = jacobi(pp, rhs_, g.dx, g.dy, opts.jacobi_omega,
                            opts.jacobi_tol, opts.jacobi_iters, bc=bc)
        sweeps += n
        return pp, err

    pp, err = solve(pp0, rhs)
    u, v, p = correct(u_star, v_star, p, pp, dt_sub, g.dx, g.dy)
    it = 0
    while (it < opts.outer_corrector_rounds
           and trace.read_host(err >= opts.outer_corrector_tol)):
        pp, err = solve(pp, divergence_rhs(u, v, dt_sub, g.dx, g.dy))
        u, v, p = correct(u, v, p, pp, dt_sub, g.dx, g.dy)
        it += 1
    _, _, mask_u_bc, mask_v_bc = masks_traced(g, opts.semantics, u.device)
    u, v = apply_bcs(u, v, g, scene.params.inlet_profile, inlet, mask_u_bc,
                     mask_v_bc, scene.params.flow_case)
    counts = torch.tensor([it, sweeps], dtype=torch.int32, device=u.device)
    return u, v, p, pp, err, counts


@traced("cfd.kernel.solve_correct_rounds")
def solve_correct_rounds(u_star, v_star, p, pp0, rhs, dt_sub, inlet, scene,
                         form: str | None = None, ctas: int | None = None):
    """Fused solve + corrector + outer rounds + BCs for one scene.
    ``u_star`` (ny, nx+1); ``v_star``, ``p``, ``pp0`` (BC-consistent),
    ``rhs`` (ny, nx). Returns (u, v, p, p_prime, err, counts), where
    ``counts`` is an int32 (2,) tensor: outer rounds run, Jacobi sweeps
    run. ``form`` ("cluster", "slab" or "cooperative") and ``ctas``
    override kernels.cluster ``plan``'s choice of form, to hold the forms
    against each other."""
    g, opts = scene.grid, scene.opts
    cavity = scene.params.flow_case == FlowCase.CAVITY
    ny, nx = g.ny, g.nx
    route = plan("rounds", 1, ny, nx, p.device, cavity=cavity, form=form, ctas=ctas)
    shapes = {"u_star": (u_star, (ny, nx + 1)), "v_star": (v_star, (ny, nx)),
              "p": (p, (ny, nx)), "pp0": (pp0, (ny, nx)), "rhs": (rhs, (ny, nx))}
    if on_cpu("solve_correct_rounds", shapes):
        return solve_correct_rounds_plain(u_star, v_star, p, pp0, rhs, dt_sub,
                                          inlet, scene)
    lib = load()
    u, v = torch.empty_like(u_star), torch.empty_like(v_star)
    p_out, pp, pp_tmp, rhs_w = (torch.empty_like(p) for _ in range(4))
    slots = torch.empty(3, dtype=torch.float32, device=p.device)
    err = torch.empty((), dtype=torch.float32, device=p.device)
    counts = torch.empty(2, dtype=torch.int32, device=p.device)
    scal = device_scalars(p.device, dt_sub, inlet)
    _, _, mask_u_bc, mask_v_bc = mask_ptrs(g, opts.semantics, p.device)
    f32 = lambda x: float(np.float32(x))
    args = (u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(), pp0.data_ptr(),
            rhs.data_ptr(), scal.data_ptr(), u.data_ptr(), v.data_ptr(),
            p_out.data_ptr(), pp.data_ptr(), pp_tmp.data_ptr(),
            rhs_w.data_ptr(), slots.data_ptr(), err.data_ptr(),
            counts.data_ptr(), mask_u_bc, mask_v_bc, ny, nx, f32(g.dx),
            f32(g.dy), *_multipliers(g.dx, g.dy, opts.jacobi_omega),
            opts.jacobi_iters, opts.jacobi_tol, opts.outer_corrector_rounds,
            opts.outer_corrector_tol,
            *inlet_args(g, scene.params.inlet_profile, scene.params.flow_case), int(cavity))
    with torch.cuda.device(p.device):
        if route.form == "cluster":
            check(lib.cfd_rounds_cluster(*args, route.ctas, stream_of(p)),
                  f"solve_correct_rounds (cluster form, {route.ctas} CTAs)")
        elif route.form == "slab":
            # each block's bottom and top rows, by sweep parity; the max
            # slots and each block's two edge flags, a 128-byte line each;
            # the speculative sweeps the kernel dropped
            halo = torch.empty(4 * route.slab[2] * 4 * -(-nx // 4), dtype=torch.float32,
                               device=p.device)
            sync = torch.empty(32 * (3 + 2 * route.slab[2]), dtype=torch.int32,
                               device=p.device)
            dropped = torch.empty(1, dtype=torch.int32, device=p.device)
            check(lib.cfd_rounds_slab(*args, route.sms, halo.data_ptr(), halo.numel(),
                                      sync.data_ptr(), sync.numel(), dropped.data_ptr(),
                                      stream_of(p)),
                  f"solve_correct_rounds (slab form, {route.slab[2]} blocks)")
            trace.keep_dropped(dropped)
        else:
            check(lib.cfd_rounds(*args, stream_of(p)), "solve_correct_rounds")
    solve_correct_rounds.launches += 1
    solve_correct_rounds.cluster_launches += route.form == "cluster"
    solve_correct_rounds.slab_launches += route.form == "slab"
    solve_correct_rounds.cavity_launches += cavity
    return u, v, p_out, pp, err, counts


solve_correct_rounds.launches = 0
solve_correct_rounds.cluster_launches = 0
solve_correct_rounds.slab_launches = 0
solve_correct_rounds.cavity_launches = 0
