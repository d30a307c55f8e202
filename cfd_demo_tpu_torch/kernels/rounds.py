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
``cavity`` to make_jacobi_solve, ensemble_pallas.py:127, :141) both
forms take their CAVITY instance: the east neighbour of column nx-2
reads the cell itself, the p' BCs copy column nx-2 into column nx-1 and
pin (0, 0) to 0, and the velocity BCs are the lid's and the walls'. On the reference's 800x264
scene that is about a hundred sweeps per step, and each sweep needs a
barrier across the whole field and a global max.

What bounds it on the H100 is the barrier a sweep and the global max,
and on the cluster's SMs the sweep's instructions, not bytes: a field is
0.84 MB, so the whole working set (about 6 fields) sits in the 50 MB L2,
and a sweep is a few microseconds of work. The kernel has two forms,
chosen before the launch by kernels.cluster's plan, never by a failure,
with the same bits and counts:

- **The cluster form** (``rounds_cluster_kernel``): one thread-block
  cluster of C CTAs of 1024 threads keeps p' on chip, C and the slabs
  from csrc/cluster.cuh's ``slab_plan`` and kernels.cluster's pick on
  the card's admission (:func:`rounds_ctas`; the same plan as the
  batched kernels 12 and 20: 14 CTAs of 20 rows at 800x264, 14 of 10
  at the JS twin's 400x132). Each CTA owns a slab of rows, p'
  ping-ponged in its shared memory with two halo rows and ar * rhs
  there too; a thread keeps 4 columns of a strip of rows in registers,
  and a row of interior cells runs no test a cell (the folds at column
  0 and the outlet are invariants of the stored values). A sweep ends
  with the CTA's max (a warp reduction and one shared atomic) and
  ``st.async`` stores into the other CTAs' shared memory (its max to
  all, its edge rows to the slabs beside it) that complete a
  transaction count on the receiver's mbarrier: no cluster-wide barrier
  a sweep. u, v and p stay in device memory. It is bound by the sweep's
  instructions on C SMs and the max's round trip between them. If the
  card refuses a cluster that the pick chose, the call raises.
- **The cooperative form** (``rounds_kernel``) takes the grids the pick
  gives no cluster (1024x512, say): persistent
  and cooperative, one block of 1024 threads per SM, all resident,
  looping over the field, with a grid-wide barrier (``grid.sync``)
  between phases and a rotating three-slot ``atomicMax`` for each
  sweep's max, one barrier a sweep across 132 SMs. A single-block form
  (one SM doing all the work) measured 30x slower; PERF.md has both
  times.

In both, the exits are decided on the device with no host read.
``solve_correct_rounds.launches`` counts launches of either form,
``.cluster_launches`` those of the cluster form, ``.cavity_launches``
those of either form's CAVITY instance.

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
from .cluster import check_route, pick_ctas, route_ctas
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


def rounds_ctas(ny: int, nx: int, device, cavity: bool = False):
    """The CTAs of the cluster the rounds kernel takes for an (ny, nx)
    grid on ``device`` (kernels.cluster pick_ctas for one scene on the
    card's admission of the channel or, with ``cavity``, the CAVITY
    instance: 14 at 800x264 on an H100), or None where it takes no
    cluster: the cooperative form runs. Needs the card for a grid a
    cluster holds."""
    return pick_ctas("cfd_rounds_cluster_admit", 1, ny, nx, device, int(cavity))


@traced("cfd.kernel.solve_correct_rounds")
def solve_correct_rounds(u_star, v_star, p, pp0, rhs, dt_sub, inlet, scene,
                         form: str | None = None, ctas: int | None = None):
    """Fused solve + corrector + outer rounds + BCs for one scene.
    ``u_star`` (ny, nx+1); ``v_star``, ``p``, ``pp0`` (BC-consistent),
    ``rhs`` (ny, nx). Returns (u, v, p, p_prime, err, counts), where
    ``counts`` is an int32 (2,) tensor: outer rounds run, Jacobi sweeps
    run. ``form`` None takes the cluster form where :func:`rounds_ctas`
    picks a cluster and the cooperative form elsewhere; "cooperative" and
    "cluster" take that form (to hold the two against each other),
    "cluster" raising where it picks none. ``ctas`` forces the cluster's
    CTAs (one of kernels.cluster.CTAS that ``slab_plan`` splits the grid
    over)."""
    g, opts = scene.grid, scene.opts
    cavity = scene.params.flow_case == FlowCase.CAVITY
    ny, nx = g.ny, g.nx
    check_route("solve_correct_rounds", form, "cluster", "cooperative", ny, nx, ctas)
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
    c = route_ctas("solve_correct_rounds", form, "cooperative", 1, ny, nx, ctas,
                   "cfd_rounds_cluster_admit", p.device, int(cavity))
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
        if c is None:
            check(lib.cfd_rounds(*args, stream_of(p)), "solve_correct_rounds")
        else:
            check(lib.cfd_rounds_cluster(*args, c, stream_of(p)),
                  f"solve_correct_rounds (cluster form, {c} CTAs)")
    solve_correct_rounds.launches += 1
    solve_correct_rounds.cluster_launches += c is not None
    solve_correct_rounds.cavity_launches += cavity
    return u, v, p_out, pp, err, counts


solve_correct_rounds.launches = 0
solve_correct_rounds.cluster_launches = 0
solve_correct_rounds.cavity_launches = 0
