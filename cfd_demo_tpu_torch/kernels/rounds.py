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
and the sweep's own work: where p' stays on chip, the sweep's
instructions; where it is swept from L2, L2's bandwidth (a 1024² field
is 4 MB, read six times a sweep). The kernel has three forms, chosen
before the launch by shape (:func:`rounds_form`), never by a failure,
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
- **The slab form** (``rounds_slab_kernel``) takes the grids no cluster
  holds up to 1024 columns (1024², 1024x512): the cluster form's slabs,
  strips, folds and arithmetic spread over the whole card, a
  cooperative launch of one block of 1024 threads an SM
  (kernels.cluster ``grid_slab_plan`` on the card's SM count, read once:
  128 blocks of 8 rows at 1024² on an H100; :func:`rounds_slab_plan`).
  A sweep's edge rows go through device memory to the slabs beside it
  and its max through a rotating slot, across one grid-wide barrier;
  the p' BCs also run on each slab's halo rows, so a solve needs no
  other exchange. It is bound by that barrier and slot, a fixed cost a
  sweep, then the strip's rows.
- **The cooperative form** (``rounds_kernel``) takes the rest (more
  than 1024 columns, or more rows than 6-row strips cover on the card):
  persistent and cooperative, one block of 1024 threads per SM, all
  resident, looping over the field from L2, with a grid-wide barrier
  (``grid.sync``) between phases and a rotating three-slot
  ``atomicMax`` for each sweep's max, one barrier a sweep across 132
  SMs. A single-block form (one SM doing all the work) measured 30x
  slower; PERF.md has both times.

In every form the exits are decided on the device with no host read.
``solve_correct_rounds.launches`` counts launches of any form,
``.cluster_launches`` and ``.slab_launches`` those of the cluster and
slab forms, ``.cavity_launches`` those of a CAVITY instance.

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
from .cluster import check_route, grid_slab_plan, pick_ctas, route_ctas, sm_count
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
    cluster: the slab or the cooperative form runs (:func:`rounds_form`).
    Needs the card for a grid a cluster holds."""
    return pick_ctas("cfd_rounds_cluster_admit", 1, ny, nx, device, int(cavity))


def rounds_slab_plan(ny: int, nx: int, device):
    """The slab form's plan for an (ny, nx) grid on ``device``'s card
    (kernels.cluster grid_slab_plan at the card's SM count: 128 blocks of
    8 rows at 1024² on an H100), or None where the form cannot take it.
    Needs the card."""
    return grid_slab_plan(ny, nx, sm_count(device))


def rounds_form(ny: int, nx: int, ctas, sms: int) -> str:
    """The form the route gives an (ny, nx) grid, on shapes alone:
    "cluster" where the pick found ``ctas`` (:func:`rounds_ctas`), else
    "slab" where kernels.cluster grid_slab_plan takes the grid on ``sms``
    SMs, else "cooperative" (more than 1024 columns, or more rows than
    6-row strips cover on the card)."""
    if ctas is not None:
        return "cluster"
    return "slab" if grid_slab_plan(ny, nx, sms) is not None else "cooperative"


FORMS = (None, "cluster", "slab", "cooperative")


@traced("cfd.kernel.solve_correct_rounds")
def solve_correct_rounds(u_star, v_star, p, pp0, rhs, dt_sub, inlet, scene,
                         form: str | None = None, ctas: int | None = None):
    """Fused solve + corrector + outer rounds + BCs for one scene.
    ``u_star`` (ny, nx+1); ``v_star``, ``p``, ``pp0`` (BC-consistent),
    ``rhs`` (ny, nx). Returns (u, v, p, p_prime, err, counts), where
    ``counts`` is an int32 (2,) tensor: outer rounds run, Jacobi sweeps
    run. ``form`` None takes the cluster form where :func:`rounds_ctas`
    picks a cluster, else the slab form where :func:`rounds_slab_plan`
    fits the card, else the cooperative form; "cluster", "slab" and
    "cooperative" take that form (to hold them against each other), the
    first two raising where they cannot take the grid. ``ctas`` forces
    the cluster's CTAs (one of kernels.cluster.CTAS that ``slab_plan``
    splits the grid over)."""
    g, opts = scene.grid, scene.opts
    cavity = scene.params.flow_case == FlowCase.CAVITY
    ny, nx = g.ny, g.nx
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    slab = form == "slab"
    if slab and (ctas is not None or grid_slab_plan(ny, nx, ny) is None):
        raise ValueError(f"solve_correct_rounds: the slab form cannot take a {ny}x{nx} "
                         f"grid{' with ctas' if ctas is not None else ''} "
                         f"(kernels.cluster.grid_slab_plan)")
    if not slab:
        check_route("solve_correct_rounds", form, "cluster", "cooperative", ny, nx, ctas)
    shapes = {"u_star": (u_star, (ny, nx + 1)), "v_star": (v_star, (ny, nx)),
              "p": (p, (ny, nx)), "pp0": (pp0, (ny, nx)), "rhs": (rhs, (ny, nx))}
    if on_cpu("solve_correct_rounds", shapes):
        return solve_correct_rounds_plain(u_star, v_star, p, pp0, rhs, dt_sub,
                                          inlet, scene)
    c = None if slab else route_ctas("solve_correct_rounds", form, "cooperative", 1, ny, nx,
                                     ctas, "cfd_rounds_cluster_admit", p.device, int(cavity))
    if form is None:
        form = rounds_form(ny, nx, c, sm_count(p.device))
    plan = rounds_slab_plan(ny, nx, p.device) if form == "slab" else None
    if form == "slab" and plan is None:
        raise ValueError(f"solve_correct_rounds: the slab form cannot take a {ny}x{nx} grid "
                         f"on {sm_count(p.device)} SMs (kernels.cluster.grid_slab_plan)")
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
        if form == "cluster":
            check(lib.cfd_rounds_cluster(*args, c, stream_of(p)),
                  f"solve_correct_rounds (cluster form, {c} CTAs)")
        elif form == "slab":
            # each block's bottom and top rows, by sweep parity
            halo = torch.empty(4 * plan[2] * 4 * -(-nx // 4), dtype=torch.float32,
                               device=p.device)
            check(lib.cfd_rounds_slab(*args, sm_count(p.device), halo.data_ptr(),
                                      halo.numel(), stream_of(p)),
                  f"solve_correct_rounds (slab form, {plan[2]} blocks)")
        else:
            check(lib.cfd_rounds(*args, stream_of(p)), "solve_correct_rounds")
    solve_correct_rounds.launches += 1
    solve_correct_rounds.cluster_launches += form == "cluster"
    solve_correct_rounds.slab_launches += form == "slab"
    solve_correct_rounds.cavity_launches += cavity
    return u, v, p_out, pp, err, counts


solve_correct_rounds.launches = 0
solve_correct_rounds.cluster_launches = 0
solve_correct_rounds.slab_launches = 0
solve_correct_rounds.cavity_launches = 0
