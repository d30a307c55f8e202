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
do (kernels/substep.py). On the reference's 800x264
scene that is about a hundred sweeps per step, and each sweep needs a
barrier across the whole field and a global max.

What bounds it on the H100 is the barrier a sweep and the global max,
and on the cluster's 16 SMs the sweep's instructions, not bytes: a field is 0.84 MB,
so the whole working set (about 6 fields) sits in the 50 MB L2, and a
sweep is a few microseconds of work. The kernel has two forms, chosen by
the grid's shape alone (``rounds_cluster_fits``), never by a failure,
with the same bits and counts:

- **The cluster form** (``rounds_cluster_kernel``): one thread-block
  cluster of 16 CTAs of 1024 threads (8 where
  ``cudaOccupancyMaxActiveClusters`` admits no 16) keeps p' on chip. Each
  CTA owns a slab of rows, p' ping-ponged in its shared memory with two
  halo rows and, at C = 16, ar * rhs there too (C = 8: rhs from L2); a
  thread keeps 4 columns of a strip of rows in registers, and a row of
  interior cells runs no test a cell (the folds at column 0 and the
  outlet are invariants of the stored values). A sweep ends with the
  CTA's max (a warp reduction and one shared atomic) and ``st.async``
  stores into the other CTAs' shared memory (its max to all, its edge
  rows to the slabs beside it) that complete a transaction count on the
  receiver's mbarrier: no cluster-wide barrier a sweep. u, v and p stay
  in device memory. It is bound by the sweep's instructions on 16 SMs
  and the max's round trip between them, and it takes every grid that
  ``cluster_plan`` (the C side's) can split over 16 CTAs within their
  shared memory: the 800x264 default scene and the 400x132 JS scene
  among them. If the card refuses a cluster that the rule admits, the
  call raises.
- **The cooperative form** (``rounds_kernel``) takes the rest: persistent
  and cooperative, one block of 1024 threads per SM, all resident,
  looping over the field, with a grid-wide barrier (``grid.sync``)
  between phases and a rotating three-slot ``atomicMax`` for each
  sweep's max, one barrier a sweep across 132 SMs. A single-block form
  (one SM doing all the work) measured 30x slower; PERF.md has both
  times.

In both, the exits are decided on the device with no host read.
``solve_correct_rounds.launches`` counts launches of either form,
``.cluster_launches`` those of the cluster form.

Both versions also return how many outer rounds and Jacobi sweeps ran,
so a check can hold the kernel's exits against the plain version's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.masks import masks_traced
from ..ops.bc import apply_bcs, check_channel
from ..ops.corrector import correct
from ..ops.divergence import divergence_rhs
from ..ops.poisson import jacobi
from ._build import check, device_scalars, load, mask_ptrs, on_cpu, stream_of
from .jacobi import _multipliers
from .substep import inlet_args


def solve_correct_rounds_plain(u_star, v_star, p, pp0, rhs, dt_sub, inlet,
                               scene):
    """ops.poisson.jacobi (exact exit) + correct + outer rounds +
    apply_bcs, as tests/test_ensemble_pallas.py builds the reference.
    The exits read the error on the host."""
    g, opts = scene.grid, scene.opts
    sweeps = 0

    def solve(pp, rhs_):
        nonlocal sweeps
        pp, err, n = jacobi(pp, rhs_, g.dx, g.dy, opts.jacobi_omega,
                            opts.jacobi_tol, opts.jacobi_iters)
        sweeps += n
        return pp, err

    pp, err = solve(pp0, rhs)
    u, v, p = correct(u_star, v_star, p, pp, dt_sub, g.dx, g.dy)
    it = 0
    while it < opts.outer_corrector_rounds and bool(err >= opts.outer_corrector_tol):
        pp, err = solve(pp, divergence_rhs(u, v, dt_sub, g.dx, g.dy))
        u, v, p = correct(u, v, p, pp, dt_sub, g.dx, g.dy)
        it += 1
    _, _, mask_u_bc, mask_v_bc = masks_traced(g, opts.semantics, u.device)
    u, v = apply_bcs(u, v, g, scene.params.inlet_profile, inlet, mask_u_bc,
                     mask_v_bc, scene.params.flow_case)
    counts = torch.tensor([it, sweeps], dtype=torch.int32, device=u.device)
    return u, v, p, pp, err, counts


# The cluster form's split (csrc/rounds.cu cluster_plan): 1024 threads a
# CTA, a thread holding 4 columns of RT rows (RT the first of STRIP_ROWS
# that covers the slab), at most 1024 columns (four row groups or more),
# and the slab's buffers within SMEM_BYTES of shared memory.
CLUSTER_THREADS, CLUSTER_COLS, STRIP_ROWS, SMEM_BYTES = 1024, 1024, (1, 2, 3, 4, 6), 231424


def cluster_plan(ny: int, nx: int, ctas: int = 16):
    """(rows a thread, rows a slab) of the cluster form at ``ctas`` CTAs,
    or None where it cannot take the grid."""
    if nx > CLUSTER_COLS:
        return None
    n4 = -(-nx // 4)
    groups = CLUSTER_THREADS // n4
    need = -(-(-(-ny // ctas)) // groups)
    rt = next((r for r in STRIP_ROWS if r >= need), None)
    if rt is None:
        return None
    rp = groups * rt
    bufs = 2 * (rp + 2) + (rp if ctas == 16 else 0)  # p' twice (with halo rows), ar*rhs
    if (bufs * 4 * n4 + 2 * 16) * 4 > SMEM_BYTES:
        return None
    return rt, rp


def rounds_cluster_fits(ny: int, nx: int) -> bool:
    """True when the rounds kernel takes its cluster form for an (ny, nx)
    grid: the form can split it over 16 CTAs."""
    return cluster_plan(ny, nx) is not None


def solve_correct_rounds(u_star, v_star, p, pp0, rhs, dt_sub, inlet, scene,
                         form: str | None = None):
    """Fused solve + corrector + outer rounds + BCs for one scene.
    ``u_star`` (ny, nx+1); ``v_star``, ``p``, ``pp0`` (BC-consistent),
    ``rhs`` (ny, nx). Returns (u, v, p, p_prime, err, counts), where
    ``counts`` is an int32 (2,) tensor: outer rounds run, Jacobi sweeps
    run. ``form`` None takes the cluster form where
    ``rounds_cluster_fits`` admits the grid and the cooperative form
    elsewhere; "cooperative" and "cluster" take that form (to hold the
    two against each other), "cluster" raising where ``cluster_plan``
    finds no split."""
    g, opts = scene.grid, scene.opts
    check_channel(scene.params.flow_case)
    ny, nx = g.ny, g.nx
    if form not in (None, "cluster", "cooperative"):
        raise ValueError(f"form must be None, 'cluster' or 'cooperative', got {form!r}")
    if form == "cluster" and cluster_plan(ny, nx) is None:
        raise ValueError(f"the cluster form cannot take a {ny}x{nx} grid (cluster_plan)")
    cluster = rounds_cluster_fits(ny, nx) if form is None else form == "cluster"
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
    entry = lib.cfd_rounds_cluster if cluster else lib.cfd_rounds
    with torch.cuda.device(p.device):
        check(entry(
            u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(), pp0.data_ptr(),
            rhs.data_ptr(), scal.data_ptr(), u.data_ptr(), v.data_ptr(),
            p_out.data_ptr(), pp.data_ptr(), pp_tmp.data_ptr(),
            rhs_w.data_ptr(), slots.data_ptr(), err.data_ptr(),
            counts.data_ptr(), mask_u_bc, mask_v_bc, ny, nx, f32(g.dx),
            f32(g.dy), *_multipliers(g.dx, g.dy, opts.jacobi_omega),
            opts.jacobi_iters, opts.jacobi_tol, opts.outer_corrector_rounds,
            opts.outer_corrector_tol,
            *inlet_args(g, scene.params.inlet_profile), stream_of(p)),
            "solve_correct_rounds" + (" (cluster form)" if cluster else ""))
    solve_correct_rounds.launches += 1
    solve_correct_rounds.cluster_launches += cluster
    return u, v, p_out, pp, err, counts


solve_correct_rounds.launches = 0
solve_correct_rounds.cluster_launches = 0


def rounds_cluster_size(ny: int, nx: int) -> int:
    """The CTAs of the cluster the card launches for an (ny, nx) grid
    (16 or 8; needs the card); raises if the rule refuses the grid or the
    card admits no cluster."""
    c = load().cfd_rounds_cluster_size(ny, nx)
    if c < 0:
        check(-c, f"the rounds kernel's cluster form at {ny}x{nx}")
    return c
