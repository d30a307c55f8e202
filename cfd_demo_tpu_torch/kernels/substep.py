"""Fused substep passes as CUDA kernels (↔ cfd_demo_tpu/kernels/substep_pallas.py).

``predict_div`` replaces ``predict_div_pallas`` (substep_pallas.py:231,
body ``_kernel_pre`` :180), csrc/predict_div.cu + predict.cuh. It reads
u, v and the two predictor masks and writes u*, v* and the divergence
RHS: 22 bytes per cell, about 92 MB a call at 2048², so memory bandwidth
bounds it on the H100. One thread per face of the (ny, nx+1) index
space computes u* and v* as ops.predictor does, for each upwind scheme
(FIRST, SECOND, QUICK: template parameters, the ±2 neighbours plain
reads) and either semantics (JS averages the convecting v). The
obstacle masks are the scene's ``masks_traced`` tensors, one byte a
face, so the kernel holds no obstacle geometry and takes any number of
cylinders. rhs(j, i) needs u*(j, i+1) and v*(j+1, i): the thread
recomputes those two rather than staging u*/v* in a shared-memory tile,
which doubles the arithmetic but keeps one pass and one launch.
Neighbour reads are served by L1/L2.

``correct_bc`` replaces ``correct_bc_pallas`` (substep_pallas.py:387,
body ``_kernel_post`` :319), csrc/correct_bc.cu. It reads u*, v*, p, p',
the step-entry u and v and the BC masks and writes u, v, p: 38 bytes
per cell, again bandwidth-bound. One thread per face applies the
corrector, then the CHANNEL BCs in the reference's order, the inlet
profile evaluated per row (UNIFORM, PARABOLIC, PARABOLIC_UPPER); the
thread on the outlet face recomputes the corrected u[:, nx-1] it
copies. res_u, res_v and max|vel| (model.rs:333-348, :877-889) are
reduced in the same pass to per-block maxima, then by one block into
three device scalars: two launches, no host read.

``correct_div`` replaces ``correct_div_pallas`` (substep_pallas.py:541,
body ``_kernel_round`` :497), csrc/correct_div.cu: one launch per Rust
outer corrector round on the fused route with ``rounds_impl="pallas"``.
It reads u*, v*, p and p' and writes the corrected u, v, p and, in the
same pass, the divergence RHS the next round's solve consumes: 32
bytes per cell, bandwidth-bound (134 MB, 0.040 ms at 2048²). rhs(j, i)
needs the corrected u(j, i+1) and v(j+1, i): the thread recomputes them
in registers.

``predict_div`` and ``correct_bc`` also take a row block of a sharded
field (the sharded step, shard/step_shmap.py): ``row_offset`` is the
global row of the block's row 0, which may be negative (shard 0's halo
lies below the grid), and ``correct_bc``'s ``own_rows`` = (lo, hi) are
the local rows its three reductions count (substep_pallas.py:235, :393,
:406-410). Every row test, the inlet's rows and the masks take global
rows; loads past the block read 0, as the Pallas window's zero-filled
rolls do, so the halo rows' outputs are stale and the caller discards
them. The kernels read the whole grid's masks at global rows; the plain
versions take the block's window of them (``masks_traced(...,
row_offset, rows)``). Without an offset the arguments are those of the
whole field, and every launch computes what it computed before.

On CPU tensors each wrapper runs its plain version, built from the
ported ops; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import (FlowCase, Grid, InletProfile, Semantics,
                           VelocityScheme)
from ..core.masks import masks_traced
from ..ops.bc import apply_bcs, check_channel, parabola
from ..ops.corrector import correct
from ..ops.divergence import divergence_rhs
from ..ops.predictor import predict
from ._build import check, device_scalars, load, mask_ptrs, on_cpu, stream_of

_SCHEME = {VelocityScheme.FIRST: 0, VelocityScheme.SECOND: 1,
           VelocityScheme.QUICK: 2}


def _f32(x: float) -> float:
    return float(np.float32(x))


def inlet_args(grid: Grid, profile: InletProfile):
    """(parabolic, f32 center, f32 radius): a kernel's inlet profile
    arguments (csrc/common.cuh ``Inlet``)."""
    if profile == InletProfile.UNIFORM:
        return 0, 0.0, 1.0
    center, radius = parabola(grid, profile)
    return 1, _f32(center), _f32(radius)


def _masks(grid: Grid, semantics: Semantics, device, row_offset, rows):
    if row_offset is None:
        return masks_traced(grid, semantics, device)
    return masks_traced(grid, semantics, device, row_offset, rows)


def _block_rows(grid: Grid, u, row_offset) -> int:
    """The rows of the arrays: the grid's, or a block's (``row_offset``)."""
    return grid.ny if row_offset is None else u.shape[0]


def predict_div_plain(u, v, dt_sub, nu, grid: Grid, scheme: VelocityScheme,
                      semantics: Semantics, row_offset=None):
    """ops.predictor.predict + ops.divergence.divergence_rhs."""
    mask_u, mask_v, _, _ = _masks(grid, semantics, u.device, row_offset, u.shape[0])
    u_star, v_star = predict(u, v, dt_sub, nu, grid.dx, grid.dy, grid.nx,
                             grid.ny, scheme, semantics == Semantics.JS,
                             mask_u, mask_v, row_offset or 0)
    return u_star, v_star, divergence_rhs(u_star, v_star, dt_sub, grid.dx,
                                          grid.dy)


def predict_div(u, v, dt_sub, nu, grid: Grid, scheme: VelocityScheme,
                semantics: Semantics, row_offset=None):
    """Fused predictor + divergence: returns (u_star, v_star, rhs) in the
    storage shapes (ny, nx+1), (ny, nx), (ny, nx), ny the block's rows
    when ``row_offset`` (an int) places u and v in the grid. ``dt_sub``
    and ``nu`` are floats or 0-d tensors on the fields' device."""
    ny, nx = _block_rows(grid, u, row_offset), grid.nx
    if on_cpu("predict_div", {"u": (u, (ny, nx + 1)), "v": (v, (ny, nx))}):
        return predict_div_plain(u, v, dt_sub, nu, grid, scheme, semantics,
                                 row_offset)
    lib = load()
    u_star, v_star, rhs = (torch.empty_like(u), torch.empty_like(v),
                           torch.empty_like(v))
    scal = device_scalars(u.device, dt_sub, nu)
    mask_u, mask_v, _, _ = mask_ptrs(grid, semantics, u.device)
    with torch.cuda.device(u.device):
        check(lib.cfd_predict_div(
            u.data_ptr(), v.data_ptr(), scal.data_ptr(), u_star.data_ptr(),
            v_star.data_ptr(), rhs.data_ptr(), mask_u, mask_v, ny, nx,
            row_offset or 0, grid.ny, _f32(grid.dx), _f32(grid.dy), _f32(grid.dx * grid.dx),
            _f32(grid.dy * grid.dy), _SCHEME[scheme],
            int(semantics == Semantics.JS), stream_of(u)), "predict_div")
    predict_div.launches += 1
    return u_star, v_star, rhs


predict_div.launches = 0


def correct_bc_plain(u_star, v_star, p, p_prime, u_entry, v_entry, dt_sub,
                     inlet, grid: Grid, profile: InletProfile,
                     flow_case: FlowCase, semantics: Semantics, row_offset=None,
                     own_rows=None):
    """ops.corrector.correct + ops.bc.apply_bcs + the three maxima (over
    the rows ``own_rows``)."""
    rows = u_star.shape[0]
    _, _, mask_u_bc, mask_v_bc = _masks(grid, semantics, u_star.device,
                                        row_offset, rows)
    u, v, p = correct(u_star, v_star, p, p_prime, dt_sub, grid.dx, grid.dy)
    u, v = apply_bcs(u, v, grid, profile, inlet, mask_u_bc, mask_v_bc,
                     flow_case, row_offset or 0)
    lo, hi = own_rows or (0, rows)
    uo, vo = u[lo:hi], v[lo:hi]
    res_u = torch.amax(torch.abs(uo - u_entry[lo:hi]))
    res_v = torch.amax(torch.abs(vo - v_entry[lo:hi]))
    max_vel = torch.maximum(torch.amax(torch.abs(uo)), torch.amax(torch.abs(vo)))
    return u, v, p, res_u, res_v, max_vel


def correct_bc(u_star, v_star, p, p_prime, u_entry, v_entry, dt_sub, inlet,
               grid: Grid, profile: InletProfile, flow_case: FlowCase,
               semantics: Semantics, row_offset=None, own_rows=None):
    """Fused corrector + BCs + step reductions. Returns
    (u, v, p, res_u, res_v, max_vel), the last three 0-d tensors:
    res_* = max|field - entry| (model.rs:333-348) and max_vel feeds the
    CFL controller. With ``row_offset`` (an int) the arrays are a row
    block of the grid and the maxima count the local rows ``own_rows`` =
    (lo, hi) only (all rows when None)."""
    check_channel(flow_case)
    ny, nx = _block_rows(grid, u_star, row_offset), grid.nx
    own_lo, own_hi = own_rows or (0, ny)
    if not 0 <= own_lo < own_hi <= ny:
        raise ValueError(f"correct_bc: own_rows {own_rows} outside the block's {ny} rows")
    shapes = {"u_star": (u_star, (ny, nx + 1)), "v_star": (v_star, (ny, nx)),
              "p": (p, (ny, nx)), "p_prime": (p_prime, (ny, nx)),
              "u_entry": (u_entry, (ny, nx + 1)), "v_entry": (v_entry, (ny, nx))}
    if on_cpu("correct_bc", shapes):
        return correct_bc_plain(u_star, v_star, p, p_prime, u_entry, v_entry,
                                dt_sub, inlet, grid, profile, flow_case,
                                semantics, row_offset, own_rows)
    lib = load()
    u, v, p_new = (torch.empty_like(u_star), torch.empty_like(v_star),
                   torch.empty_like(p))
    partials = torch.empty(3 * lib.cfd_correct_bc_partials(ny, nx),
                           dtype=torch.float32, device=u.device)
    red = torch.empty(3, dtype=torch.float32, device=u.device)
    scal = device_scalars(u.device, dt_sub, inlet)
    _, _, mask_u_bc, mask_v_bc = mask_ptrs(grid, semantics, u.device)
    with torch.cuda.device(u.device):
        check(lib.cfd_correct_bc(
            u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(),
            p_prime.data_ptr(), u_entry.data_ptr(), v_entry.data_ptr(),
            scal.data_ptr(), u.data_ptr(), v.data_ptr(), p_new.data_ptr(),
            partials.data_ptr(), red.data_ptr(), mask_u_bc, mask_v_bc, ny, nx,
            row_offset or 0, grid.ny, own_lo, own_hi, _f32(grid.dx), _f32(grid.dy), *inlet_args(grid, profile),
            stream_of(u)), "correct_bc")
    correct_bc.launches += 1
    return u, v, p_new, red[0], red[1], red[2]


correct_bc.launches = 0


def correct_div_plain(u_star, v_star, p, p_prime, dt_sub, grid: Grid):
    """ops.corrector.correct + ops.divergence.divergence_rhs."""
    u, v, p = correct(u_star, v_star, p, p_prime, dt_sub, grid.dx, grid.dy)
    return u, v, p, divergence_rhs(u, v, dt_sub, grid.dx, grid.dy)


def correct_div(u_star, v_star, p, p_prime, dt_sub, grid: Grid):
    """Fused corrector + next-round divergence: returns (u, v, p_new,
    rhs_next) in the storage shapes, rhs_next the divergence RHS of the
    corrected (u, v). ``dt_sub`` is a float or a 0-d tensor on the
    fields' device."""
    ny, nx = grid.ny, grid.nx
    shapes = {"u_star": (u_star, (ny, nx + 1)), "v_star": (v_star, (ny, nx)),
              "p": (p, (ny, nx)), "p_prime": (p_prime, (ny, nx))}
    if on_cpu("correct_div", shapes):
        return correct_div_plain(u_star, v_star, p, p_prime, dt_sub, grid)
    lib = load()
    u, v = torch.empty_like(u_star), torch.empty_like(v_star)
    p_new, rhs = torch.empty_like(p), torch.empty_like(p)
    scal = device_scalars(u.device, dt_sub)
    with torch.cuda.device(u.device):
        check(lib.cfd_correct_div(
            u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(),
            p_prime.data_ptr(), scal.data_ptr(), u.data_ptr(), v.data_ptr(),
            p_new.data_ptr(), rhs.data_ptr(), ny, nx, _f32(grid.dx),
            _f32(grid.dy), stream_of(u)), "correct_div")
    correct_div.launches += 1
    return u, v, p_new, rhs


correct_div.launches = 0
