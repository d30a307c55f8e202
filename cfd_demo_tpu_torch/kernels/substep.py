"""Fused substep passes as CUDA kernels (↔ cfd_demo_tpu/kernels/substep_pallas.py).

``predict_div`` replaces ``predict_div_pallas`` (substep_pallas.py:231,
body ``_kernel_pre`` :180), csrc/predict_div.cu. It reads u and v and
writes u*, v* and the divergence RHS: 20 bytes per cell, about 84 MB a
call at 2048², so memory bandwidth bounds it on the H100. One thread per
face of the (ny, nx+1) index space computes u* and v* as ops.predictor
does, with the Rust obstacle masks evaluated in registers from the cell
centres (no mask arrays are read). rhs(j, i) needs u*(j, i+1) and
v*(j+1, i): the thread recomputes those two rather than staging u*/v* in
a shared-memory tile, which doubles the arithmetic but keeps one pass
and one launch. Neighbour reads are served by L1/L2.

``correct_bc`` replaces ``correct_bc_pallas`` (substep_pallas.py:387,
body ``_kernel_post`` :319), csrc/correct_bc.cu. It reads u*, v*, p, p',
the step-entry u and v and writes u, v, p: 36 bytes per cell, again
bandwidth-bound. One thread per face applies the corrector, then the
CHANNEL BCs in the reference's order; the thread on the outlet face
recomputes the corrected u[:, nx-1] it copies. res_u, res_v and max|vel|
(model.rs:333-348, :877-889) are reduced in the same pass to per-block
maxima, then by one block into three device scalars: two launches, no
host read.

On CPU tensors each wrapper runs its plain version, built from the
ported ops; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import (FlowCase, Grid, InletProfile, Semantics,
                           VelocityScheme)
from ..core.masks import masks_traced
from ..core.unported import WIDEN_STEP, unported
from ..ops.bc import apply_bcs
from ..ops.corrector import correct
from ..ops.divergence import divergence_rhs
from ..ops.predictor import predict
from ._build import check, cylinders, device_scalars, load, on_cpu, stream_of


def _f32(x: float) -> float:
    return float(np.float32(x))


def _check_slice(scheme=VelocityScheme.FIRST, semantics=Semantics.RUST,
                 profile=InletProfile.UNIFORM, flow_case=FlowCase.CHANNEL):
    if scheme != VelocityScheme.FIRST:
        raise unported(f"the {scheme.value} velocity scheme", WIDEN_STEP)
    if semantics != Semantics.RUST:
        raise unported("JS semantics", WIDEN_STEP)
    if profile != InletProfile.UNIFORM:
        raise unported(f"the {profile.value} inlet profile", WIDEN_STEP)
    if flow_case != FlowCase.CHANNEL:
        raise unported(f"{flow_case.value} flow", WIDEN_STEP)


def predict_div_plain(u, v, dt_sub, nu, grid: Grid, scheme: VelocityScheme,
                      semantics: Semantics):
    """ops.predictor.predict + ops.divergence.divergence_rhs."""
    mask_u, mask_v, _, _ = masks_traced(grid, semantics, u.device)
    u_star, v_star = predict(u, v, dt_sub, nu, grid.dx, grid.dy, grid.nx,
                             grid.ny, scheme, semantics == Semantics.JS,
                             mask_u, mask_v)
    return u_star, v_star, divergence_rhs(u_star, v_star, dt_sub, grid.dx,
                                          grid.dy)


def predict_div(u, v, dt_sub, nu, grid: Grid, scheme: VelocityScheme,
                semantics: Semantics):
    """Fused predictor + divergence: returns (u_star, v_star, rhs) in the
    storage shapes (ny, nx+1), (ny, nx), (ny, nx). ``dt_sub`` and ``nu``
    are floats or 0-d tensors on the fields' device."""
    _check_slice(scheme, semantics)
    ny, nx = grid.ny, grid.nx
    if on_cpu("predict_div", {"u": (u, (ny, nx + 1)), "v": (v, (ny, nx))}):
        return predict_div_plain(u, v, dt_sub, nu, grid, scheme, semantics)
    lib = load()
    u_star, v_star, rhs = (torch.empty_like(u), torch.empty_like(v),
                           torch.empty_like(v))
    scal = device_scalars(u.device, dt_sub, nu)
    n_cyl, cyl = cylinders(grid)
    with torch.cuda.device(u.device):
        check(lib.cfd_predict_div(
            u.data_ptr(), v.data_ptr(), scal.data_ptr(), u_star.data_ptr(),
            v_star.data_ptr(), rhs.data_ptr(), ny, nx, _f32(grid.dx),
            _f32(grid.dy), _f32(grid.dx * grid.dx), _f32(grid.dy * grid.dy),
            n_cyl, cyl, stream_of(u)), "predict_div")
    predict_div.launches += 1
    return u_star, v_star, rhs


predict_div.launches = 0


def correct_bc_plain(u_star, v_star, p, p_prime, u_entry, v_entry, dt_sub,
                     inlet, grid: Grid, profile: InletProfile,
                     flow_case: FlowCase, semantics: Semantics):
    """ops.corrector.correct + ops.bc.apply_bcs + the three maxima."""
    _, _, mask_u_bc, mask_v_bc = masks_traced(grid, semantics, u_star.device)
    u, v, p = correct(u_star, v_star, p, p_prime, dt_sub, grid.dx, grid.dy)
    u, v = apply_bcs(u, v, grid, profile, inlet, mask_u_bc, mask_v_bc,
                     flow_case)
    res_u = torch.amax(torch.abs(u - u_entry))
    res_v = torch.amax(torch.abs(v - v_entry))
    max_vel = torch.maximum(torch.amax(torch.abs(u)), torch.amax(torch.abs(v)))
    return u, v, p, res_u, res_v, max_vel


def correct_bc(u_star, v_star, p, p_prime, u_entry, v_entry, dt_sub, inlet,
               grid: Grid, profile: InletProfile, flow_case: FlowCase,
               semantics: Semantics):
    """Fused corrector + BCs + step reductions. Returns
    (u, v, p, res_u, res_v, max_vel), the last three 0-d tensors:
    res_* = max|field - entry| (model.rs:333-348) and max_vel feeds the
    CFL controller."""
    _check_slice(semantics=semantics, profile=profile, flow_case=flow_case)
    ny, nx = grid.ny, grid.nx
    shapes = {"u_star": (u_star, (ny, nx + 1)), "v_star": (v_star, (ny, nx)),
              "p": (p, (ny, nx)), "p_prime": (p_prime, (ny, nx)),
              "u_entry": (u_entry, (ny, nx + 1)), "v_entry": (v_entry, (ny, nx))}
    if on_cpu("correct_bc", shapes):
        return correct_bc_plain(u_star, v_star, p, p_prime, u_entry, v_entry,
                                dt_sub, inlet, grid, profile, flow_case,
                                semantics)
    lib = load()
    u, v, p_new = (torch.empty_like(u_star), torch.empty_like(v_star),
                   torch.empty_like(p))
    partials = torch.empty(3 * lib.cfd_correct_bc_partials(ny, nx),
                           dtype=torch.float32, device=u.device)
    red = torch.empty(3, dtype=torch.float32, device=u.device)
    scal = device_scalars(u.device, dt_sub, inlet)
    n_cyl, cyl = cylinders(grid)
    with torch.cuda.device(u.device):
        check(lib.cfd_correct_bc(
            u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(),
            p_prime.data_ptr(), u_entry.data_ptr(), v_entry.data_ptr(),
            scal.data_ptr(), u.data_ptr(), v.data_ptr(), p_new.data_ptr(),
            partials.data_ptr(), red.data_ptr(), ny, nx, _f32(grid.dx),
            _f32(grid.dy), n_cyl, cyl, stream_of(u)), "correct_bc")
    correct_bc.launches += 1
    return u, v, p_new, red[0], red[1], red[2]


correct_bc.launches = 0
