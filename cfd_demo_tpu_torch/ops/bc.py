"""Velocity boundary conditions (↔ cfd_demo_tpu/ops/bc.py).

CHANNEL flow, model.rs:826-875, applied at the end of every PISO substep
in this order:

1. inlet:  u[j, 0] = profile(y_j)    (uniform or clamped parabolic)
2. outlet: u[j, nx] = u[j, nx-1]     (zero-gradient)
3. no-slip rows: u[0, :] = u[ny-1, :] = 0   (overwrites the corners)
4. v row 0 = 0 (the top row j=ny is implicit zero)
5. obstacle zeroing via the BC masks (Rust: west u face / south v face
   of obstacle cells, model.rs:869-874; JS: every face inside)

CAVITY flow (the lid-driven cavity, JAX ops/bc.py:99-117): the moving
lid on u's row ny-1 (the ramped speed, or for either parabolic profile
the centred parabola along x, zero at the side walls), the floor u = 0,
the side walls u = 0 at i = 0 and i = nx (winning at the lid's
corners), v = 0 on row 0 and on columns 0 and nx-1, then the masks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import FlowCase, Grid, InletProfile
from ..core.unported import CAVITY, unported
from .stencil import apply_solid_mask


def check_channel(flow_case: FlowCase, where: str = ""):
    """CHANNEL flow only, for the routes that do not take CAVITY yet (the
    batches, the sharded step): CAVITY raises (queue 1 item 6b)."""
    if flow_case != FlowCase.CHANNEL:
        raise unported(f"{flow_case.value} flow{where}", CAVITY)


def parabola(grid: Grid, profile: InletProfile):
    """(center, radius) of a parabolic inlet (model.rs:833-848): the
    channel's height, or for PARABOLIC_UPPER (the sudden-expansion inlet)
    its upper half, whose lower half the clamp zeroes exactly."""
    if profile == InletProfile.PARABOLIC_UPPER:
        return 3.0 * grid.ly / 4.0, grid.ly / 4.0
    return grid.ly / 2.0, grid.ly / 2.0


def inlet_profile_column(grid: Grid, profile: InletProfile, inlet_velocity,
                         device, dtype=torch.float32) -> torch.Tensor:
    """Per-row inlet u value (model.rs:833-848); ``inlet_velocity`` may
    be a 0-d tensor (the ramp), or a ``(B,)`` tensor of per-scene speeds,
    which gives a ``(B, ny)`` column. The parabola's shape is computed in
    f32 as the JAX package computes it, ``1 - ((y - c) / r)**2`` with
    ``y = (j + 0.5) f32(dy)``, the formula the CUDA kernels evaluate per
    row (csrc/common.cuh ``inlet_at``); the reference clamps the final
    value, not the shape."""
    if isinstance(inlet_velocity, torch.Tensor):
        inlet_velocity = inlet_velocity[..., None]
    if profile == InletProfile.UNIFORM:
        return inlet_velocity * torch.ones((grid.ny,), dtype=dtype, device=device)
    center, radius = parabola(grid, profile)
    y = (np.arange(grid.ny, dtype=np.float32) + 0.5) * np.float32(grid.dy)
    shape_fn = 1.0 - ((y - np.float32(center)) / np.float32(radius)) ** 2
    shape_fn = torch.from_numpy(shape_fn.astype(np.float32)).to(device, dtype)
    return torch.clamp(inlet_velocity * shape_fn, min=0.0)


def lid_profile_row(grid: Grid, profile: InletProfile, lid_velocity, device,
                    dtype=torch.float32) -> torch.Tensor:
    """The cavity lid's u at faces i = 0..nx (JAX ops/bc.py:99-110): the
    ramped speed, or for PARABOLIC and PARABOLIC_UPPER (no lid analogue of
    the upper half: the same parabola) max(lid (1 - ((x - h) / h)^2), 0)
    at x = i f32(dx), h = f32(lx / 2), in f32 as the JAX package computes
    it and the CUDA kernels do (csrc/common.cuh ``lid_at``)."""
    if profile == InletProfile.UNIFORM:
        return lid_velocity * torch.ones((grid.nx + 1,), dtype=dtype, device=device)
    x = np.arange(grid.nx + 1, dtype=np.float32) * np.float32(grid.dx)
    half = np.float32(grid.lx / 2.0)
    t = (x - half) / half
    shape_fn = torch.from_numpy((np.float32(1.0) - t * t).astype(np.float32))
    return torch.clamp(lid_velocity * shape_fn.to(device, dtype), min=0.0)


def apply_bcs(u: torch.Tensor, v: torch.Tensor, grid: Grid,
              profile: InletProfile, inlet_velocity, mask_u_bc, mask_v_bc,
              flow_case: FlowCase = FlowCase.CHANNEL, row_offset: int = 0):
    """Returns (u, v) with the boundary conditions of ``flow_case``
    enforced. Fields may carry leading batch dimensions, with a ``(B,)``
    inlet speed. On a row block of a sharded field (rows [row_offset,
    row_offset + rows) of the grid, the masks the block's), the inlet
    column and the wall rows are taken at the block's global rows."""
    ny, nx = grid.ny, grid.nx
    rows = u.shape[-2]
    u = u.clone()
    if flow_case == FlowCase.CAVITY:
        return _cavity_bcs(u, v.clone(), grid, profile, inlet_velocity, mask_u_bc,
                           mask_v_bc, row_offset)
    inlet = inlet_profile_column(grid, profile, inlet_velocity, u.device, u.dtype)
    lo, hi = max(row_offset, 0), min(row_offset + rows, ny)
    u[..., lo - row_offset:hi - row_offset, 0] = inlet[..., lo:hi]
    u[..., :, nx] = u[..., :, nx - 1]
    for j in (0, ny - 1):
        if 0 <= j - row_offset < rows:
            u[..., j - row_offset, :] = 0.0
    v = v.clone()
    if 0 <= -row_offset < rows:
        v[..., -row_offset, :] = 0.0
    return apply_solid_mask(u, mask_u_bc), apply_solid_mask(v, mask_v_bc)


def _cavity_bcs(u, v, grid: Grid, profile: InletProfile, lid_velocity, mask_u_bc,
                mask_v_bc, row_offset: int):
    """apply_bcs's CAVITY branch on copies of u and v (module docstring)."""
    ny, nx, rows = grid.ny, grid.nx, u.shape[-2]
    if isinstance(lid_velocity, torch.Tensor):
        lid_velocity = lid_velocity[..., None]
    if 0 <= ny - 1 - row_offset < rows:
        u[..., ny - 1 - row_offset, :] = lid_profile_row(grid, profile, lid_velocity,
                                                         u.device, u.dtype)
    if 0 <= -row_offset < rows:
        u[..., -row_offset, :] = 0.0
        v[..., -row_offset, :] = 0.0
    u[..., :, 0] = 0.0
    u[..., :, nx] = 0.0
    v[..., :, 0] = 0.0
    v[..., :, nx - 1] = 0.0
    return apply_solid_mask(u, mask_u_bc), apply_solid_mask(v, mask_v_bc)
