"""Velocity boundary conditions, CHANNEL flow (↔ cfd_demo_tpu/ops/bc.py).

model.rs:826-875, applied at the end of every PISO substep in this order:

1. inlet:  u[j, 0] = profile(y_j)    (uniform or clamped parabolic)
2. outlet: u[j, nx] = u[j, nx-1]     (zero-gradient)
3. no-slip rows: u[0, :] = u[ny-1, :] = 0   (overwrites the corners)
4. v row 0 = 0 (the top row j=ny is implicit zero)
5. obstacle zeroing via the Rust BC masks (west u face / south v face
   of obstacle cells, model.rs:869-874)
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import FlowCase, Grid, InletProfile
from ..core.unported import CAVITY, unported
from .stencil import apply_solid_mask


def check_channel(flow_case: FlowCase):
    """CHANNEL flow only: CAVITY raises (queue 1 item 6b)."""
    if flow_case != FlowCase.CHANNEL:
        raise unported(f"{flow_case.value} flow", CAVITY)


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


def apply_bcs(u: torch.Tensor, v: torch.Tensor, grid: Grid,
              profile: InletProfile, inlet_velocity, mask_u_bc, mask_v_bc,
              flow_case: FlowCase = FlowCase.CHANNEL, row_offset: int = 0):
    """Returns (u, v) with the boundary conditions enforced. Fields may
    carry leading batch dimensions, with a ``(B,)`` inlet speed. On a row
    block of a sharded field (rows [row_offset, row_offset + rows) of the
    grid, the masks the block's), the inlet column and the no-slip rows
    are taken at the block's global rows."""
    check_channel(flow_case)
    ny, nx = grid.ny, grid.nx
    rows = u.shape[-2]
    u = u.clone()
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
