"""Velocity boundary conditions, CHANNEL flow (↔ cfd_demo_tpu/ops/bc.py).

model.rs:826-875, applied at the end of every PISO substep in this order:

1. inlet:  u[j, 0] = profile(y_j)    (UNIFORM: the ramped inlet speed)
2. outlet: u[j, nx] = u[j, nx-1]     (zero-gradient)
3. no-slip rows: u[0, :] = u[ny-1, :] = 0   (overwrites the corners)
4. v row 0 = 0 (the top row j=ny is implicit zero)
5. obstacle zeroing via the Rust BC masks (west u face / south v face
   of obstacle cells, model.rs:869-874)
"""
from __future__ import annotations

import torch

from ..core.config import FlowCase, Grid, InletProfile
from ..core.unported import WIDEN_STEP, unported
from .stencil import apply_solid_mask


def _check(profile: InletProfile, flow_case: FlowCase):
    if profile != InletProfile.UNIFORM:
        raise unported(f"the {profile.value} inlet profile", WIDEN_STEP)
    if flow_case != FlowCase.CHANNEL:
        raise unported(f"{flow_case.value} flow", WIDEN_STEP)


def inlet_profile_column(grid: Grid, profile: InletProfile, inlet_velocity,
                         device, dtype=torch.float32) -> torch.Tensor:
    """Per-row inlet u value (model.rs:833-848); ``inlet_velocity`` may
    be a 0-d tensor (the ramp), or a ``(B,)`` tensor of per-scene speeds,
    which gives a ``(B, ny)`` column."""
    _check(profile, FlowCase.CHANNEL)
    if isinstance(inlet_velocity, torch.Tensor):
        inlet_velocity = inlet_velocity[..., None]
    return inlet_velocity * torch.ones((grid.ny,), dtype=dtype, device=device)


def apply_bcs(u: torch.Tensor, v: torch.Tensor, grid: Grid,
              profile: InletProfile, inlet_velocity, mask_u_bc, mask_v_bc,
              flow_case: FlowCase = FlowCase.CHANNEL):
    """Returns (u, v) with the boundary conditions enforced. Fields may
    carry leading batch dimensions, with a ``(B,)`` inlet speed."""
    _check(profile, flow_case)
    ny, nx = grid.ny, grid.nx
    u = u.clone()
    u[..., :, 0] = inlet_profile_column(grid, profile, inlet_velocity,
                                        u.device, u.dtype)
    u[..., :, nx] = u[..., :, nx - 1]
    u[..., 0, :] = 0.0
    u[..., ny - 1, :] = 0.0
    v = v.clone()
    v[..., 0, :] = 0.0
    return apply_solid_mask(u, mask_u_bc), apply_solid_mask(v, mask_v_bc)
