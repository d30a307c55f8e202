"""Velocity predictor (u*, v*) (↔ cfd_demo_tpu/ops/predictor.py).

u* = u + dt*(-[(Fe-Fw)/dx + (Fn-Fs)/dy] + nu*laplace(u)) with Fe = face_e^2,
Fn = v_n*face_n (u-momentum) and Fe = u_e*face_e, Fn = face_n^2
(v-momentum); obstacle faces are forced to zero (model.rs:434/519).

Interior update regions (model.rs:540-541, :588-589), outside of which
u* = u:
  u: j in [1, ny-2], i in [1, nx-1]
  v: j in [1, ny-1], i in [1, nx-2]
"""
from __future__ import annotations

import torch

from ..core.config import VelocityScheme
from .schemes import u_faces, v_faces
from .stencil import Shifts, apply_solid_mask, col_index, per_scene, row_index


def predict(u, v, dt_sub, nu, dx, dy, nx: int, ny: int,
            scheme: VelocityScheme, avg_conv_v: bool, mask_u, mask_v,
            row_offset: int = 0):
    """Returns (u_star, v_star). ``dt_sub``/``nu`` are floats, 0-d
    tensors or, for a batch of scenes ``(B, ny, *)``, ``(B,)`` tensors on
    the fields' device. On a row block of a sharded field, ``row_offset``
    is the global row of its row 0 (``ny`` the global height, the masks
    the block's rows); rows beyond the block read 0."""
    dt_sub, nu = per_scene(dt_sub), per_scene(nu)
    # ---- u momentum ---------------------------------------------------
    fu = u_faces(u, v, nx, ny, scheme, avg_conv_v, row_offset)
    conv_u = ((fu.e * fu.e - fu.w * fu.w) / dx
              + (fu.v_n * fu.n - fu.v_s * fu.s) / dy)
    su = Shifts(u, u.shape)
    lap_u = ((su(0, 1) - 2.0 * u + su(0, -1)) / (dx * dx)
             + (su(1, 0) - 2.0 * u + su(-1, 0)) / (dy * dy))
    u_cand = u + dt_sub * (-conv_u + nu * lap_u)
    iu, ju = col_index(u.shape, u.device), row_index(u.shape, u.device, row_offset)
    interior_u = (iu >= 1) & (iu <= nx - 1) & (ju >= 1) & (ju <= ny - 2)
    u_star = torch.where(interior_u, apply_solid_mask(u_cand, mask_u), u)

    # ---- v momentum ---------------------------------------------------
    fv = v_faces(u, v, nx, ny, scheme, row_offset)
    conv_v = ((fv.u_e * fv.e - fv.u_w * fv.w) / dx
              + (fv.n * fv.n - fv.s * fv.s) / dy)
    sv = Shifts(v, v.shape)
    lap_v = ((sv(0, 1) - 2.0 * v + sv(0, -1)) / (dx * dx)
             + (sv(1, 0) - 2.0 * v + sv(-1, 0)) / (dy * dy))
    v_cand = v + dt_sub * (-conv_v + nu * lap_v)
    iv, jv = col_index(v.shape, v.device), row_index(v.shape, v.device, row_offset)
    interior_v = (iv >= 1) & (iv <= nx - 2) & (jv >= 1) & (jv <= ny - 1)
    v_star = torch.where(interior_v, apply_solid_mask(v_cand, mask_v), v)
    return u_star, v_star
