"""Divergence RHS for the pressure-correction solve
(↔ cfd_demo_tpu/ops/divergence.py).

rhs[j, i] = ((u*[j, i+1] - u*[j, i])/dx + (v*[j+1, i] - v*[j, i])/dy) / dt_sub

over all pressure cells (model.rs:1406-1440). v's implicit top row
j=ny reads as zero through the zero-filling shift.
"""
from __future__ import annotations

import torch

from .stencil import per_scene, shifted


def divergence_rhs(u_star: torch.Tensor, v_star: torch.Tensor, dt_sub,
                   dx: float, dy: float) -> torch.Tensor:
    du = (u_star[..., 1:] - u_star[..., :-1]) / dx
    dv = (shifted(v_star, v_star.shape, 1, 0) - v_star) / dy
    return (du + dv) / per_scene(dt_sub)
