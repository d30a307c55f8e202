"""Velocity corrector + pressure accumulation (↔ cfd_demo_tpu/ops/corrector.py).

u[j,i] = u*[j,i] - dt_sub * (p'[j,i] - p'[j,i-1]) / dx   (i in [1, nx-1])
v[j,i] = v*[j,i] - dt_sub * (p'[j,i] - p'[j-1,i]) / dy   (j in [1, ny-1])
p     += p'                                              (everywhere)

model.rs:1334-1404. Faces outside the update ranges keep u*/v*.
"""
from __future__ import annotations

import torch

from .stencil import per_scene


def correct(u_star: torch.Tensor, v_star: torch.Tensor, p: torch.Tensor,
            p_prime: torch.Tensor, dt_sub, dx: float, dy: float):
    """Returns (u, v, p); v in the implicit-top-row layout. Fields may
    carry leading batch dimensions, with ``dt_sub`` of shape ``(B,)``."""
    dt_sub = per_scene(dt_sub)
    u = u_star.clone()
    u[..., 1:-1] = (u_star[..., 1:-1]
                    - dt_sub * (p_prime[..., 1:] - p_prime[..., :-1]) / dx)
    v = v_star.clone()
    v[..., 1:, :] = (v_star[..., 1:, :]
                     - dt_sub * (p_prime[..., 1:, :] - p_prime[..., :-1, :]) / dy)
    return u, v, p + p_prime
