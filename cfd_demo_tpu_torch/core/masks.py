"""Obstacle masks built on the device from index tensors
(↔ cfd_demo_tpu/core/masks.py ``masks_traced``).

Rust semantics (model.rs:232-261): a cell whose *centre* lies strictly
inside a cylinder marks both adjacent u faces and both adjacent v faces
for the predictor; the end-of-substep BCs zero only the west u face and
the south v face of each such cell (model.rs:869-874).

JS semantics (index.html:377-380, :912-929): the predictor and the BCs
both test the *face position itself*, u face (i dx, (j + 0.5) dy) and v
face ((i + 0.5) dx, j dy), with an inclusive radius.

Coordinates are computed in f32 exactly as the JAX package does,
``(i + off) * dx`` with ``dx`` rounded to f32, and compared against
``f32(r**2)``: a face on the cylinder's rim flips if any of these
roundings differ. The CUDA kernels read these tensors (one byte a face)
rather than testing obstacles themselves, so any number of cylinders
runs on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .config import Cylinder, Grid, Semantics
from .unported import BOX_FLOAT64, unported


def _inside_any(grid: Grid, x: torch.Tensor, y: torch.Tensor,
                inclusive: bool = False) -> torch.Tensor:
    acc = torch.zeros(torch.broadcast_shapes(x.shape, y.shape),
                      dtype=torch.bool, device=x.device)
    for obs in grid.obstacles:
        if not isinstance(obs, Cylinder):
            raise unported(f"obstacle {type(obs).__name__}", BOX_FLOAT64)
        dxo = x - float(np.float32(obs.center_x))
        dyo = y - float(np.float32(obs.center_y))
        d2, r2 = dxo * dxo + dyo * dyo, float(np.float32(obs.radius ** 2))
        acc |= (d2 <= r2) if inclusive else (d2 < r2)
    return acc


@functools.lru_cache(maxsize=64)
def masks_traced(grid: Grid, semantics: Semantics, device, row_offset: int = 0,
                 rows=None):
    """(mask_u, mask_v, mask_u_bc, mask_v_bc) as contiguous bool tensors
    in the storage shapes (ny, nx+1) and (ny, nx) on ``device``; a tuple
    of None when the scene has no obstacles. Cached per (grid, semantics,
    device, window): callers must not write into the returned tensors.

    With ``rows``, the masks of a row block of a sharded field: global
    rows [row_offset, row_offset + rows), False outside the grid (a
    halo beyond the domain's edge)."""
    if not grid.obstacles:
        return None, None, None, None
    if rows is not None:
        lo, hi = max(row_offset, 0), min(row_offset + rows, grid.ny)
        out = []
        for m in masks_traced(grid, semantics, device):
            w = m.new_zeros((rows,) + m.shape[1:])
            if hi > lo:
                w[lo - row_offset:hi - row_offset] = m[lo:hi]
            out.append(w)
        return tuple(out)
    ny, nx = grid.ny, grid.nx
    dx = float(np.float32(grid.dx))
    dy = float(np.float32(grid.dy))
    f32 = torch.float32
    iu = torch.arange(nx + 1, device=device)[None, :]
    iv = torch.arange(nx, device=device)[None, :]
    jj = torch.arange(ny, device=device)[:, None]
    if semantics == Semantics.JS:
        yu = (jj.to(f32) + 0.5) * dy
        mask_u = _inside_any(grid, (iu.to(f32) + 0.0) * dx, yu, True)
        xv = (iv.to(f32) + 0.5) * dx
        mask_v = _inside_any(grid, xv, (jj.to(f32) + 0.0) * dy, True)
        return mask_u, mask_v, mask_u, mask_v
    # u face f: cells west (i-1) and east (i) of it, on row j.
    yc = (jj.to(f32) + 0.5) * dy
    in_w = _inside_any(grid, (iu.to(f32) + (-0.5)) * dx, yc) & (iu >= 1)
    in_e = _inside_any(grid, (iu.to(f32) + 0.5) * dx, yc) & (iu <= nx - 1)
    mask_u = in_w | (in_e & (iu >= 1))   # cell 0 never marks face 0
    mask_u_bc = in_e                     # west face of each inside cell
    # v face r: cells south (j-1) and north (j) of it, on column i.
    xc = (iv.to(f32) + 0.5) * dx
    in_s = _inside_any(grid, xc, (jj.to(f32) + (-0.5)) * dy) & (jj >= 1)
    in_n = _inside_any(grid, xc, yc)
    mask_v = in_s | (in_n & (jj >= 1))
    mask_v_bc = in_n
    return mask_u, mask_v, mask_u_bc, mask_v_bc
