"""Fast-diagonalisation (FDM) Poisson solve (↔ cfd_demo_tpu/ops/fdm.py).

The pressure-correction operator on the interior unknowns is separable,
A = Ty (x) I + I (x) Tx, with Tx, Ty the one-dimensional folded
Laplacians (Neumann mirror folds from the p' boundary slaving,
model.rs:807-815, plus the Dirichlet-0 outlet ghost). It diagonalises
as A = (Qy (x) Qx) L (Qy (x) Qx)^T, so the exact solve is two small
dense products per side and an elementwise scale:

    e = -Qy @ ((Qy^T r Qx) * S) @ Qx^T,   S = 1/(ly + lx)

In CAVITY flow the east end is a Neumann mirror too (``east_dirichlet``
False): both axes take the Neumann-Neumann DCT basis, the operator is
singular with its one zero eigenvalue at mode (0, 0), and S is its
pseudo-inverse there (0 for that mode), so the solve returns the
zero-mean solution of the compatible part of r (JAX ops/fdm.py:153-180,
tests/test_projection.py:237).

It is the exact bottom solve of the aligned MG_PRODUCTION hierarchy
(ops.poisson) and, on the whole interior, PressureSolver.FDM
(solver.piso ``_solve_fdm``). The bases are built once per (shape, h, d_wall, device) on the CPU,
as the JAX package builds them at trace time, and cached.

Precision: the four products take f32 operands and round each result to
f32, as the JAX package's HIGHEST-precision f32 matmuls do, but multiply
in f64. A f32 cuBLAS product would use TF32 (about three decimal digits)
whenever a caller has turned that on, through either of torch's two flag
APIs, and reading the flags raises once both have been used; an f64
product never uses TF32, whatever the flags say. FDM's exactness rests
on it (docs/PERF.md:471-478). The bottom level is at most
``mgp_coarse_stop`` cells a side, so the f64 products cost nothing there.
The same products serve ``fdm_precision`` "highest" and "high" (the
JAX package's bf16x3 form): the port never computes below the f32
result.

Sign convention: the residual is r = rhs - A p with A = +Laplacian
(ops.poisson._mg_residual); the 1-D matrices here are the positive
semi-definite -Laplacian, hence the leading minus in the apply.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def _t1d(m: int, h: float, right_dirichlet: bool,
         d_wall: float) -> np.ndarray:
    """1-D folded -Laplacian (positive semi-definite, symmetric).

    The left end is a Neumann mirror fold. ``right_dirichlet`` couples
    the last cell to a 0-valued ghost at distance ``d_wall`` in the
    symmetric FV flux form: diag(last) = (1 + h/d)/h^2. The end folds
    compose, so m = 1 (a saturated axis) gets (h/d)/h^2 with a Dirichlet
    end and 0 with two Neumann ends."""
    T = np.zeros((m, m), np.float64)
    for i in range(m):
        T[i, i] = 2.0
        if i > 0:
            T[i, i - 1] = -1.0
        if i < m - 1:
            T[i, i + 1] = -1.0
    T[0, 0] -= 1.0                    # left Neumann: west coupling folds out
    if right_dirichlet:
        T[m - 1, m - 1] += h / d_wall - 1.0  # east coupling -> wall flux
    else:
        T[m - 1, m - 1] -= 1.0        # right Neumann mirror
    return T / (h * h)


def _fdm_constants(my: int, mx: int, dy: float, dx: float, d_wall: float
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Qy, Qx, S) as float32 numpy from f64 eigh, for the d != h
    operator of the coarse levels."""
    Ty = _t1d(my, dy, False, 0.0)
    Tx = _t1d(mx, dx, True, d_wall)
    ly, Qy = np.linalg.eigh(Ty)
    lx, Qx = np.linalg.eigh(Tx)
    S = 1.0 / (ly[:, None] + lx[None, :])
    return (Qy.astype(np.float32), Qx.astype(np.float32),
            S.astype(np.float32))


def _mulmod_i32(a: torch.Tensor, b: torch.Tensor, period: int) -> torch.Tensor:
    """(a * b) % period on int32 tensors without overflow, by an 8-bit
    limb split of b: the largest intermediate is a * (b // 256) <
    period^2 / 256, exact in int32 for period <= ~741k."""
    a = a % period
    b = b % period
    return ((a * (b // 256) % period) * 256 + a * (b % 256)) % period


def _dct_basis(m: int, dirichlet_right: bool):
    """Closed-form orthonormal eigenbasis of the d = h folded 1-D
    operator, on the CPU: (Q, lam) with lam ascending.

    Neumann-Neumann: v_k[i] = cos(pi k (2i+1) / (2m)); Neumann-Dirichlet:
    v_k[i] = cos(pi (2k+1)(2i+1) / (2(2m+1))). The cosine's integer
    numerator is reduced mod its period in int32 first, so f32 cos never
    sees an argument beyond 2 pi. Eigenvalues are 4 sin^2(theta/2), not
    2 - 2 cos(theta), which cancels to 0 for the low modes at large m.
    Columns are normalised numerically."""
    i = torch.arange(m, dtype=torch.int32)
    k = torch.arange(m, dtype=torch.int32)
    if dirichlet_right:
        period = 2 * (4 * m + 2)
        numer = _mulmod_i32(2 * i[:, None] + 1, 2 * k[None, :] + 1, period)
        ang = float(np.float32(np.pi / (4 * m + 2))) * numer.to(torch.float32)
        half = (float(np.float32(np.pi / (2 * (2 * m + 1))))
                * (2 * k + 1).to(torch.float32))
    else:
        period = 4 * m
        numer = _mulmod_i32(2 * i[:, None] + 1, k[None, :], period)
        ang = float(np.float32(np.pi / (2 * m))) * numer.to(torch.float32)
        half = float(np.float32(np.pi / (2 * m))) * k.to(torch.float32)
    s = torch.sin(half)
    lam = 4.0 * s * s
    Q = torch.cos(ang)
    Q = Q / torch.sqrt(torch.sum(Q * Q, dim=0, keepdim=True))
    return Q, lam


@lru_cache(maxsize=64)
def _fdm_bases(my: int, mx: int, dx: float, dy: float, d_wall: float,
               device: torch.device, east_dirichlet: bool = True):
    """(Qy, Qx, S) f32 on ``device``, built on the CPU and cached per
    geometry. d_wall == dx (the fine-level operator) and the all-Neumann
    operator take the closed-form DCT bases; the coarse levels' d != h
    fold takes the f64-eigh constants."""
    if d_wall == dx or not east_dirichlet:
        Qy, ly = _dct_basis(my, False)
        Qx, lx = _dct_basis(mx, east_dirichlet)
        L = (ly[:, None] / float(np.float32(dy * dy))
             + lx[None, :] / float(np.float32(dx * dx)))
        if east_dirichlet:
            S = 1.0 / L
        else:  # the pseudo-inverse: lam ascends, so the one 0 is at (0, 0)
            S = torch.where(L == 0.0, 0.0, 1.0 / torch.where(L == 0.0, 1.0, L))
    else:
        Qy, Qx, S = map(torch.from_numpy, _fdm_constants(my, mx, dy, dx,
                                                         d_wall))
    return tuple(t.to(device) for t in (Qy, Qx, S))


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for f32 operands, multiplied in f64 and rounded to f32:
    never TF32 (see the module docstring)."""
    return torch.matmul(a.double(), b.double()).to(torch.float32)


def fdm_solve_interior(r: torch.Tensor, dx: float, dy: float,
                       d_wall: float, east_dirichlet: bool = True) -> torch.Tensor:
    """Exact solve A e = r of the folded interior operator (+Laplacian
    convention, Neumann west, south and north, the Dirichlet outlet east
    at d_wall from the last centre, or with ``east_dirichlet`` False a
    Neumann east and the pseudo-inverse); ``r`` is an interior-unknown
    array (my, mx)."""
    my, mx = r.shape
    Qy, Qx, S = _fdm_bases(my, mx, float(dx), float(dy), float(d_wall),
                           r.device, bool(east_dirichlet))
    t = _matmul_f32(Qy.T, _matmul_f32(r, Qx))
    t = t * S
    return -_matmul_f32(Qy, _matmul_f32(t, Qx.T))
