"""Damped-Jacobi pressure-correction solve, CHANNEL flow
(↔ the Jacobi slice of cfd_demo_tpu/ops/poisson.py).

model.rs:733-824: a whole-array damped sweep with the per-iteration p'
BCs (model.rs:807-815: Neumann bottom/top/left, Dirichlet 0 at the
outlet column), looped as a do-while that exits after the first sweep
whose max interior change is below ``tol``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _apply_pprime_bcs(pp: torch.Tensor) -> torch.Tensor:
    """Rows first, then columns (the corner values depend on the order)."""
    ny, nx = pp.shape
    pp = pp.clone()
    pp[0] = pp[1]            # bottom
    pp[ny - 1] = pp[ny - 2]  # top
    pp[:, 0] = pp[:, 1]      # left
    pp[:, nx - 1] = 0.0      # outlet
    return pp


def _jacobi_sweep(pp, rhs, dx, dy, omega) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped-Jacobi iteration incl. p' BCs; returns (pp, max_err)
    with max_err over the interior cells."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    c = pp[1:-1, 1:-1]
    update = ((pp[1:-1, 2:] + pp[1:-1, :-2]) / dx2
              + (pp[2:, 1:-1] + pp[:-2, 1:-1]) / dy2 - rhs[1:-1, 1:-1]) / denom
    new_val = omega * update + (1.0 - omega) * c
    err = torch.amax(torch.abs(new_val - c))
    out = pp.clone()
    out[1:-1, 1:-1] = new_val
    return _apply_pprime_bcs(out), err


def jacobi(pp0: torch.Tensor, rhs: torch.Tensor, dx: float, dy: float,
           omega: float, tol: float, iters: int, early_exit: bool = True):
    """Returns (p_prime, max_error_of_last_sweep, iterations_run).

    ``early_exit`` (``_exact_while``): a do-while on the host that stops
    after the first sweep whose error is below ``tol``; it reads the
    error back once per sweep. Otherwise (``_masked_while`` at fixed
    trip count): max(1, iters) sweeps whose results freeze once
    converged -- the same fields, with no host read, and the count
    returned as a 0-d tensor.
    """
    if early_exit:
        pp, it = pp0, 0
        while True:
            pp, err = _jacobi_sweep(pp, rhs, dx, dy, omega)
            it += 1
            if not (it < iters and bool(err >= tol)):
                return pp, err, it
    pp = pp0
    err = torch.full((), float("inf"), dtype=pp0.dtype, device=pp0.device)
    done = torch.zeros((), dtype=torch.bool, device=pp0.device)
    n = torch.zeros((), dtype=torch.int32, device=pp0.device)
    for _ in range(max(1, iters)):
        pp2, err2 = _jacobi_sweep(pp, rhs, dx, dy, omega)
        pp = torch.where(done, pp, pp2)
        err = torch.where(done, err, err2)
        n = n + (~done).to(torch.int32)
        done = done | (err < tol)
    return pp, err, n
