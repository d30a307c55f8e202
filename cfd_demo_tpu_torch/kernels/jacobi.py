"""Fused damped-Jacobi sweeps as a CUDA kernel (↔ cfd_demo_tpu/kernels/jacobi_pallas.py).

``jacobi_fused_k`` replaces ``jacobi_fused_k`` (jacobi_pallas.py:968,
body ``_kernel`` :50), csrc/jacobi.cu: k damped sweeps on p' with the
multipliers ``ax, ay, ar, ac`` of jacobi_pallas.py:87-94 and folded
boundary reads (a Neumann neighbour reads the cell itself, the outlet
reads 0), the p' BCs once at the end, rows then columns, and the max
|delta| of the last sweep over interior cells. Folding makes the result
equal to k plain sweeps only for BC-consistent input p', which the
solver always passes (zeros or a previous solve's output).

Each sweep reads p' and rhs and writes p' (12 bytes per cell, about
50 MB at 2048²), and every sweep needs the whole field of the previous
one. This first version runs one sweep per launch, ping-ponging two
buffers, so the launch boundary is the barrier; the last sweep writes
per-block maxima, and one block then applies the BCs and reduces them.
A call is k + 1 launches. Keeping k sweeps in shared memory on a tile
with a k-cell halo, the TPU kernel's design, is later work.

``jacobi_chain`` replaces ``jacobi_pallas`` (jacobi_pallas.py:1114) and
keeps its schedule: iters//k launches of k, the tolerance checked
between them, then the iters%k remainder launch unconditionally.
"""
from __future__ import annotations

import torch

from ..ops.poisson import _jacobi_sweep
from ._build import check, load, on_cpu, stream_of


def _multipliers(dx: float, dy: float, omega: float):
    """(ax, ay, ar, ac) in double precision, rounded to f32 at the call
    as jacobi_pallas.py:87-94 rounds them."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    return (omega / (dx2 * denom), omega / (dy2 * denom), omega / denom,
            1.0 - omega)


def jacobi_fused_k_plain(pp, rhs, dx: float, dy: float, omega: float, k: int):
    """k ops.poisson._jacobi_sweep's; returns (p', last sweep's error)."""
    for _ in range(k):
        pp, err = _jacobi_sweep(pp, rhs, dx, dy, omega)
    return pp, err


def jacobi_fused_k(pp, rhs, dx: float, dy: float, omega: float, k: int):
    """k fused damped-Jacobi sweeps (CHANNEL p' BCs). Returns
    (p', last-sweep max error as a 0-d tensor)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    ny, nx = pp.shape
    if ny < 3 or nx < 3:
        raise ValueError(f"jacobi_fused_k needs at least 3x3 cells, got {pp.shape}")
    if on_cpu("jacobi_fused_k", {"pp": (pp, (ny, nx)), "rhs": (rhs, (ny, nx))}):
        return jacobi_fused_k_plain(pp, rhs, dx, dy, omega, k)
    lib = load()
    out, tmp = torch.empty_like(pp), torch.empty_like(pp)
    partials = torch.empty(lib.cfd_jacobi_partials(ny, nx), dtype=torch.float32,
                           device=pp.device)
    err = torch.empty((), dtype=torch.float32, device=pp.device)
    with torch.cuda.device(pp.device):
        check(lib.cfd_jacobi_fused_k(
            pp.data_ptr(), rhs.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            partials.data_ptr(), err.data_ptr(), ny, nx, k,
            *_multipliers(dx, dy, omega), stream_of(pp)), "jacobi_fused_k")
    jacobi_fused_k.launches += 1
    return out, err


jacobi_fused_k.launches = 0


def jacobi_chain(pp0, rhs, dx: float, dy: float, omega: float, tol: float,
                 iters: int, k: int = 16, early_exit: bool = True):
    """Returns (p', last error, iterations run), exactly ``iters``
    iterations when no early exit fires.

    With ``early_exit`` and tol > 0 the error is read on the host once
    per k-launch (K-granularity exit, jacobi_pallas.py:28-30). Moving
    that test onto the device (a device-side loop or a CUDA graph) is
    later work; with tol == 0 the chain never reads back."""
    n_full, rem = divmod(iters, k)
    pp = pp0
    err = torch.full((), float("inf"), dtype=torch.float32, device=pp0.device)
    n_run = 0
    for _ in range(n_full):
        pp, err = jacobi_fused_k(pp, rhs, dx, dy, omega, k)
        n_run += k
        if early_exit and tol > 0.0 and not bool(err >= tol):
            break
    if rem:
        pp, err = jacobi_fused_k(pp, rhs, dx, dy, omega, rem)
        n_run += rem
    return pp, err, n_run
