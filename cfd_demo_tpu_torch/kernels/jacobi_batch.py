"""The batched Jacobi solve as a CUDA kernel
(↔ cfd_demo_tpu/kernels/jacobi_pallas.py ``jacobi_pallas_batch``).

``jacobi_batch`` replaces ``jacobi_pallas_batch`` (jacobi_pallas.py:1585,
body ``_kernel_batch`` :1503), csrc/jacobi_batch.cu. B scenes of
(ny, nx) run damped sweeps with folded boundary reads and the
multipliers of jacobi_pallas.py:87-94; after each sweep, scene b freezes
once its max interior |change| is below tol, keeping that error, and
counts its sweeps only while active. The p' BCs follow once, rows then
columns. The kernel stops when every scene has frozen: the same fields,
as the vmapped masked loop gives (ops.poisson._masked_while). Scenes
marked ``done`` on entry (the masked outer rounds' converged scenes)
are never swept, so a launch in a round where every scene has converged
ends after its first grid-wide barrier, with no host read.

The ensemble takes this route when a scene is too large for the
whole-substep kernel (kernels.ensemble), as the reference's own
800x264 grid is: a field is 845 KB there, more than one SM's shared
memory, and a sweep needs every neighbour of the last. What bounds it
on the H100 is the barrier per sweep, not bytes: the batch's p', its
ping-pong buffer and rhs (20 MB at 8x800x264) stay in the 50 MB L2. So
it is the persistent cooperative form of csrc/rounds.cu: one block of
1024 threads per SM, a grid-wide barrier per sweep, and per scene a
rotating three-slot ``atomicMax`` for the sweep's max, so every exit is
decided on the device and nothing is read back.
"""
from __future__ import annotations

import torch

from ..ops.poisson import jacobi
from ._build import check, load, on_cpu, stream_of
from .jacobi import _multipliers


def jacobi_batch_plain(pp0, rhs, dx: float, dy: float, omega: float,
                       tol: float, iters: int, done=None):
    """ops.poisson.jacobi's masked form on the batch."""
    return jacobi(pp0, rhs, dx, dy, omega, tol, iters, early_exit=False,
                  done=done)


def jacobi_batch(pp0, rhs, dx: float, dy: float, omega: float, tol: float,
                 iters: int, done=None):
    """Batched masked-convergence Jacobi solve (CHANNEL p' BCs) of
    (B, ny, nx) BC-consistent ``pp0`` and ``rhs``. Returns (p' (B, ny,
    nx), err (B,), sweeps run (B,) int32); max(1, iters) sweeps at
    most. The scenes a (B,) bool ``done`` marks are not swept: p' = pp0,
    err inf, 0 sweeps."""
    if pp0.dim() != 3:
        raise ValueError(f"jacobi_batch takes (B, ny, nx) fields, got {tuple(pp0.shape)}")
    B, ny, nx = pp0.shape
    if ny < 3 or nx < 3:
        raise ValueError(f"jacobi_batch needs at least 3x3 cells, got {pp0.shape}")
    if done is not None and (done.dtype != torch.bool or done.shape != (B,)
                             or done.device != pp0.device
                             or not done.is_contiguous()):
        raise ValueError(f"jacobi_batch: done must be a contiguous ({B},) bool "
                         f"tensor on {pp0.device}, got {done.dtype} "
                         f"{tuple(done.shape)} on {done.device}")
    if on_cpu("jacobi_batch", {"pp0": (pp0, (B, ny, nx)), "rhs": (rhs, (B, ny, nx))}):
        return jacobi_batch_plain(pp0, rhs, dx, dy, omega, tol, iters, done)
    lib = load()
    out, tmp = torch.empty_like(pp0), torch.empty_like(pp0)
    slots = torch.empty(3 * B, dtype=torch.float32, device=pp0.device)
    err = torch.empty(B, dtype=torch.float32, device=pp0.device)
    n = torch.empty(B, dtype=torch.int32, device=pp0.device)
    with torch.cuda.device(pp0.device):
        check(lib.cfd_jacobi_batch(
            pp0.data_ptr(), rhs.data_ptr(),
            None if done is None else done.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), slots.data_ptr(), err.data_ptr(), n.data_ptr(),
            B, ny, nx, iters,
            tol, *_multipliers(dx, dy, omega), stream_of(pp0)), "jacobi_batch")
    jacobi_batch.launches += 1
    return out, err, n


jacobi_batch.launches = 0
