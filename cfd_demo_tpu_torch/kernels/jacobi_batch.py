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
only copies pp0, with no host read.

The ensemble takes this route for a Jacobi batch that the whole-substep
kernel (kernels.ensemble ``substep_batch_takes``) does not take: one
beyond one block's shared memory that no cluster holds either (wider
than 1024 columns, or too tall for 16 CTAs), or a card that admits no
such cluster. (The reference's own 800x264 grid, 845 KB a field, goes to
that kernel's cluster form.) A sweep needs every neighbour of the last.
What bounds it on the H100 is the exchange a sweep (the barrier and the
max), not bytes: a sweep is a few microseconds of work. Two forms, the
same bits and counts; kernels.cluster ``plan`` chooses one before each
launch. The cluster form (``jacobi_batch_cluster_kernel``) gives each
scene its own thread-block cluster of C CTAs, with no grid-wide barrier:
p' in the cluster's shared memory, ar * rhs beside it where it fits, a
thread's 4-column strip in registers, each sweep's max and edge rows
pushed with ``st.async`` onto the receivers' mbarriers (csrc/cluster.cuh,
the rounds kernel's machinery; 14 CTAs at 8x800x264 on an H100, two
waves); a scene flagged done only copies its pp0. The cooperative form
(``jacobi_batch_kernel``) takes the scenes no cluster takes: one block
of 1024 threads per SM, a grid-wide barrier per sweep, and per scene a
rotating three-slot ``atomicMax`` for the sweep's max.

In both, every exit is decided on the device and nothing is read back.
``jacobi_batch.launches`` counts launches of either form,
``.cluster_launches`` those of the cluster form.
"""
from __future__ import annotations

import torch

from ..ops.poisson import jacobi
from ..trace import traced
from ._build import check, load, on_cpu, stream_of
from .cluster import plan
from .jacobi import _multipliers


def jacobi_batch_plain(pp0, rhs, dx: float, dy: float, omega: float,
                       tol: float, iters: int, done=None):
    """ops.poisson.jacobi's masked form on the batch."""
    return jacobi(pp0, rhs, dx, dy, omega, tol, iters, early_exit=False,
                  done=done)


@traced("cfd.kernel.jacobi_batch")
def jacobi_batch(pp0, rhs, dx: float, dy: float, omega: float, tol: float,
                 iters: int, done=None, form: str | None = None,
                 ctas: int | None = None):
    """Batched masked-convergence Jacobi solve (CHANNEL p' BCs) of
    (B, ny, nx) BC-consistent ``pp0`` and ``rhs``. Returns (p' (B, ny,
    nx), err (B,), sweeps run (B,) int32); max(1, iters) sweeps at
    most. The scenes a (B,) bool ``done`` marks are not swept: p' = pp0,
    err inf, 0 sweeps. ``form`` ("cluster" or "cooperative") and
    ``ctas`` override kernels.cluster ``plan``'s choice of form, to hold
    the two against each other."""
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
    route = plan("jacobi_batch", B, ny, nx, pp0.device, form=form, ctas=ctas)
    if on_cpu("jacobi_batch", {"pp0": (pp0, (B, ny, nx)), "rhs": (rhs, (B, ny, nx))}):
        return jacobi_batch_plain(pp0, rhs, dx, dy, omega, tol, iters, done)
    lib = load()
    out = torch.empty_like(pp0)
    err = torch.empty(B, dtype=torch.float32, device=pp0.device)
    n = torch.empty(B, dtype=torch.int32, device=pp0.device)
    done_ptr = None if done is None else done.data_ptr()
    mult = _multipliers(dx, dy, omega)
    with torch.cuda.device(pp0.device):
        if route.form == "cluster":
            check(lib.cfd_jacobi_batch_cluster(
                pp0.data_ptr(), rhs.data_ptr(), done_ptr, out.data_ptr(), err.data_ptr(),
                n.data_ptr(), B, ny, nx, iters, tol, *mult, route.ctas, stream_of(pp0)),
                f"jacobi_batch (cluster form, {route.ctas} CTAs a scene)")
        else:
            tmp = torch.empty_like(pp0)
            slots = torch.empty(3 * B, dtype=torch.float32, device=pp0.device)
            check(lib.cfd_jacobi_batch(
                pp0.data_ptr(), rhs.data_ptr(), done_ptr, out.data_ptr(), tmp.data_ptr(),
                slots.data_ptr(), err.data_ptr(), n.data_ptr(), B, ny, nx, iters, tol,
                *mult, stream_of(pp0)), "jacobi_batch")
    jacobi_batch.launches += 1
    jacobi_batch.cluster_launches += route.form == "cluster"
    return out, err, n


jacobi_batch.launches = 0
jacobi_batch.cluster_launches = 0
