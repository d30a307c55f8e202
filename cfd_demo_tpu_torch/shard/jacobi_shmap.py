"""Sharded Jacobi pressure solves over a row mesh
(↔ cfd_demo_tpu/shard/jacobi_shmap.py:56-168, :235-262).

Two forms over a row-sharded p':

* :func:`jacobi_shmap`, plain: a k-row halo exchanged once per k
  sweeps, the sweeps run on each shard's extended block with the valid
  region shrinking into the halo and the p' BCs applied every sweep on
  global rows and columns; no kernel.
* :func:`jacobi_shard_body` (JAX ``jacobi_pallas_shard_body``): one
  ``halo8(k)``-row exchange, then one ``jacobi_fused_k_shard`` launch
  (TPU kernel 11, csrc/jacobi.cu) per shard per k sweeps. rhs is
  exchanged once. The exit is the fixed count, or with ``early_exit``
  and tol > 0 the launch-granular test of the max over shards of the
  last sweep's residual, read on the host once a launch (the JAX loop's
  condition is replicated, so every shard runs the same launches).
  :func:`jacobi_kernel_shmap` (JAX ``jacobi_pallas_shmap``) runs it on
  global tensors.

The bodies take and return tuples of row blocks (shard/mesh.py).
"""
from __future__ import annotations

import torch

from ..kernels.jacobi import jacobi_fused_k_shard
from ..ops.stencil import shifted
from .. import trace
from .halo import exchange_rows, global_row_index, pmax
from .mesh import RowMesh, join_rows, split_rows


def halo8(k: int) -> int:
    """A k-row halo rounded up to a multiple of 8 rows (jacobi_pallas.py:44):
    the shard blocks keep the Pallas kernels' row alignment."""
    return -(-k // 8) * 8


def _sweep_ext(ppx, rhsx, gr, gc, ny, nx, dx2, dy2, omega):
    """One damped-Jacobi sweep on a halo-extended block, with the
    reference's per-iteration p' BCs on *global* rows and columns."""
    denom = 2.0 / dx2 + 2.0 / dy2
    east = shifted(ppx, ppx.shape, 0, 1)
    west = shifted(ppx, ppx.shape, 0, -1)
    north = shifted(ppx, ppx.shape, 1, 0)
    south = shifted(ppx, ppx.shape, -1, 0)
    update = ((east + west) / dx2 + (north + south) / dy2 - rhsx) / denom
    new = omega * update + (1.0 - omega) * ppx
    interior = (gr >= 1) & (gr <= ny - 2) & (gc >= 1) & (gc <= nx - 2)
    delta = torch.where(interior, torch.abs(new - ppx), 0.0)
    ppx = torch.where(interior, new, ppx)
    ppx = torch.where(gr == 0, shifted(ppx, ppx.shape, 1, 0), ppx)
    ppx = torch.where(gr == ny - 1, shifted(ppx, ppx.shape, -1, 0), ppx)
    ppx = torch.where(gc == 0, shifted(ppx, ppx.shape, 0, 1), ppx)
    ppx = torch.where(gc == nx - 1, 0.0, ppx)
    return ppx, delta


def jacobi_shmap(pp: torch.Tensor, rhs: torch.Tensor, mesh: RowMesh, dx: float,
                 dy: float, omega: float, iters: int, k: int = 1):
    """Fixed-iteration sharded Jacobi on global (ny, nx) tensors, plain.
    Returns (p' on pp's device, the last sweep's max error over the
    shards). Requires iters % k == 0 and local rows >= k."""
    ny, nx = pp.shape
    local = ny // mesh.size
    if iters % k or local < k:
        raise ValueError(f"jacobi_shmap: iters={iters} must be a multiple of k={k} "
                         f"and local rows {local} >= k")
    dx2, dy2 = dx * dx, dy * dy
    blocks = split_rows(pp, mesh)
    rhsx = exchange_rows(split_rows(rhs, mesh), mesh, k)
    idx = [(global_row_index(local, s, k, d), torch.arange(nx, device=d)[None, :])
           for s, d in enumerate(mesh.devices)]
    errs = None
    for _ in range(iters // k):
        ppx = list(exchange_rows(blocks, mesh, k))
        errs = []
        for s, (gr, gc) in enumerate(idx):
            # Only the rows this shard owns count toward the residual; the
            # halo rows go stale as the valid region shrinks.
            owned = (gr >= s * local) & (gr < (s + 1) * local)
            for _ in range(k):
                ppx[s], delta = _sweep_ext(ppx[s], rhsx[s], gr, gc, ny, nx, dx2, dy2,
                                           omega)
                err = torch.amax(torch.where(owned, delta, 0.0))
            errs.append(err)
        blocks = tuple(x[k:k + local] for x in ppx)
    return join_rows(blocks, pp.device), pmax(errs, mesh).to(pp.device)


def fused_shard_body(kernel, halo: int, pp_blocks, rhs_blocks, mesh: RowMesh,
                     gny: int, dx: float, dy: float, omega: float, iters: int, k: int,
                     tol: float, early_exit: bool):
    """iters // k launches of a shard kernel (``jacobi_fused_k_shard`` or
    ``sor_fused_k_shard``) on every shard's ``halo``-row extended block,
    one exchange before each; rhs is exchanged once. Returns (p' blocks,
    the last launch's max error over the shards, a 0-d tensor on the
    first shard's device)."""
    local = pp_blocks[0].shape[0]
    if iters % k or local % 8 or local < halo:
        raise ValueError(f"{kernel.__name__}: iters={iters} must be a multiple of "
                         f"k={k}, and local rows {local} a multiple of 8 and >= {halo}")
    rhs_ext = exchange_rows(rhs_blocks, mesh, halo)  # launch-invariant: once
    offs = [s * local - halo for s in range(mesh.size)]

    def one_launch(blocks):
        ppx = exchange_rows(blocks, mesh, halo)
        outs, errs = zip(*(kernel(ppx[s], rhs_ext[s], offs[s], gny, dx, dy, omega, k,
                                  halo, halo + local)
                           for s in range(mesh.size)))
        return tuple(o[halo:halo + local] for o in outs), pmax(errs, mesh)

    blocks = tuple(pp_blocks)
    err = torch.full((), float("inf"), dtype=torch.float32, device=mesh.devices[0])
    for _ in range(iters // k):
        blocks, err = one_launch(blocks)
        if early_exit and tol > 0.0 and not trace.read_host(err >= tol):
            break
    return blocks, err


def jacobi_shard_body(pp_blocks, rhs_blocks, mesh: RowMesh, gny: int, dx: float,
                      dy: float, omega: float, iters: int, k: int = 10,
                      tol: float = 0.0, early_exit: bool = False):
    """The fused sharded Jacobi on row blocks of a gny-row p', a
    halo8(k)-row halo: returns (p' blocks, the last launch's max error
    over the shards). Requires iters % k == 0, local rows a multiple of 8
    and at least halo8(k)."""
    return fused_shard_body(jacobi_fused_k_shard, halo8(k), pp_blocks, rhs_blocks,
                            mesh, gny, dx, dy, omega, iters, k, tol, early_exit)


def jacobi_kernel_shmap(pp: torch.Tensor, rhs: torch.Tensor, mesh: RowMesh, dx: float,
                        dy: float, omega: float, iters: int, k: int = 10,
                        tol: float = 0.0, early_exit: bool = False):
    """:func:`jacobi_shard_body` on global (ny, nx) tensors: returns (p'
    on pp's device, the last launch's max error)."""
    blocks, err = jacobi_shard_body(split_rows(pp, mesh), split_rows(rhs, mesh), mesh,
                                    pp.shape[0], dx, dy, omega, iters, k, tol,
                                    early_exit)
    return join_rows(blocks, pp.device), err.to(pp.device)
