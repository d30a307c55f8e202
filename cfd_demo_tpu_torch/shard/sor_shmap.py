"""Sharded red/black SOR over a row mesh (↔ cfd_demo_tpu/shard/sor_shmap.py:23-96).

The sharded form of the SOR solver (ops.poisson.sor): each fused-k
launch of ``sor_fused_k_shard`` (TPU kernel 14, csrc/sor.cu) consumes a
2k-row halo -- the black half reads the red half's updated values, so
validity shrinks two rings an iteration -- exchanged once per launch.
The structure, the exits and the arguments are those of
shard/jacobi_shmap.py :func:`~.jacobi_shmap.jacobi_shard_body`.
"""
from __future__ import annotations

import torch

from ..kernels.sor import sor_fused_k_shard
from .jacobi_shmap import fused_shard_body, halo8
from .mesh import RowMesh, join_rows, split_rows


def sor_shard_body(pp_blocks, rhs_blocks, mesh: RowMesh, gny: int, dx: float,
                   dy: float, omega: float, iters: int, k: int = 5, tol: float = 0.0,
                   early_exit: bool = False):
    """The fused sharded SOR on row blocks of a gny-row p', a
    halo8(2k)-row halo: returns (p' blocks, the last launch's max error
    over the shards). Requires iters % k == 0, local rows a multiple of 8
    and at least halo8(2k)."""
    return fused_shard_body(sor_fused_k_shard, halo8(2 * k), pp_blocks, rhs_blocks,
                            mesh, gny, dx, dy, omega, iters, k, tol, early_exit)


def sor_kernel_shmap(pp: torch.Tensor, rhs: torch.Tensor, mesh: RowMesh, dx: float,
                     dy: float, omega: float, iters: int, k: int = 5, tol: float = 0.0,
                     early_exit: bool = False):
    """:func:`sor_shard_body` on global (ny, nx) tensors (JAX
    ``sor_pallas_shmap``): returns (p' on pp's device, the error)."""
    blocks, err = sor_shard_body(split_rows(pp, mesh), split_rows(rhs, mesh), mesh,
                                 pp.shape[0], dx, dy, omega, iters, k, tol, early_exit)
    return join_rows(blocks, pp.device), err.to(pp.device)
