"""Fused red/black SOR iterations as CUDA kernels
(↔ cfd_demo_tpu/kernels/sor_pallas.py).

``sor_fused_k`` replaces ``sor_fused_k`` (sor_pallas.py:352, body
``_kernel`` :37), and ``sor_fused_k_rb2`` replaces ``sor_fused_k_rb2``
(sor_pallas.py:916, body ``_kernel_rb2`` :707), both in csrc/sor.cu: k
red/black iterations on p' with the multipliers of sor_pallas.py:75-79
and folded boundary reads (a Neumann neighbour reads the cell itself,
the outlet reads 0), the p' BCs once at the end, rows then columns, and
the max |change| of the last iteration over interior cells. Folding
makes the result equal to k plain iterations only for BC-consistent
input p', which the solver always passes.

A colour half reads only the other colour, and each cell of the half
only its own value besides: the half is race-free in place, so a launch
sweeps one half on the card and the launch boundary is the barrier
between halves. The wrapper copies p' into its output and sweeps that,
so the caller's tensor is never changed. Each cell takes its |change|
at its own update; the last iteration's blocks write their maxima, and
one block then applies the BCs and reduces them. A call is 2k + 1
launches. What bounds it is bytes: a full-layout half reads p' and rhs
and writes its colour, whose cells are every other float of a row, so
it moves about the whole of all three arrays (about 50 MB at 2048²).
The colour-split layout (``sor_compress``: red[j, t] = p[j, 2t + (j&1)],
black[j, t] = p[j, 2t + 1 - (j&1)]) stores each colour contiguously at
half width: a half then reads its own colour, the other colour and its
rhs colour and writes its own, four half-width arrays (about 34 MB at
2048²), two thirds of the full layout's bytes. That is the reason for
the split on the H100, not the TPU's lane rolls it was made for. The
split and its inverse are plain strided PyTorch, once per chain, as they
were XLA outside the kernel on the TPU. Keeping k iterations in shared
memory on a tile with a 2k-row halo, the TPU kernel's design, is later
work.

``sor_fused_k_shard`` replaces ``sor_fused_k_shard`` (sor_pallas.py:569,
call :609, body ``_kernel_shard`` :452), the sharded step's SOR solve
(shard/sor_shmap.py): kernel 13's iterations and BC pass (csrc/sor.cu,
the full layout) on a halo-extended block at global row and column
offsets, as ``kernels.jacobi.jacobi_fused_k_shard`` is kernel 2's. The
colour is the parity of the global row plus column (sor_pallas.py:483-494),
so a shard colours its cells as the whole grid does; err counts the
owned cells; the halo, two rings stale an iteration, spans 2k rows, and
the caller keeps the owned rows. The colour-split layout is not used
here: a block's parity depends on its offset.

``sor_chain`` replaces ``sor_pallas`` (sor_pallas.py:641) and
``sor_chain_rb2`` replaces ``sor_pallas_rb2`` (sor_pallas.py:958), with
their schedules: iters // k launches of k, the tolerance checked
between them when it is live, then the iters % k remainder; on a fixed
schedule the rb2 chain folds the remainder into its last launch
(sor_pallas.py:981-986).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.poisson import _sor_sweep
from .. import trace
from ..trace import span, traced
from ._build import check, load, on_cpu, stream_of
from .jacobi import block_indices, block_masks, block_pprime_bcs, folded_neighbours, shard_block


def _coefficients(dx: float, dy: float, omega: float):
    """(bx, by, br, om, 1 - om), each an f32 value as sor_pallas.py:75-79
    rounds it; 1 - om is taken in f32, as ``1.0 - om`` is there."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    om = np.float32(omega)
    return tuple(float(np.float32(x)) for x in (
        1.0 / (dx2 * denom), 1.0 / (dy2 * denom), 1.0 / denom, om,
        np.float32(1.0) - om))


def _check_k(what: str, k: int, ny: int, nx: int) -> None:
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1, got {k}")
    if ny < 3 or nx < 3:
        raise ValueError(f"{what} needs at least 3x3 cells, got {ny}x{nx}")


def sor_fused_k_plain(pp, rhs, dx: float, dy: float, omega: float, k: int):
    """k ops.poisson._sor_sweep's; returns (p', last iteration's error)."""
    for _ in range(k):
        pp, err = _sor_sweep(pp, rhs, dx, dy, omega)
    return pp, err


@traced("cfd.kernel.sor_fused_k")
def sor_fused_k(pp, rhs, dx: float, dy: float, omega: float, k: int):
    """k fused red/black SOR iterations (CHANNEL p' BCs) on the full
    layout. Returns (p', last-iteration max error as a 0-d tensor)."""
    ny, nx = pp.shape
    _check_k("sor_fused_k", k, ny, nx)
    if on_cpu("sor_fused_k", {"pp": (pp, (ny, nx)), "rhs": (rhs, (ny, nx))}):
        return sor_fused_k_plain(pp, rhs, dx, dy, omega, k)
    lib = load()
    out = pp.clone()
    partials = torch.empty(lib.cfd_sor_partials(ny, nx), dtype=torch.float32,
                           device=pp.device)
    err = torch.empty((), dtype=torch.float32, device=pp.device)
    with torch.cuda.device(pp.device):
        check(lib.cfd_sor_fused_k(
            out.data_ptr(), rhs.data_ptr(), partials.data_ptr(), err.data_ptr(),
            ny, nx, k, *_coefficients(dx, dy, omega), stream_of(pp)), "sor_fused_k")
    sor_fused_k.launches += 1
    return out, err


sor_fused_k.launches = 0


def sor_chain(pp0, rhs, dx: float, dy: float, omega: float, tol: float,
              iters: int, k: int = 8, early_exit: bool = True):
    """Returns (p', last error, iterations run), exactly ``iters``
    iterations when no early exit fires; the iterations are also added to
    ``trace.sor_iterations``. With ``early_exit`` and tol > 0
    the error is read on the host once per k-launch (K-granularity
    exit); with tol == 0 the chain never reads back."""
    n_full, rem = divmod(iters, k)
    pp = pp0
    err = torch.full((), float("inf"), dtype=torch.float32, device=pp0.device)
    n_run = 0
    for _ in range(n_full):
        pp, err = sor_fused_k(pp, rhs, dx, dy, omega, k)
        n_run += k
        if early_exit and tol > 0.0 and not trace.read_host(err >= tol):
            break
    if rem:
        pp, err = sor_fused_k(pp, rhs, dx, dy, omega, rem)
        n_run += rem
    trace.sor_iterations += n_run
    return pp, err, n_run


def sor_fused_k_shard_plain(pp_ext, rhs_ext, row_offset: int, gny: int, dx: float,
                            dy: float, omega: float, k: int, own_lo: int, own_hi: int,
                            cavity: bool = False, col_offset: int = 0, gnx=None,
                            own_cols=None):
    """k red/black iterations on the block in the Pallas kernel's
    arithmetic (sor_pallas.py:519-531: (1 - om) p' + om (bx (E + W) + by
    (N + S) - br rhs), red then black by global parity), the BCs once;
    returns (block, last iteration's owned max |change|)."""
    blk = shard_block("sor_fused_k_shard", pp_ext, row_offset, gny, own_lo, own_hi,
                      col_offset, gnx, own_cols, cavity)
    bx, by, br, om, omc = (torch.tensor(np.float32(c), device=pp_ext.device)
                           for c in _coefficients(dx, dy, omega))
    interior, owned = block_masks(pp_ext.shape, blk, pp_ext.device)
    gr, gc = block_indices(pp_ext.shape, blk, pp_ext.device)
    par = (gr + gc) % 2
    rhs_s = br * rhs_ext
    pp, zero = pp_ext, pp_ext.new_zeros(())

    def half(pp, mask):
        E, W, N, S = folded_neighbours(pp, blk)
        new = omc * pp + om * (bx * (E + W) + by * (N + S) - rhs_s)
        return torch.where(mask, new, pp)

    for _ in range(k):
        old = pp
        pp = half(half(pp, interior & (par == 0)), interior & (par == 1))
        err = torch.amax(torch.where(owned, torch.abs(pp - old), zero))
    return block_pprime_bcs(pp, blk), err


@traced("cfd.kernel.sor_fused_k_shard")
def sor_fused_k_shard(pp_ext, rhs_ext, row_offset: int, gny: int, dx: float, dy: float,
                      omega: float, k: int, own_lo: int, own_hi: int,
                      cavity: bool = False, col_offset: int = 0, gnx=None,
                      own_cols=None):
    """k fused red/black SOR iterations (CHANNEL p' BCs) on a
    halo-extended block at global offsets. Returns (the block, the last
    iteration's max |change| over the owned cells as a 0-d tensor); keep
    its owned rows."""
    if k < 1:
        raise ValueError(f"sor_fused_k_shard: k must be >= 1, got {k}")
    blk = shard_block("sor_fused_k_shard", pp_ext, row_offset, gny, own_lo, own_hi,
                      col_offset, gnx, own_cols, cavity)
    shape = tuple(pp_ext.shape)
    if on_cpu("sor_fused_k_shard", {"pp_ext": (pp_ext, shape),
                                    "rhs_ext": (rhs_ext, shape)}):
        return sor_fused_k_shard_plain(pp_ext, rhs_ext, row_offset, gny, dx, dy, omega,
                                       k, own_lo, own_hi, cavity, col_offset, gnx,
                                       own_cols)
    lib = load()
    ny, nx = shape
    out = pp_ext.clone()
    partials = torch.empty(lib.cfd_sor_partials(ny, nx), dtype=torch.float32,
                           device=pp_ext.device)
    err = torch.empty((), dtype=torch.float32, device=pp_ext.device)
    with torch.cuda.device(pp_ext.device):
        check(lib.cfd_sor_fused_k_shard(
            out.data_ptr(), rhs_ext.data_ptr(), partials.data_ptr(), err.data_ptr(),
            ny, nx, k, *blk, *_coefficients(dx, dy, omega), stream_of(pp_ext)),
            "sor_fused_k_shard")
    sor_fused_k_shard.launches += 1
    return out, err


sor_fused_k_shard.launches = 0


# ---------------------------------------------------------------------------
# The colour-split layout
# ---------------------------------------------------------------------------

def _row_odd(ny: int, device) -> torch.Tensor:
    return (torch.arange(ny, device=device) % 2 == 1)[:, None]


def sor_compress(x):
    """(ny, nx even) -> (red, black) half-width arrays (sor_pallas.py:859):
    red[j, t] = x[j, 2t + (j&1)], black[j, t] = x[j, 2t + 1 - (j&1)]."""
    ny, nx = x.shape
    if nx % 2:
        raise ValueError(f"sor_compress needs an even nx, got {nx}")
    a, b = x[:, 0::2], x[:, 1::2]
    rodd = _row_odd(ny, x.device)
    return torch.where(rodd, b, a), torch.where(rodd, a, b)


def sor_decompress(xr, xb):
    """Inverse of :func:`sor_compress` (sor_pallas.py:876)."""
    ny, nxc = xr.shape
    rodd = _row_odd(ny, xr.device)
    even_c = torch.where(rodd, xb, xr)
    odd_c = torch.where(rodd, xr, xb)
    return torch.stack([even_c, odd_c], dim=2).reshape(ny, 2 * nxc)


def sor_fused_k_rb2_plain(pr, pb, rr, rb, dx: float, dy: float, omega: float,
                          k: int):
    """k plain iterations on the full layout between a decompress and a
    compress; returns (pr', pb', last iteration's error)."""
    pp, err = sor_fused_k_plain(sor_decompress(pr, pb), sor_decompress(rr, rb),
                                dx, dy, omega, k)
    return (*sor_compress(pp), err)


@traced("cfd.kernel.sor_fused_k_rb2")
def sor_fused_k_rb2(pr, pb, rr, rb, dx: float, dy: float, omega: float, k: int):
    """k fused red/black SOR iterations on the colour-split arrays
    (ny, nx/2) of a (ny, nx) field (``sor_compress``). Returns (pr', pb',
    last iteration max error as a 0-d tensor)."""
    ny, nxc = pr.shape
    nx = 2 * nxc
    _check_k("sor_fused_k_rb2", k, ny, nx)
    shape = (ny, nxc)
    if on_cpu("sor_fused_k_rb2", {"pr": (pr, shape), "pb": (pb, shape),
                                  "rr": (rr, shape), "rb": (rb, shape)}):
        return sor_fused_k_rb2_plain(pr, pb, rr, rb, dx, dy, omega, k)
    lib = load()
    pr2, pb2 = pr.clone(), pb.clone()
    partials = torch.empty(lib.cfd_sor_rb2_partials(ny, nx), dtype=torch.float32,
                           device=pr.device)
    err = torch.empty((), dtype=torch.float32, device=pr.device)
    with torch.cuda.device(pr.device):
        check(lib.cfd_sor_fused_k_rb2(
            pr2.data_ptr(), pb2.data_ptr(), rr.data_ptr(), rb.data_ptr(),
            partials.data_ptr(), err.data_ptr(), ny, nx, k,
            *_coefficients(dx, dy, omega), stream_of(pr)), "sor_fused_k_rb2")
    sor_fused_k_rb2.launches += 1
    return pr2, pb2, err


sor_fused_k_rb2.launches = 0


def sor_chain_rb2(pp0, rhs, dx: float, dy: float, omega: float, tol: float,
                  iters: int, k: int = 8, early_exit: bool = True):
    """ops.poisson.sor through the colour-split chain: split p' and rhs
    once, iters // k launches of k, then the remainder, and join once
    (the split and the join each inside a ``cfd.sor.layout`` span).
    Returns (p', last error, iterations run), the iterations also added
    to ``trace.sor_iterations``. On the fixed schedule (no
    live tolerance) the remainder folds into the last launch, [k, ..., k,
    k + iters % k]: the same iterations, one launch fewer. With
    ``early_exit`` and tol > 0 the launches stay uniform-k plus the
    remainder, and the error is read on the host once per k-launch."""
    with span("cfd.sor.layout"):
        pr, pb = sor_compress(pp0)
        rr, rb = sor_compress(rhs)
    n_full, rem = divmod(iters, k)
    adaptive = early_exit and tol > 0.0 and n_full > 0
    sizes = [k] * n_full
    if rem and n_full and not adaptive:
        sizes[-1], rem = k + rem, 0
    err = torch.full((), float("inf"), dtype=torch.float32, device=pp0.device)
    n_run = 0
    for size in sizes:
        pr, pb, err = sor_fused_k_rb2(pr, pb, rr, rb, dx, dy, omega, size)
        n_run += size
        if adaptive and not trace.read_host(err >= tol):
            break
    if rem:
        pr, pb, err = sor_fused_k_rb2(pr, pb, rr, rb, dx, dy, omega, rem)
        n_run += rem
    trace.sor_iterations += n_run
    with span("cfd.sor.layout"):
        pp = sor_decompress(pr, pb)
    return pp, err, n_run
