"""Fused damped-Jacobi sweeps as a CUDA kernel (↔ cfd_demo_tpu/kernels/jacobi_pallas.py).

``jacobi_fused_k`` replaces ``jacobi_fused_k`` (jacobi_pallas.py:968,
body ``_kernel`` :50), csrc/jacobi.cu: k damped sweeps on p' with the
multipliers ``ax, ay, ar, ac`` of jacobi_pallas.py:87-94 and folded
boundary reads (a Neumann neighbour reads the cell itself, the outlet
reads 0), the p' BCs once at the end, rows then columns, and the max
|delta| of the last sweep over interior cells. ``cavity`` takes the
kernel's CAVITY instance (jacobi_pallas.py:133-134, :185-187): the east
neighbour of column nx-2 reads the cell itself, and the BCs copy column
nx-2 into column nx-1 and pin the cell (0, 0) to 0. Folding makes the result
equal to k plain sweeps only for BC-consistent input p', which the
solver always passes (zeros or a previous solve's output).

What bounds it on the H100: a sweep needs the whole field of the
previous one, and a sweep a launch moves 12 bytes a cell through device
memory every sweep (about 50 MB at 2048², 26-28 µs a sweep, 30x the
call's bound). The kernel is temporally blocked, as the TPU kernel's VMEM
window was: a block owns a tile, loads p' and rhs over the tile and a
t-cell halo into shared memory (16-byte cp.async), runs t sweeps there
(each sweep exact on the cells one ring further in, the folds tested on
global indices, so the owned cells come out exact) and writes only its
owned cells. A call of k sweeps is ceil(k / t) launches, the remainder
last; the last one also applies the p' BCs (tiles are clamped inside the
grid, so a ring cell and the interior cell it copies share a tile) and
folds its max |delta| into err with an atomicMax. t and the tile are
constants of csrc/jacobi.cu, chosen on the card (its note and PERF.md
give the measurements); ``jacobi_tile()`` reports them. The result is
``jacobi_fused_k_folded`` (the whole field's folded sweeps in the
Pallas kernel's arithmetic, ``jacobi_fused_k_shard_plain`` on one
block) bit for bit.

``jacobi_chain`` replaces ``jacobi_pallas`` (jacobi_pallas.py:1114) and
keeps its schedule: iters//k launches of k, the tolerance checked
between them, then the iters%k remainder launch unconditionally.

``jacobi_fused_k_shard`` replaces ``jacobi_fused_k_shard``
(jacobi_pallas.py:1404, call :1450, body ``_kernel_shard`` :1293), the
sharded step's solve (shard/jacobi_shmap.py): the same k sweeps and BC
pass, one sweep a launch (csrc/jacobi.cu on sweep.cuh's per-sweep
kernels and ``Block``; the tiled form is ROADMAP work for it), on
a halo-extended (ext_ny, nx) block whose local (0, 0) is global
(row_offset, col_offset) of a (gny, gnx) grid. The offsets may be
negative: shard 0's halo lies below the grid. The interior, the folded
reads, the outlet and the BC cells are tested on global rows and
columns, and err is the last sweep's max |delta| over the owned rows
[own_lo, own_hi) and columns ``own_cols`` only. The halo's rows go stale
one ring a sweep, as the Pallas kernel's do (it rolls with wraparound at
its window's edges), and a neighbour past the block's edge reads the
cell itself here: the caller keeps the owned rows, which a halo of k
rows or more keeps exact. The column form (``col_offset``, ``gnx``,
``own_cols``) serves the 2-D tier. ``jacobi_fused_k_shard_plain`` is its
plain twin, in the Pallas kernel's arithmetic (the f32 multipliers).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.unported import CAVITY, unported
from ..ops.poisson import _apply_pprime_bcs, _apply_pprime_bcs_cavity, _jacobi_sweep
from .. import trace
from ..trace import traced
from ._build import check, load, on_cpu, stream_of


def _multipliers(dx: float, dy: float, omega: float):
    """(ax, ay, ar, ac) in double precision, rounded to f32 at the call
    as jacobi_pallas.py:87-94 rounds them."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    return (omega / (dx2 * denom), omega / (dy2 * denom), omega / denom,
            1.0 - omega)


def jacobi_fused_k_plain(pp, rhs, dx: float, dy: float, omega: float, k: int,
                         bc=_apply_pprime_bcs):
    """k ops.poisson._jacobi_sweep's with the p' BCs ``bc``; returns (p',
    last sweep's error)."""
    for _ in range(k):
        pp, err = _jacobi_sweep(pp, rhs, dx, dy, omega, bc)
    return pp, err


@traced("cfd.kernel.jacobi_fused_k")
def jacobi_fused_k(pp, rhs, dx: float, dy: float, omega: float, k: int,
                   cavity: bool = False):
    """k fused damped-Jacobi sweeps with the CHANNEL p' BCs, or with
    ``cavity`` the CAVITY ones. Returns (p', last-sweep max error as a
    0-d tensor)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    ny, nx = pp.shape
    if ny < 3 or nx < 3:
        raise ValueError(f"jacobi_fused_k needs at least 3x3 cells, got {pp.shape}")
    if on_cpu("jacobi_fused_k", {"pp": (pp, (ny, nx)), "rhs": (rhs, (ny, nx))}):
        return jacobi_fused_k_plain(pp, rhs, dx, dy, omega, k,
                                    _apply_pprime_bcs_cavity if cavity else _apply_pprime_bcs)
    lib = load()
    out, tmp = torch.empty_like(pp), torch.empty_like(pp)
    err = torch.empty((), dtype=torch.float32, device=pp.device)
    with torch.cuda.device(pp.device):
        check(lib.cfd_jacobi_fused_k(
            pp.data_ptr(), rhs.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            err.data_ptr(), ny, nx, k, *_multipliers(dx, dy, omega), int(cavity),
            stream_of(pp)), "jacobi_fused_k")
    jacobi_fused_k.launches += 1
    jacobi_fused_k.cavity_launches += cavity
    return out, err


jacobi_fused_k.launches = 0
jacobi_fused_k.cavity_launches = 0


def jacobi_tile() -> dict:
    """The CUDA kernel's constants: sweeps a launch, the owned tile's
    rows and columns, threads a block (needs the built library)."""
    out = (ctypes.c_int * 4)()
    load().cfd_jacobi_tile(out)
    return dict(zip(("sweeps", "rows", "cols", "threads"), out))


def jacobi_chain(pp0, rhs, dx: float, dy: float, omega: float, tol: float,
                 iters: int, k: int = 16, early_exit: bool = True,
                 cavity: bool = False):
    """Returns (p', last error, iterations run), exactly ``iters``
    iterations when no early exit fires.

    With ``early_exit`` and tol > 0 the error is read on the host once
    per k-launch (K-granularity exit, jacobi_pallas.py:28-30). Moving
    that test onto the device (a device-side loop or a CUDA graph) is
    later work; with tol == 0 the chain never reads back. ``cavity``
    takes the CAVITY p' BCs."""
    n_full, rem = divmod(iters, k)
    pp = pp0
    err = torch.full((), float("inf"), dtype=torch.float32, device=pp0.device)
    n_run = 0
    for _ in range(n_full):
        pp, err = jacobi_fused_k(pp, rhs, dx, dy, omega, k, cavity)
        n_run += k
        if early_exit and tol > 0.0 and not trace.read_host(err >= tol):
            break
    if rem:
        pp, err = jacobi_fused_k(pp, rhs, dx, dy, omega, rem, cavity)
        n_run += rem
    return pp, err, n_run


# ---------------------------------------------------------------------------
# The sharded tier's block form (kernel 11; kernel 14 in kernels/sor.py)
# ---------------------------------------------------------------------------

def shard_block(what: str, pp_ext, row_offset: int, gny: int, own_lo: int,
                own_hi: int, col_offset: int, gnx, own_cols, cavity: bool):
    """Validate a shard kernel's block arguments; returns the Block of
    csrc/sweep.cuh as ints (row_off, col_off, gny, gnx, own_lo, own_hi,
    own_clo, own_chi)."""
    if cavity:
        raise unported(f"the cavity p' BCs of {what}", CAVITY)
    ext_ny, nx = pp_ext.shape
    gnx = nx if gnx is None else gnx
    own_clo, own_chi = own_cols if own_cols is not None else (0, nx)
    if gny < 3 or gnx < 3:
        raise ValueError(f"{what} needs a grid of at least 3x3 cells, got {gny}x{gnx}")
    if not (0 <= own_lo < own_hi <= ext_ny and 0 <= own_clo < own_chi <= nx):
        raise ValueError(f"{what}: owned rows [{own_lo}, {own_hi}) and columns "
                         f"[{own_clo}, {own_chi}) outside the ({ext_ny}, {nx}) block")
    return (int(row_offset), int(col_offset), gny, gnx, own_lo, own_hi, own_clo,
            own_chi)


def block_indices(shape, blk, device):
    """Global row (rows, 1) and column (1, cols) indices of a block."""
    row_off, col_off = blk[:2]
    gr = torch.arange(row_off, row_off + shape[0], device=device)[:, None]
    gc = torch.arange(col_off, col_off + shape[1], device=device)[None, :]
    return gr, gc


def block_masks(shape, blk, device):
    """(interior, owned): the global interior cells of a block, and those
    of them in its owned rows and columns."""
    _, _, gny, gnx, own_lo, own_hi, own_clo, own_chi = blk
    gr, gc = block_indices(shape, blk, device)
    lr = torch.arange(shape[0], device=device)[:, None]
    lc = torch.arange(shape[1], device=device)[None, :]
    interior = (gr >= 1) & (gr <= gny - 2) & (gc >= 1) & (gc <= gnx - 2)
    owned = (interior & (lr >= own_lo) & (lr < own_hi)
             & (lc >= own_clo) & (lc < own_chi))
    return interior, owned


def _edge_shift(x, dim: int, step: int):
    """x shifted by ``step`` along ``dim`` (out[j] = x[j + step]), the
    edge cell reading itself."""
    n = x.shape[dim]
    if step > 0:
        return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)


def folded_neighbours(pp, blk, cavity: bool = False):
    """(E, W, N, S) of every cell of a block with the kernels' folds
    (sweep.cuh ``folded``): a Neumann neighbour reads the cell itself,
    the outlet reads 0 (with ``cavity`` the cell itself too), a neighbour
    past the block's edge the cell."""
    gny, gnx = blk[2], blk[3]
    gr, gc = block_indices(pp.shape, blk, pp.device)
    east_fold = pp if cavity else pp.new_zeros(())
    E = torch.where(gc == gnx - 2, east_fold, _edge_shift(pp, 1, 1))
    W = torch.where(gc == 1, pp, _edge_shift(pp, 1, -1))
    N = torch.where(gr == gny - 2, pp, _edge_shift(pp, 0, 1))
    S = torch.where(gr == 1, pp, _edge_shift(pp, 0, -1))
    return E, W, N, S


def block_pprime_bcs(pp, blk, cavity: bool = False):
    """The p' BCs on a block's global boundary cells, in the Pallas
    kernels' order (jacobi_pallas.py:1388-1396, :185-187): the bottom and
    top rows from their neighbours, then the left column from column 1,
    then the outlet 0, or with ``cavity`` the right column from column
    nx-2 and the cell (0, 0) pinned to 0; a corner takes the diagonal
    cell."""
    gny, gnx = blk[2], blk[3]
    gr, gc = block_indices(pp.shape, blk, pp.device)
    pp = torch.where(gr == 0, _edge_shift(pp, 0, 1), pp)
    pp = torch.where(gr == gny - 1, _edge_shift(pp, 0, -1), pp)
    pp = torch.where(gc == 0, _edge_shift(pp, 1, 1), pp)
    if not cavity:
        return torch.where(gc == gnx - 1, pp.new_zeros(()), pp)
    pp = torch.where(gc == gnx - 1, _edge_shift(pp, 1, -1), pp)
    return torch.where((gr == 0) & (gc == 0), pp.new_zeros(()), pp)


def jacobi_fused_k_shard_plain(pp_ext, rhs_ext, row_offset: int, gny: int, dx: float,
                               dy: float, omega: float, k: int, own_lo: int,
                               own_hi: int, cavity: bool = False, col_offset: int = 0,
                               gnx=None, own_cols=None):
    """k folded sweeps on the block in the Pallas kernel's arithmetic
    (jacobi_pallas.py:1318-1372: ax (E + W) + ay (N + S) + ac p' - ar
    rhs), the BCs once; returns (block, last sweep's owned max |delta|).
    Cells that are not global interior cells keep their values until the
    BC pass."""
    blk = shard_block("jacobi_fused_k_shard", pp_ext, row_offset, gny, own_lo,
                      own_hi, col_offset, gnx, own_cols, cavity)
    return _folded_sweeps(pp_ext, rhs_ext, blk, dx, dy, omega, k, False)


def _folded_sweeps(pp_ext, rhs_ext, blk, dx, dy, omega, k, cavity):
    """jacobi_fused_k_shard_plain's sweeps and BCs on a validated block."""
    ax, ay, ar, ac = (torch.tensor(np.float32(c), device=pp_ext.device)
                      for c in _multipliers(dx, dy, omega))
    interior, owned = block_masks(pp_ext.shape, blk, pp_ext.device)
    rhs_s = ar * rhs_ext
    pp, zero = pp_ext, pp_ext.new_zeros(())
    for _ in range(k):
        E, W, N, S = folded_neighbours(pp, blk, cavity)
        new = ax * (E + W) + ay * (N + S) + ac * pp - rhs_s
        err = torch.amax(torch.where(owned, torch.abs(new - pp), zero))
        pp = torch.where(interior, new, pp)
    return block_pprime_bcs(pp, blk, cavity), err


def jacobi_fused_k_folded(pp, rhs, dx: float, dy: float, omega: float, k: int,
                          cavity: bool = False):
    """The whole field's k folded sweeps in the Pallas kernel's arithmetic
    and the p' BCs of CHANNEL flow, or with ``cavity`` of CAVITY flow:
    what kernel 2 computes, bit for bit (``jacobi_fused_k_shard_plain``
    on one block holding the grid)."""
    ny, nx = pp.shape
    blk = (0, 0, ny, nx, 0, ny, 0, nx)
    return _folded_sweeps(pp, rhs, blk, dx, dy, omega, k, cavity)


@traced("cfd.kernel.jacobi_fused_k_shard")
def jacobi_fused_k_shard(pp_ext, rhs_ext, row_offset: int, gny: int, dx: float,
                         dy: float, omega: float, k: int, own_lo: int, own_hi: int,
                         cavity: bool = False, col_offset: int = 0, gnx=None,
                         own_cols=None):
    """k fused damped-Jacobi sweeps (CHANNEL p' BCs) on a halo-extended
    block at global offsets. Returns (the block, the last sweep's max
    |delta| over the owned cells as a 0-d tensor); keep its owned rows."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    blk = shard_block("jacobi_fused_k_shard", pp_ext, row_offset, gny, own_lo,
                      own_hi, col_offset, gnx, own_cols, cavity)
    shape = tuple(pp_ext.shape)
    if on_cpu("jacobi_fused_k_shard", {"pp_ext": (pp_ext, shape),
                                       "rhs_ext": (rhs_ext, shape)}):
        return jacobi_fused_k_shard_plain(pp_ext, rhs_ext, row_offset, gny, dx, dy,
                                          omega, k, own_lo, own_hi, cavity,
                                          col_offset, gnx, own_cols)
    lib = load()
    ny, nx = shape
    out, tmp = torch.empty_like(pp_ext), torch.empty_like(pp_ext)
    partials = torch.empty(lib.cfd_jacobi_partials(ny, nx), dtype=torch.float32,
                           device=pp_ext.device)
    err = torch.empty((), dtype=torch.float32, device=pp_ext.device)
    with torch.cuda.device(pp_ext.device):
        check(lib.cfd_jacobi_fused_k_shard(
            pp_ext.data_ptr(), rhs_ext.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            partials.data_ptr(), err.data_ptr(), ny, nx, k, *blk,
            *_multipliers(dx, dy, omega), stream_of(pp_ext)), "jacobi_fused_k_shard")
    jacobi_fused_k_shard.launches += 1
    return out, err


jacobi_fused_k_shard.launches = 0
