"""The aligned MG_PRODUCTION cycle's fused smoothers as CUDA kernels
(↔ cfd_demo_tpu/kernels/jacobi_pallas.py), csrc/mgp.cu.

- ``jacobi_fused_k_res`` replaces ``jacobi_fused_k_res``
  (jacobi_pallas.py:363, body ``_kernel_res`` :200): k damped sweeps of
  the full p' array with folded boundary reads, the residual
  r = rhs - A p of the final iterate (written unless ``emit_res`` is
  False) and max|r| over the interior, then the p' BCs.
- ``jacobi_fused_k_restrict`` replaces ``jacobi_fused_k_restrict``
  (:444, ``_kernel_res`` with ``emit_restrict``): the same sweeps, then
  the residual restricted to the first coarse level, returned compact as
  ((ny-2)//2, (nx-2)//2), where the TPU kernel returns half rows at lane
  width for a strided slice to take apart.
- ``jacobi_fused_k_corr`` replaces ``jacobi_fused_k_corr`` (:681,
  ``_kernel_corr`` :533): the y pass of the last prolongation of the
  coarse correction, given its x pass ``row`` of ((ny-2)//2, nx-2), added
  on the interior; k sweeps; max|r| and max|p'|.
- ``cc_sweeps`` replaces ``cc_sweeps_pallas`` (:1734, ``_kernel_cc``
  :1639): k damped sweeps of the folded cell-centred operator of a coarse
  level, outlet diagonal (1 + dx/d)/dx^2 + 2/dy^2 when d != dx, in the
  reciprocal-multiplier form; optionally the residual.

Each kernel takes CHANNEL or CAVITY flow: ``cavity`` on the three
fine-level kernels (jacobi_pallas.py:302, :334-340, :639, :661) folds
the east neighbour of column nx-2 to the cell itself and gives the ring
the cavity's BCs (column nx-2 copied into column nx-1, the cell (0, 0)
pinned to 0); ``east_dirichlet`` False on ``cc_sweeps`` (:1690, :1704,
:1751) mirrors the coarse level's east edge instead of reading the
outlet's 0 ghost, with a uniform diagonal. On the card each is a
template flag of the kernel (csrc/sweep.cuh, csrc/mgp.cu), counted in
the wrapper's ``cavity_launches`` too.

The sweeps use the TPU kernels' multipliers (``ax, ay, ar, ac``,
jacobi_pallas.py:268-274; ``bx, by, denom`` for the residual; ``inv_dg``
for the coarse levels, :1670-1680), so each kernel differs from its plain
version by a few ulps per sweep. The folded reads equal the plain sweep
and BCs only on BC-consistent p', which the cycle always passes; the
corr kernel adds the correction first and still never reads the ring, so
its final BC refresh gives bc(p + e) (jacobi_pallas.py:549-553).

Bound: each is bound by device-memory bytes. A 2048² sweep reads p' and
rhs and writes p' (12 bytes a cell, about 50 MB), and each sweep needs
the whole previous one. This first version runs one sweep per launch,
ping-ponging two buffers (the launch boundary is the grid-wide barrier),
then one launch for the residual (with the restriction, or with max|p'|)
and one block for the BCs and the maxima: k + 2 launches, k + 3 for corr.
A tiled shared-memory form with a (k+1)-cell halo (one more row for the
restriction's y pair), the TPU kernels' design, is later work.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises, and adds one to its ``launches``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.poisson import (_apply_pprime_bcs, _apply_pprime_bcs_cavity, _cc_prolong_y,
                           _cc_residual, _cc_restrict, _cc_sweeps, _mg_residual,
                           _mgp_smooth)
from ..trace import traced
from ._build import check, load, on_cpu, stream_of
from .jacobi import _multipliers


class Smoothers(NamedTuple):
    """The aligned cycle's four smoothers (ops.poisson._smoothers)."""

    res: object
    restrict: object
    corr: object
    cc: object


def _residual_multipliers(dx: float, dy: float):
    """(bx, by, denom) of the fused residual (jacobi_pallas.py:268-274)."""
    dx2, dy2 = dx * dx, dy * dy
    return 1.0 / dx2, 1.0 / dy2, 2.0 / dx2 + 2.0 / dy2


def _check_fine(what, pp, k):
    if k < 0:
        raise ValueError(f"{what}: k must be >= 0, got {k}")
    if pp.dim() != 2 or pp.shape[0] < 3 or pp.shape[1] < 3:
        raise ValueError(f"{what} needs a 2-D array of at least 3x3 cells, "
                         f"got {tuple(pp.shape)}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def pprime_bcs(cavity: bool):
    """The p' BCs of CAVITY flow when ``cavity``, else CHANNEL's."""
    return _apply_pprime_bcs_cavity if cavity else _apply_pprime_bcs


def jacobi_fused_k_res_plain(pp, rhs, dx, dy, omega, k, emit_res=True, cavity=False):
    """ops.poisson._mgp_smooth (with the cavity's p' BCs when ``cavity``)
    + _mg_residual; (p', r or None, max|r|)."""
    p = _mgp_smooth(pp, rhs, dx, dy, omega, k, pprime_bcs(cavity))
    r = _mg_residual(p, rhs, dx, dy)
    return p, (r if emit_res else None), torch.amax(torch.abs(r))


def jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, omega, k, cavity=False):
    """As jacobi_fused_k_res_plain, with the interior residual restricted
    by ops.poisson._cc_restrict; (p', r_c, max|r|)."""
    p, r, err = jacobi_fused_k_res_plain(pp, rhs, dx, dy, omega, k, True, cavity)
    return p, _cc_restrict(r[1:-1, 1:-1]).contiguous(), err


def jacobi_fused_k_corr_plain(pp, rhs, row, dx, dy, omega, k, cavity=False):
    """bc(p' + pad(_cc_prolong_y(row))), then the res smoother without
    the residual array (ops/poisson.py:1052-1056); (p', max|r|, max|p'|)."""
    e = torch.nn.functional.pad(_cc_prolong_y(row, pp.shape[0] - 2),
                                (1, 1, 1, 1))
    p = pprime_bcs(cavity)(pp + e)
    p, _, err = jacobi_fused_k_res_plain(p, rhs, dx, dy, omega, k, False, cavity)
    return p, err, torch.amax(torch.abs(p))


def cc_sweeps_plain(p, rhs, dx, dy, omega, k, d_wall, emit_res=False,
                    east_dirichlet=True):
    """ops.poisson._cc_sweeps (+ _cc_residual); (p, r or None)."""
    p = _cc_sweeps(p, rhs, dx, dy, omega, k, d_wall, east_dirichlet)
    r = _cc_residual(p, rhs, dx, dy, d_wall, east_dirichlet) if emit_res else None
    return p, r


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@traced("cfd.kernel.jacobi_fused_k_res")
def jacobi_fused_k_res(pp, rhs, dx, dy, omega, k, emit_res=True, cavity=False):
    """k fused sweeps + the residual; (p', r or None, max|r| as 0-d)."""
    _check_fine("jacobi_fused_k_res", pp, k)
    ny, nx = pp.shape
    if on_cpu("jacobi_fused_k_res", {"pp": (pp, (ny, nx)), "rhs": (rhs, (ny, nx))}):
        return jacobi_fused_k_res_plain(pp, rhs, dx, dy, omega, k, emit_res, cavity)
    lib = load()
    out, tmp = torch.empty_like(pp), torch.empty_like(pp)
    r = torch.empty_like(pp) if emit_res else None
    parts = torch.empty(lib.cfd_jacobi_partials(ny, nx), device=pp.device, dtype=torch.float32)
    err = torch.empty((), device=pp.device, dtype=torch.float32)
    with torch.cuda.device(pp.device):
        check(lib.cfd_mgp_res(
            pp.data_ptr(), rhs.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            r.data_ptr() if emit_res else None, parts.data_ptr(), err.data_ptr(),
            ny, nx, k, *_multipliers(dx, dy, omega), *_residual_multipliers(dx, dy),
            int(cavity), stream_of(pp)), "jacobi_fused_k_res")
    jacobi_fused_k_res.launches += 1
    jacobi_fused_k_res.cavity_launches += cavity
    return out, r, err


jacobi_fused_k_res.launches = 0
jacobi_fused_k_res.cavity_launches = 0


@traced("cfd.kernel.jacobi_fused_k_restrict")
def jacobi_fused_k_restrict(pp, rhs, dx, dy, omega, k, cavity=False):
    """k fused sweeps + the restricted residual; (p', r_c of
    ((ny-2)//2, (nx-2)//2), max|r| as 0-d). Even ny and nx."""
    _check_fine("jacobi_fused_k_restrict", pp, k)
    ny, nx = pp.shape
    if ny % 2 or nx % 2:
        raise ValueError(f"jacobi_fused_k_restrict needs even ny and nx, "
                         f"got {ny}x{nx}")
    if on_cpu("jacobi_fused_k_restrict",
              {"pp": (pp, (ny, nx)), "rhs": (rhs, (ny, nx))}):
        return jacobi_fused_k_restrict_plain(pp, rhs, dx, dy, omega, k, cavity)
    lib = load()
    ncy, ncx = (ny - 2) // 2, (nx - 2) // 2
    out, tmp = torch.empty_like(pp), torch.empty_like(pp)
    rc = torch.empty((ncy, ncx), device=pp.device, dtype=torch.float32)
    parts = torch.empty(lib.cfd_jacobi_partials(ncy, ncx), device=pp.device,
                        dtype=torch.float32)
    err = torch.empty((), device=pp.device, dtype=torch.float32)
    with torch.cuda.device(pp.device):
        check(lib.cfd_mgp_restrict(
            pp.data_ptr(), rhs.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            rc.data_ptr(), parts.data_ptr(), err.data_ptr(), ny, nx, k,
            *_multipliers(dx, dy, omega), *_residual_multipliers(dx, dy),
            int(cavity), stream_of(pp)), "jacobi_fused_k_restrict")
    jacobi_fused_k_restrict.launches += 1
    jacobi_fused_k_restrict.cavity_launches += cavity
    return out, rc, err


jacobi_fused_k_restrict.launches = 0
jacobi_fused_k_restrict.cavity_launches = 0


@traced("cfd.kernel.jacobi_fused_k_corr")
def jacobi_fused_k_corr(pp, rhs, row, dx, dy, omega, k, cavity=False):
    """Correction (y pass of ``row``, ((ny-2)//2, nx-2)) + k fused
    sweeps; (p', max|r|, max|p'|) with 0-d maxima. Even ny and nx."""
    _check_fine("jacobi_fused_k_corr", pp, k)
    ny, nx = pp.shape
    if ny % 2 or nx % 2:
        raise ValueError(f"jacobi_fused_k_corr needs even ny and nx, "
                         f"got {ny}x{nx}")
    if on_cpu("jacobi_fused_k_corr", {"pp": (pp, (ny, nx)), "rhs": (rhs, (ny, nx)),
                                      "row": (row, ((ny - 2) // 2, nx - 2))}):
        return jacobi_fused_k_corr_plain(pp, rhs, row, dx, dy, omega, k, cavity)
    lib = load()
    out, tmp = torch.empty_like(pp), torch.empty_like(pp)
    n = lib.cfd_jacobi_partials(ny, nx)
    part_r = torch.empty(n, device=pp.device, dtype=torch.float32)
    part_p = torch.empty(n, device=pp.device, dtype=torch.float32)
    err = torch.empty((), device=pp.device, dtype=torch.float32)
    pmax = torch.empty((), device=pp.device, dtype=torch.float32)
    with torch.cuda.device(pp.device):
        check(lib.cfd_mgp_corr(
            pp.data_ptr(), rhs.data_ptr(), row.data_ptr(), out.data_ptr(),
            tmp.data_ptr(), part_r.data_ptr(), part_p.data_ptr(), err.data_ptr(),
            pmax.data_ptr(), ny, nx, k, *_multipliers(dx, dy, omega),
            *_residual_multipliers(dx, dy), int(cavity), stream_of(pp)),
            "jacobi_fused_k_corr")
    jacobi_fused_k_corr.launches += 1
    jacobi_fused_k_corr.cavity_launches += cavity
    return out, err, pmax


jacobi_fused_k_corr.launches = 0
jacobi_fused_k_corr.cavity_launches = 0


def _cc_multipliers(dx, dy, omega, d_wall, east_dirichlet=True):
    """(bx, by, om, 1 - om, inv_dg, inv_dg_last, dg, dg_last) as f32,
    rounded as _kernel_cc rounds them (jacobi_pallas.py:1670-1680, :1751):
    with an outlet extra term (an outlet, d != dx) both reciprocals are
    taken in f32, else (no outlet, or d == dx) 1/denom is rounded once."""
    f32 = np.float32
    denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)
    om = f32(omega)
    out = [f32(1.0 / (dx * dx)), f32(1.0 / (dy * dy)), om, f32(1.0) - om]
    if east_dirichlet and d_wall != dx:
        dg, dg_last = f32(denom), f32(denom + (dx / d_wall - 1.0) / (dx * dx))
        out += [f32(1.0) / dg, f32(1.0) / dg_last, dg, dg_last]
    else:
        out += [f32(1.0 / denom)] * 2 + [f32(denom)] * 2
    return [float(x) for x in out]


@traced("cfd.kernel.cc_sweeps")
def cc_sweeps(p, rhs, dx, dy, omega, k, d_wall, emit_res=False, east_dirichlet=True):
    """k damped sweeps on a cell-centred coarse level, the outlet's 0
    ghost at its east edge or, without ``east_dirichlet``, a mirror;
    (p, r or None)."""
    if k < 0:
        raise ValueError(f"cc_sweeps: k must be >= 0, got {k}")
    if p.dim() != 2:
        raise ValueError(f"cc_sweeps needs a 2-D array, got {tuple(p.shape)}")
    ny, nx = p.shape
    if on_cpu("cc_sweeps", {"p": (p, (ny, nx)), "rhs": (rhs, (ny, nx))}):
        return cc_sweeps_plain(p, rhs, dx, dy, omega, k, d_wall, emit_res, east_dirichlet)
    lib = load()
    out, tmp = torch.empty_like(p), torch.empty_like(p)
    r = torch.empty_like(p) if emit_res else None
    with torch.cuda.device(p.device):
        check(lib.cfd_cc_sweeps(
            p.data_ptr(), rhs.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            r.data_ptr() if emit_res else None, ny, nx, k,
            *_cc_multipliers(dx, dy, omega, d_wall, east_dirichlet),
            int(east_dirichlet), stream_of(p)), "cc_sweeps")
    cc_sweeps.launches += 1
    cc_sweeps.cavity_launches += not east_dirichlet
    return out, r


cc_sweeps.launches = 0
cc_sweeps.cavity_launches = 0
