"""The vertex multigrid's kernels in CUDA (↔ cfd_demo_tpu/kernels/mg_pallas.py
and jacobi_pallas.py's multigrid smoother), csrc/mg.cu.

Four wrappers, on compact levels of any size from 3x3, odd or even:

- ``mg_smooth`` replaces ``mg_smooth_pallas`` (jacobi_pallas.py:1221,
  body ``_kernel_mg`` :1180), kernel 10, and ``mg_smooth_int``
  (mg_pallas.py:177, body ``_kernel_smooth`` :77), kernel 16: k undamped
  Jacobi sweeps of the interior, the boundary read and left as it is
  (ops.poisson._mg_smooth). The two TPU kernels compute the same
  function, kernel 16 on the lane-interleaved levels that Mosaic's lack
  of strided lane reads forced (mg_pallas.py:9-25).
- ``mg_residual_restrict`` replaces ``mg_residual_restrict_int``
  (mg_pallas.py:511, ``_kernel_restrict`` :348), kernel 17: the coarse
  level ((ny+1)//2, (nx+1)//2) of ops.poisson._mg_restrict applied to
  _mg_residual, compact; its ring is 0, as a residual's is.
- ``mg_prolong_add`` replaces ``mg_prolong_add_int`` (mg_pallas.py:687,
  ``_kernel_prolong`` :575), kernel 18: p + _mg_prolong(e), and with
  ``bc`` the p' BCs of that sum (the channel's, or with ``cavity`` the
  cavity's), which the legacy cycle applies before its post-smoother
  (ops/poisson.py:663 of the JAX package; the TPU kernel leaves that to
  its post-smoother's folded reads, mg_pallas.py:1107-1108).
- ``mgp_smooth`` replaces ``mgp_smooth_int`` (mg_pallas.py:1023,
  ``_kernel_smooth_mgp`` :826), kernel 19: k damped sweeps with the p'
  BCs (ops.poisson._mgp_smooth), the channel's or with ``cavity`` the
  cavity's (mg_pallas.py:998-1010), as csrc/sweep.cuh's folded sweep (no
  ring cell read) and one BC refresh at the end. That equals the plain
  sweeps only on BC-consistent input, which the legacy cycle always
  passes: zeros, a smoother's output, bc(p + prolong(e)).

Arithmetic: the sweeps use the TPU kernels' multipliers (``bx, by, br``,
mg_pallas.py:100-104; ``ax, ay, ar, ac``, :871-875) and the restriction
its residual form (idx2, idy2, denom, :376-378) and separable weights
(:404-410), so they differ from the plain versions' divisions by a few
ulps a sweep. The prolongation repeats the plain version's operations
and agrees with it bit for bit.

Bound: bytes. A sweep reads p' and rhs and writes p' (12 bytes a cell,
50 MB at 2048²); the restriction reads p' and rhs once (8 bytes a fine
cell) and the prolongation reads p and writes the sum (8 bytes a fine
cell). Every sweep needs the whole previous one, so a level that does
not fit one block's shared memory runs one sweep a launch, ping-ponging
two buffers, the launch boundary as the grid-wide barrier; a level whose
two p' buffers and scaled rhs fit the 227 KB of one block (19,370 cells:
128² of the 2048² hierarchy and everything below) runs all its k sweeps
in one launch of one block, with a barrier between sweeps. mgp_smooth's
multi-launch form adds one launch for the ring. The transfers are one
launch each, a thread a coarse (restriction) or fine (prolongation)
cell.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises, and adds one to its ``launches``, and
``mgp_smooth`` and ``mg_prolong_add`` one to their ``cavity_launches``
for a CAVITY instance.
"""
from __future__ import annotations

import torch

from ..ops.poisson import _mg_prolong, _mg_residual, _mg_restrict, _mg_smooth, _mgp_smooth
from ..trace import traced
from ._build import check, load, on_cpu, stream_of
from .jacobi import _multipliers
from .mgp import _check_fine, _residual_multipliers, pprime_bcs
from .sor import _coefficients


def coarse_shape(ny: int, nx: int):
    """The next level of the vertex hierarchy: (n + 1) // 2 a side."""
    return (ny + 1) // 2, (nx + 1) // 2


def _smooth_multipliers(dx: float, dy: float):
    """(bx, by, br) of mg_pallas.py:100-104, the SOR kernels' first three
    coefficients (sor_pallas.py:75-79 rounds them alike)."""
    return _coefficients(dx, dy, 1.0)[:3]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def mg_smooth_plain(p, rhs, dx, dy, k):
    """ops.poisson._mg_smooth."""
    return _mg_smooth(p, rhs, dx, dy, k)


def mg_residual_restrict_plain(p, rhs, dx, dy):
    """_mg_restrict(_mg_residual(p, rhs), (nx+1)//2, (ny+1)//2)."""
    ny_c, nx_c = coarse_shape(*p.shape)
    return _mg_restrict(_mg_residual(p, rhs, dx, dy), nx_c, ny_c)


def mg_prolong_add_plain(e, p, bc=False, cavity=False):
    """p + _mg_prolong(e), with the p' BCs when ``bc`` (the cavity's
    with ``cavity``)."""
    out = p + _mg_prolong(e, p.shape[1], p.shape[0])
    return pprime_bcs(cavity)(out) if bc else out


def mgp_smooth_plain(p, rhs, dx, dy, omega, k, cavity=False):
    """ops.poisson._mgp_smooth, with the cavity's p' BCs when
    ``cavity``."""
    return _mgp_smooth(p, rhs, dx, dy, omega, k, pprime_bcs(cavity))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@traced("cfd.kernel.mg_smooth")
def mg_smooth(p, rhs, dx, dy, k):
    """k undamped interior sweeps; returns a new level."""
    _check_fine("mg_smooth", p, k)
    shape = tuple(p.shape)
    if on_cpu("mg_smooth", {"p": (p, shape), "rhs": (rhs, shape)}):
        return mg_smooth_plain(p, rhs, dx, dy, k)
    lib = load()
    out, tmp = torch.empty_like(p), torch.empty_like(p)
    with torch.cuda.device(p.device):
        check(lib.cfd_mg_smooth(p.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                                tmp.data_ptr(), *shape, k, *_smooth_multipliers(dx, dy),
                                stream_of(p)), "mg_smooth")
    if k:  # k == 0 is a copy
        mg_smooth.launches += 1
    return out


mg_smooth.launches = 0


@traced("cfd.kernel.mg_residual_restrict")
def mg_residual_restrict(p, rhs, dx, dy):
    """The coarse residual ((ny+1)//2, (nx+1)//2) of a level."""
    _check_fine("mg_residual_restrict", p, 0)
    shape = tuple(p.shape)
    if on_cpu("mg_residual_restrict", {"p": (p, shape), "rhs": (rhs, shape)}):
        return mg_residual_restrict_plain(p, rhs, dx, dy)
    lib = load()
    rc = torch.empty(coarse_shape(*shape), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        check(lib.cfd_mg_restrict(p.data_ptr(), rhs.data_ptr(), rc.data_ptr(), *shape,
                                  *_residual_multipliers(dx, dy), stream_of(p)),
              "mg_residual_restrict")
    mg_residual_restrict.launches += 1
    return rc


mg_residual_restrict.launches = 0


@traced("cfd.kernel.mg_prolong_add")
def mg_prolong_add(e, p, bc=False, cavity=False):
    """p + the prolongation of the next level's ``e``; with ``bc`` the
    p' BCs of that sum, the channel's or with ``cavity`` the cavity's."""
    _check_fine("mg_prolong_add", p, 0)
    shape = tuple(p.shape)
    if on_cpu("mg_prolong_add", {"e": (e, coarse_shape(*shape)), "p": (p, shape)}):
        return mg_prolong_add_plain(e, p, bc, cavity)
    lib = load()
    out = torch.empty_like(p)
    mode = (2 if cavity else 1) if bc else 0
    with torch.cuda.device(p.device):
        check(lib.cfd_mg_prolong_add(e.data_ptr(), p.data_ptr(), out.data_ptr(), *shape,
                                     mode, stream_of(p)), "mg_prolong_add")
    mg_prolong_add.launches += 1
    mg_prolong_add.cavity_launches += mode == 2
    return out


mg_prolong_add.launches = 0
mg_prolong_add.cavity_launches = 0


@traced("cfd.kernel.mgp_smooth")
def mgp_smooth(p, rhs, dx, dy, omega, k, cavity=False):
    """k damped sweeps with the p' BCs, the channel's or with ``cavity``
    the cavity's (BC-consistent ``p``)."""
    _check_fine("mgp_smooth", p, k)
    shape = tuple(p.shape)
    if on_cpu("mgp_smooth", {"p": (p, shape), "rhs": (rhs, shape)}):
        return mgp_smooth_plain(p, rhs, dx, dy, omega, k, cavity)
    lib = load()
    out, tmp = torch.empty_like(p), torch.empty_like(p)
    with torch.cuda.device(p.device):
        check(lib.cfd_mgp_smooth(p.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                                 tmp.data_ptr(), *shape, k, *_multipliers(dx, dy, omega),
                                 int(cavity), stream_of(p)), "mgp_smooth")
    if k:  # k == 0 is a copy
        mgp_smooth.launches += 1
        mgp_smooth.cavity_launches += bool(cavity)
    return out


mgp_smooth.launches = 0
mgp_smooth.cavity_launches = 0
