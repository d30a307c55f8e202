"""Pressure-correction solves (↔ the Jacobi, SOR, MULTIGRID and
MG_PRODUCTION slices of cfd_demo_tpu/ops/poisson.py).

Jacobi, model.rs:733-824: a whole-array damped sweep with the
per-iteration p' BCs (model.rs:807-815: Neumann bottom/top/left,
Dirichlet 0 at the outlet column; in CAVITY flow all-Neumann with the
(0, 0) cell pinned, ``bc=_apply_pprime_bcs_cavity``), looped as a
do-while that exits after the first sweep whose max interior change is
below ``tol``. SOR takes the channel BCs only.

SOR, index.html:741-774: red/black over-relaxed sweeps (the parallel
form), or the JS-exact lexicographic ordering as a wavefront; the same
BCs and loop as Jacobi.

MULTIGRID (``multigrid``), index.html:775-795: the JS kit's vertex
V-cycles, zero-started, a fixed mg_cycles of them: undamped
interior-only Jacobi, full-weighting restriction and bilinear
prolongation, coarsening (n+1)//2.

MG_PRODUCTION (``multigrid_production``): V-cycles of the aligned
cell-centred hierarchy (or, with mgp_scheme "legacy", the JS kit's
hierarchy with damped p'-BC sweeps) until max|rhs - A p'| falls below
the divergence-calibrated tolerance or the f32 noise floor, with the p'
BCs ``bc`` of either flow case; see the sections below.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import trace
from ..core.config import FlowCase
from .fdm import fdm_solve_interior


def _apply_pprime_bcs(pp: torch.Tensor) -> torch.Tensor:
    """Rows first, then columns (the corner values depend on the order).
    Leading batch dimensions carry over."""
    ny, nx = pp.shape[-2:]
    pp = pp.clone()
    pp[..., 0, :] = pp[..., 1, :]            # bottom
    pp[..., ny - 1, :] = pp[..., ny - 2, :]  # top
    pp[..., :, 0] = pp[..., :, 1]            # left
    pp[..., :, nx - 1] = 0.0                 # outlet
    return pp


def _apply_pprime_bcs_cavity(pp: torch.Tensor) -> torch.Tensor:
    """All-Neumann p' BCs of closed (CAVITY) flow (JAX ops/poisson.py:
    55-66): rows first, then the left column, then the right column from
    column nx-2; the pure-Neumann system is singular, so the bottom-left
    cell is pinned to 0 last (the gauge)."""
    ny, nx = pp.shape[-2:]
    pp = pp.clone()
    pp[..., 0, :] = pp[..., 1, :]
    pp[..., ny - 1, :] = pp[..., ny - 2, :]
    pp[..., :, 0] = pp[..., :, 1]
    pp[..., :, nx - 1] = pp[..., :, nx - 2]
    pp[..., 0, 0] = 0.0
    return pp


def pprime_bc_fn(flow_case):
    """The p' BCs of ``flow_case`` (JAX ops/poisson.py:69-72)."""
    return (_apply_pprime_bcs if flow_case == FlowCase.CHANNEL
            else _apply_pprime_bcs_cavity)


def _jacobi_sweep(pp, rhs, dx, dy, omega,
                  bc=_apply_pprime_bcs) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped-Jacobi iteration incl. the p' BCs ``bc``; returns (pp,
    max_err) with max_err over the interior cells, one per scene of a
    batch (a 0-d tensor for one scene)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    c = pp[..., 1:-1, 1:-1]
    update = ((pp[..., 1:-1, 2:] + pp[..., 1:-1, :-2]) / dx2
              + (pp[..., 2:, 1:-1] + pp[..., :-2, 1:-1]) / dy2
              - rhs[..., 1:-1, 1:-1]) / denom
    new_val = omega * update + (1.0 - omega) * c
    err = torch.amax(torch.abs(new_val - c), dim=(-2, -1))
    out = pp.clone()
    out[..., 1:-1, 1:-1] = new_val
    return bc(out), err


def _sweep_loop(sweep, pp0, tol, iters, early_exit, done=None):
    """The solvers' shared convergence loop (JAX ops/poisson.py:375-393):
    ``sweep(pp) -> (pp, err)``. Returns (p', last sweep's error,
    sweeps run).

    ``early_exit``: a do-while on the host that stops after the first
    sweep whose error is below ``tol``; it reads the error back once per
    sweep, and takes one scene. Otherwise (``_masked_while``): max(1,
    iters) sweeps whose results freeze once converged -- the same
    fields, with no host read, and the count returned as a tensor. On a
    batch ``(B, ny, nx)`` each scene freezes at its own sweep, with err
    and the count of shape ``(B,)``; the scenes a bool ``done`` marks
    start frozen (p' = pp0, err inf, 0 sweeps), as the masked outer
    rounds' converged scenes do.
    """
    if early_exit:
        if pp0.dim() != 2:
            raise ValueError("the exact exit takes one scene; a batch takes "
                             "early_exit=False")
        pp, it = pp0, 0
        while True:
            pp, err = sweep(pp)
            it += 1
            if not (it < iters and trace.read_host(err >= tol)):
                return pp, err, it
    lead = pp0.shape[:-2]
    pp = pp0
    err = torch.full(lead, float("inf"), dtype=pp0.dtype, device=pp0.device)
    done = (torch.zeros(lead, dtype=torch.bool, device=pp0.device) if done is None
            else done.clone())
    n = torch.zeros(lead, dtype=torch.int32, device=pp0.device)
    for _ in range(max(1, iters)):
        if done.device.type == "cpu" and bool(done.all()):
            break  # the JAX loop's own exit; on the card it reads nothing
        pp2, err2 = sweep(pp)
        pp = torch.where(done[..., None, None], pp, pp2)
        err = torch.where(done, err, err2)
        n = n + (~done).to(torch.int32)
        done = done | (err < tol)
    return pp, err, n


def jacobi(pp0: torch.Tensor, rhs: torch.Tensor, dx: float, dy: float,
           omega: float, tol: float, iters: int, early_exit: bool = True,
           done=None, bc=_apply_pprime_bcs):
    """Damped Jacobi with the p' BCs ``bc`` (the channel's by default);
    returns (p_prime, max_error_of_last_sweep, iterations_run), looped by
    :func:`_sweep_loop`."""
    return _sweep_loop(lambda pp: _jacobi_sweep(pp, rhs, dx, dy, omega, bc), pp0,
                       tol, iters, early_exit, done)


# ---------------------------------------------------------------------------
# Red/black SOR (PressureSolver.SOR) and the JS-exact lexicographic ordering
# ---------------------------------------------------------------------------

def _interior(shape, device):
    """Bool (ny, nx) mask of the interior cells, and the parity (r + c) % 2
    of the global row and column (0: red, 1: black)."""
    ny, nx = shape[-2:]
    r = torch.arange(ny, device=device)[:, None]
    c = torch.arange(nx, device=device)[None, :]
    interior = (r >= 1) & (r <= ny - 2) & (c >= 1) & (c <= nx - 2)
    return interior, (r + c) % 2


def _sor_sweep(pp, rhs, dx, dy, omega) -> Tuple[torch.Tensor, torch.Tensor]:
    """One red/black SOR iteration incl. p' BCs (JAX ops/poisson.py:352):
    the red half (r + c even) then the black half, which reads the red
    half's updates; returns (pp, max|change| over the interior), one err
    per scene of a batch."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    interior, parity = _interior(pp.shape, pp.device)
    par = parity[1:-1, 1:-1]
    r = rhs[..., 1:-1, 1:-1]
    old = pp

    def half(pp, colour):
        c = pp[..., 1:-1, 1:-1]
        update = ((pp[..., 1:-1, 2:] + pp[..., 1:-1, :-2]) / dx2
                  + (pp[..., 2:, 1:-1] + pp[..., :-2, 1:-1]) / dy2 - r) / denom
        new_val = (1.0 - omega) * c + omega * update
        out = pp.clone()
        out[..., 1:-1, 1:-1] = torch.where(par == colour, new_val, c)
        return out

    pp = half(half(pp, 0), 1)
    err = torch.amax(torch.where(interior, torch.abs(pp - old), 0.0), dim=(-2, -1))
    return _apply_pprime_bcs(pp), err


def sor(pp0, rhs, dx: float, dy: float, omega: float, tol: float, iters: int,
        early_exit: bool = True, done=None):
    """Red/black SOR, the parallel form of index.html:741-774 (JAX
    ops/poisson.py:396); returns (p', last error, iterations run), looped
    by :func:`_sweep_loop`."""
    return _sweep_loop(lambda pp: _sor_sweep(pp, rhs, dx, dy, omega), pp0, tol,
                       iters, early_exit, done)


def _sor_sweep_lex(pp, rhs, dx, dy, omega) -> Tuple[torch.Tensor, torch.Tensor]:
    """One JS-exact lexicographic SOR sweep (index.html:747-773; JAX
    ops/poisson.py:410) as a wavefront over anti-diagonals d = r + c: a
    cell reads its updated west and south neighbours (diagonal d - 1) and
    its stale east and north ones (d + 1), so whole diagonals in
    increasing d reproduce the sequential sweep. Constants in f32 as the
    JAX sweep rounds them. Each diagonal gathers its own cells: (nx + ny)
    small steps a sweep, a parity mode, not a fast path."""
    F = np.float32
    dx2 = float(F(dx) * F(dx))
    dy2 = float(F(dy) * F(dy))
    denom = float(F(2.0) / F(dx2) + F(2.0) / F(dy2))
    om = F(omega)
    one_m = float(F(1.0) - om)
    ny, nx = pp.shape[-2:]
    flat = pp.reshape(*pp.shape[:-2], ny * nx).clone()
    rflat = rhs.reshape(*rhs.shape[:-2], ny * nx)
    old = pp
    for d in range(2, (ny - 2) + (nx - 2) + 1):
        j = torch.arange(max(1, d - (nx - 2)), min(ny - 2, d - 1) + 1,
                         device=pp.device)
        k = j * nx + (d - j)
        upd = ((flat[..., k + 1] + flat[..., k - 1]) / dx2
               + (flat[..., k + nx] + flat[..., k - nx]) / dy2
               - rflat[..., k]) / denom
        flat[..., k] = one_m * flat[..., k] + float(om) * upd
    pp = flat.reshape(pp.shape)
    interior, _ = _interior(pp.shape, pp.device)
    err = torch.amax(torch.where(interior, torch.abs(pp - old), 0.0), dim=(-2, -1))
    return _apply_pprime_bcs(pp), err


def sor_lexicographic(pp0, rhs, dx: float, dy: float, omega: float, tol: float,
                      iters: int, early_exit: bool = True, done=None):
    """JS-ordering-exact SOR (SolverOptions.sor_ordering="lexicographic";
    JAX ops/poisson.py:459) through the wavefront sweep, looped by
    :func:`_sweep_loop`. Plain PyTorch only: the JAX package never routes
    it to a kernel (solver/piso.py:364-375)."""
    return _sweep_loop(lambda pp: _sor_sweep_lex(pp, rhs, dx, dy, omega), pp0,
                       tol, iters, early_exit, done)


# ---------------------------------------------------------------------------
# Production projection (PressureSolver.MG_PRODUCTION, aligned scheme)
#
# The aligned cell-centred hierarchy of the JAX package
# (ops/poisson.py:668-696): the unknowns of every coarse level are
# interior cells, with the boundary slaving folded into the stencil
# (Neumann mirror: ghost = self; outlet: a 0-valued ghost at the tracked
# centre-to-wall distance d, d_0 = 1.5 h_fine on the first coarse level,
# d_{l+1} = d_l + h_l / 2; in CAVITY flow, east_dirichlet False, the
# east edge mirrors too and FDM takes the pseudo-inverse); 2x2-average
# restriction and bilinear prolongation, odd sizes mirror-padding or
# aggregating on the west and south sides; levels at or below
# mgp_coarse_stop cells a side solve exactly by FDM (ops.fdm). The fine
# level keeps the full-array damped sweeps with the p' BCs, through the
# fused smoother kernels (kernels.mgp).
# ---------------------------------------------------------------------------

def _mg_residual(p, rhs, dx, dy):
    """r = rhs - A p on the interior, 0 on the boundary ring."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    ap = ((p[1:-1, 2:] + p[1:-1, :-2]) / dx2
          + (p[2:, 1:-1] + p[:-2, 1:-1]) / dy2 - denom * p[1:-1, 1:-1])
    r = torch.zeros_like(p)
    r[1:-1, 1:-1] = rhs[1:-1, 1:-1] - ap
    return r


def _mgp_smooth(p, rhs, dx, dy, omega, iterations, bc=_apply_pprime_bcs):
    """Damped-Jacobi sweeps with the p' BCs ``bc`` re-applied every
    sweep (JAX ops/poisson.py:607)."""
    for _ in range(iterations):
        p, _ = _jacobi_sweep(p, rhs, dx, dy, omega, bc)
    return p


# ---------------------------------------------------------------------------
# The JS kit's vertex V-cycle (PressureSolver.MULTIGRID; JAX
# ops/poisson.py:478-599), and the legacy MG_PRODUCTION cycle built on its
# transfers (:647-665). Each piece keeps the JAX expression's order of
# operations, so that the CPU results agree to the ulp.
# ---------------------------------------------------------------------------

def _mg_smooth(p, rhs, dx, dy, iterations: int):
    """Undamped Jacobi on the interior, no BCs (index.html:1347-1369)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    for _ in range(iterations):
        update = ((p[1:-1, 2:] + p[1:-1, :-2]) / dx2
                  + (p[2:, 1:-1] + p[:-2, 1:-1]) / dy2 - rhs[1:-1, 1:-1]) / denom
        p = p.clone()
        p[1:-1, 1:-1] = update
    return p


def _mg_restrict(fine, nx_c: int, ny_c: int):
    """Full weighting at the even fine points, injection on the boundary
    by the same-row and same-column samples, columns last so that the
    corners take the column values (index.html:1372-1395)."""
    ny_f, nx_f = fine.shape
    f = torch.nn.functional.pad(fine, (1, 1, 1, 1))

    def sh(dj, di):  # fine[j + dj, i + di] at the even points, 0 outside
        return f[1 + dj:1 + dj + ny_f:2, 1 + di:1 + di + nx_f:2]

    w9 = (sh(0, 0)
          + 0.5 * (sh(0, 1) + sh(0, -1) + sh(1, 0) + sh(-1, 0))
          + 0.25 * (sh(1, 1) + sh(1, -1) + sh(-1, 1) + sh(-1, -1))) / 4.0
    out = w9[:ny_c, :nx_c].clone()
    out[0] = fine[0, ::2][:nx_c]
    out[ny_c - 1] = fine[ny_f - 1, ::2][:nx_c]
    out[:, 0] = fine[::2, 0][:ny_c]
    out[:, nx_c - 1] = fine[::2, nx_f - 1][:ny_c]
    return out


def _mg_prolong(coarse, nx_f: int, ny_f: int):
    """Bilinear prolongation (index.html:1398-1421): fine column i
    interpolates coarse columns i//2 and min(i//2 + 1, last), then the
    same along rows."""
    ny_c, nx_c = coarse.shape
    dev, dt = coarse.device, coarse.dtype
    right = torch.cat([coarse[:, 1:], coarse[:, -1:]], dim=1)
    rep = coarse.repeat_interleave(2, dim=1)[:, :nx_f]
    rep_r = right.repeat_interleave(2, dim=1)[:, :nx_f]
    a = (torch.arange(nx_f, device=dev) % 2).to(dt) * 0.5
    row = rep * (1 - a) + rep_r * a
    down = torch.cat([row[1:], row[-1:]], dim=0)
    rep_y = row.repeat_interleave(2, dim=0)[:ny_f]
    rep_d = down.repeat_interleave(2, dim=0)[:ny_f]
    b = (torch.arange(ny_f, device=dev) % 2).to(dt)[:, None] * 0.5
    return rep_y * (1 - b) + rep_d * b


class MgKit(NamedTuple):
    """The vertex cycles' four kernels (kernels.mg), or their plain
    versions: smooth(p, rhs, dx, dy, k); restrict(p, rhs, dx, dy) ->
    the coarse residual; prolong(e, p, bc, cavity) -> p + prolong(e),
    with the channel p' BCs when bc (the cavity's with cavity);
    mgp_smooth(p, rhs, dx, dy, omega, k, cavity)."""

    smooth: object
    restrict: object
    prolong: object
    mgp_smooth: object


def _mg_kit(opts) -> MgKit:
    """The kernel wrappers (each runs its plain version on CPU tensors),
    or with pressure_impl "jnp" the plain versions on any device."""
    from ..kernels import mg  # kernels.mg imports this module
    if opts.pressure_impl == "jnp":
        return MgKit(mg.mg_smooth_plain, mg.mg_residual_restrict_plain,
                     mg.mg_prolong_add_plain, mg.mgp_smooth_plain)
    return MgKit(mg.mg_smooth, mg.mg_residual_restrict, mg.mg_prolong_add,
                 mg.mgp_smooth)


def _mg_vcycle(p, rhs, dx, dy, opts, kit: MgKit):
    """One vertex V-cycle (JAX ops/poisson.py:589): pre-smooth, and at or
    below mg_coarsest cells on a side the coarse smoothing alone; else
    the restricted residual, the coarse cycle from zero at 2dx, 2dy, the
    prolonged correction, post-smooth."""
    ny, nx = p.shape
    p = kit.smooth(p, rhs, dx, dy, opts.mg_pre_smooth)
    if nx <= opts.mg_coarsest or ny <= opts.mg_coarsest:
        return kit.smooth(p, rhs, dx, dy, opts.mg_coarse_smooth)
    r_c = kit.restrict(p, rhs, dx, dy)
    e_c = _mg_vcycle(torch.zeros_like(r_c), r_c, 2 * dx, 2 * dy, opts, kit)
    p = kit.prolong(e_c, p, False)
    return kit.smooth(p, rhs, dx, dy, opts.mg_post_smooth)


def multigrid(pp0, rhs, dx: float, dy: float, opts):
    """PressureSolver.MULTIGRID (JAX ops/poisson.py:1330): mg_cycles
    V-cycles from zero (``pp0`` gives only the shape, index.html:777),
    then the residual report. Returns (p', max|rhs - A p'|, mg_cycles as
    a 0-d int32 tensor); reads nothing back to the host."""
    if pp0.dim() != 2:
        raise ValueError("multigrid takes one scene")
    kit = _mg_kit(opts)
    pp = torch.zeros_like(pp0)
    for _ in range(opts.mg_cycles):
        pp = _mg_vcycle(pp, rhs, dx, dy, opts, kit)
        trace.vcycles += 1
    err = torch.amax(torch.abs(_mg_residual(pp, rhs, dx, dy)))  # 0 on the ring
    return pp, err, torch.full((), opts.mg_cycles, dtype=torch.int32,
                               device=pp0.device)


def _mgp_vcycle(p, rhs, dx, dy, opts, kit: MgKit, bc=_apply_pprime_bcs):
    """One legacy MG_PRODUCTION V-cycle (JAX ops/poisson.py:647): the JS
    kit's hierarchy with mgp_smooth damped sweeps and the p' BCs ``bc``
    at every level (the correction obeys the same homogeneous BCs as
    p'), and bc(p + prolong(e)) before the post-smoother."""
    ny, nx = p.shape
    omega, nu = opts.jacobi_omega, opts.mgp_smooth
    cavity = bc is _apply_pprime_bcs_cavity
    p = kit.mgp_smooth(p, rhs, dx, dy, omega, nu, cavity)
    if nx <= opts.mg_coarsest or ny <= opts.mg_coarsest:
        return kit.mgp_smooth(p, rhs, dx, dy, omega, opts.mg_coarse_smooth, cavity)
    r_c = kit.restrict(p, rhs, dx, dy)
    e_c = _mgp_vcycle(torch.zeros_like(r_c), r_c, 2 * dx, 2 * dy, opts, kit, bc)
    p = kit.prolong(e_c, p, True, cavity)
    return kit.mgp_smooth(p, rhs, dx, dy, omega, nu, cavity)


def _cc_neighbors(p, east_dirichlet=True):
    """Folded neighbour reads (E, W, N, S) on an interior-unknown array:
    Neumann edges mirror (ghost = self), the outlet (east) edge reads
    the 0-valued Dirichlet ghost, or with ``east_dirichlet`` False (the
    cavity's all-Neumann operator) mirrors too."""
    east_ghost = torch.zeros_like(p[:, -1:]) if east_dirichlet else p[:, -1:]
    e = torch.cat([p[:, 1:], east_ghost], dim=1)
    w = torch.cat([p[:, :1], p[:, :-1]], dim=1)
    n = torch.cat([p[1:], p[-1:]], dim=0)
    s = torch.cat([p[:1], p[:-1]], dim=0)
    return e, w, n, s


def _cc_diag(shape, dx, dy, d_wall, device, east_dirichlet=True):
    """Diagonal of -A: 2/dx^2 + 2/dy^2, and in the outlet column, when
    the wall sits at d != dx from the last centre, (1 + dx/d)/dx^2 in
    place of the x part; uniform without an outlet (``east_dirichlet``
    False). A float, or an f32 (1, nx) row."""
    denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)
    if not east_dirichlet or d_wall == dx:
        return denom
    extra = (dx / d_wall - 1.0) / (dx * dx)
    dg = torch.full((1, shape[1]), denom, dtype=torch.float32, device=device)
    dg[0, -1] = denom + extra
    return dg


def _cc_residual(p, rhs, dx, dy, d_wall, east_dirichlet=True):
    dx2, dy2 = dx * dx, dy * dy
    e, w, n, s = _cc_neighbors(p, east_dirichlet)
    dg = _cc_diag(p.shape, dx, dy, d_wall, p.device, east_dirichlet)
    return rhs - ((e + w) / dx2 + (n + s) / dy2 - dg * p)


def _cc_sweeps(p, rhs, dx, dy, omega, iters, d_wall, east_dirichlet=True):
    """Damped-Jacobi sweeps on the folded cell-centred operator."""
    dx2, dy2 = dx * dx, dy * dy
    dg = _cc_diag(p.shape, dx, dy, d_wall, p.device, east_dirichlet)
    for _ in range(iters):
        e, w, n, s = _cc_neighbors(p, east_dirichlet)
        upd = ((e + w) / dx2 + (n + s) / dy2 - rhs) / dg
        p = (1.0 - omega) * p + omega * upd
    return p


def _cc_coarse_size(m: int) -> int:
    """Coarse cells along one axis: even m halves; odd m takes whichever
    of (m+1)/2 (mirror-pad a ghost on the west/south side) and (m-1)/2
    (the first coarse cell aggregates three fine ones) is even; m == 1
    saturates at 1 (the transfers are the identity along that axis)."""
    if m <= 1:
        return max(m, 1)
    if m % 2 == 0:
        return m // 2
    return (m + 1) // 2 if ((m + 1) // 2) % 2 == 0 else m // 2


def _cc_restrict_x(f):
    """2-average restriction along x with the odd-size rule."""
    nx = f.shape[1]
    if nx % 2 == 0:
        return 0.5 * (f[:, 0::2] + f[:, 1::2])
    if _cc_coarse_size(nx) == (nx + 1) // 2:   # mirror-pad west
        g = torch.cat([f[:, :1], f], dim=1)
        return 0.5 * (g[:, 0::2] + g[:, 1::2])
    g = f[:, 1:]                               # aggregate west
    t = 0.5 * (g[:, 0::2] + g[:, 1::2])
    t[:, :1] = (f[:, :1] + f[:, 1:2] + f[:, 2:3]) / 3.0
    return t


def _cc_restrict_y(f):
    """As _cc_restrict_x, along y."""
    ny = f.shape[0]
    if ny % 2 == 0:
        return 0.5 * (f[0::2] + f[1::2])
    if _cc_coarse_size(ny) == (ny + 1) // 2:   # mirror-pad south
        g = torch.cat([f[:1], f], dim=0)
        return 0.5 * (g[0::2] + g[1::2])
    g = f[1:]                                  # aggregate south
    t = 0.5 * (g[0::2] + g[1::2])
    t[:1] = (f[:1] + f[1:2] + f[2:3]) / 3.0
    return t


def _cc_restrict(fine):
    """Cell-centred averaging restriction, x first, then y."""
    return _cc_restrict_y(_cc_restrict_x(fine))


def _cc_prolong_x(coarse, nx_f, east_dirichlet=True):
    """The x pass of _cc_prolong: coarse columns interpolated to nx_f
    fine columns, at coarse rows. The Neumann west edge clamps, the
    outlet edge interpolates toward the 0 ghost, or clamps too when not
    ``east_dirichlet`` (JAX ops/poisson.py:848-851)."""
    ny_c, nx_c = coarse.shape
    if nx_f == nx_c:  # saturated axis (width 1): identity
        return coarse
    left = torch.cat([coarse[:, :1], coarse[:, :-1]], dim=1)
    east_ghost = (torch.zeros_like(coarse[:, -1:]) if east_dirichlet
                  else coarse[:, -1:])
    rightn = torch.cat([coarse[:, 1:], east_ghost], dim=1)
    rw = 0.75 * coarse + 0.25 * rightn
    if nx_f == 2 * nx_c + 1:  # aggregate west: first coarse = 3 fine
        lw = 0.75 * coarse + 0.25 * left
        lw[:, 1] = 0.8 * coarse[:, 1] + 0.2 * left[:, 1]
        pairs = torch.stack([lw[:, 1:], rw[:, 1:]], dim=2)
        head = torch.cat([coarse[:, :1], coarse[:, :1],
                          0.6 * coarse[:, :1] + 0.4 * coarse[:, 1:2]], dim=1)
        return torch.cat([head, pairs.reshape(ny_c, 2 * (nx_c - 1))], dim=1)
    # even (nx_f == 2 nx_c) or mirror-pad west (nx_f == 2 nx_c - 1)
    even = 0.75 * coarse + 0.25 * left
    row = torch.stack([even, rw], dim=2).reshape(ny_c, 2 * nx_c)
    return row[:, 2 * nx_c - nx_f:]


def _cc_prolong_y(row, ny_f):
    """The y pass of _cc_prolong: coarse rows of ``row`` interpolated to
    ny_f fine rows; both edges clamp."""
    ny_c, width = row.shape
    if ny_f == ny_c:  # saturated axis (height 1): identity
        return row
    dnv = torch.cat([row[:1], row[:-1]], dim=0)
    upv = torch.cat([row[1:], row[-1:]], dim=0)
    uw = 0.75 * row + 0.25 * upv
    if ny_f == 2 * ny_c + 1:  # aggregate south
        lw = 0.75 * row + 0.25 * dnv
        lw[1] = 0.8 * row[1] + 0.2 * dnv[1]
        pairs = torch.stack([lw[1:], uw[1:]], dim=1)
        head = torch.cat([row[:1], row[:1], 0.6 * row[:1] + 0.4 * row[1:2]],
                         dim=0)
        return torch.cat([head, pairs.reshape(2 * (ny_c - 1), width)], dim=0)
    evr = 0.75 * row + 0.25 * dnv
    out = torch.stack([evr, uw], dim=1).reshape(2 * ny_c, width)
    return out[2 * ny_c - ny_f:]


def _cc_prolong(coarse, ny_f, nx_f, east_dirichlet=True):
    """Cell-centred bilinear prolongation, the per-axis inverse of
    _cc_restrict's even, mirror-pad and aggregate cases."""
    return _cc_prolong_y(_cc_prolong_x(coarse, nx_f, east_dirichlet), ny_f)


def _cc_vcycle(rhs, dx, dy, opts, d_wall, smoothers, east_dirichlet=True):
    """Solve A e = rhs from a zero guess on one coarse level. FDM at or
    below mgp_coarse_stop cells on the longer side; otherwise pre-smooth
    with the residual (the cc kernel), recurse, prolong, post-smooth.
    A saturated axis keeps its own h and d_wall on the coarser level.
    ``east_dirichlet`` False: the cavity's all-Neumann operator."""
    ny, nx = rhs.shape
    if max(ny, nx) <= opts.mgp_coarse_stop:
        return fdm_solve_interior(rhs, dx, dy, d_wall, east_dirichlet)
    omega, nu = opts.jacobi_omega, opts.mgp_smooth
    p, r = smoothers.cc(torch.zeros_like(rhs), rhs, dx, dy, omega, nu, d_wall,
                        True, east_dirichlet)
    x_sat = _cc_coarse_size(nx) == nx
    y_sat = _cc_coarse_size(ny) == ny
    e_c = _cc_vcycle(_cc_restrict(r), dx if x_sat else 2 * dx,
                     dy if y_sat else 2 * dy, opts,
                     d_wall if x_sat else d_wall + dx / 2, smoothers, east_dirichlet)
    p = p + _cc_prolong(e_c, ny, nx, east_dirichlet)
    return smoothers.cc(p, rhs, dx, dy, omega, nu, d_wall, False, east_dirichlet)[0]


def _mgp_aligned_correction(r_full, dx, dy, opts, smoothers, east_dirichlet=True):
    """Full-size correction (zero ring) from a full residual array with
    a zero ring: FDM of the interior when it is at most mgp_coarse_stop
    on its shorter side, else restrict, coarse V-cycle, prolong."""
    ny, nx = r_full.shape
    r_int = r_full[1:-1, 1:-1]
    if min(ny - 2, nx - 2) <= opts.mgp_coarse_stop:
        e_int = fdm_solve_interior(r_int, dx, dy, dx, east_dirichlet)
    else:
        e_c = _cc_vcycle(_cc_restrict(r_int), 2 * dx, 2 * dy, opts, 1.5 * dx,
                         smoothers, east_dirichlet)
        e_int = _cc_prolong(e_c, ny - 2, nx - 2, east_dirichlet)
    return torch.nn.functional.pad(e_int, (1, 1, 1, 1))


def _mgp_vcycle_aligned(p, rhs, dx, dy, opts, smoothers, bc=_apply_pprime_bcs):
    """One aligned V-cycle on the full array with the p' BCs ``bc``
    (JAX ops/poisson.py:992); returns (p, max|rhs - A p|, max|p| or None).

    Interiors of at most mgp_coarse_stop on the shorter side take the
    FDM correction alone (exact in one cycle). Even grids run the
    restrict kernel (sweeps, residual, first restriction), the coarse
    cycle, the x pass of the last prolongation, and the corr kernel (y
    pass, add, sweeps, max|r|, max|p|); other grids the res kernel
    before and after the full correction. The cavity's BCs take each
    kernel's CAVITY instance and the coarse levels' all-Neumann
    operator."""
    ny, nx = p.shape
    cavity = bc is _apply_pprime_bcs_cavity
    east_dirichlet = not cavity
    if min(ny - 2, nx - 2) <= opts.mgp_coarse_stop:
        r = _mg_residual(p, rhs, dx, dy)
        p = bc(p + _mgp_aligned_correction(r, dx, dy, opts, smoothers, east_dirichlet))
        return p, torch.amax(torch.abs(_mg_residual(p, rhs, dx, dy))), None
    omega, nu = opts.jacobi_omega, opts.mgp_smooth
    if ny % 2 == 0 and nx % 2 == 0:
        p, r_c, _ = smoothers.restrict(p, rhs, dx, dy, omega, nu, cavity)
        e_c = _cc_vcycle(r_c, 2 * dx, 2 * dy, opts, 1.5 * dx, smoothers, east_dirichlet)
        row = _cc_prolong_x(e_c, nx - 2, east_dirichlet).contiguous()
        return smoothers.corr(p, rhs, row, dx, dy, omega, nu, cavity)
    p, r, _ = smoothers.res(p, rhs, dx, dy, omega, nu, True, cavity)
    p = bc(p + _mgp_aligned_correction(r, dx, dy, opts, smoothers, east_dirichlet))
    p, _, err = smoothers.res(p, rhs, dx, dy, omega, nu, False, cavity)
    return p, err, None


def _mgp_noise_floor(opts, dx, dy):
    """floor(max|p|, max|rhs|) = mgp_floor * eps * (denom max|p| +
    max|rhs|), below which the f32 residual cannot resolve; None when
    mgp_floor is 0."""
    f = opts.mgp_floor
    if not f:
        return None
    eps = float(np.finfo(np.float32).eps)
    denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)

    def floor(p_abs_max, rhs_abs_max):
        return (f * eps) * (denom * p_abs_max + rhs_abs_max)

    return floor


def _exact_while(cycle, p0, tol, iters):
    """Do-while: at least one cycle, then until err < max(tol, the
    cycle's extra tolerance) or ``iters`` cycles. The exit test reads one
    bool on the host per cycle; returns (p, err, cycles run)."""
    p, it = p0, 0
    while True:
        p, err, extra = cycle(p)
        trace.vcycles += 1
        it += 1
        tol_eff = tol if extra is None else torch.maximum(tol, extra)
        if not (it < iters and trace.read_host(err >= tol_eff)):
            return p, err, it


def _masked_while(cycle, p0, tol, iters):
    """The same fields, err and count as _exact_while at a fixed trip
    count of max(1, iters): cycles after the exit are computed and
    discarded, and nothing is read back. The count is a 0-d tensor."""
    p = p0
    err = torch.full((), float("inf"), dtype=p0.dtype, device=p0.device)
    done = torch.zeros((), dtype=torch.bool, device=p0.device)
    n = torch.zeros((), dtype=torch.int32, device=p0.device)
    for _ in range(max(1, iters)):
        p2, err2, extra = cycle(p)
        trace.vcycles += 1  # discarded after the exit, but run
        tol_eff = tol if extra is None else torch.maximum(tol, extra)
        p = torch.where(done, p, p2)
        err = torch.where(done, err, err2)
        n = n + (~done).to(torch.int32)
        done = done | (err < tol_eff)
    return p, err, n


def check_mgp_scheme(opts) -> None:
    """"aligned", "legacy" or "auto", which resolves to aligned at every
    size: the JAX package's legacy-below-2M-cells rule
    (ops/poisson.py:1139-1149) is a reading of the TPU's launch latency,
    not carried over."""
    if opts.mgp_scheme not in ("auto", "aligned", "legacy"):
        raise ValueError(f'mgp_scheme must be "auto", "aligned" or "legacy", '
                         f"got {opts.mgp_scheme!r}")


def _smoothers(opts):
    """The aligned cycle's four smoothers: the kernel wrappers (each runs
    its plain version on CPU tensors), or with pressure_impl "jnp" the
    plain versions on any device."""
    from ..kernels import mgp  # kernels.mgp imports this module
    if opts.pressure_impl == "jnp":
        return mgp.Smoothers(mgp.jacobi_fused_k_res_plain,
                             mgp.jacobi_fused_k_restrict_plain,
                             mgp.jacobi_fused_k_corr_plain, mgp.cc_sweeps_plain)
    return mgp.Smoothers(mgp.jacobi_fused_k_res, mgp.jacobi_fused_k_restrict,
                         mgp.jacobi_fused_k_corr, mgp.cc_sweeps)


def multigrid_production(pp0, rhs, dx: float, dy: float, opts, tol_r,
                         bc=_apply_pprime_bcs):
    """PressureSolver.MG_PRODUCTION with the p' BCs ``bc``, the channel's
    or the cavity's (JAX ops/poisson.py:1085).

    Aligned V-cycles (with mgp_scheme "legacy", :func:`_mgp_vcycle`, the
    error then max|_mg_residual| after the cycle, JAX
    ops/poisson.py:1167-1170), warm-started from ``pp0``, until max|rhs - A p'| <=
    ``tol_r`` (a float or a 0-d tensor; projection_div_tol / dt_sub
    bounds the post-correction max|div u| by projection_div_tol), widened
    to mgp_rtol x the warm-start residual when mgp_rtol > 0 and to the
    f32 noise floor when mgp_floor > 0, at most mgp_max_cycles; or
    exactly mgp_fixed_cycles cycles when that is > 0, always aligned, as
    the JAX package runs them whenever the BC is known
    (ops/poisson.py:1299-1305). early_exit takes the exact do-while (one
    host read per cycle), otherwise the masked fixed-trip loop. Returns
    (p', max|residual|, cycles run)."""
    check_mgp_scheme(opts)
    if opts.mgp_smooth == 3 and pp0.shape[-2] * pp0.shape[-1] >= 48_000_000:
        # The JAX package's size rule (ops/poisson.py:1113-1121): five
        # sweeps a position from 48M cells, unless set explicitly.
        opts = dataclasses.replace(opts, mgp_smooth=5)
    smoothers = _smoothers(opts)
    legacy = opts.mgp_scheme == "legacy" and opts.mgp_fixed_cycles == 0
    kit = _mg_kit(opts) if legacy else None

    def cycle(p):
        if legacy:
            p = _mgp_vcycle(p, rhs, dx, dy, opts, kit, bc)
            err, pmax = torch.amax(torch.abs(_mg_residual(p, rhs, dx, dy))), None
        else:
            p, err, pmax = _mgp_vcycle_aligned(p, rhs, dx, dy, opts, smoothers, bc)
        if floor is None:
            return p, err, None
        if pmax is None:
            pmax = torch.amax(torch.abs(p))
        return p, err, floor(pmax, rhs_max)

    p0 = bc(pp0)
    if opts.mgp_fixed_cycles > 0:  # JAX _mgp_fixed (ops/poisson.py:1282-1310)
        err = torch.zeros((), dtype=p0.dtype, device=p0.device)
        for _ in range(opts.mgp_fixed_cycles):
            p0, err, _ = _mgp_vcycle_aligned(p0, rhs, dx, dy, opts, smoothers, bc)
            trace.vcycles += 1
        return p0, err, opts.mgp_fixed_cycles
    tol = torch.as_tensor(tol_r, dtype=torch.float32, device=pp0.device)
    if opts.mgp_rtol > 0.0:
        err0 = torch.amax(torch.abs(_mg_residual(p0, rhs, dx, dy)))
        tol = torch.maximum(tol, opts.mgp_rtol * err0)
    floor = _mgp_noise_floor(opts, dx, dy)
    rhs_max = torch.amax(torch.abs(rhs)) if floor is not None else None
    loop = _exact_while if opts.early_exit else _masked_while
    return loop(cycle, p0, tol, opts.mgp_max_cycles)
