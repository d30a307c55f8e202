"""Fused substep passes as CUDA kernels (↔ cfd_demo_tpu/kernels/substep_pallas.py).

``predict_div`` replaces ``predict_div_pallas`` (substep_pallas.py:231,
body ``_kernel_pre`` :180), csrc/predict_div.cu + predict.cuh. It reads
u, v and the two predictor masks and writes u*, v* and the divergence
RHS: 22 bytes per cell, about 92 MB a call at 2048², 0.028 ms of memory
time on the H100. Its faces are arithmetic-heavy (four IEEE divisions
each, which stay divisions: the plain version and the Pallas kernel
divide), so the kernel is bound by the instructions it issues. The
kernel tiles the field: a CTA of 256 threads owns a tile of 31 rows
by 32 columns of cells (:data:`PREDICT_TILE`; :func:`predict_tile_plan`
gives the launch its grid and its interior tiles). It stages u and v
over the tile's faces and a halo of the scheme's reach (1 for FIRST, 2
for SECOND and QUICK), zero-filled outside the arrays as the plain
version reads them, and the masks over its faces, in shared memory;
computes its 31x33 u* faces and 32x32 v* faces once each (at most 4 a
thread), writing out the ones it owns (the last column tile owns the
outlet face i = nx; v's row past the tile is the next tile's, or v's
implicit zero row); then rhs from shared memory. Interior tiles, whose
window lies inside the arrays and whose faces are all away from the
walls and the schemes' near-wall forms, load with no bounds test and
run the face functions with their row and column tests dropped (a
CTA-uniform branch). A zero dividend skips its division (common.cuh
``div_rn``: IEEE gives the zero itself), which spares the division's
slow path over the zeros of a flow that starts from rest. The face
functions (predict.cuh ``ustar_at``/``vstar_at``) take the loader as a
template parameter and keep every expression's operand order, so under
``-fmad=false`` the kernel gives the plain version's bits as the CPU
computes them. Each upwind scheme (FIRST, SECOND, QUICK: template
parameters) and either semantics (JS averages the convecting v) is an
instance. The obstacle masks are the scene's
``masks_traced`` tensors, one byte a face, so the kernels hold no
obstacle geometry and take any number of cylinders.

``correct_bc`` replaces ``correct_bc_pallas`` (substep_pallas.py:387,
body ``_kernel_post`` :319), csrc/correct_bc.cu. It reads u*, v*, p, p',
the step-entry u and v and the BC masks and writes u, v, p: 38 bytes
per cell, bandwidth-bound. Every face gets the corrector, then the
CHANNEL BCs in the reference's order, the inlet profile evaluated per
row (UNIFORM, PARABOLIC, PARABOLIC_UPPER); the outlet face recomputes
the corrected u[:, nx-1] it copies. In CAVITY flow (a template flag of
the one-launch kernel) the BCs are ops/bc.py's cavity branch: the lid,
UNIFORM or the parabola along x evaluated per face (csrc/common.cuh
``lid_at``), the floor and the side walls. res_u, res_v and max|vel|
(model.rs:333-348, :877-889) are reduced in the same pass, in one
launch (:data:`CORRECT_STRIP`, :func:`correct_strip_plan`): CTAs of
32x8 threads, each thread a column
strip of 16 rows that loads the next row's inputs before it stores this
row's outputs and carries p'[j-1] in a register for v; the three maxima
are reduced together (one shuffle pass over three registers, one
shared exchange) into three partials a CTA, and the last CTA to take a
ticket (an atomic counter after a ``__threadfence``) reduces the
partials into three device scalars and sets the counter back to 0. The
partials and the counter are allocated once per device, stream and
shape. The maxima use ``pmax``, which keeps a NaN as ``torch.amax``
does (no float ``atomicMax``), and are order-free: the plain version's
bits as the CPU computes them. No host read.

``correct_div`` replaces ``correct_div_pallas`` (substep_pallas.py:541,
body ``_kernel_round`` :497), csrc/correct_div.cu: one launch per Rust
outer corrector round on the fused route with ``rounds_impl="pallas"``.
It reads u*, v*, p and p' and writes the corrected u, v, p and, in the
same pass, the divergence RHS the next round's solve consumes: 32
bytes per cell, bandwidth-bound (134 MB, 0.040 ms at 2048²). rhs(j, i)
needs the corrected u(j, i+1) and v(j+1, i): the thread recomputes them
in registers.

``predict_div`` and ``correct_bc`` also take a row block
of a sharded field (the sharded step, shard/step_shmap.py):
``row_offset`` is the global row of the block's row 0, which may be
negative (shard 0's halo lies below the grid), and ``correct_bc``'s
``own_rows`` = (lo, hi) are
the local rows its three reductions count (substep_pallas.py:235, :393,
:406-410). Every row test, the inlet's rows and the masks take global
rows; loads past the block read 0, as the Pallas window's zero-filled
rolls do, so the halo rows' outputs are stale and the caller discards
them. The kernels read the whole grid's masks at global rows; the plain
versions take the block's window of them (``masks_traced(...,
row_offset, rows)``), so the two agree on the rows the caller keeps.
Without an offset the arguments are those of the whole field.

On CPU tensors each wrapper runs its plain version, built from the
ported ops; on CUDA tensors it launches the kernel or raises. Each
wrapper's ``launches`` counts its launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import (FlowCase, Grid, InletProfile, Semantics,
                           VelocityScheme)
from ..core.masks import masks_traced
from ..ops.bc import apply_bcs, parabola
from ..ops.corrector import correct
from ..ops.divergence import divergence_rhs
from ..ops.predictor import predict
from ..trace import traced
from ._build import check, device_scalars, load, mask_ptrs, on_cpu, stream_of

_SCHEME = {VelocityScheme.FIRST: 0, VelocityScheme.SECOND: 1,
           VelocityScheme.QUICK: 2}


def _f32(x: float) -> float:
    return float(np.float32(x))


def inlet_args(grid: Grid, profile: InletProfile,
               flow_case: FlowCase = FlowCase.CHANNEL):
    """(parabolic, f32 center, f32 radius): a kernel's inlet profile
    arguments (csrc/common.cuh ``Inlet``); in CAVITY flow the lid's, whose
    parabola (either parabolic profile) is centred along x."""
    if profile == InletProfile.UNIFORM:
        return 0, 0.0, 1.0
    if flow_case == FlowCase.CAVITY:
        return 1, _f32(grid.lx / 2.0), _f32(grid.lx / 2.0)
    center, radius = parabola(grid, profile)
    return 1, _f32(center), _f32(radius)


def _masks(grid: Grid, semantics: Semantics, device, row_offset, rows):
    if row_offset is None:
        return masks_traced(grid, semantics, device)
    return masks_traced(grid, semantics, device, row_offset, rows)


def _block_rows(grid: Grid, u, row_offset) -> int:
    """The rows of the arrays: the grid's, or a block's (``row_offset``)."""
    return grid.ny if row_offset is None else u.shape[0]


# The tiled predict_div's tile, (rows, cols) of cells a CTA of 256
# threads (csrc/predict_div.cu kTY, kTX; the launch checks them): at most
# 4 of the tile's u faces, v faces and cells a thread.
PREDICT_TILE = (31, 32)
# The one-launch correct_bc's CTA: threads across, threads down, rows a
# thread (csrc/correct_bc.cu kCX, kCY, kCR).
CORRECT_STRIP = (32, 8, 16)


def scheme_reach(scheme: VelocityScheme) -> int:
    """How far a face's stencil reaches (ops/schemes.py): 1 for FIRST, 2
    for SECOND and QUICK (the ±2 neighbours)."""
    return 1 if scheme == VelocityScheme.FIRST else 2


@functools.lru_cache(maxsize=None)
def predict_tile_plan(ny: int, nx: int, scheme: VelocityScheme, row_offset: int = 0,
                      gny: int | None = None, tile: tuple = PREDICT_TILE) -> dict:
    """The tiled predict_div's launch on a (ny, nx) block at global row
    ``row_offset`` of a ``gny``-row grid (the whole field: 0, ny), with
    the kernel's tile (a rebuilt kernel's, to time another).

    With (ty, tx) = ``tile``, tile (by, bx) owns the cells of rows
    [ty by, ty by + ty) and columns [tx bx, tx bx + tx) within the block,
    their u faces (the last column tile also the outlet face i = nx) and
    v faces; it stages u and v over its faces and a ``halo`` of the
    scheme's reach. Returns ``grid`` (gy,
    gx), ``tile``, ``halo`` and ``fast`` = (fy0, fy1, fx0, fx1): the
    interior tiles [fy0, fy1) x [fx0, fx1), whose window lies inside the
    arrays and whose u faces (global rows 2..gny-3, columns 3..nx-2) and
    v faces (global rows 2..gny-2, columns 3..nx-3) all take the faces'
    generic form; the kernel reads them with no bounds or row test."""
    gny = ny if gny is None else gny
    ty, tx = tile
    h = scheme_reach(scheme)
    gy, gx = -(-ny // ty), -(-nx // tx)
    # a tile computes u faces of rows [r0, r0 + ty) and v faces of rows
    # [r0, r0 + ty]; its window holds rows [r0 - h, r0 + ty + 1 + h)
    rows = [by for by in range(gy)
            if by * ty >= h and by * ty + row_offset >= 2
            and by * ty + ty + 1 + h <= ny and by * ty + ty + row_offset <= gny - 2]
    # u faces of columns [c0, c0 + tx], v faces of [c0, c0 + tx)
    cols = [bx for bx in range(gx) if bx * tx >= 3 and bx * tx + tx <= nx - 2]
    fy = (rows[0], rows[-1] + 1) if rows else (0, 0)
    fx = (cols[0], cols[-1] + 1) if cols else (0, 0)
    if not rows or not cols:
        fy = fx = (0, 0)
    return {"grid": (gy, gx), "tile": tile, "halo": h, "fast": (*fy, *fx)}


def predict_tile_owned(plan: dict, by: int, bx: int, ny: int, nx: int) -> dict:
    """The faces and cells tile (by, bx) of ``plan`` writes, as (rows,
    cols) ranges: ``u`` (the last column tile also owns the outlet face
    i = nx), ``v`` and ``rhs``, clipped to the block (csrc/predict_div.cu
    ``tile_body``)."""
    ty, tx = plan["tile"]
    r0, c0 = by * ty, bx * tx
    rows = range(r0, min(r0 + ty, ny))
    last = bx == plan["grid"][1] - 1
    return {"u": (rows, range(c0, nx + 1 if last else c0 + tx)),
            "v": (rows, range(c0, min(c0 + tx, nx))),
            "rhs": (rows, range(c0, min(c0 + tx, nx)))}


def correct_strip_plan(ny: int, nx: int) -> dict:
    """The one-launch correct_bc's launch on a (ny, nx) block: ``grid``
    (gy, gx) CTAs of :data:`CORRECT_STRIP` threads, ``partials`` (one
    set of three maxima a CTA; csrc/correct_bc.cu
    ``cfd_correct_bc_fused_partials`` gives the same count)."""
    cx, cy, cr = CORRECT_STRIP
    gy, gx = -(-ny // (cy * cr)), -(-(nx + 1) // cx)
    return {"grid": (gy, gx), "threads": (cy, cx), "rows": cr, "partials": gy * gx}


def correct_strips(plan: dict, ny: int, nx: int):
    """Every thread's strip of ``plan``: (CTA, column, rows), the rows
    clipped to the block; threads past the block's faces are left out."""
    (gy, gx), (cy, cx), cr = plan["grid"], plan["threads"], plan["rows"]
    for by in range(gy):
        for bx in range(gx):
            for ty in range(cy):
                j0 = (by * cy + ty) * cr
                for tx in range(cx):
                    i = bx * cx + tx
                    if i <= nx and j0 < ny:
                        yield by * gx + bx, i, range(j0, min(j0 + cr, ny))


def predict_div_plain(u, v, dt_sub, nu, grid: Grid, scheme: VelocityScheme,
                      semantics: Semantics, row_offset=None):
    """ops.predictor.predict + ops.divergence.divergence_rhs."""
    mask_u, mask_v, _, _ = _masks(grid, semantics, u.device, row_offset, u.shape[0])
    u_star, v_star = predict(u, v, dt_sub, nu, grid.dx, grid.dy, grid.nx,
                             grid.ny, scheme, semantics == Semantics.JS,
                             mask_u, mask_v, row_offset or 0)
    return u_star, v_star, divergence_rhs(u_star, v_star, dt_sub, grid.dx,
                                          grid.dy)


@traced("cfd.kernel.predict_div")
def predict_div(u, v, dt_sub, nu, grid: Grid, scheme: VelocityScheme,
                semantics: Semantics, row_offset=None):
    """Fused predictor + divergence: returns (u_star, v_star, rhs) in the
    storage shapes (ny, nx+1), (ny, nx), (ny, nx), ny the block's rows
    when ``row_offset`` (an int) places u and v in the grid. ``dt_sub``
    and ``nu`` are floats or 0-d tensors on the fields' device."""
    ny, nx = _block_rows(grid, u, row_offset), grid.nx
    if on_cpu("predict_div", {"u": (u, (ny, nx + 1)), "v": (v, (ny, nx))}):
        return predict_div_plain(u, v, dt_sub, nu, grid, scheme, semantics,
                                 row_offset)
    lib = load()
    u_star, v_star, rhs = (torch.empty_like(u), torch.empty_like(v),
                           torch.empty_like(v))
    scal = device_scalars(u.device, dt_sub, nu)
    mask_u, mask_v, _, _ = mask_ptrs(grid, semantics, u.device)
    args = (u.data_ptr(), v.data_ptr(), scal.data_ptr(), u_star.data_ptr(),
            v_star.data_ptr(), rhs.data_ptr(), mask_u, mask_v, ny, nx, row_offset or 0,
            grid.ny, _f32(grid.dx), _f32(grid.dy), _f32(grid.dx * grid.dx),
            _f32(grid.dy * grid.dy), _SCHEME[scheme], int(semantics == Semantics.JS))
    plan = predict_tile_plan(ny, nx, scheme, row_offset or 0, grid.ny)
    with torch.cuda.device(u.device):
        check(lib.cfd_predict_div_tiled(*args, *plan["tile"], *plan["fast"], stream_of(u)),
              "predict_div")
    predict_div.launches += 1
    return u_star, v_star, rhs


predict_div.launches = 0


def correct_bc_plain(u_star, v_star, p, p_prime, u_entry, v_entry, dt_sub,
                     inlet, grid: Grid, profile: InletProfile,
                     flow_case: FlowCase, semantics: Semantics, row_offset=None,
                     own_rows=None):
    """ops.corrector.correct + ops.bc.apply_bcs + the three maxima (over
    the rows ``own_rows``)."""
    rows = u_star.shape[0]
    _, _, mask_u_bc, mask_v_bc = _masks(grid, semantics, u_star.device,
                                        row_offset, rows)
    u, v, p = correct(u_star, v_star, p, p_prime, dt_sub, grid.dx, grid.dy)
    u, v = apply_bcs(u, v, grid, profile, inlet, mask_u_bc, mask_v_bc,
                     flow_case, row_offset or 0)
    lo, hi = own_rows or (0, rows)
    uo, vo = u[lo:hi], v[lo:hi]
    res_u = torch.amax(torch.abs(uo - u_entry[lo:hi]))
    res_v = torch.amax(torch.abs(vo - v_entry[lo:hi]))
    max_vel = torch.maximum(torch.amax(torch.abs(uo)), torch.amax(torch.abs(vo)))
    return u, v, p, res_u, res_v, max_vel


# (device, stream, CTAs) -> (partials, ticket) of the one-launch
# correct_bc: allocated once, the ticket zeroed once; every launch leaves
# it at 0. One stream's launches run one at a time.
_STRIP_SCRATCH: dict = {}


def _strip_scratch(device, stream: int, ctas: int):
    key = (device, stream, ctas)
    if key not in _STRIP_SCRATCH:
        _STRIP_SCRATCH[key] = (torch.empty(3 * ctas, dtype=torch.float32, device=device),
                               torch.zeros(1, dtype=torch.int32, device=device))
    return _STRIP_SCRATCH[key]


@traced("cfd.kernel.correct_bc")
def correct_bc(u_star, v_star, p, p_prime, u_entry, v_entry, dt_sub, inlet,
               grid: Grid, profile: InletProfile, flow_case: FlowCase,
               semantics: Semantics, row_offset=None, own_rows=None):
    """Fused corrector + BCs + step reductions. Returns
    (u, v, p, res_u, res_v, max_vel), the last three 0-d tensors:
    res_* = max|field - entry| (model.rs:333-348) and max_vel feeds the
    CFL controller. With ``row_offset`` (an int) the arrays are a row
    block of the grid and the maxima count the local rows ``own_rows`` =
    (lo, hi) only (all rows when None)."""
    cavity = flow_case == FlowCase.CAVITY
    ny, nx = _block_rows(grid, u_star, row_offset), grid.nx
    own_lo, own_hi = own_rows or (0, ny)
    if not 0 <= own_lo < own_hi <= ny:
        raise ValueError(f"correct_bc: own_rows {own_rows} outside the block's {ny} rows")
    shapes = {"u_star": (u_star, (ny, nx + 1)), "v_star": (v_star, (ny, nx)),
              "p": (p, (ny, nx)), "p_prime": (p_prime, (ny, nx)),
              "u_entry": (u_entry, (ny, nx + 1)), "v_entry": (v_entry, (ny, nx))}
    if on_cpu("correct_bc", shapes):
        return correct_bc_plain(u_star, v_star, p, p_prime, u_entry, v_entry,
                                dt_sub, inlet, grid, profile, flow_case,
                                semantics, row_offset, own_rows)
    lib = load()
    dev = u_star.device
    u, v, p_new = (torch.empty_like(u_star), torch.empty_like(v_star),
                   torch.empty_like(p))
    red = torch.empty(3, dtype=torch.float32, device=dev)
    scal = device_scalars(dev, dt_sub, inlet)
    _, _, mask_u_bc, mask_v_bc = mask_ptrs(grid, semantics, dev)
    ins = (u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(), p_prime.data_ptr(),
           u_entry.data_ptr(), v_entry.data_ptr(), scal.data_ptr(), u.data_ptr(),
           v.data_ptr(), p_new.data_ptr())
    rest = (ny, nx, row_offset or 0, grid.ny, own_lo, own_hi, _f32(grid.dx),
            _f32(grid.dy), *inlet_args(grid, profile, flow_case))
    with torch.cuda.device(dev):
        stream = stream_of(u_star)
        partials, ticket = _strip_scratch(dev, stream, correct_strip_plan(ny, nx)["partials"])
        check(lib.cfd_correct_bc_fused(
            *ins, partials.data_ptr(), ticket.data_ptr(), red.data_ptr(), mask_u_bc,
            mask_v_bc, *rest, int(cavity), stream), "correct_bc")
    correct_bc.launches += 1
    correct_bc.cavity_launches += cavity
    return u, v, p_new, red[0], red[1], red[2]


correct_bc.launches = 0
correct_bc.cavity_launches = 0


def correct_div_plain(u_star, v_star, p, p_prime, dt_sub, grid: Grid):
    """ops.corrector.correct + ops.divergence.divergence_rhs."""
    u, v, p = correct(u_star, v_star, p, p_prime, dt_sub, grid.dx, grid.dy)
    return u, v, p, divergence_rhs(u, v, dt_sub, grid.dx, grid.dy)


@traced("cfd.kernel.correct_div")
def correct_div(u_star, v_star, p, p_prime, dt_sub, grid: Grid):
    """Fused corrector + next-round divergence: returns (u, v, p_new,
    rhs_next) in the storage shapes, rhs_next the divergence RHS of the
    corrected (u, v). ``dt_sub`` is a float or a 0-d tensor on the
    fields' device."""
    ny, nx = grid.ny, grid.nx
    shapes = {"u_star": (u_star, (ny, nx + 1)), "v_star": (v_star, (ny, nx)),
              "p": (p, (ny, nx)), "p_prime": (p_prime, (ny, nx))}
    if on_cpu("correct_div", shapes):
        return correct_div_plain(u_star, v_star, p, p_prime, dt_sub, grid)
    lib = load()
    u, v = torch.empty_like(u_star), torch.empty_like(v_star)
    p_new, rhs = torch.empty_like(p), torch.empty_like(p)
    scal = device_scalars(u.device, dt_sub)
    with torch.cuda.device(u.device):
        check(lib.cfd_correct_div(
            u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(),
            p_prime.data_ptr(), scal.data_ptr(), u.data_ptr(), v.data_ptr(),
            p_new.data_ptr(), rhs.data_ptr(), ny, nx, _f32(grid.dx),
            _f32(grid.dy), stream_of(u)), "correct_div")
    correct_div.launches += 1
    return u, v, p_new, rhs


correct_div.launches = 0
