"""Kernel 1's tiled schedule and kernel 3's strip schedule, on the CPU.

csrc/predict_div.cu runs predict_div on tiles of ``PREDICT_TILE`` cells:
a CTA stages u and v over its faces and a halo of the scheme's reach,
computes each of its u* and v* faces once and writes the ones it owns;
``predict_tile_plan`` (the launch's plan) names the interior tiles that
read with no bounds or row tests. csrc/correct_bc.cu runs correct_bc
as one launch of column strips (``correct_strip_plan``) with one set of
three partial maxima a CTA. No CUDA kernel runs here: these tests hold
the plans to what the kernels need (every face and cell written once,
a halo that covers the stencil, interior tiles only where the plain
version has no near-wall form), and emulate the schedules with the
plain versions: ``predict_div_plain`` on each row tile's window at its
global row offset gives the whole field's bits, and the strips' per-CTA
maxima reduce to ``correct_bc_plain``'s. The CUDA kernels are held to
the plain versions bit for bit by tests/test_torch_cuda.py on the card.
The last tests add the row-offset forms the Pallas parity tests
of tests/test_torch_shard_kernels.py leave out (JS FIRST and SECOND,
PARABOLIC_UPPER) against the Pallas kernels in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.kernels.substep_pallas import correct_bc_pallas, predict_div_pallas

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.kernels import substep as ksub

torch.set_num_threads(1)

SCHEMES = list(tc.VelocityScheme)
INSTANCES = [(s, m) for s in tc.VelocityScheme for m in tc.Semantics]
DT, NU = 0.003, 1e-4
# (nx, ny): odd and even, a one-tile grid, tiles straddling every edge,
# and grids with interior tiles, some a cell or two past a whole tile.
SHAPES = [(65, 47), (64, 48), (33, 17), (20, 12), (130, 97), (200, 160), (97, 100),
          (98, 95)]
# Row blocks (rows, row offset, the grid's rows): below the grid, inside
# it, past its top.
BLOCKS = [(96, -16, 160), (96, 40, 160), (80, 100, 160), (80, 97, 160), (33, 3, 47)]


def grid_of(nx, ny):
    lx, ly = 3.0, 3.0 * ny / nx
    return tc.Grid(nx=nx, ny=ny, lx=lx, ly=ly,
                   obstacles=(tc.Cylinder(0.3 * lx, 0.5 * ly, 0.2 * ly),
                              tc.Cylinder(0.7 * lx, 0.3 * ly, 0.1 * ly)))


def fields(seed, rows, nx, zero_frac=0.0):
    """Seeded random (u, v) of ``rows`` rows; ``zero_frac`` of the values
    set to exactly 0, as a flow starting from rest has them."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((rows, nx + 1)).astype(np.float32)
    v = (0.5 * rng.standard_normal((rows, nx))).astype(np.float32)
    if zero_frac:
        u[rng.random(u.shape) < zero_frac] = 0.0
        v[rng.random(v.shape) < zero_frac] = 0.0
    return torch.from_numpy(u), torch.from_numpy(v)


def tiles(plan):
    gy, gx = plan["grid"]
    return [(by, bx) for by in range(gy) for bx in range(gx)]


def is_fast(plan, by, bx):
    fy0, fy1, fx0, fx1 = plan["fast"]
    return fy0 <= by < fy1 and fx0 <= bx < fx1


# ---------------------------------------------------------------------------
# Kernel 1: the tile plan
# ---------------------------------------------------------------------------

def _cases():
    for nx, ny in SHAPES:
        yield ny, nx, 0, ny
    for rows, off, gny in BLOCKS:
        yield rows, 200 if gny == 160 else 65, off, gny


CASES = list(_cases())


@pytest.mark.parametrize("tile", [ksub.PREDICT_TILE, (7, 32), (15, 64)])
@pytest.mark.parametrize("ny,nx,off,gny", CASES)
def test_tile_plan_writes_every_face_and_cell_once(ny, nx, off, gny, tile):
    for scheme in SCHEMES:
        plan = ksub.predict_tile_plan(ny, nx, scheme, off, gny, tile=tile)
        assert plan["tile"] == tile
        count = {"u": torch.zeros(ny, nx + 1, dtype=torch.int32),
                 "v": torch.zeros(ny, nx, dtype=torch.int32),
                 "rhs": torch.zeros(ny, nx, dtype=torch.int32)}
        for by, bx in tiles(plan):
            for what, (rows, cols) in ksub.predict_tile_owned(plan, by, bx, ny, nx).items():
                count[what][rows.start:rows.stop, cols.start:cols.stop] += 1
        for what, c in count.items():
            assert bool((c == 1).all()), (what, int(c.min()), int(c.max()))


def reach(scheme, semantics, field):
    """How far a change of ``field`` ("u" or "v") at one point moves u*
    and v* in the plain version: the largest (row, column) distance of a
    changed face, for each output, on a 40x32 grid with no obstacle."""
    grid = tc.Grid(nx=40, ny=32, lx=3.0, ly=2.4)
    u, v = fields(7, 32, 40)
    ref = ksub.predict_div_plain(u, v, DT, NU, grid, scheme, semantics)
    j0, i0 = 16, 20
    u2, v2 = u.clone(), v.clone()
    (u2 if field == "u" else v2)[j0, i0] += 0.75
    got = ksub.predict_div_plain(u2, v2, DT, NU, grid, scheme, semantics)
    out = {}
    for name, a, b in (("u*", got[0], ref[0]), ("v*", got[1], ref[1])):
        jj, ii = torch.nonzero(a != b, as_tuple=True)
        out[name] = (int((jj - j0).abs().max()), int((ii - i0).abs().max()))
    return out


@pytest.mark.parametrize("scheme,semantics", INSTANCES)
def test_tile_halo_covers_the_stencil(scheme, semantics):
    """A face reads u and v at most ``halo`` rows and columns away from
    itself (the windows hold the tile's faces and that halo), and the
    scheme's own field reaches exactly that far."""
    h = ksub.predict_tile_plan(64, 64, scheme)["halo"]
    assert h == ksub.scheme_reach(scheme)
    for field in ("u", "v"):
        r = reach(scheme, semantics, field)
        for name, (dj, di) in r.items():
            assert max(dj, di) <= h, (field, name, dj, di, h)
    own = reach(scheme, semantics, "u")["u*"]
    assert max(own) == h


def generic_u(gj, i, nx, gny):
    """A u face the plain version computes with no row or column case:
    inside the interior (ops/predictor.py: rows 1..gny-2, columns
    1..nx-1) and past every near-wall form of ops/schemes.py u_faces
    (SECOND: i > 2, i < nx - 1, j > 1, j < gny - 2; QUICK: i >= 3,
    i <= nx - 2, j >= 2, j < gny - 2)."""
    return 3 <= i <= nx - 2 and 2 <= gj <= gny - 3


def generic_v(gj, i, nx, gny):
    """The same for a v face (ops/predictor.py: rows 1..gny-1, columns
    1..nx-2; v_faces: i > 1, i < nx - 2, j > 1, j < gny - 1)."""
    return 3 <= i <= nx - 3 and 2 <= gj <= gny - 2


@pytest.mark.parametrize("ny,nx,off,gny", CASES + [(2048, 2048, 0, 2048),
                                                   (528, 2048, 1016, 2048)])
def test_fast_tiles_are_generic(ny, nx, off, gny):
    """Every interior tile's window lies inside the arrays (its loads
    need no test), and every face it computes is generic; at 2048^2 all
    but the edge tiles (two rows at the top, where the last tile is
    ragged) are interior."""
    for scheme in SCHEMES:
        plan = ksub.predict_tile_plan(ny, nx, scheme, off, gny)
        h, (ty, tx) = plan["halo"], plan["tile"]
        fast = [t for t in tiles(plan) if is_fast(plan, *t)]
        small = ny * nx < 50_000  # every face; else the corners (the sets are boxes)
        for by, bx in fast:
            r0, c0 = by * ty, bx * tx
            assert r0 - h >= 0 and r0 + ty + 1 + h <= ny  # u and v windows' rows
            assert c0 - h >= 0 and c0 + tx + h <= nx      # u's columns to c0+tx+h
            u_rows, u_cols = range(r0, r0 + ty), range(c0, c0 + tx + 1)
            v_rows, v_cols = range(r0, r0 + ty + 1), range(c0, c0 + tx)
            pick = (lambda x: x) if small else (lambda x: (x[0], x[-1]))
            assert all(generic_u(j + off, i, nx, gny) for j in pick(u_rows)
                       for i in pick(u_cols))
            assert all(generic_v(j + off, i, nx, gny) and j < ny for j in pick(v_rows)
                       for i in pick(v_cols))
        if ny >= 2048 or (ny, nx) == (528, 2048):
            gy, gx = plan["grid"]
            assert len(fast) >= (gy - 3) * (gx - 2), (len(fast), gy, gx)
        fy0, fy1, fx0, fx1 = plan["fast"]
        assert (fy1 > fy0) == (fx1 > fx0)  # empty both ways or neither


def test_fast_rows_take_every_generic_tile():
    """The interior rectangle is not needlessly small: each row tile
    outside it (at a width that has interior columns) has a window past
    the block or a face with a near-wall form."""
    ny, nx, off, gny = 200, 130, 0, 200
    for scheme in SCHEMES:
        plan = ksub.predict_tile_plan(ny, nx, scheme, off, gny)
        h, (ty, tx) = plan["halo"], plan["tile"]
        fy0, fy1, fx0, fx1 = plan["fast"]
        for by in range(plan["grid"][0]):
            if fy0 <= by < fy1:
                continue
            r0 = by * ty
            inside = r0 - h >= 0 and r0 + ty + 1 + h <= ny
            generic = all(2 <= r0 + r + off <= gny - 3 for r in range(ty)) and \
                2 <= r0 + ty + off <= gny - 2
            assert not (inside and generic), (scheme, by)


@pytest.mark.parametrize("tile_rows", [ksub.PREDICT_TILE[0], 7])
@pytest.mark.parametrize("scheme,semantics", INSTANCES)
@pytest.mark.parametrize("ny,nx,off,gny", [(47, 65, 0, 47), (48, 64, 0, 48),
                                           (17, 33, 0, 17), (12, 20, 0, 12),
                                           (96, 200, -16, 160), (80, 200, 100, 160)])
def test_row_tiled_schedule_is_the_whole_field(ny, nx, off, gny, scheme, semantics,
                                               tile_rows):
    """predict_div_plain on each row tile's window (its rows and the
    halo, one more v row for the rhs, clipped to the block) at its global
    row offset, owned rows taken, is the whole block's predict_div_plain
    bit for bit (zeros in the fields, as the kernels see them)."""
    grid = grid_of(nx, gny)
    u, v = fields(ny + nx + off, ny, nx, zero_frac=0.3)
    row_offset = off if (off, gny) != (0, ny) else None
    ref = ksub.predict_div_plain(u, v, DT, NU, grid, scheme, semantics, row_offset)
    plan = ksub.predict_tile_plan(ny, nx, scheme, off, gny, tile=(tile_rows, 32))
    h = plan["halo"]
    got = [torch.full_like(x, float("nan")) for x in ref]
    for by in range(plan["grid"][0]):
        r0 = by * tile_rows
        r1 = min(r0 + tile_rows, ny)
        lo, hi = max(r0 - h, 0), min(r1 + 1 + h, ny)
        out = ksub.predict_div_plain(u[lo:hi].contiguous(), v[lo:hi].contiguous(), DT, NU,
                                     grid, scheme, semantics, off + lo)
        for g, o in zip(got, out):
            g[r0:r1] = o[r0 - lo:r1 - lo]
    for name, a, b in zip(("u*", "v*", "rhs"), got, ref):
        assert torch.equal(a, b), (name, float((a - b).abs().nan_to_num(1e30).max()))


# ---------------------------------------------------------------------------
# Kernel 3: the strip plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,ny", SHAPES + [(2048, 2048), (2048, 528)])
def test_strip_plan_covers_each_face_once(nx, ny):
    plan = ksub.correct_strip_plan(ny, nx)
    count = torch.zeros(ny, nx + 1, dtype=torch.int32)
    ctas = set()
    for cta, i, rows in ksub.correct_strips(plan, ny, nx):
        count[rows.start:rows.stop, i] += 1
        ctas.add(cta)
    assert bool((count == 1).all())
    gy, gx = plan["grid"]
    assert plan["partials"] == gy * gx
    assert ctas <= set(range(plan["partials"]))
    # every CTA with a face writes its partials; at 2048^2 every CTA has one
    if nx >= 2048:
        assert len(ctas) == plan["partials"]


def _correct_inputs(seed, rows, nx):
    rng = np.random.default_rng(seed)
    mk = lambda c: torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32))
    return mk(nx + 1), mk(nx), mk(nx), mk(nx), mk(nx + 1), mk(nx)


def strip_maxima(plan, ny, nx, faces_u, faces_v, own):
    """The kernel's reduction, emulated: each CTA's maxima over its
    strips' owned faces (torch.amax keeps a NaN, as pmax does), then the
    maxima over the CTAs' partials."""
    parts = torch.zeros(plan["partials"], 3)
    lo, hi = own
    for cta, i, rows in ksub.correct_strips(plan, ny, nx):
        r0, r1 = max(rows.start, lo), min(rows.stop, hi)
        if r0 >= r1:
            continue
        vals = [(0, faces_u[0][r0:r1, i]), (2, faces_u[1][r0:r1, i])]
        if i < nx:
            vals += [(1, faces_v[0][r0:r1, i]), (2, faces_v[1][r0:r1, i])]
        for c, x in vals:
            parts[cta, c] = torch.amax(torch.cat([parts[cta, c:c + 1], x]))
    return torch.amax(parts, dim=0)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("ny,nx,off,gny,own", [(47, 65, 0, 47, None), (17, 33, 0, 17, None),
                                               (96, 130, -16, 160, (16, 80)),
                                               (96, 130, 80, 160, (0, 96)),
                                               (96, 130, 40, 160, (63, 95))])
def test_strip_reductions_are_the_plain_maxima(ny, nx, off, gny, own, nan):
    """The strips' per-CTA partials reduce to correct_bc_plain's res_u,
    res_v and max_vel bit for bit, counting the owned rows only; a NaN in
    u* comes out in res_u and max_vel."""
    grid = grid_of(nx, gny)
    us, vs, p, pp, ue, ve = _correct_inputs(ny + nx + off, ny, nx)
    if nan:  # a row inside the walls, a column clear of the cylinders
        us[sum(own or (0, ny)) // 2, nx // 2] = float("nan")
    kw = {} if (off, gny) == (0, ny) else dict(row_offset=off, own_rows=own)
    u, v, _, res_u, res_v, max_vel = ksub.correct_bc_plain(
        us, vs, p, pp, ue, ve, DT, 0.8, grid, tc.InletProfile.PARABOLIC,
        tc.FlowCase.CHANNEL, tc.Semantics.RUST, **kw)
    plan = ksub.correct_strip_plan(ny, nx)
    got = strip_maxima(plan, ny, nx, ((u - ue).abs(), u.abs()), ((v - ve).abs(), v.abs()),
                       own or (0, ny))
    want = torch.stack([res_u, res_v, max_vel])
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    if nan:
        assert bool(res_u.isnan()) and bool(max_vel.isnan()) and not bool(res_v.isnan())


# ---------------------------------------------------------------------------
# Row-offset forms against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

H, LOC = 8, 16  # shard/step_shmap.py's halo; 16 owned rows of a 64-row grid


def _block_grid(m):
    return m.Grid(nx=48, ny=64, lx=3.0, ly=4.0, obstacles=(m.Cylinder(1.0, 1.55, 0.45),))


@pytest.mark.parametrize("shard", [0, 2, 3])
@pytest.mark.parametrize("scheme,sem", [("FIRST", "JS"), ("SECOND", "JS")])
def test_predict_div_row_offset_matches_pallas_js(shard, scheme, sem):
    off = shard * LOC - H
    u, v = (x.numpy() for x in fields(90 + shard, LOC + 2 * H, 48))
    want = predict_div_pallas(jnp.asarray(u), jnp.asarray(v), DT, NU, _block_grid(jc),
                              getattr(jc.VelocityScheme, scheme), getattr(jc.Semantics, sem),
                              interpret=True, row_offset=off)
    got = ksub.predict_div(torch.from_numpy(u), torch.from_numpy(v), DT, NU,
                           _block_grid(tc), getattr(tc.VelocityScheme, scheme),
                           getattr(tc.Semantics, sem), row_offset=off)
    own = slice(H, H + LOC)
    for g, w in zip(got, want):
        w = np.asarray(w)[own]
        np.testing.assert_allclose(g.numpy()[own], w, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("shard", [0, 3])
@pytest.mark.parametrize("sem", ["RUST", "JS"])
def test_correct_bc_row_offset_matches_pallas_upper(shard, sem):
    off = shard * LOC - H
    arrays = [x.numpy() for x in _correct_inputs(95 + shard, LOC + 2 * H, 48)]
    args = lambda m, f: (*(f(x) for x in arrays), DT, 0.7, _block_grid(m),
                         m.InletProfile.PARABOLIC_UPPER, m.FlowCase.CHANNEL,
                         getattr(m.Semantics, sem))
    want = correct_bc_pallas(*args(jc, jnp.asarray), interpret=True, row_offset=off,
                             own_rows=(H, H + LOC))
    got = ksub.correct_bc(*args(tc, torch.from_numpy), row_offset=off, own_rows=(H, H + LOC))
    own = slice(H, H + LOC)
    for g, w in zip(got[:3], want[:3]):
        w = np.asarray(w)[own]
        np.testing.assert_allclose(g.numpy()[own], w, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(w).max())))
    for g, w in zip(got[3:], want[3:]):
        assert np.isclose(float(g), float(w), rtol=1e-5, atol=1e-8)
