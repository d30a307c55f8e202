"""The port's row-sharded pieces against cfd_demo_tpu on the CPU: the halo
exchange, the shard kernels' plain twins (TPU kernels 11 and 14) and the
row-offset forms of kernels 1 and 3 (the sharded solves:
tests/test_torch_shard_solve.py).

Inputs are made with numpy from a seed and given to both packages. The
JAX side runs its kernels with ``interpret=True`` and its sharded
functions on the 8-device virtual CPU mesh of tests/conftest.py; the
port's wrappers run their plain versions on CPU tensors, on a
``RowMesh`` of the same 8 shards. Only owned rows are compared: the
halo rows go stale by design (the Pallas kernels roll with wraparound
at their window's edges). Tolerances are those of tests/test_shmap.py:
fields 1e-6 of max(1, max|field|), scalars rtol 1e-5 (SOR's residual,
amplified by omega = 1.7, rtol 1e-4 as there).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import cfd_demo_tpu as jc
from cfd_demo_tpu.kernels import jacobi_pallas as jjac
from cfd_demo_tpu.kernels import sor_pallas as jsor
from cfd_demo_tpu.kernels.substep_pallas import correct_bc_pallas, predict_div_pallas
from cfd_demo_tpu.shard import halo as jhalo
from cfd_demo_tpu.shard.mesh import make_mesh as jax_mesh

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.kernels import jacobi as kjac
from cfd_demo_tpu_torch.kernels import sor as ksor
from cfd_demo_tpu_torch.kernels import substep as ksub
from cfd_demo_tpu_torch.shard import halo as thalo
from cfd_demo_tpu_torch.shard import jacobi_shmap as tjs
from cfd_demo_tpu_torch.shard.mesh import gather_state, make_mesh, shard_state, split_rows

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs the 8-device virtual CPU mesh (CFD_TEST_PLATFORM=cpu)")

torch.set_num_threads(1)

S = 8


def T(a):
    return torch.from_numpy(np.array(a))


def atol_of(ref, rtol=1e-6):
    return rtol * max(1.0, float(np.max(np.abs(np.asarray(ref)))))


def assert_fields(got, ref, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol_of(ref, rtol))


def cpu_mesh(n=S):
    return make_mesh(n, "cpu")


# ---------------------------------------------------------------------------
# The mesh and the halo exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 8])
def test_exchange_rows_matches_jax(width):
    """tests/test_shmap.py test_exchange_rows, against shard_map's output."""
    n = 8 * S
    x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    want = jax.shard_map(lambda loc: jhalo.exchange_rows(loc, "y", width),
                         mesh=jax_mesh(), in_specs=P("y", None),
                         out_specs=P("y", None))(jnp.asarray(x))
    mesh = cpu_mesh()
    got = thalo.exchange_rows(split_rows(T(x), mesh), mesh, width)
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))


def test_global_row_index_and_pmax():
    mesh = cpu_mesh(4)
    np.testing.assert_array_equal(thalo.global_row_index(16, 2, 8)[:, 0].numpy(),
                                  np.arange(24, 56))
    errs = [torch.tensor(v) for v in (0.5, 2.0, float("nan"), 1.0)]
    assert torch.isnan(thalo.pmax(errs, mesh))  # NaN propagates, as lax.pmax
    assert float(thalo.pmax(errs[:2] + errs[3:], make_mesh(3, "cpu"))) == 2.0


def test_shard_and_gather_state_round_trip():
    scene = tc.make_scene(tc.Grid(nx=24, ny=32, lx=3.0, ly=4.0), opts=tc.solver_options_for(
        tc.Semantics.JS))
    state = scene.init_state(device="cpu")
    state.u.copy_(torch.randn(state.u.shape))
    mesh = cpu_mesh(4)
    sharded = shard_state(state, mesh)
    assert len(sharded.u) == 4 and sharded.u[0].shape == (8, 25)
    assert sharded.u_prev is not None and sharded.dt.dim() == 0
    back = gather_state(sharded, "cpu")
    for f in ("u", "v", "p", "p_prime", "u_prev", "v_prev", "dt", "step"):
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    with pytest.raises(ValueError, match="do not split"):
        split_rows(torch.zeros(30, 4), mesh)
    with pytest.raises(ValueError, match="at least one"):
        tc.shard.RowMesh(())


# ---------------------------------------------------------------------------
# Kernels 11 and 14: the plain twins against the Pallas kernels
# ---------------------------------------------------------------------------

GNY, NX, LOC = 96, 128, 32


def _block(seed, rows, cols=NX):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((rows, cols)).astype(np.float32),
            rng.standard_normal((rows, cols)).astype(np.float32))


# where row 0 of the block lies: below the grid (shard 0), inside, at the
# top (the last shard), and an odd offset (the red/black parity)
OFFSETS = {"bottom": lambda h: -h, "interior": lambda h: LOC - h,
           "top": lambda h: GNY - LOC - h, "odd": lambda h: 17}


def _shard_case(jax_kernel, port_kernel, halo, k, omega, off, seed, cols=None):
    ext = LOC + 2 * halo
    pp, rhs = _block(seed, ext, NX if cols is None else cols[0])
    kw, own, own_c = {}, slice(halo, halo + LOC), slice(None)
    if cols is not None:
        width, col_off, gnx = cols
        kw = dict(col_offset=col_off, gnx=gnx, own_cols=(halo, width - halo))
        own_c = slice(halo, width - halo)
    want, werr = jax_kernel(jnp.asarray(pp), jnp.asarray(rhs), off, GNY, 1 / NX, 1 / GNY,
                            omega, k, own_lo=halo, own_hi=halo + LOC, interpret=True, **kw)
    got, gerr = port_kernel(T(pp), T(rhs), off, GNY, 1 / NX, 1 / GNY, omega, k, halo,
                            halo + LOC, **kw)
    want = np.asarray(want)[own, own_c]
    assert_fields(got.numpy()[own, own_c], want)
    return float(gerr), float(werr)


@pytest.mark.parametrize("where", sorted(OFFSETS))
@pytest.mark.parametrize("k", [4, 10])
def test_jacobi_fused_k_shard_plain_matches_pallas(where, k):
    halo = tjs.halo8(k)
    gerr, werr = _shard_case(jjac.jacobi_fused_k_shard, kjac.jacobi_fused_k_shard,
                             halo, k, 0.8, OFFSETS[where](halo), seed=k)
    assert np.isclose(gerr, werr, rtol=1e-5, atol=1e-8)


def test_jacobi_fused_k_shard_column_block_matches_pallas():
    """The 2-D tier's column form: a column block whose halo lies left of
    the grid (col_offset < 0), err over the owned columns only."""
    k = 10
    halo = tjs.halo8(k)
    gerr, werr = _shard_case(jjac.jacobi_fused_k_shard, kjac.jacobi_fused_k_shard,
                             halo, k, 0.8, LOC - halo, seed=3,
                             cols=(96 + 2 * halo, -halo, 160))
    assert np.isclose(gerr, werr, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("where", sorted(OFFSETS))
@pytest.mark.parametrize("k", [2, 5])
def test_sor_fused_k_shard_plain_matches_pallas(where, k):
    halo = tjs.halo8(2 * k)
    gerr, werr = _shard_case(jsor.sor_fused_k_shard, ksor.sor_fused_k_shard, halo, k,
                             1.7, OFFSETS[where](halo), seed=10 + k)
    assert np.isclose(gerr, werr, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("col_off", [-16, -15])
def test_sor_fused_k_shard_column_block_matches_pallas(col_off):
    """A column block; an odd column offset flips every cell's colour."""
    k = 5
    halo = tjs.halo8(2 * k)
    gerr, werr = _shard_case(jsor.sor_fused_k_shard, ksor.sor_fused_k_shard, halo, k,
                             1.7, 40 - halo, seed=7, cols=(96 + 2 * halo, col_off, 160))
    assert np.isclose(gerr, werr, rtol=1e-4, atol=1e-7)


def test_shard_kernels_raise_for_cavity_and_bad_blocks():
    pp, rhs = _block(0, 48)
    for kern in (kjac.jacobi_fused_k_shard, ksor.sor_fused_k_shard):
        with pytest.raises(NotImplementedError, match="item 6b"):
            kern(T(pp), T(rhs), 0, GNY, 0.1, 0.1, 0.8, 2, 8, 40, cavity=True)
        with pytest.raises(ValueError, match="owned rows"):
            kern(T(pp), T(rhs), 0, GNY, 0.1, 0.1, 0.8, 2, 8, 49)
        with pytest.raises(ValueError, match="k must be"):
            kern(T(pp), T(rhs), 0, GNY, 0.1, 0.1, 0.8, 0, 8, 40)


# ---------------------------------------------------------------------------
# Kernels 1 and 3 with a row offset: plain against the Pallas kernels
# ---------------------------------------------------------------------------

H = 8  # the substep kernels' halo (shard/step_shmap.py)


def grids(m):
    return m.Grid(nx=48, ny=64, lx=3.0, ly=4.0,
                  obstacles=(m.Cylinder(1.0, 1.55, 0.45),))


def _ext_uv(seed, loc=16):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((loc + 2 * H, 49)).astype(np.float32)
    v = 0.5 * rng.standard_normal((loc + 2 * H, 48)).astype(np.float32)
    return u, v


SHARDS = {"bottom": 0, "middle": 1, "top": 3}  # of 4 shards of 16 rows


@pytest.mark.parametrize("where", sorted(SHARDS))
@pytest.mark.parametrize("scheme,sem", [("FIRST", "RUST"), ("SECOND", "RUST"),
                                        ("QUICK", "RUST"), ("QUICK", "JS")])
def test_predict_div_row_offset_matches_pallas(where, scheme, sem):
    loc = 16
    off = SHARDS[where] * loc - H
    u, v = _ext_uv(hash((where, scheme, sem)) % 1000)
    dt, nu = 0.01, 1e-3
    want = predict_div_pallas(jnp.asarray(u), jnp.asarray(v), dt, nu, grids(jc),
                              getattr(jc.VelocityScheme, scheme),
                              getattr(jc.Semantics, sem), interpret=True, row_offset=off)
    got = ksub.predict_div(T(u), T(v), dt, nu, grids(tc),
                           getattr(tc.VelocityScheme, scheme),
                           getattr(tc.Semantics, sem), row_offset=off)
    own = slice(H, H + loc)
    for g, w in zip(got, want):
        assert_fields(g.numpy()[own], np.asarray(w)[own])


@pytest.mark.parametrize("where", sorted(SHARDS))
@pytest.mark.parametrize("profile,sem", [("UNIFORM", "RUST"), ("PARABOLIC", "JS")])
def test_correct_bc_row_offset_matches_pallas(where, profile, sem):
    loc = 16
    off = SHARDS[where] * loc - H
    rng = np.random.default_rng(SHARDS[where])
    us, vs = _ext_uv(SHARDS[where] + 50)
    p, pp, ve = (rng.standard_normal((loc + 2 * H, 48)).astype(np.float32)
                 for _ in range(3))
    ue = rng.standard_normal((loc + 2 * H, 49)).astype(np.float32)
    dt, inlet = 0.01, 0.7
    args = lambda m, f: (*(f(x) for x in (us, vs, p, pp, ue, ve)), dt, inlet, grids(m),
                         getattr(m.InletProfile, profile), m.FlowCase.CHANNEL,
                         getattr(m.Semantics, sem))
    want = correct_bc_pallas(*args(jc, jnp.asarray), interpret=True, row_offset=off,
                             own_rows=(H, H + loc))
    got = ksub.correct_bc(*args(tc, T), row_offset=off, own_rows=(H, H + loc))
    own = slice(H, H + loc)
    for g, w in zip(got[:3], want[:3]):
        assert_fields(g.numpy()[own], np.asarray(w)[own])
    for g, w in zip(got[3:], want[3:]):
        assert np.isclose(float(g), float(w), rtol=1e-5, atol=1e-8)


def test_offset_forms_equal_the_whole_field_on_one_shard():
    """row_offset 0 on the whole grid is the unsharded call, bit for bit."""
    g = grids(tc)
    u, v = (torch.randn(64, 49), torch.randn(64, 48))
    a = ksub.predict_div(u, v, 0.01, 1e-3, g, tc.VelocityScheme.FIRST, tc.Semantics.RUST)
    b = ksub.predict_div(u, v, 0.01, 1e-3, g, tc.VelocityScheme.FIRST, tc.Semantics.RUST,
                         row_offset=0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    p, pp = torch.randn(64, 48), torch.randn(64, 48)
    args = (a[0], a[1], p, pp, u, v, 0.01, 1.0, g, tc.InletProfile.UNIFORM,
            tc.FlowCase.CHANNEL, tc.Semantics.RUST)
    for x, y in zip(ksub.correct_bc(*args), ksub.correct_bc(*args, row_offset=0,
                                                            own_rows=(0, 64))):
        assert torch.equal(x, y)
