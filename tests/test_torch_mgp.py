"""The port's MG_PRODUCTION projection against cfd_demo_tpu on the CPU.

- The plain versions of the four smoother kernels (kernels/mgp.py)
  against the Pallas kernels they replace, in interpret mode, with the
  shapes, call forms and tolerances of tests/test_projection.py:294-336,
  :598-680 and tests/test_jacobi_kernel_interpret.py:78-106.
- The cell-centred kit against ops/poisson.py, bit for bit.
- The whole ``multigrid_production`` against the JAX one, and a 5-step
  production rollout against ``cfd_demo_tpu.make_run``.

Why the solves are compared with JAX's op-by-op semantics: the solve
runs to the f32 noise floor of its residual, and an ulp of difference
anywhere changes the rounding of every later residual; the solve maps
that noise through A^-1, whose condition number grows as n², so two
faithful f32 solves at 256² differ by ~eps n relative (2-6e-5 measured)
in their smoothest modes. Under jit, XLA rewrites the divisions by the
constants h² into reciprocal multiplies, which alone moves the JAX
package's own 256² solve by 2.6e-3 relative after two cycles. So the
standalone solves compare with JAX run op by op (``jax.disable_jit``),
and the rollout runs where n is small enough for the golden bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.kernels import jacobi_pallas as JK
from cfd_demo_tpu.ops import poisson as JP

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.kernels import mgp
from cfd_demo_tpu_torch.ops import poisson as TP

from conftest import l2

torch.set_num_threads(1)
EPS = float(np.finfo(np.float32).eps)
OMEGA, K = 0.75, 3


def T(a):
    return torch.from_numpy(np.array(a))


def fine_case(seed, shape):
    """BC-consistent p' (what the folded kernels require) and a random
    rhs, as tests/test_projection.py:303-308 builds them."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    pp = JP._apply_pprime_bcs(jnp.asarray(0.1 * rng.standard_normal(shape),
                                          jnp.float32))
    rhs = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    return pp, rhs, 1.0 / nx, 1.0 / ny


def res_tol(p_ref, rhs, dx, dy):
    """The residual's f32 cancellation floor (test_projection.py:320)."""
    return 30 * EPS * ((2 / dx ** 2 + 2 / dy ** 2) * float(np.abs(p_ref).max())
                       + float(np.abs(rhs).max()))


# ---------------------------------------------------------------------------
# Plain versions of kernels 6-9 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [((64, 96), 3), ((64, 97), 3),   # odd nx
                                     ((384, 128), 8)])               # block seams
def test_res_plain_matches_pallas(shape, k):
    pp, rhs, dx, dy = fine_case(11, shape)
    p_ref, r_ref, m_ref = JK.jacobi_fused_k_res(pp, rhs, dx, dy, OMEGA, k,
                                                interpret=True)
    p_got, r_got, m_got = mgp.jacobi_fused_k_res(T(pp), T(rhs), dx, dy, OMEGA, k)
    tol = res_tol(p_ref, rhs, dx, dy)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_ref), rtol=0, atol=tol)
    assert np.isclose(float(m_got), float(m_ref), rtol=1e-3, atol=tol)
    # emit_res=False: the same p' and metric, no residual array
    _, r_none, m_none = JK.jacobi_fused_k_res(pp, rhs, dx, dy, OMEGA, k,
                                              interpret=True, emit_res=False)
    p2, r2, m2 = mgp.jacobi_fused_k_res(T(pp), T(rhs), dx, dy, OMEGA, k, False)
    assert r_none is None and r2 is None
    torch.testing.assert_close(p2, p_got, rtol=0, atol=0)
    assert float(m2) == float(m_got)
    assert np.isclose(float(m2), float(m_none), rtol=1e-3, atol=tol)


@pytest.mark.parametrize("shape", [(64, 96), (48, 150)])
def test_restrict_plain_matches_pallas(shape):
    ny, nx = shape
    pp, rhs, dx, dy = fine_case(19, shape)
    p_ref, m, m_ref = JK.jacobi_fused_k_restrict(pp, rhs, dx, dy, OMEGA, K,
                                                 interpret=True)
    ncy, ncx = (ny - 2) // 2, (nx - 2) // 2
    rc_ref = np.asarray(m)[:ncy, 1::2][:, :ncx]  # the TPU layout, unpacked
    p_got, rc_got, m_got = mgp.jacobi_fused_k_restrict(T(pp), T(rhs), dx, dy,
                                                       OMEGA, K)
    assert tuple(rc_got.shape) == (ncy, ncx)
    tol = res_tol(p_ref, rhs, dx, dy)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rc_got.numpy(), rc_ref, rtol=0, atol=tol)
    assert np.isclose(float(m_got), float(m_ref), rtol=1e-3, atol=tol)


@pytest.mark.parametrize("shape", [(64, 96), (80, 150)])
def test_corr_plain_matches_pallas(shape):
    ny, nx = shape
    pp, rhs, dx, dy = fine_case(23, shape)
    ncy, ncx = (ny - 2) // 2, (nx - 2) // 2
    e_c = jnp.asarray(0.05 * np.random.default_rng(24).standard_normal((ncy, ncx)),
                      jnp.float32)
    row = JP._cc_prolong_x(e_c, nx - 2, True)
    rowp = jnp.pad(row, ((0, ny // 2 - ncy), (1, 0)))  # the TPU layout
    p_ref, err_ref, pmax_ref = JK.jacobi_fused_k_corr(pp, rhs, rowp, dx, dy,
                                                      OMEGA, K, interpret=True)
    p_got, err_got, pmax_got = mgp.jacobi_fused_k_corr(T(pp), T(rhs), T(row), dx,
                                                       dy, OMEGA, K)
    tol = res_tol(p_ref, rhs, dx, dy)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=0, atol=1e-6)
    assert np.isclose(float(err_got), float(err_ref), rtol=1e-3, atol=tol)
    assert float(pmax_got) == float(torch.amax(torch.abs(p_got)))
    assert np.isclose(float(pmax_got), float(pmax_ref), rtol=1e-6)


@pytest.mark.parametrize("shape", [(64, 96), (63, 97)])  # odd row-pad
@pytest.mark.parametrize("d_wall_mult", [1.0, 1.5, 16.5 / 32])
def test_cc_sweeps_plain_matches_pallas(shape, d_wall_mult):
    """The outlet is Dirichlet (CHANNEL; tests/test_torch_cavity_mgp.py
    holds CAVITY's all-Neumann cc sweeps)."""
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    d_wall = d_wall_mult * dx
    rng = np.random.default_rng(11)
    p0 = jnp.asarray(rng.standard_normal(shape) * 0.1, jnp.float32)
    rhs = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    for emit_res in (True, False):
        ref, r_ref = JK.cc_sweeps_pallas(p0, rhs, dx, dy, OMEGA, K, True, d_wall,
                                         emit_res=emit_res, interpret=True)
        got, r_got = mgp.cc_sweeps(T(p0), T(rhs), dx, dy, OMEGA, K, d_wall,
                                   emit_res)
        # tolerances of test_jacobi_kernel_interpret.py:99-104
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        if emit_res:
            np.testing.assert_allclose(r_got.numpy(), np.asarray(r_ref),
                                       rtol=1e-4, atol=1e-3)
        else:
            assert r_ref is None and r_got is None


def test_wrappers_validate_and_count_nothing_on_the_cpu():
    pp, rhs, dx, dy = (T(a) if not isinstance(a, float) else a
                       for a in fine_case(3, (16, 24)))
    with pytest.raises(ValueError, match="even"):
        mgp.jacobi_fused_k_restrict(pp[:, :-1].contiguous(), rhs[:, :-1].contiguous(),
                                    dx, dy, OMEGA, K)
    with pytest.raises(ValueError, match="shape"):
        mgp.jacobi_fused_k_corr(pp, rhs, torch.zeros(7, 21), dx, dy, OMEGA, K)
    with pytest.raises(ValueError, match="contiguous"):
        mgp.cc_sweeps(pp.t(), rhs.t(), dx, dy, OMEGA, K, dx)
    wrappers = (mgp.jacobi_fused_k_res, mgp.jacobi_fused_k_restrict,
                mgp.jacobi_fused_k_corr, mgp.cc_sweeps)
    before = [w.launches for w in wrappers]
    mgp.jacobi_fused_k_res(pp, rhs, dx, dy, OMEGA, K)
    mgp.jacobi_fused_k_restrict(pp, rhs, dx, dy, OMEGA, K)
    mgp.jacobi_fused_k_corr(pp, rhs, torch.zeros(7, 22), dx, dy, OMEGA, K)
    mgp.cc_sweeps(pp, rhs, dx, dy, OMEGA, K, dx, True)
    assert [w.launches for w in wrappers] == before  # plain paths launch nothing


# ---------------------------------------------------------------------------
# The cell-centred kit, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(254, 254), (127, 63), (130, 97), (9, 1), (1, 9),
                                   (23, 15)])
def test_cc_kit_matches_jax_bitwise(shape):
    rng = np.random.default_rng(31)
    f = rng.standard_normal(shape).astype(np.float32)
    ny, nx = shape
    for m in (1, 2, 3, 7, 63, 127, 1023):
        assert TP._cc_coarse_size(m) == JP._cc_coarse_size(m)
    if min(shape) > 2:
        np.testing.assert_array_equal(TP._cc_restrict(T(f)).numpy(),
                                      np.asarray(JP._cc_restrict(jnp.asarray(f))))
    for nyf, nxf in ((2 * ny, 2 * nx), (2 * ny - 1, 2 * nx + 1), (2 * ny + 1, 2 * nx - 1)):
        if (nx < 2 and nxf == 2 * nx + 1) or (ny < 2 and nyf == 2 * ny + 1):
            continue  # aggregation needs two coarse cells
        np.testing.assert_array_equal(
            TP._cc_prolong(T(f), nyf, nxf).numpy(),
            np.asarray(JP._cc_prolong(jnp.asarray(f), nyf, nxf, True)))
    dx, dy = 0.2, 0.3
    for dw in (dx, 1.5 * dx):
        p = TP._cc_sweeps(T(f), T(2 * f), dx, dy, OMEGA, K, dw)
        np.testing.assert_array_equal(p.numpy(), np.asarray(JP._cc_sweeps(
            jnp.asarray(f), jnp.asarray(2 * f), dx, dy, OMEGA, K, True, dw)))
        np.testing.assert_array_equal(
            TP._cc_residual(p, T(2 * f), dx, dy, dw).numpy(),
            np.asarray(JP._cc_residual(jnp.asarray(p.numpy()), jnp.asarray(2 * f),
                                       dx, dy, True, dw)))
    if min(shape) > 2:
        np.testing.assert_array_equal(
            TP._mg_residual(T(f), T(2 * f), dx, dy).numpy(),
            np.asarray(JP._mg_residual(jnp.asarray(f), jnp.asarray(2 * f), dx, dy)))


# ---------------------------------------------------------------------------
# multigrid_production against the JAX one
# ---------------------------------------------------------------------------

def _jopts(**kw):
    return jcfg.solver_options_for(jcfg.Semantics.RUST, mgp_scheme="aligned", **kw)


def _topts(**kw):
    return tc.solver_options_for(tc.Semantics.RUST, **kw)


@pytest.mark.parametrize("shape,tol_scale,kw", [
    ((256, 256), 0.0, {}),                      # exits at the f32 noise floor
    ((256, 256), 1e-4, dict(mgp_rtol=0.05)),    # the relative exit
    ((131, 211), 1e-4, {}),                     # odd: the res kernel's route
    ((126, 254), 1e-4, dict(mgp_rtol=0.02)),    # anisotropic
    ((256, 256), 1e-4, dict(early_exit=False)),  # the masked fixed-trip loop
    ((160, 128), 0.0, dict(mgp_fixed_cycles=3)),
])
def test_multigrid_production_matches_jax(shape, tol_scale, kw):
    """256²: the fine level, one cell-centred level (127²) above the
    stop, the FDM bottom at 64². Same cycle count; p' within the golden
    L2 (1e-5 x max(1, rms)) and, tighter, 2e-4 of its rms: the eps n
    amplification the module docstring derives (2-6e-5 measured)."""
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    rng = np.random.default_rng(7)
    rhs = np.zeros(shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((ny - 2, nx - 2))
    pp0 = np.zeros(shape, np.float32)
    tol_r = tol_scale * float(np.abs(rhs).max())
    with jax.disable_jit():
        jp, je, jn = JP.multigrid_production(jnp.asarray(pp0), jnp.asarray(rhs),
                                             dx, dy, _jopts(**kw), tol_r)
    tp, te, tn = TP.multigrid_production(T(pp0), T(rhs), dx, dy, _topts(**kw),
                                         tol_r)
    jp, tp = np.asarray(jp), tp.numpy()
    assert int(tn) == int(jn)
    if "mgp_fixed_cycles" not in kw:
        assert int(tn) < 30  # the exit fired before the cycle cap
    rms = float(np.sqrt(np.mean(jp.astype(np.float64) ** 2)))
    assert l2(tp, jp) <= 1e-5 * max(1.0, rms)
    assert l2(tp, jp) <= 2e-4 * rms
    assert np.isclose(float(te), float(je), rtol=0.25)  # the residual at its floor
    if tol_scale == 0.0 and "mgp_fixed_cycles" not in kw:
        floor = 4 * EPS * ((2 / dx ** 2 + 2 / dy ** 2) * float(np.abs(tp).max())
                           + float(np.abs(rhs).max()))
        assert float(te) < floor  # the noise floor decided the exit


def test_early_exit_and_masked_loop_agree():
    ny = nx = 96
    rng = np.random.default_rng(5)
    rhs = T(rng.standard_normal((ny, nx)).astype(np.float32))
    pp0 = torch.zeros(ny, nx)
    tol = 1e-3 * float(rhs.abs().max())
    a = TP.multigrid_production(pp0, rhs, 1 / nx, 1 / ny,
                                _topts(mgp_coarse_stop=8), tol)
    b = TP.multigrid_production(pp0, rhs, 1 / nx, 1 / ny,
                                _topts(mgp_coarse_stop=8, early_exit=False), tol)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert float(a[1]) == float(b[1]) and int(a[2]) == int(b[2])


def test_size_rule_and_legacy_scheme(monkeypatch):
    """mgp_smooth 3 becomes 5 from 48M cells (ops/poisson.py:1113-1121)
    unless set explicitly; "legacy" is taken (tests/test_torch_mg_legacy.py),
    an unknown scheme raises."""
    seen = []
    monkeypatch.setattr(TP, "_smoothers", lambda opts: seen.append(opts.mgp_smooth)
                        or (_ for _ in ()).throw(StopIteration))
    big = torch.empty((6000, 8000))
    for smooth, want in ((3, 5), (4, 4)):
        with pytest.raises(StopIteration):
            TP.multigrid_production(big, big, 1.0, 1.0, _topts(mgp_smooth=smooth), 1.0)
        assert seen.pop() == want
    with pytest.raises(StopIteration):  # past the scheme check, into the solve
        TP.multigrid_production(big, big, 1.0, 1.0, _topts(mgp_scheme="legacy"), 1.0)
    with pytest.raises(ValueError, match="mgp_scheme"):
        TP.multigrid_production(big, big, 1.0, 1.0, _topts(mgp_scheme="vertex"), 1.0)


@pytest.mark.parametrize("shape,want", [
    ((40, 26), {"jacobi_fused_k_restrict", "jacobi_fused_k_corr", "cc_sweeps"}),
    ((41, 26), {"jacobi_fused_k_res", "cc_sweeps"}),
    ((10, 10), set()),   # the interior is at most mgp_coarse_stop: FDM alone
])
@pytest.mark.parametrize("impl", ["auto", "jnp"])
def test_cycle_routes_to_the_smoother_kernels(monkeypatch, shape, want, impl):
    """Even grids run the restrict and corr kernels, other grids the res
    kernel, every coarse level above the stop the cc kernel; "jnp" runs
    their plain versions."""
    calls = []
    for name in ("jacobi_fused_k_res", "jacobi_fused_k_restrict",
                 "jacobi_fused_k_corr", "cc_sweeps"):
        for suffix in ("", "_plain"):
            fn = getattr(mgp, name + suffix)
            monkeypatch.setattr(mgp, name + suffix,
                                lambda *a, _f=fn, _n=name + suffix, **k:
                                (calls.append(_n), _f(*a, **k))[1])
    ny, nx = shape
    rhs = T(np.random.default_rng(2).standard_normal(shape).astype(np.float32))
    TP.multigrid_production(torch.zeros(shape), rhs, 1 / nx, 1 / ny,
                            _topts(mgp_coarse_stop=8, pressure_impl=impl), 0.0)
    wrappers = {c for c in calls if not c.endswith("_plain")}
    plain = {c[:-len("_plain")] for c in calls if c.endswith("_plain")}
    if impl == "auto":  # on CPU tensors each wrapper runs its plain version
        assert wrappers == want
    else:
        assert not wrappers
    # the plain restrict and corr smooth through the plain res smoother
    assert want <= plain <= want | ({"jacobi_fused_k_res"} if want else set())


# ---------------------------------------------------------------------------
# A production rollout against cfd_demo_tpu.make_run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,ny,substep_impl", [
    (24, 16, "auto"),     # tests/test_golden.py's grid: restrict + corr kernels
    (24, 16, "pallas"),   # the fused route: predict_div, the solve, correct_bc
    (27, 16, "auto"),     # odd nx: the res kernel, an aggregating coarse level
    (23, 15, "auto"),     # odd both: mirror-padding coarse levels
])
def test_production_rollout_matches_jax(nx, ny, substep_impl):
    """Five production steps (bench.py --mode production's options) on
    the golden grid, with mgp_coarse_stop 4 so that the cycle has two
    cell-centred levels above its FDM bottom. Golden bounds of
    tests/test_golden.py:116-141: u, v L2 <= 1e-5 x max(1, rms), grad p
    L2 <= 1e-4 x max(1, rms), mean-removed p L2 <= 1e-5 x max(1, rms)."""
    scenes = []
    for m in (jc, tc):
        grid = m.Grid(nx=nx, ny=ny, lx=4.0 * nx / 24, ly=1.5 * ny / 16,
                      obstacles=(m.Cylinder(1.0, 0.75 * ny / 16, 0.3),))
        params = m.SimulationParams(dt=0.004, viscosity=1e-4,
                                    pressure_solver=m.PressureSolver.MG_PRODUCTION)
        opts = m.solver_options_for(m.Semantics.RUST, ramp_up_steps=4,
                                    outer_corrector_rounds=0, mgp_coarse_stop=4,
                                    substep_impl=substep_impl)
        scenes.append(m.make_scene(grid, params, opts))
    js, jd = jc.make_run(scenes[0], 5, donate=False)(scenes[0].init_state())
    ts, td = tc.make_run(scenes[1], 5)(scenes[1].init_state(device="cpu"))
    g = scenes[1].grid
    rms = lambda a: max(1.0, float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2))))
    for f in ("u", "v"):
        want = np.asarray(getattr(js, f))
        assert l2(getattr(ts, f).numpy(), want) <= 1e-5 * rms(want), f
    gp, op = ts.p.numpy().astype(np.float64), np.asarray(js.p, np.float64)
    gx = l2(np.diff(gp, axis=1) / g.dx, np.diff(op, axis=1) / g.dx)
    gy = l2(np.diff(gp, axis=0) / g.dy, np.diff(op, axis=0) / g.dy)
    assert max(gx, gy) <= 1e-4 * rms(np.diff(op, axis=1) / g.dx)
    d = gp - op
    assert l2(d - d.mean(), 0.0) <= 1e-5 * rms(op)
    np.testing.assert_allclose(td.dt.numpy(), np.asarray(jd.dt), rtol=1e-5)
    # res_p: each step's exit residual, at or below its tolerance or floor
    np.testing.assert_allclose(td.res_p.numpy(), np.asarray(jd.res_p), rtol=1e-2,
                               atol=1e-6)
    assert float(np.abs(np.asarray(js.u)).max()) > 0.5  # the inlet ramp is on
