"""MG_PRODUCTION under the lid-driven cavity (CAVITY flow) on the port
against cfd_demo_tpu on the CPU, inputs made with numpy from a seed.

- The aligned hierarchy's all-Neumann operator (``east_dirichlet``
  False) against ops/poisson.py bit for bit: the folded reads, the
  uniform diagonal, the sweeps, the residual and the prolongation, at
  even, mirror-pad and aggregate sizes.
- The plain versions of kernels 6, 7, 8 (``cavity=True``), 9
  (``east_dirichlet=False``), 18's cavity ring and 19 (``cavity=True``)
  against the Pallas kernels in interpret mode, at the tolerances
  tests/test_torch_mgp.py and tests/test_torch_mg.py hold their channel
  twins to (those of tests/test_jacobi_kernel_interpret.py:99-104 for
  kernel 9).
- ``multigrid_production`` with the cavity's p' BCs against the JAX one
  run op by op (tests/test_torch_mgp.py explains why): aligned on an even
  and an odd grid, legacy, fixed cycles; the same cycle count and exit
  residual, p' with the mean difference removed (the pure-Neumann
  system fixes p' only up to a constant, and the solve runs to the f32
  noise floor, where two faithful solves differ in their smoothest
  modes).
- The slice end to end: ``make_scene`` CAVITY MG_PRODUCTION steps
  against the JAX package under Rust/JS, FIRST/QUICK and both lids, per
  field L2 <= 1e-5 a step (tests/test_golden.py:3-5), p and p' with the
  mean difference removed; and a JAX cavity production state resumed.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.kernels import jacobi_pallas as JK
from cfd_demo_tpu.kernels import mg_pallas as JM
from cfd_demo_tpu.ops import poisson as JP

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.kernels import mg, mgp
from cfd_demo_tpu_torch.ops import poisson as TP
from cfd_demo_tpu_torch.solver import piso as tpiso

from conftest import l2

torch.set_num_threads(1)
EPS = float(np.finfo(np.float32).eps)
OMEGA, K = 0.75, 3


def T(a):
    return torch.from_numpy(np.array(a))


def cavity_case(seed, shape):
    """A cavity-BC-consistent p' (what the folded kernels require), a
    random rhs, dx, dy."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    pp = JP._apply_pprime_bcs_cavity(jnp.asarray(0.1 * rng.standard_normal(shape),
                                                 jnp.float32))
    rhs = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    return pp, rhs, 1.0 / nx, 1.0 / ny


def res_tol(p_ref, rhs, dx, dy):
    """The residual's f32 cancellation floor (test_projection.py:320)."""
    return 30 * EPS * ((2 / dx ** 2 + 2 / dy ** 2) * float(np.abs(p_ref).max())
                       + float(np.abs(rhs).max()))


def sweep_tol(k, p_ref, rhs_scaled):
    """tests/test_torch_mg.py's bound for a damped smoother's kernel."""
    return 16 * EPS * max(k, 1) * (float(np.abs(np.asarray(p_ref)).max())
                                   + float(np.abs(np.asarray(rhs_scaled)).max()))


def demeaned_l2(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((d - d.mean()) ** 2)))


def assert_cavity_ring(p):
    """The cavity's p' BCs hold: the gauge cell 0, every other ring cell
    its nearest interior cell's value (a corner the diagonal one)."""
    p = np.asarray(p)
    want = np.asarray(JP._apply_pprime_bcs_cavity(jnp.asarray(p)))
    np.testing.assert_array_equal(p, want)
    assert p[0, 0] == 0.0


# ---------------------------------------------------------------------------
# The aligned hierarchy's all-Neumann operator, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(254, 254), (127, 63), (130, 97), (9, 1), (1, 9),
                                   (23, 15)])
def test_all_neumann_cc_kit_matches_jax_bitwise(shape):
    """east_dirichlet=False: E reads the cell itself at the last column,
    the diagonal is uniform whatever d_wall is, and the prolongation's x
    pass clamps at the east edge (JAX ops/poisson.py:848-851)."""
    rng = np.random.default_rng(41)
    f = rng.standard_normal(shape).astype(np.float32)
    ny, nx = shape
    ref = JP._cc_neighbors(jnp.asarray(f), False)
    for r, g in zip(ref, TP._cc_neighbors(T(f), False)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert TP._cc_diag(shape, 0.2, 0.3, 0.37, "cpu", False) == JP._cc_diag(
        shape, 0.2, 0.3, False, 0.37)
    for nyf, nxf in ((2 * ny, 2 * nx), (2 * ny - 1, 2 * nx + 1), (2 * ny + 1, 2 * nx - 1)):
        if (nx < 2 and nxf == 2 * nx + 1) or (ny < 2 and nyf == 2 * ny + 1):
            continue  # aggregation needs two coarse cells
        np.testing.assert_array_equal(
            TP._cc_prolong_x(T(f), nxf, False).numpy(),
            np.asarray(JP._cc_prolong_x(jnp.asarray(f), nxf, False)))
        np.testing.assert_array_equal(
            TP._cc_prolong(T(f), nyf, nxf, False).numpy(),
            np.asarray(JP._cc_prolong(jnp.asarray(f), nyf, nxf, False)))
    dx, dy = 0.2, 0.3
    for dw in (dx, 1.5 * dx):
        p = TP._cc_sweeps(T(f), T(2 * f), dx, dy, OMEGA, K, dw, False)
        np.testing.assert_array_equal(p.numpy(), np.asarray(JP._cc_sweeps(
            jnp.asarray(f), jnp.asarray(2 * f), dx, dy, OMEGA, K, False, dw)))
        np.testing.assert_array_equal(
            TP._cc_residual(p, T(2 * f), dx, dy, dw, False).numpy(),
            np.asarray(JP._cc_residual(jnp.asarray(p.numpy()), jnp.asarray(2 * f),
                                       dx, dy, False, dw)))


# ---------------------------------------------------------------------------
# Plain versions of the kernels' CAVITY instances against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [((64, 96), 3), ((64, 97), 3), ((384, 128), 8)])
def test_res_cavity_plain_matches_pallas(shape, k):
    """Kernel 6 with cavity=True (jacobi_pallas.py:302, :334-340)."""
    pp, rhs, dx, dy = cavity_case(11, shape)
    p_ref, r_ref, m_ref = JK.jacobi_fused_k_res(pp, rhs, dx, dy, OMEGA, k,
                                                interpret=True, cavity=True)
    p_got, r_got, m_got = mgp.jacobi_fused_k_res(T(pp), T(rhs), dx, dy, OMEGA, k,
                                                 cavity=True)
    tol = res_tol(p_ref, rhs, dx, dy)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_got.numpy(), np.asarray(r_ref), rtol=0, atol=tol)
    assert np.isclose(float(m_got), float(m_ref), rtol=1e-3, atol=tol)
    assert_cavity_ring(p_got)
    channel = mgp.jacobi_fused_k_res(T(pp), T(rhs), dx, dy, OMEGA, k)
    assert not torch.equal(channel[0], p_got)  # the flag reaches the plain version
    p2, r2, m2 = mgp.jacobi_fused_k_res(T(pp), T(rhs), dx, dy, OMEGA, k, False, True)
    assert r2 is None and torch.equal(p2, p_got) and float(m2) == float(m_got)


@pytest.mark.parametrize("shape", [(64, 96), (48, 150)])
def test_restrict_cavity_plain_matches_pallas(shape):
    """Kernel 7 with cavity=True (jacobi_pallas.py:444, ``cavity``)."""
    ny, nx = shape
    pp, rhs, dx, dy = cavity_case(19, shape)
    p_ref, m, m_ref = JK.jacobi_fused_k_restrict(pp, rhs, dx, dy, OMEGA, K,
                                                 interpret=True, cavity=True)
    ncy, ncx = (ny - 2) // 2, (nx - 2) // 2
    rc_ref = np.asarray(m)[:ncy, 1::2][:, :ncx]  # the TPU layout, unpacked
    p_got, rc_got, m_got = mgp.jacobi_fused_k_restrict(T(pp), T(rhs), dx, dy, OMEGA, K,
                                                       cavity=True)
    tol = res_tol(p_ref, rhs, dx, dy)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rc_got.numpy(), rc_ref, rtol=0, atol=tol)
    assert np.isclose(float(m_got), float(m_ref), rtol=1e-3, atol=tol)
    assert_cavity_ring(p_got)


@pytest.mark.parametrize("shape", [(64, 96), (80, 150)])
def test_corr_cavity_plain_matches_pallas(shape):
    """Kernel 8 with cavity=True (jacobi_pallas.py:681, ``cavity``), fed
    the x pass of an all-Neumann prolongation, as the cavity's cycle
    feeds it."""
    ny, nx = shape
    pp, rhs, dx, dy = cavity_case(23, shape)
    ncy, ncx = (ny - 2) // 2, (nx - 2) // 2
    e_c = jnp.asarray(0.05 * np.random.default_rng(24).standard_normal((ncy, ncx)),
                      jnp.float32)
    row = JP._cc_prolong_x(e_c, nx - 2, False)
    rowp = jnp.pad(row, ((0, ny // 2 - ncy), (1, 0)))  # the TPU layout
    p_ref, err_ref, pmax_ref = JK.jacobi_fused_k_corr(pp, rhs, rowp, dx, dy, OMEGA, K,
                                                      interpret=True, cavity=True)
    p_got, err_got, pmax_got = mgp.jacobi_fused_k_corr(T(pp), T(rhs), T(row), dx, dy,
                                                       OMEGA, K, cavity=True)
    tol = res_tol(p_ref, rhs, dx, dy)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=0, atol=1e-6)
    assert np.isclose(float(err_got), float(err_ref), rtol=1e-3, atol=tol)
    assert float(pmax_got) == float(torch.amax(torch.abs(p_got)))
    assert np.isclose(float(pmax_got), float(pmax_ref), rtol=1e-6)
    assert_cavity_ring(p_got)


@pytest.mark.parametrize("shape", [(64, 96), (63, 97)])  # odd row-pad
@pytest.mark.parametrize("d_wall_mult", [1.0, 1.5, 16.5 / 32])
def test_cc_sweeps_all_neumann_plain_matches_pallas(shape, d_wall_mult):
    """Kernel 9 with east_dirichlet=False, as tests/test_torch_mgp.py holds
    the channel's (its d_wall parametrisation): without an outlet d_wall
    changes nothing, and 1/denom is rounded once (jacobi_pallas.py:1751)."""
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    d_wall = d_wall_mult * dx
    rng = np.random.default_rng(11)
    p0 = jnp.asarray(rng.standard_normal(shape) * 0.1, jnp.float32)
    rhs = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    for emit_res in (True, False):
        ref, r_ref = JK.cc_sweeps_pallas(p0, rhs, dx, dy, OMEGA, K, False, d_wall,
                                         emit_res=emit_res, interpret=True)
        got, r_got = mgp.cc_sweeps(T(p0), T(rhs), dx, dy, OMEGA, K, d_wall, emit_res,
                                   east_dirichlet=False)
        # tolerances of test_jacobi_kernel_interpret.py:99-104
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        if emit_res:
            np.testing.assert_allclose(r_got.numpy(), np.asarray(r_ref),
                                       rtol=1e-4, atol=1e-3)
        else:
            assert r_ref is None and r_got is None
    mult = mgp._cc_multipliers(dx, dy, OMEGA, d_wall, east_dirichlet=False)
    assert mult == mgp._cc_multipliers(dx, dy, OMEGA, dx)  # the d == dx rounding
    assert mult[4] == mult[5] and mult[6] == mult[7]


NCY, NCX, NXP = 48, 100, 128  # stride 1, 128 lanes (tests/test_torch_mg.py)


def lanes(a):
    """A compact level padded to NXP lanes: the interleaved form at s = 1."""
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, NXP - a.shape[1])))


@pytest.mark.parametrize("k", [3, 10])
def test_mgp_smooth_cavity_plain_matches_kernel_19(k):
    """Kernel 19 with cavity=True (mg_pallas.py:998-1023)."""
    pp, rhs, dx, dy = cavity_case(6, (NCY, NCX))
    p, rhs = np.asarray(pp), np.asarray(rhs)
    got = mg.mgp_smooth(T(p), T(rhs), dx, dy, OMEGA, k, cavity=True)
    ref = JM.mgp_smooth_int(lanes(p), lanes(rhs), dx, dy, 1, NCX, k, OMEGA, True,
                            interpret=True)
    ar = OMEGA / (2 / dx ** 2 + 2 / dy ** 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :NCX], rtol=0,
                               atol=sweep_tol(k, got, ar * rhs))
    assert_cavity_ring(got)


def test_mg_prolong_add_cavity_ring_matches_kernel_18():
    """Kernel 18's sum with the cavity's p' BCs: the port's ring, which
    the TPU kernel leaves to its post-smoother, equals the legacy cycle's
    bc(p + _mg_prolong(e)) (JAX ops/poisson.py:663)."""
    pp, _, _, _ = cavity_case(4, (NCY, NCX))
    p = np.asarray(pp)
    e = np.random.default_rng(5).standard_normal((NCY // 2, NCX // 2)).astype(np.float32)
    got = mg.mg_prolong_add(T(e), T(p), True, cavity=True)
    ref = JM.mg_prolong_add_int(JM._interleave(jnp.asarray(e), 2, NXP), lanes(p), 1,
                                NCX, interpret=True)
    ref = np.asarray(JP._apply_pprime_bcs_cavity(jnp.asarray(np.asarray(ref)[:, :NCX])))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=EPS * float(np.abs(ref).max()))
    xla = JP._apply_pprime_bcs_cavity(jnp.asarray(p) + JP._mg_prolong(jnp.asarray(e),
                                                                      NCX, NCY))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    assert_cavity_ring(got)


def test_cavity_wrappers_count_nothing_on_the_cpu():
    """The plain paths launch nothing, CAVITY instance or not."""
    pp, rhs, dx, dy = (T(a) if not isinstance(a, float) else a
                       for a in cavity_case(3, (16, 24)))
    wrappers = (mgp.jacobi_fused_k_res, mgp.jacobi_fused_k_restrict,
                mgp.jacobi_fused_k_corr, mgp.cc_sweeps, mg.mgp_smooth, mg.mg_prolong_add)
    before = [(w.launches, w.cavity_launches) for w in wrappers]
    mgp.jacobi_fused_k_res(pp, rhs, dx, dy, OMEGA, K, cavity=True)
    mgp.jacobi_fused_k_restrict(pp, rhs, dx, dy, OMEGA, K, cavity=True)
    mgp.jacobi_fused_k_corr(pp, rhs, torch.zeros(7, 22), dx, dy, OMEGA, K, cavity=True)
    mgp.cc_sweeps(pp, rhs, dx, dy, OMEGA, K, dx, True, east_dirichlet=False)
    mg.mgp_smooth(pp, rhs, dx, dy, OMEGA, K, cavity=True)
    mg.mg_prolong_add(torch.zeros(8, 12), pp, True, cavity=True)
    assert [(w.launches, w.cavity_launches) for w in wrappers] == before


# ---------------------------------------------------------------------------
# multigrid_production with the cavity's p' BCs against the JAX one
# ---------------------------------------------------------------------------

def _jopts(**kw):
    return jcfg.solver_options_for(jcfg.Semantics.RUST, **{"mgp_scheme": "aligned", **kw})


def _topts(**kw):
    return tc.solver_options_for(tc.Semantics.RUST, **kw)


@pytest.mark.parametrize("shape,tol_scale,compatible,kw", [
    ((96, 128), 0.0, True, dict(mgp_coarse_stop=16)),    # even: restrict + corr
    ((97, 131), 1e-4, True, dict(mgp_coarse_stop=16)),   # odd: the res kernel
    ((96, 128), 1e-4, True, dict(mgp_coarse_stop=16, early_exit=False)),  # masked
    ((48, 64), 0.0, False, dict(mgp_coarse_stop=8)),     # a compatibility defect
    ((33, 49), 1e-2, True, dict(mgp_scheme="legacy")),   # the vertex hierarchy
    ((64, 96), 0.0, True, dict(mgp_coarse_stop=8, mgp_fixed_cycles=3)),
])
def test_cavity_multigrid_production_matches_jax(shape, tol_scale, compatible, kw):
    """The same cycle count and exit residual as the JAX solve run op by
    op; p' within the golden L2 (1e-5 x max(1, rms)) and 2e-4 of its rms
    (tests/test_torch_mgp.py's bounds) with the mean difference removed,
    the gauge cell 0 on both. A compatible rhs (zero mean, as a closed
    cavity's divergence has) exits before the cycle cap; one with a mean
    (a compatibility defect) leaves a residual no p' removes, and both
    packages stall to mgp_max_cycles."""
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    rng = np.random.default_rng(7)
    rhs = np.zeros(shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((ny - 2, nx - 2))
    if compatible:
        rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
    pp0 = np.zeros(shape, np.float32)
    tol_r = tol_scale * float(np.abs(rhs).max())
    with jax.disable_jit():
        jp, je, jn = JP.multigrid_production(jnp.asarray(pp0), jnp.asarray(rhs), dx, dy,
                                             _jopts(**kw), tol_r,
                                             bc=JP._apply_pprime_bcs_cavity)
    tp, te, tn = TP.multigrid_production(T(pp0), T(rhs), dx, dy, _topts(**kw), tol_r,
                                         bc=TP._apply_pprime_bcs_cavity)
    jp, tp = np.asarray(jp), tp.numpy()
    assert int(tn) == int(jn)
    if "mgp_fixed_cycles" not in kw:
        assert (int(tn) < 30) == compatible  # the exit fired, or the defect stalled it
    rms = float(np.sqrt(np.mean(jp.astype(np.float64) ** 2)))
    assert demeaned_l2(tp, jp) <= 1e-5 * max(1.0, rms)
    assert demeaned_l2(tp, jp) <= 2e-4 * rms
    # the residual at the f32 noise floor, tests/test_torch_mgp.py's bound
    assert np.isclose(float(te), float(je), rtol=0.25)
    assert_cavity_ring(tp)
    assert jp[0, 0] == 0.0


@pytest.mark.parametrize("shape,want", [
    ((40, 26), {"jacobi_fused_k_restrict", "jacobi_fused_k_corr", "cc_sweeps"}),
    ((41, 26), {"jacobi_fused_k_res", "cc_sweeps"}),
])
def test_cavity_cycle_calls_the_cavity_instances(monkeypatch, shape, want):
    """The aligned cycle with the cavity's BCs calls each smoother with
    cavity=True (east_dirichlet=False on the coarse levels); the legacy
    cycle calls kernels 18 and 19 with cavity=True; the channel's calls
    none of them so."""
    seen = []

    def spy(module, name, pos):  # the cycle passes the flag at ``pos``
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: (
            seen.append((name, bool(a[pos]))), fn(*a, **k))[1])

    for module, name, pos in ((mgp, "jacobi_fused_k_res", 7),
                              (mgp, "jacobi_fused_k_restrict", 6),
                              (mgp, "jacobi_fused_k_corr", 7), (mgp, "cc_sweeps", 8),
                              (mg, "mgp_smooth", 6), (mg, "mg_prolong_add", 3)):
        spy(module, name, pos)
    ny, nx = shape
    rhs = T(np.random.default_rng(2).standard_normal(shape).astype(np.float32))
    for scheme in ("aligned", "legacy"):
        for bc in (TP._apply_pprime_bcs_cavity, TP._apply_pprime_bcs):
            seen.clear()
            TP.multigrid_production(torch.zeros(shape), rhs, 1 / nx, 1 / ny,
                                    _topts(mgp_coarse_stop=8, mgp_scheme=scheme,
                                           mgp_max_cycles=2), 0.0, bc=bc)
            assert {n for n, _ in seen} == (want if scheme == "aligned"
                                            else {"mgp_smooth", "mg_prolong_add"})
            cavity = bc is TP._apply_pprime_bcs_cavity
            # cc_sweeps' flag is east_dirichlet, the others' cavity
            assert all(flag == (cavity != (n == "cc_sweeps")) for n, flag in seen), seen


# ---------------------------------------------------------------------------
# The slice: CAVITY MG_PRODUCTION steps against the JAX package
# ---------------------------------------------------------------------------

def _scene(m, n=24, semantics="RUST", scheme="FIRST", profile="UNIFORM", **kw):
    """cavity_grid(n) with the cavity app's constants (dt 0.002, viscosity
    1e-2, lid 1.0) and MG_PRODUCTION, mgp_coarse_stop 4 so that the cycle
    has cell-centred levels above its FDM bottom; a 3-step lid ramp."""
    params = m.SimulationParams(dt=0.002, viscosity=1e-2, target_inlet_velocity=1.0,
                                flow_case=m.FlowCase.CAVITY,
                                pressure_solver=m.PressureSolver.MG_PRODUCTION,
                                velocity_scheme=m.VelocityScheme[scheme],
                                inlet_profile=m.InletProfile[profile])
    opts = m.solver_options_for(m.Semantics[semantics], ramp_up_steps=3,
                                mgp_coarse_stop=4, **kw)
    return m.make_scene(m.cavity_grid(n), params, opts)


STEP_CASES = {
    "aligned": {},
    "js": {"semantics": "JS"},
    "quick-parabolic": {"scheme": "QUICK", "profile": "PARABOLIC"},
    "js-quick-parabolic-upper": {"semantics": "JS", "scheme": "QUICK",
                                 "profile": "PARABOLIC_UPPER"},
    "odd": {"n": 25},
    "fused": {"substep_impl": "pallas"},
    "legacy": {"mgp_scheme": "legacy"},
    "fixed-cycles": {"mgp_fixed_cycles": 2},
}


def assert_step_close(ts, js, what):
    """Per-field L2 <= 1e-5 (tests/test_golden.py:3-5): u and v directly,
    p and p' with the mean difference removed."""
    for f in ("u", "v", "p", "p_prime"):
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        err = demeaned_l2(got, want) if f in ("p", "p_prime") else l2(got, want)
        assert err <= 1e-5, (what, f, err)
    assert float(ts.p_prime[0, 0]) == 0.0


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_cavity_production_steps_match_jax(case, monkeypatch):
    """Four steps on both packages; the port's solve goes through
    multigrid_production with the cavity's p' BCs, the lid moves, and
    res_p agrees."""
    kw = STEP_CASES[case]
    jscene, tscene = _scene(jc, **kw), _scene(tc, **kw)
    bcs = []
    real = tpiso.multigrid_production
    monkeypatch.setattr(tpiso, "multigrid_production",
                        lambda *a, **k: (bcs.append(k.get("bc")), real(*a, **k))[1])
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    for k in range(4):
        js, jd = jstep(js)
        ts, td = tstep(ts)
        assert_step_close(ts, js, k)
        np.testing.assert_allclose(float(td.res_p), float(jd.res_p), rtol=1e-2, atol=1e-6)
    assert bcs and all(b is TP._apply_pprime_bcs_cavity for b in bcs)
    lid = ts.u[-1].numpy()
    assert lid[0] == 0 and lid[-1] == 0 and lid.max() > 0.5


def test_cavity_production_state_resumes_from_jax():
    """A JAX cavity production state (after 3 steps) carried into the
    port with state_from_numpy; both step on to the same fields."""
    jscene, tscene = _scene(jc), _scene(tc)
    jstep = jc.make_step(jscene, donate=False)
    js = jscene.init_state()
    for _ in range(3):
        js, _ = jstep(js)
    d = {f.name: (None if getattr(js, f.name) is None else np.asarray(getattr(js, f.name)))
         for f in dataclasses.fields(js)}
    ts = tc.state_from_numpy(d, "cpu")
    tstep = tc.make_step(tscene)
    for k in range(2):
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        assert_step_close(ts, js, k)
    assert int(ts.step) == int(js.step) == 5


@pytest.mark.parametrize("solver,kw,item", [
    ("SOR", {}, "item 6b"),
    ("MG_PRODUCTION", {"differentiable": True, "early_exit": False,
                       "outer_corrector_rounds": 0}, "item 6b"),
])
def test_cavity_outside_the_slice_still_raises(solver, kw, item):
    """CAVITY with SOR or differentiable still raises naming item 6b, and
    a batch or the sharded step refuses a cavity production scene."""
    with pytest.raises(NotImplementedError, match=item):
        tc.make_scene(tc.cavity_grid(16), tc.SimulationParams(
            flow_case=tc.FlowCase.CAVITY, pressure_solver=tc.PressureSolver[solver]),
            _topts(**kw))
    scene = _scene(tc, 16)
    with pytest.raises(NotImplementedError, match="item 6b"):
        tc.make_step(scene)(tc.batch_state(scene.init_state(device="cpu"), 2))
    from cfd_demo_tpu_torch.shard import make_mesh, make_step_shmap
    with pytest.raises(NotImplementedError, match="item 6b"):
        make_step_shmap(scene, make_mesh(2, "cpu"))


def test_cavity_production_cell_is_the_app_scene():
    """cells.py's "2048^2 cavity production" is the cavity app's scene
    with --solver mg-production (apps/cavity.py:21-28, apps/common.py:28,
    :43-50); at 2048² it takes the fused route and, on its even grid, the
    restrict and corr kernels."""
    from cfd_demo_tpu.apps.common import base_parser, params_from_args
    from cfd_demo_tpu_torch import cells
    make = cells.CELLS["2048^2 cavity production"][0]
    scene = make()
    ap = base_parser("cavity")
    ap.set_defaults(dt=0.002, viscosity=1e-2, inlet=1.0)
    args = ap.parse_args(["--solver", "mg-production"])
    want = jc.make_scene(jc.cavity_grid(2048), params_from_args(args, jc.FlowCase.CAVITY),
                         jc.solver_options_for(jc.Semantics.RUST))
    for part in ("grid", "params", "opts"):
        assert repr(getattr(scene, part)) == repr(getattr(want, part)), part
    assert tpiso._use_fused_substep(scene)
