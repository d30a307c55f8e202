"""The JS twin's configurations on the port against cfd_demo_tpu on the CPU.

JS semantics (face-position masks, the averaged convecting v, the zero
warm start, extrapolation, adaptive substeps, residual dt scaling),
SECOND and QUICK faces and the PARABOLIC and PARABOLIC_UPPER inlets:
each op against its JAX counterpart on the same numpy-seeded inputs,
each kernel's plain version against the Pallas kernel in interpret mode,
and the whole step against the NumPy oracle and the JAX package at the
golden bounds of tests/test_golden.py.

Tolerances: masks and inlet columns exactly equal (the same f32
operations); faces, which select and combine values with the JAX
package's operation order, bit for bit; fields after arithmetic
1e-6 x max(1, max|ref|), the bound of tests/test_substep_pallas.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.core.masks import masks_traced as j_masks
from cfd_demo_tpu.kernels.rounds_pallas import solve_correct_rounds_pallas
from cfd_demo_tpu.kernels.substep_pallas import (correct_bc_pallas,
                                                 predict_div_pallas)
from cfd_demo_tpu.ops import bc as jbc
from cfd_demo_tpu.ops import predictor as jpred
from cfd_demo_tpu.ops import schemes as jsch
from cfd_demo_tpu.oracle.reference import NumpyModel

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.core import config as tcfg
from cfd_demo_tpu_torch.core.masks import masks_traced as t_masks
from cfd_demo_tpu_torch.kernels import rounds as trounds
from cfd_demo_tpu_torch.kernels import substep as tsub
from cfd_demo_tpu_torch.ops import bc as tbc
from cfd_demo_tpu_torch.ops import predictor as tpred
from cfd_demo_tpu_torch.ops import schemes as tsch

from conftest import l2

torch.set_num_threads(1)

CPU = torch.device("cpu")
DT, NU, INLET = 0.003, 1e-4, 1.0
SCHEMES = ["FIRST", "SECOND", "QUICK"]
SEMANTICS = ["RUST", "JS"]
PROFILES = ["UNIFORM", "PARABOLIC", "PARABOLIC_UPPER"]


def both(name, *args, **kw):
    """The same config object built in both packages."""
    return getattr(jcfg, name)(*args, **kw), getattr(tcfg, name)(*args, **kw)


def grids(nx=96, ny=64, lx=3.0, ly=2.0, c=(0.8, 1.0, 0.3)):
    """The grid of tests/test_substep_pallas.py:24 in both packages."""
    return (jcfg.Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=(jcfg.Cylinder(*c),)),
            tcfg.Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=(tcfg.Cylinder(*c),)))


JG, TG = grids()


def fields(seed, grid, scale=1.0):
    rng = np.random.default_rng(seed)
    ny, nx = grid.ny, grid.nx
    mk = lambda shape: (scale * rng.standard_normal(shape)).astype(np.float32)
    return mk((ny, nx + 1)), mk((ny, nx)), mk((ny, nx)), mk((ny, nx))


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_close(ref, got, scale_rtol=1e-6):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = scale_rtol * max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

# The grids of tests/test_torch_ops.py: the ops grid, the golden grid, the
# 800x264 default scene, the 2048^2 benchmark scene, and the JS twin's own
# 400x132 default.
MASK_GRIDS = {
    "ops": dict(nx=96, ny=64, lx=3.0, ly=2.0, c=(0.8, 1.0, 0.3)),
    "golden": dict(nx=24, ny=16, lx=4.0, ly=1.5, c=(1.0, 0.75, 0.3)),
    "default": dict(nx=800, ny=264, lx=30.0, ly=10.0, c=(7.5, 5.0, 0.75)),
    "bench2048": dict(nx=2048, ny=2048, lx=30.0, ly=30.0, c=(7.5, 15.0, 0.75)),
    "js-default": dict(nx=400, ny=132, lx=30.0, ly=10.0, c=(7.5, 5.0, 0.75)),
}


@pytest.mark.parametrize("name", list(MASK_GRIDS))
def test_js_masks_exactly_equal(name):
    jg, tg = grids(**MASK_GRIDS[name])
    ref = j_masks(jg, jcfg.Semantics.JS, jnp.float32)
    got = t_masks(tg, tcfg.Semantics.JS, CPU)
    for r, g in zip(ref, got):
        assert g.dtype == torch.bool and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert np.asarray(r).any()
    assert got[2] is got[0] and got[3] is got[1]  # the BCs test the faces too


@pytest.mark.parametrize("scheme", ["SECOND", "QUICK"])
@pytest.mark.parametrize("avg_conv_v", [False, True])
def test_faces(scheme, avg_conv_v):
    u, v, _, _ = fields(1, JG)
    nx, ny = JG.nx, JG.ny
    ref_u = jsch.u_faces(J(u), J(v), nx, ny, jcfg.VelocityScheme[scheme], avg_conv_v)
    got_u = tsch.u_faces(T(u), T(v), nx, ny, tcfg.VelocityScheme[scheme], avg_conv_v)
    ref_v = jsch.v_faces(J(u), J(v), nx, ny, jcfg.VelocityScheme[scheme])
    got_v = tsch.v_faces(T(u), T(v), nx, ny, tcfg.VelocityScheme[scheme])
    for r, g in zip(tuple(ref_u) + tuple(ref_v), tuple(got_u) + tuple(got_v)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_first_faces_with_averaged_v():
    u, v, _, _ = fields(2, JG)
    ref = jsch.u_faces(J(u), J(v), JG.nx, JG.ny, jcfg.VelocityScheme.FIRST, True)
    got = tsch.u_faces(T(u), T(v), TG.nx, TG.ny, tcfg.VelocityScheme.FIRST, True)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("scheme", ["SECOND", "QUICK"])
def test_predictor(semantics, scheme):
    u, v, _, _ = fields(3, JG)
    jm = j_masks(JG, jcfg.Semantics[semantics], jnp.float32)
    tm = t_masks(TG, tcfg.Semantics[semantics], CPU)
    js = semantics == "JS"
    ref = jpred.predict(J(u), J(v), DT, NU, JG.dx, JG.dy, JG.nx, JG.ny,
                        jcfg.VelocityScheme[scheme], js, jm[0], jm[1])
    got = tpred.predict(T(u), T(v), DT, NU, TG.dx, TG.dy, TG.nx, TG.ny,
                        tcfg.VelocityScheme[scheme], js, tm[0], tm[1])
    for r, g in zip(ref, got):
        assert_close(r, g)


@pytest.mark.parametrize("ny,ly", [(16, 1.5), (64, 2.0), (132, 10.0), (37, 2.3),
                                   (2048, 30.0)])
@pytest.mark.parametrize("profile", PROFILES)
def test_inlet_column_exactly_equal(ny, ly, profile):
    jg, tg = both("Grid", nx=20, ny=ny, lx=3.0, ly=ly)
    ref = np.asarray(jbc.inlet_profile_column(jg, jcfg.InletProfile[profile],
                                              jnp.float32(0.73)))
    got = tbc.inlet_profile_column(tg, tcfg.InletProfile[profile],
                                   torch.tensor(0.73), CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # The kernels' per-row formula (inlet_profile_traced) is the same f32
    # arithmetic: equal to the column bit for bit.
    traced = jbc.inlet_profile_traced(jg, jcfg.InletProfile[profile],
                                      jnp.float32(0.73), jnp.arange(ny), jnp.float32)
    np.testing.assert_array_equal(np.asarray(traced), ref)
    if profile == "PARABOLIC_UPPER":
        assert not ref[: ny // 2 - 1].any() and ref.max() > 0.7 * 0.9


@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("profile", ["PARABOLIC", "PARABOLIC_UPPER"])
def test_apply_bcs(semantics, profile):
    u, v, _, _ = fields(4, JG)
    jm = j_masks(JG, jcfg.Semantics[semantics], jnp.float32)
    tm = t_masks(TG, tcfg.Semantics[semantics], CPU)
    ref = jbc.apply_bcs(J(u), J(v), JG, jcfg.InletProfile[profile], 0.7, jm[2], jm[3])
    got = tbc.apply_bcs(T(u), T(v), TG, tcfg.InletProfile[profile],
                        torch.tensor(0.7), tm[2], tm[3])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# Plain versions of kernels 1, 3 and 4 against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_predict_div_plain_matches_pallas(semantics, scheme):
    """tests/test_substep_pallas.py:41-59's grid of cases."""
    u, v, _, _ = fields(5, JG)
    ref = predict_div_pallas(J(u), J(v), DT, NU, JG, jcfg.VelocityScheme[scheme],
                             jcfg.Semantics[semantics], block_rows=16, interpret=True)
    got = tsub.predict_div(T(u), T(v), DT, NU, TG, tcfg.VelocityScheme[scheme],
                           tcfg.Semantics[semantics])
    for r, g in zip(ref, got):
        assert_close(r, g)


@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("profile", PROFILES)
def test_correct_bc_plain_matches_pallas(semantics, profile):
    """tests/test_substep_pallas.py:62-93's CHANNEL cases, with
    PARABOLIC_UPPER."""
    u, v, p, pp = fields(6, JG)
    ue, ve, _, _ = fields(7, JG)
    ref = correct_bc_pallas(J(u), J(v), J(p), J(pp), J(ue), J(ve), DT, INLET, JG,
                            jcfg.InletProfile[profile], jcfg.FlowCase.CHANNEL,
                            jcfg.Semantics[semantics], block_rows=16, interpret=True)
    got = tsub.correct_bc(T(u), T(v), T(p), T(pp), T(ue), T(ve), DT,
                          torch.tensor(INLET), TG, tcfg.InletProfile[profile],
                          tcfg.FlowCase.CHANNEL, tcfg.Semantics[semantics])
    for r, g in zip(ref, got):
        assert_close(r, g)


def _rounds_scene(m, profile="PARABOLIC", scheme="QUICK"):
    """A JS scene on tests/test_ensemble_pallas.py:99-146's grid."""
    grid = m.Grid(nx=40, ny=24, lx=3.0, ly=1.5,
                  obstacles=(m.Cylinder(0.9, 0.75, 0.3),))
    params = m.SimulationParams(dt=0.002, viscosity=1e-4,
                                velocity_scheme=m.VelocityScheme[scheme],
                                inlet_profile=m.InletProfile[profile])
    return m.make_scene(grid, params, m.solver_options_for(m.Semantics.JS))


@pytest.mark.parametrize("profile", ["PARABOLIC", "PARABOLIC_UPPER"])
def test_rounds_plain_matches_pallas_js(profile):
    """The rounds kernel's JS form: no outer rounds, a zero warm start,
    the face-position BC masks and a parabolic inlet."""
    jscene, tscene = _rounds_scene(jc, profile), _rounds_scene(tc, profile)
    rng = np.random.default_rng(8)
    mk = lambda shp, s: (s * rng.standard_normal(shp)).astype(np.float32)
    arrays = (mk((24, 41), 0.1), mk((24, 40), 0.1), mk((24, 40), 0.05),
              np.zeros((24, 40), np.float32), mk((24, 40), 1.0))
    ref = solve_correct_rounds_pallas(*map(J, arrays), 0.002, 0.8, jscene,
                                      interpret=True)
    got = trounds.solve_correct_rounds(*map(T, arrays), 0.002, torch.tensor(0.8),
                                       tscene)
    for name, r, g in zip(("u", "v", "p", "pp", "err"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=5e-5, err_msg=name)
    rounds, sweeps = got[5].tolist()
    assert rounds == 0 and 1 <= sweeps <= tscene.opts.jacobi_iters
    # The inlet column is the profile's, exactly (the jitted Pallas kernel
    # may round its division by the radius differently: within the bound
    # above), zero on the no-slip rows.
    col = tbc.inlet_profile_column(tscene.grid, tscene.params.inlet_profile,
                                   torch.tensor(0.8), CPU)
    col[0] = col[-1] = 0.0
    np.testing.assert_array_equal(got[0][:, 0].numpy(), col.numpy())


# ---------------------------------------------------------------------------
# The whole step: the golden configs (tests/test_golden.py:52-61)
# ---------------------------------------------------------------------------

CONFIGS = [
    ("rust-first-jacobi", "RUST", "FIRST", "JACOBI", "UNIFORM"),
    ("rust-second-jacobi", "RUST", "SECOND", "JACOBI", "PARABOLIC"),
    ("js-first-jacobi", "JS", "FIRST", "JACOBI", "UNIFORM"),
    ("js-second-jacobi", "JS", "SECOND", "JACOBI", "UNIFORM"),
    ("js-quick-jacobi", "JS", "QUICK", "JACOBI", "PARABOLIC"),
    ("rust-first-jacobi-upper", "RUST", "FIRST", "JACOBI", "PARABOLIC_UPPER"),
    ("js-first-sor", "JS", "FIRST", "SOR", "UNIFORM"),
    ("js-first-multigrid", "JS", "FIRST", "MULTIGRID", "UNIFORM"),
]


def golden(sem, scheme, solver, profile, **overrides):
    """A golden config (tests/test_golden.py:47-69) as (JAX scene, port
    scene, oracle)."""
    def make(m):
        grid = m.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                      obstacles=(m.Cylinder(center_x=1.0, center_y=0.75, radius=0.3),))
        params = m.SimulationParams(dt=0.004, viscosity=1e-4, target_inlet_velocity=1.0,
                                    velocity_scheme=m.VelocityScheme[scheme],
                                    inlet_profile=m.InletProfile[profile],
                                    pressure_solver=m.PressureSolver[solver])
        opts = m.solver_options_for(m.Semantics[sem], **overrides)
        return grid, params, opts

    jargs = make(jcfg)
    oracle = NumpyModel(*jargs)
    return jc.make_scene(*jargs), tc.make_scene(*make(tcfg)), oracle


def oracle_field(oracle, name):
    f = getattr(oracle, name)
    return f[:-1] if name == "v" else f


def assert_golden(ts, want, g, what):
    """tests/test_golden.py:116-141 against one reference."""
    for f in ("u", "v"):
        w = np.asarray(want[f], np.float64)
        scale = max(1.0, float(np.sqrt(np.mean(w ** 2))))
        assert l2(getattr(ts, f).numpy(), w) <= 1e-5 * scale, (what, f)
    gp = ts.p.numpy().astype(np.float64)
    op = np.asarray(want["p"], np.float64)
    gscale = max(1.0, float(np.sqrt(np.mean((np.diff(op, axis=1) / g.dx) ** 2))))
    gx = l2(np.diff(gp, axis=1) / g.dx, np.diff(op, axis=1) / g.dx)
    gy = l2(np.diff(gp, axis=0) / g.dy, np.diff(op, axis=0) / g.dy)
    assert max(gx, gy) <= 1e-4 * gscale, (what, "grad p")
    d = gp - op
    d -= d.mean()
    pscale = max(1.0, float(np.sqrt(np.mean(op ** 2))))
    assert float(np.sqrt(np.mean(d ** 2))) <= 1e-5 * pscale, (what, "p")
    assert np.isclose(float(ts.dt), float(want["dt"]), rtol=1e-5, atol=1e-8), what


@pytest.mark.parametrize("name,sem,scheme,solver,profile", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_golden_fixed_iters(name, sem, scheme, solver, profile):
    """Golden layer 1 (tests/test_golden.py:72-99): zero tolerances, so
    every solve runs its full count on both sides."""
    kw = dict(ramp_up_steps=3, jacobi_tol=0.0, outer_corrector_tol=0.0, jacobi_iters=10)
    if sem == "RUST":
        kw["outer_corrector_rounds"] = 4
    else:
        kw.update(substeps_adaptive=False, substeps_init=2)
    jscene, tscene, oracle = golden(sem, scheme, solver, profile, **kw)
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    for k in range(3):
        oracle.update()
        js, _ = jstep(js)
        ts, diag = tstep(ts)
        for f in ("u", "v", "p", "p_prime"):
            got = getattr(ts, f).numpy()
            assert l2(got, oracle_field(oracle, f)) <= 1e-5, (name, k, f, "oracle")
            assert l2(got, np.asarray(getattr(js, f))) <= 1e-5, (name, k, f, "jax")
        assert np.isclose(float(ts.dt), float(oracle.dt), rtol=1e-5, atol=1e-8)
        assert int(diag.substeps) == (2 if sem == "JS" else 1)


@pytest.mark.parametrize("name,sem,scheme,solver,profile", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_golden_real_constants(name, sem, scheme, solver, profile):
    """Golden layer 2 (tests/test_golden.py:102-146): the reference's
    tolerances, early exits, JS's adaptive substeps and extrapolation."""
    jscene, tscene, oracle = golden(sem, scheme, solver, profile, ramp_up_steps=4)
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    g = tscene.grid
    for k in range(4):
        oracle.update()
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        assert_golden(ts, {"u": oracle_field(oracle, "u"), "v": oracle_field(oracle, "v"),
                           "p": oracle.p, "dt": oracle.dt}, g, f"{name} oracle {k}")
        assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt}, g,
                      f"{name} jax {k}")
        assert int(ts.substeps) == oracle.substeps == int(js.substeps), (name, k)


def test_residual_dt_scaling_matches_oracle_and_jax():
    """tests/test_golden.py:170-190: index.html:338-350's dt scaling."""
    jscene, tscene, oracle = golden(
        "JS", "FIRST", "JACOBI", "UNIFORM", ramp_up_steps=4, residual_dt_scaling=True,
        substeps_adaptive=False, substeps_init=2, jacobi_tol=0.0, jacobi_iters=10)
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    scaled = 0
    for k in range(4):
        oracle.update()
        js, _ = jstep(js)
        cap = float(ts.dt_user)
        ts, _ = tstep(ts)
        assert np.isclose(float(ts.dt), float(oracle.dt), rtol=1e-5, atol=1e-9), k
        assert np.isclose(float(ts.dt), float(js.dt), rtol=1e-5, atol=1e-9), k
        assert l2(ts.u.numpy(), oracle_field(oracle, "u")) <= 1e-5
        scaled += float(ts.dt) < cap
    assert scaled  # the residual scaling cut dt below the user's


def test_adaptive_substeps_follow_jax_step_for_step():
    """A JS run with adaptive substeps (5 at rest, halved, then grown to
    the cap of 20) on the golden grid: the executed and the adapted
    counts equal the JAX package's every step, the fields and residuals
    at the golden bounds."""
    jscene, tscene, _ = golden("JS", "FIRST", "JACOBI", "UNIFORM", ramp_up_steps=4)
    js, jd = jc.make_run(jscene, 12, donate=False)(jscene.init_state())
    ts, td = tc.make_run(tscene, 12)(tscene.init_state(device="cpu"))
    np.testing.assert_array_equal(td.substeps.numpy(), np.asarray(jd.substeps))
    assert int(ts.substeps) == int(js.substeps)
    assert td.substeps.tolist()[:3] == [5, 2, 20]  # the count shrank and grew
    for f in ("dt", "res_u", "res_v", "res_p"):
        np.testing.assert_allclose(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt}, tscene.grid,
                  "adaptive")


def test_js_state_from_jax_resumes():
    """A JS state saved by the JAX package (u_prev, v_prev and an adapted
    substep count included) resumes on the port to the same fields."""
    jscene, tscene, _ = golden("JS", "QUICK", "JACOBI", "PARABOLIC", ramp_up_steps=4)
    jstep = jc.make_step(jscene, donate=False)
    js = jscene.init_state()
    for _ in range(2):
        js, _ = jstep(js)
    d = {f.name: (None if getattr(js, f.name) is None else np.asarray(getattr(js, f.name)))
         for f in dataclasses.fields(js)}
    assert d["u_prev"] is not None and int(d["substeps"]) != 5
    ts = tc.state_from_numpy(d, "cpu")
    back = tc.state_to_numpy(ts)
    for k, a in d.items():
        np.testing.assert_array_equal(back[k], a)
    tstep = tc.make_step(tscene)
    for _ in range(2):
        js, _ = jstep(js)
        ts, _ = tstep(ts)
    assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt}, tscene.grid,
                  "resumed")
    assert l2(ts.u_prev.numpy(), np.asarray(js.u_prev)) <= 1e-5
    assert int(ts.substeps) == int(js.substeps) and int(ts.step) == 4


def test_init_state_js_fields():
    scene = tc.make_scene(tc.default_js_grid(), tc.SimulationParams(),
                          tc.solver_options_for(tc.Semantics.JS))
    s = scene.init_state(device="cpu")
    j = jc.make_scene(jc.default_js_grid(), jc.SimulationParams(),
                      jc.solver_options_for(jc.Semantics.JS)).init_state()
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(s, f.name)
        assert b.shape == np.asarray(a).shape and str(b.dtype)[6:] == str(a.dtype), f.name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(s.substeps) == 5 and not s.u_prev.any()


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def _fast_js_scenes(n=64):
    """bench.py --mode fast's shape with JS, QUICK and PARABOLIC
    (cells.js_quick_scene) on a small grid, the fused route forced and the
    cylinder widened to span a few cells."""
    out = []
    for m in (jc, tc):
        grid = m.Grid(nx=n, ny=n, lx=30.0, ly=30.0, obstacles=(m.Cylinder(7.5, 15.0, 3.0),))
        opts = m.solver_options_for(
            m.Semantics.JS, ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
            outer_corrector_rounds=0, early_exit=False, substeps_adaptive=False,
            substeps_init=1, extrapolate=True, substep_impl="pallas")
        out.append(m.make_scene(grid, m.SimulationParams(
            dt=0.002, viscosity=1e-4, velocity_scheme=m.VelocityScheme.QUICK,
            inlet_profile=m.InletProfile.PARABOLIC), opts))
    return out


def test_fused_js_quick_run_matches_jax(monkeypatch):
    """The fused route (predict_div, the Jacobi chain from zero,
    correct_bc) with JS semantics against the JAX package, which runs
    its Pallas kernels in interpret mode on the CPU."""
    jscene, tscene = _fast_js_scenes()
    calls = []
    from cfd_demo_tpu_torch.solver import piso as tpiso
    for name in ("predict_div", "correct_bc", "jacobi_chain"):
        fn = getattr(tpiso, name)
        monkeypatch.setattr(tpiso, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    js, jd = jc.make_run(jscene, 4, donate=False)(jscene.init_state())
    ts, td = tc.make_run(tscene, 4)(tscene.init_state(device="cpu"))
    assert set(calls) == {"predict_div", "correct_bc", "jacobi_chain"}
    for f in ("u", "v", "p", "p_prime", "u_prev"):
        assert l2(getattr(ts, f).numpy(), np.asarray(getattr(js, f))) <= 1e-5, f
    for f in ("dt", "res_u", "res_v", "res_p"):
        np.testing.assert_allclose(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)


def test_batched_js_scenes_raise_item_9():
    """Batches of JS, SECOND/QUICK, parabolic or multi-substep scenes
    raise before any route is chosen, on every pressure_impl."""
    base = tc.Grid(nx=24, ny=16, lx=4.0, ly=1.5, obstacles=(tc.Cylinder(1.0, 0.75, 0.3),))
    cases = [(tc.SimulationParams(), tc.solver_options_for(tc.Semantics.JS)),
             (tc.SimulationParams(velocity_scheme=tc.VelocityScheme.SECOND),
              tc.solver_options_for(tc.Semantics.RUST)),
             (tc.SimulationParams(velocity_scheme=tc.VelocityScheme.QUICK),
              tc.solver_options_for(tc.Semantics.RUST, pressure_impl="jnp")),
             (tc.SimulationParams(inlet_profile=tc.InletProfile.PARABOLIC_UPPER),
              tc.solver_options_for(tc.Semantics.RUST)),
             (tc.SimulationParams(), tc.solver_options_for(tc.Semantics.RUST,
                                                           substeps_init=2))]
    for params, opts in cases:
        scene = tc.make_scene(base, params, opts)
        batched = tc.batch_state(scene.init_state(device="cpu"), 2)
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            tc.make_step(scene)(batched)
