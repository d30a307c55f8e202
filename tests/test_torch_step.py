"""The port's whole step against the NumPy oracle and cfd_demo_tpu on the CPU.

The bounds are the golden ones of tests/test_golden.py: per-field L2
<= 1e-5 per step with every tolerance at zero (identical iteration
counts), and, with the reference's real constants, L2 on u and v, grad p
and mean-removed p (an outer-round count that differs by one at a float
knife edge shifts p by a near-uniform gauge, tests/test_golden.py:14-24).
"""
import dataclasses

import numpy as np
import pytest
import torch

import cfd_demo_tpu as jc
from cfd_demo_tpu.oracle.reference import NumpyModel

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch import cells
from cfd_demo_tpu_torch.solver import piso as tpiso

from conftest import l2

torch.set_num_threads(1)

FIELDS = ("u", "v", "p", "p_prime")


def golden_setup(**opt_overrides):
    """The rust-first-jacobi config of tests/test_golden.py:53 on its grid."""
    def grid(m):
        return m.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                      obstacles=(m.Cylinder(center_x=1.0, center_y=0.75,
                                            radius=0.3),))

    def params(m):
        return m.SimulationParams(dt=0.004, viscosity=1e-4,
                                  target_inlet_velocity=1.0)

    scenes = [m.make_scene(grid(m), params(m),
                           m.solver_options_for(m.Semantics.RUST, **opt_overrides))
              for m in (jc, tc)]
    oracle = NumpyModel(grid(jc), params(jc),
                        jc.solver_options_for(jc.Semantics.RUST, **opt_overrides))
    return scenes[0], scenes[1], oracle


def oracle_field(oracle, name):
    f = getattr(oracle, name)
    return f[:-1] if name == "v" else f


def t_field(state, name):
    return getattr(state, name).numpy()


def test_fixed_iters_matches_oracle_and_jax():
    """Golden layer 1 (tests/test_golden.py:74-99): zero tolerances."""
    jscene, tscene, oracle = golden_setup(
        ramp_up_steps=3, jacobi_tol=0.0, outer_corrector_tol=0.0,
        jacobi_iters=10, outer_corrector_rounds=4)
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    for k in range(3):
        oracle.update()
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        for f in FIELDS:
            got = t_field(ts, f)
            assert l2(got, oracle_field(oracle, f)) <= 1e-5, (k, f, "oracle")
            assert l2(got, np.asarray(getattr(js, f))) <= 1e-5, (k, f, "jax")
        assert np.isclose(float(ts.dt), float(oracle.dt), rtol=1e-5, atol=1e-8)
        assert np.isclose(float(ts.dt), float(js.dt), rtol=1e-5, atol=1e-8)


def _assert_golden(ts, want, dx, dy, what):
    """tests/test_golden.py:116-141 against one reference."""
    for f in ("u", "v"):
        w = want[f]
        scale = max(1.0, float(np.sqrt(np.mean(np.asarray(w, np.float64) ** 2))))
        assert l2(t_field(ts, f), w) <= 1e-5 * scale, (what, f)
    gp = t_field(ts, "p").astype(np.float64)
    op = np.asarray(want["p"], np.float64)
    gscale = max(1.0, float(np.sqrt(np.mean((np.diff(op, axis=1) / dx) ** 2))))
    gx = l2(np.diff(gp, axis=1) / dx, np.diff(op, axis=1) / dx)
    gy = l2(np.diff(gp, axis=0) / dy, np.diff(op, axis=0) / dy)
    assert max(gx, gy) <= 1e-4 * gscale, (what, "grad p")
    d = gp - op
    d -= d.mean()
    pscale = max(1.0, float(np.sqrt(np.mean(op ** 2))))
    assert float(np.sqrt(np.mean(d ** 2))) <= 1e-5 * pscale, (what, "p")
    assert np.isclose(float(ts.dt), float(want["dt"]), rtol=1e-5, atol=1e-8), what


def test_real_constants_match_oracle_and_jax():
    """Golden layer 2 (tests/test_golden.py:103-146): the reference's
    tolerances, early exits and 20 outer rounds."""
    jscene, tscene, oracle = golden_setup(ramp_up_steps=4)
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    g = tscene.grid
    for k in range(4):
        oracle.update()
        js, _ = jstep(js)
        ts, diag = tstep(ts)
        _assert_golden(ts, {"u": oracle_field(oracle, "u"),
                            "v": oracle_field(oracle, "v"),
                            "p": oracle.p, "dt": oracle.dt}, g.dx, g.dy,
                       f"oracle step {k}")
        _assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt},
                       g.dx, g.dy, f"jax step {k}")
        assert int(ts.substeps) == oracle.substeps == int(diag.substeps)


def _fast_scenes(n=64):
    """The benchmark's fast mode (bench.py:78-86) on a small grid, with
    the fused route forced; the cylinder is widened to span a few cells."""
    out = []
    for m in (jc, tc):
        grid = m.Grid(nx=n, ny=n, lx=30.0, ly=30.0,
                      obstacles=(m.Cylinder(7.5, 15.0, 3.0),))
        opts = m.solver_options_for(
            m.Semantics.RUST, ramp_up_steps=10, jacobi_tol=0.0,
            jacobi_iters=50, outer_corrector_rounds=0, early_exit=False,
            substep_impl="pallas")
        out.append(m.make_scene(grid, m.SimulationParams(dt=0.002,
                                                         viscosity=1e-4), opts))
    return out


def test_fast_shape_run_matches_jax():
    jscene, tscene = _fast_scenes()
    js, jd = jc.make_run(jscene, 5, donate=False)(jscene.init_state())
    ts, td = tc.make_run(tscene, 5)(tscene.init_state(device="cpu"))
    for f in FIELDS:
        assert l2(t_field(ts, f), np.asarray(getattr(js, f))) <= 1e-5, f
    for f in ("dt", "res_u", "res_v", "res_p"):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(td.step.numpy(), np.asarray(jd.step))
    assert float(ts.u.abs().max()) >= 0.4  # the inlet ramp reached 4/10


def _spy(monkeypatch, name, calls):
    fn = getattr(tpiso, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(tpiso, name, wrapped)


@pytest.mark.parametrize("route", ["fused", "rounds", "fused-with-rounds",
                                   "plain", "production", "production-plain"])
def test_route_table(monkeypatch, route):
    """piso.py's route table: which kernel wrappers one step calls."""
    calls = []
    for name in ("predict_div", "jacobi_chain", "correct_bc",
                 "solve_correct_rounds", "jacobi", "multigrid_production"):
        _spy(monkeypatch, name, calls)
    production = dict(pressure_solver=tc.PressureSolver.MG_PRODUCTION)
    if route == "rounds":
        _, scene, _ = golden_setup()
        want = {"predict_div", "solve_correct_rounds"}
    elif route == "plain":
        _, scene, _ = golden_setup(substep_impl="jnp")
        want = {"jacobi"}
    elif route == "production-plain":
        # below 2M cells: plain predictor, the production solve, no rounds kernel
        _, scene, _ = golden_setup(outer_corrector_rounds=0)
        scene = dataclasses.replace(scene, params=dataclasses.replace(
            scene.params, **production))
        want = {"multigrid_production"}
    else:
        _, scene = _fast_scenes(32)
        want = {"predict_div", "jacobi_chain", "correct_bc"}
        if route == "fused-with-rounds":
            scene = dataclasses.replace(scene, opts=dataclasses.replace(
                scene.opts, outer_corrector_rounds=2, jacobi_tol=1e-4,
                early_exit=True, pressure_impl="pallas"))
            want = {"predict_div", "jacobi_chain"}
        elif route == "production":
            scene = dataclasses.replace(scene, params=dataclasses.replace(
                scene.params, **production))
            want = {"predict_div", "multigrid_production", "correct_bc"}
    tc.make_step(scene)(scene.init_state(device="cpu"))
    assert set(calls) == want


def _predictor_scene(case):
    """A small scene of each route that reaches ``_substep_jnp``, a few
    steps into the inlet ramp."""
    cyl = tc.Cylinder(center_x=1.0, center_y=0.75, radius=0.3)
    grid = tc.Grid(nx=24, ny=16, lx=4.0, ly=1.5, obstacles=(cyl,))
    params = tc.SimulationParams(dt=0.004, viscosity=1e-4, target_inlet_velocity=1.0)
    semantics, opts = tc.Semantics.RUST, {"ramp_up_steps": 4}
    if case == "rounds-js":
        semantics = tc.Semantics.JS
        params = dataclasses.replace(params, velocity_scheme=tc.VelocityScheme.QUICK,
                                     inlet_profile=tc.InletProfile.PARABOLIC)
    elif case == "rounds-cavity":
        grid = tc.cavity_grid(20)
        params = tc.SimulationParams(dt=0.002, viscosity=1e-2,
                                     flow_case=tc.FlowCase.CAVITY)
    elif case in ("sor", "fdm", "multigrid", "mg_production"):
        params = dataclasses.replace(
            params, pressure_solver=tc.PressureSolver[case.upper()])
    elif case in ("substep-jnp", "batch-substep-jnp"):
        opts["substep_impl"] = "jnp"
    elif case == "pressure-jnp":
        opts["pressure_impl"] = "jnp"
    return tc.make_scene(grid, params, tc.solver_options_for(semantics, **opts))


@pytest.mark.parametrize("case", ["rounds", "rounds-js", "rounds-cavity", "batch",
                                  "batch-substep-jnp", "sor", "fdm", "multigrid",
                                  "mg_production", "substep-jnp", "pressure-jnp"])
def test_rounds_route_predicts_with_kernel_1(monkeypatch, case):
    """The single-scene JACOBI rounds route computes u*, v* and rhs with
    one ``predict_div`` call a substep and never the plain predictor;
    every other caller of ``_substep_jnp`` keeps the plain predictor and
    never calls ``predict_div``."""
    calls = []
    for name in ("predict_div", "predict"):
        _spy(monkeypatch, name, calls)
    scene = _predictor_scene(case)
    state = scene.init_state(device="cpu")
    if case.startswith("batch"):
        # a batch that kernel 20 does not take reaches _substep_jnp
        monkeypatch.setattr(tpiso, "substep_batch_takes", lambda *a: False)
        state = tc.batch_state(state, 2, nu=torch.tensor([1e-4, 1e-2]))
    step, substeps = tc.make_step(scene), 0
    for _ in range(3):
        state, diag = step(state)
        substeps += int(diag.substeps.max())
    if case.startswith("rounds"):
        assert calls == ["predict_div"] * substeps
    else:
        assert "predict_div" not in calls and calls.count("predict") >= 3
    assert bool(torch.isfinite(state.u).all()) and float(state.u.abs().max()) > 0


def _parent_predictor(u, v, dt_sub, nu, grid, scheme, semantics):
    """The plain predictor and divergence as the rounds route composed
    them before it called ``predict_div``."""
    mask_u, mask_v, _, _ = tpiso.masks_traced(grid, semantics, u.device)
    u_star, v_star = tpiso.predict(u, v, dt_sub, nu, grid.dx, grid.dy, grid.nx,
                                   grid.ny, scheme, semantics == tc.Semantics.JS,
                                   mask_u, mask_v)
    return u_star, v_star, tpiso.divergence_rhs(u_star, v_star, dt_sub, grid.dx, grid.dy)


def _rounds_bits_scene(case):
    if case == "800x264 at 80x27":
        # the app's default scene and parameters on a tenth of its cells
        grid = tc.Grid(nx=80, ny=27, lx=30.0, ly=10.0,
                       obstacles=(tc.Cylinder(center_x=7.5, center_y=5.0, radius=0.75),))
        return tc.make_scene(grid), 50
    if case == "cavity 32x32":
        return tc.make_scene(tc.cavity_grid(32), tc.SimulationParams(
            dt=0.002, viscosity=1e-2, flow_case=tc.FlowCase.CAVITY)), 0
    if case == "golden":
        return golden_setup(ramp_up_steps=4)[1], 0
    return _predictor_scene("rounds-js"), 0


@pytest.mark.parametrize("case", ["golden", "800x264 at 80x27", "cavity 32x32", "js quick"])
def test_rounds_route_fields_are_the_plain_predictors(monkeypatch, case):
    """On the CPU, ``predict_div`` runs the plain composition: steps of the
    rounds route give, bit for bit, the fields of the same steps with the
    plain predictor and divergence called directly."""
    scene, start = _rounds_bits_scene(case)
    init = scene.init_state(device="cpu")
    init = dataclasses.replace(init, step=torch.tensor(start, dtype=torch.int32))
    step = tc.make_step(scene)
    parent_calls = []

    def parent(*args):
        parent_calls.append(args)
        return _parent_predictor(*args)

    states = []
    for predictor in (tpiso.predict_div, parent):
        monkeypatch.setattr(tpiso, "predict_div", predictor)
        state = init
        for _ in range(3):
            state, _ = step(state)
        states.append(state)
    got, want = states
    assert len(parent_calls) >= 3 and float(got.u.abs().max()) > 0
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name


def test_reference_shaped_production_scene_skips_the_rounds_kernel(monkeypatch):
    """The 800x264 scene with MG_PRODUCTION (and the default 20 outer
    rounds) takes the plain projection: the rounds kernel is Jacobi's
    alone (JAX piso.py:573)."""
    calls = []
    for name in ("solve_correct_rounds", "multigrid_production", "jacobi",
                 "jacobi_chain"):
        _spy(monkeypatch, name, calls)
    scene = tc.make_scene(tc.default_grid(), tc.SimulationParams(
        pressure_solver=tc.PressureSolver.MG_PRODUCTION))
    assert not tpiso._use_fused_substep(scene)
    state = scene.init_state(device="cpu")
    state = dataclasses.replace(state, step=torch.tensor(50, dtype=torch.int32))
    state, _ = tc.make_step(scene)(state)
    assert "solve_correct_rounds" not in calls
    assert set(calls) == {"multigrid_production"}
    assert bool(torch.isfinite(state.u).all()) and float(state.u.abs().max()) > 0


def test_state_round_trip_and_resume_from_jax():
    """state_from_numpy/state_to_numpy carry a JAX state into the port,
    and both packages continue from it to the same fields."""
    jscene, tscene, _ = golden_setup(ramp_up_steps=4)
    jstep = jc.make_step(jscene, donate=False)
    js = jscene.init_state()
    for _ in range(2):
        js, _ = jstep(js)
    d = {f.name: (None if getattr(js, f.name) is None
                  else np.asarray(getattr(js, f.name)))
         for f in dataclasses.fields(js)}
    ts = tc.state_from_numpy(d, "cpu")
    back = tc.state_to_numpy(ts)
    assert set(back) == set(d)
    for k, a in d.items():
        if a is None:
            assert back[k] is None
        else:
            assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
            np.testing.assert_array_equal(back[k], a)
    tstep = tc.make_step(tscene)
    for _ in range(2):
        js, _ = jstep(js)
        ts, _ = tstep(ts)
    g = tscene.grid
    _assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt},
                   g.dx, g.dy, "resumed")
    assert int(ts.step) == int(js.step) == 4


def _bench_jax_scene(mode, n):
    """bench.py:78-120's scene for ``mode`` at n², in the JAX package."""
    grid = jc.Grid(nx=n, ny=n, lx=30.0, ly=30.0,
                   obstacles=(jc.Cylinder(7.5, 15.0, 0.75),))
    params = jc.SimulationParams(dt=0.002, viscosity=1e-4)
    if mode == "fast":
        opts = jc.solver_options_for(
            jc.Semantics.RUST, ramp_up_steps=10, jacobi_tol=0.0,
            jacobi_iters=50, outer_corrector_rounds=0, early_exit=False,
            pressure_impl="auto", pallas_fuse_k=0)
    elif mode == "production":
        params = jc.SimulationParams(
            dt=0.002, viscosity=1e-4,
            pressure_solver=jc.PressureSolver.MG_PRODUCTION)
        opts = jc.solver_options_for(
            jc.Semantics.RUST, ramp_up_steps=10, outer_corrector_rounds=0,
            pressure_impl="auto", pallas_fuse_k=0, mgp_rtol=0.0,
            mgp_scheme="auto")
    else:
        opts = jc.solver_options_for(jc.Semantics.RUST, ramp_up_steps=10,
                                     pressure_impl="auto", pallas_fuse_k=0)
    return jc.make_scene(grid, params, opts)


@pytest.mark.parametrize("cell", ["800x264 default", "2048^2 fast",
                                  "2048^2 reference", "2048^2 production",
                                  "1024^2 cavity"])
def test_cells_are_the_reference_configs(cell):
    """cells.py's scenes are the README quick start, bench.py's modes and
    the cavity app's scene (apps/cavity.py), and each takes the route its
    cell is meant to exercise."""
    make = cells.CELLS[cell][0]
    scene = make()
    if cell == "800x264 default":
        want = jc.make_scene(jc.default_grid())
    elif cell == "1024^2 cavity":
        want = jc.make_scene(jc.cavity_grid(1024), jc.SimulationParams(
            dt=0.002, viscosity=1e-2, target_inlet_velocity=1.0,
            flow_case=jc.FlowCase.CAVITY), jc.solver_options_for(jc.Semantics.RUST))
    else:
        want = _bench_jax_scene(cell.split()[1], 2048)
    for part in ("grid", "params", "opts"):
        assert repr(getattr(scene, part)) == repr(getattr(want, part)), part
    rounds_route = cell in ("800x264 default", "1024^2 cavity")
    fused = tpiso._use_fused_substep(scene)
    assert fused == (not rounds_route)
    assert ((scene.opts.outer_corrector_rounds > 0)
            == (cell in ("800x264 default", "2048^2 reference", "1024^2 cavity")))


def test_cells_rounds_args_and_busy_time():
    scene = cells.reference_scene()
    state = scene.init_state(device="cpu")
    out = tpiso.solve_correct_rounds(*cells.rounds_args(scene, state))
    assert out[5].tolist() == [0, 1]  # a field at rest converges at once
    assert cells._busy_us([(5, 6), (0, 2), (1, 3)]) == 4.0
