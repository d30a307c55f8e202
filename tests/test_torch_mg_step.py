"""The port's MULTIGRID and legacy MG_PRODUCTION steps against the NumPy
oracle and cfd_demo_tpu on the CPU, and the cells that run them.

Bounds: the golden ones of tests/test_golden.py (per-field L2 <= 1e-5 a
step with every tolerance at zero; u, v, grad p and mean-removed p with
the reference's real constants). tests/test_torch_mg.py holds the
solvers and the kernels' plain versions.
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
from test_torch_step import _assert_golden, oracle_field, t_field

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def mg_golden_setup(solver="MULTIGRID", **opt_overrides):
    """tests/test_golden.py's grid with Rust/FIRST/UNIFORM/CHANNEL and the
    given solver."""
    def grid(m):
        return m.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                      obstacles=(m.Cylinder(center_x=1.0, center_y=0.75, radius=0.3),))

    def params(m):
        return m.SimulationParams(dt=0.004, viscosity=1e-4, target_inlet_velocity=1.0,
                                  pressure_solver=getattr(m.PressureSolver, solver))

    scenes = [m.make_scene(grid(m), params(m),
                           m.solver_options_for(m.Semantics.RUST, **opt_overrides))
              for m in (jc, tc)]
    oracle = NumpyModel(grid(jc), params(jc),
                        jc.solver_options_for(jc.Semantics.RUST, **opt_overrides))
    return scenes[0], scenes[1], oracle


def test_multigrid_fixed_iters_matches_oracle_and_jax():
    """Golden layer 1 (tests/test_golden.py:74-99): zero tolerances, 4
    outer rounds of the three-cycle solve."""
    jscene, tscene, oracle = mg_golden_setup(
        ramp_up_steps=3, jacobi_tol=0.0, outer_corrector_tol=0.0,
        outer_corrector_rounds=4)
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    for k in range(3):
        oracle.update()
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        for f in ("u", "v", "p", "p_prime"):
            got = t_field(ts, f)
            assert l2(got, oracle_field(oracle, f)) <= 1e-5, (k, f, "oracle")
            assert l2(got, np.asarray(getattr(js, f))) <= 1e-5, (k, f, "jax")
        assert np.isclose(float(ts.dt), float(oracle.dt), rtol=1e-5, atol=1e-8)


def test_multigrid_real_constants_match_oracle_and_jax():
    """Golden layer 2 (tests/test_golden.py:103-146): the reference's
    tolerances and 20 outer rounds, exact exits."""
    jscene, tscene, oracle = mg_golden_setup(ramp_up_steps=4)
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    g = tscene.grid
    for k in range(4):
        oracle.update()
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        _assert_golden(ts, {"u": oracle_field(oracle, "u"), "v": oracle_field(oracle, "v"),
                            "p": oracle.p, "dt": oracle.dt}, g.dx, g.dy, f"oracle {k}")
        _assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt},
                       g.dx, g.dy, f"jax {k}")


def _bench_scenes(nx, ny, solver, **kw):
    """bench.py --mode production's options (bench.py:87-96) with
    ``solver`` on a small grid, the cylinder widened to span a few cells."""
    out = []
    for m in (jc, tc):
        grid = m.Grid(nx=nx, ny=ny, lx=30.0, ly=30.0 * ny / nx,
                      obstacles=(m.Cylinder(7.5, 15.0 * ny / nx, 3.0),))
        opts = m.solver_options_for(m.Semantics.RUST, ramp_up_steps=10,
                                    outer_corrector_rounds=0, **kw)
        out.append(m.make_scene(grid, m.SimulationParams(
            dt=0.002, viscosity=1e-4, pressure_solver=getattr(m.PressureSolver, solver)),
            opts))
    return out


def _spy_piso(monkeypatch, calls, names):
    for name in names:
        fn = getattr(tpiso, name)
        monkeypatch.setattr(tpiso, name, lambda *a, _f=fn, _n=name, **kw:
                            (calls.append(_n), _f(*a, **kw))[1])


@pytest.mark.parametrize("nx,ny", [(63, 47)])
def test_fused_multigrid_route_matches_jax(monkeypatch, nx, ny):
    """The fused route (predict_div, multigrid, correct_bc), as the
    multigrid cell runs it at >= 2M cells, on a small grid with
    FUSED_MIN_CELLS at 0 (odd: every level odd): 5 steps against the JAX
    step. res_p, the max residual of a three-cycle solve, carries its
    f32 cancellation, which XLA's jit rounds otherwise (it multiplies by
    1/h² where the port divides; tests/test_torch_mgp.py): 1e-3."""
    monkeypatch.setattr(tpiso, "FUSED_MIN_CELLS", 0)
    calls = []
    _spy_piso(monkeypatch, calls, ("predict_div", "correct_bc", "multigrid",
                                   "_substep_jnp"))
    jscene, tscene = _bench_scenes(nx, ny, "MULTIGRID")
    js, jd = jc.make_run(jscene, 5, donate=False)(jscene.init_state())
    ts, td = tc.make_run(tscene, 5)(tscene.init_state(device="cpu"))
    assert set(calls) == {"predict_div", "multigrid", "correct_bc"}
    g = tscene.grid
    _assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt}, g.dx, g.dy,
                   f"{nx}x{ny}")
    for f, rtol in (("dt", 1e-5), ("res_u", 1e-4), ("res_v", 1e-4), ("res_p", 1e-3)):
        np.testing.assert_allclose(getattr(td, f).numpy(), np.asarray(getattr(jd, f)),
                                   rtol=rtol, atol=1e-7, err_msg=f)
    assert float(ts.u.abs().max()) >= 0.4


@pytest.mark.parametrize("nx,ny,substep_impl", [(27, 16, "pallas")])
def test_legacy_production_rollout_matches_jax(nx, ny, substep_impl):
    """Five legacy MG_PRODUCTION steps against cfd_demo_tpu.make_run
    (tests/test_torch_mgp.py:332-365's bounds) on the fused route, as
    the legacy cell runs them, odd nx."""
    scenes = []
    for m in (jc, tc):
        grid = m.Grid(nx=nx, ny=ny, lx=4.0 * nx / 24, ly=1.5 * ny / 16,
                      obstacles=(m.Cylinder(1.0, 0.75 * ny / 16, 0.3),))
        params = m.SimulationParams(dt=0.004, viscosity=1e-4,
                                    pressure_solver=m.PressureSolver.MG_PRODUCTION)
        opts = m.solver_options_for(m.Semantics.RUST, ramp_up_steps=4,
                                    outer_corrector_rounds=0, mgp_scheme="legacy",
                                    substep_impl=substep_impl)
        scenes.append(m.make_scene(grid, params, opts))
    js, jd = jc.make_run(scenes[0], 5, donate=False)(scenes[0].init_state())
    ts, td = tc.make_run(scenes[1], 5)(scenes[1].init_state(device="cpu"))
    g = scenes[1].grid
    _assert_golden(ts, {"u": js.u, "v": js.v, "p": js.p, "dt": js.dt}, g.dx, g.dy,
                   "legacy")
    np.testing.assert_allclose(td.res_p.numpy(), np.asarray(jd.res_p), rtol=1e-2,
                               atol=1e-6)
    assert float(np.abs(np.asarray(js.u)).max()) > 0.5


@pytest.mark.parametrize("solver,kw", [("MULTIGRID", {}),
                                       ("MG_PRODUCTION", {"mgp_scheme": "legacy"})])
def test_batches_raise(solver, kw):
    """A batch of either solver names queue 1 item 9; make_scene itself
    takes both."""
    _, scene, _ = mg_golden_setup(solver, early_exit=False, **kw)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tc.make_step(scene)(tc.batch_state(scene.init_state("cpu"), 2))


def test_800x264_multigrid_takes_the_plain_projection(monkeypatch):
    """The Rust app's scene with --solver multigrid: plain predictor, the
    multigrid solve in each of its outer rounds, never the rounds kernel."""
    calls = []
    _spy_piso(monkeypatch, calls, ("solve_correct_rounds", "multigrid", "_substep_jnp"))
    scene = tc.make_scene(tc.default_grid(), tc.SimulationParams(
        pressure_solver=tc.PressureSolver.MULTIGRID))
    state = scene.init_state(device="cpu")
    state = dataclasses.replace(state, step=torch.tensor(50, dtype=torch.int32))
    state, _ = tc.make_step(scene)(state)
    assert set(calls) == {"_substep_jnp", "multigrid"}
    assert bool(torch.isfinite(state.u).all()) and float(state.u.abs().max()) > 0


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,make,solver,scheme", [
    ("2048^2 multigrid", cells.multigrid_scene, "MULTIGRID", "auto"),
    ("2048^2 production legacy", cells.legacy_production_scene, "MG_PRODUCTION",
     "legacy")])
def test_cells_are_bench_modes(name, make, solver, scheme):
    """bench.py --mode production (--mgp-scheme legacy), and for
    multigrid the same options with the solver swapped."""
    scene = make(2048)
    want = jc.make_scene(
        jc.Grid(nx=2048, ny=2048, lx=30.0, ly=30.0,
                obstacles=(jc.Cylinder(7.5, 15.0, 0.75),)),
        jc.SimulationParams(dt=0.002, viscosity=1e-4,
                            pressure_solver=getattr(jc.PressureSolver, solver)),
        jc.solver_options_for(jc.Semantics.RUST, ramp_up_steps=10,
                              outer_corrector_rounds=0, pressure_impl="auto",
                              pallas_fuse_k=0, mgp_rtol=0.0, mgp_scheme=scheme))
    for part in ("grid", "params", "opts"):
        assert repr(getattr(scene, part)) == repr(getattr(want, part)), part
    assert tpiso._use_fused_substep(scene)
    assert cells.CELLS[name][0] is make
    assert cells.vertex_levels(2048, 2048, scene.opts.mg_coarsest) == 10
    assert cells.vertex_levels(264, 800, scene.opts.mg_coarsest) == 8
