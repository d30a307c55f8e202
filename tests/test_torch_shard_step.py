"""The port's row-sharded step against cfd_demo_tpu's and its own unsharded
step, on the CPU.

The configurations are those of tests/test_shmap.py (a 96x128 channel
with a cylinder, 5 or 4 steps). The JAX side runs ``make_run_shmap(...,
interpret=True)`` on the 8-device virtual CPU mesh of tests/conftest.py;
the port runs ``make_run_shmap`` on a CPU ``RowMesh`` of the same 8
shards (16 rows each), from the same state (``state_from_numpy``).
Tolerances: fields 1e-6 of max(1, max|field|), scalars rtol 1e-5, atol
1e-8 (tests/test_shmap.py). FDM: the port's exact solve takes its
products in f64 (ops/fdm.py), the JAX package's in f32, so the two
differ at the golden bounds (tests/test_golden.py, as
tests/test_torch_sor.py holds the unsharded FDM step), while the
sharded and unsharded port runs agree bit for bit (the same gathered
solve, tests/test_shmap.py test_step_shmap_fdm). The port's sharded
step at 4 shards is also held against its own unsharded ``make_run``
at the bounds JAX's sharded step is held to its single-device step.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import cfd_demo_tpu as jc
from cfd_demo_tpu.shard.mesh import make_mesh as jax_mesh
from cfd_demo_tpu.shard.step_shmap import _sor_k as jax_sor_k
from cfd_demo_tpu.shard.step_shmap import make_run_shmap as jax_run_shmap
from cfd_demo_tpu.solver.piso import resolve_fuse_k as jax_resolve_fuse_k

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.core.state import _FIELDS
from cfd_demo_tpu_torch.shard import gather_state, make_mesh, make_run_shmap, shard_state
from cfd_demo_tpu_torch.shard.step_shmap import sor_k
from cfd_demo_tpu_torch.solver.piso import resolve_fuse_k

from test_torch_step import _assert_golden

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs the 8-device virtual CPU mesh (CFD_TEST_PLATFORM=cpu)")

torch.set_num_threads(1)

FIELDS = ("u", "v", "p", "p_prime", "u_prev", "v_prev")
SCALARS = ("res_u", "res_v", "res_p", "dt", "t")


def scene(m, solver="JACOBI", semantics="RUST", **opts):
    grid = m.Grid(nx=96, ny=128, lx=3.0, ly=4.0,
                  obstacles=(m.Cylinder(0.8, 2.0, 0.3),))
    params = m.SimulationParams(dt=0.002, viscosity=1e-4,
                                pressure_solver=getattr(m.PressureSolver, solver))
    return m.make_scene(grid, params, m.solver_options_for(
        getattr(m.Semantics, semantics), ramp_up_steps=5, pressure_impl="jnp",
        substep_impl="jnp", **opts))


# name -> (scene options, steps, the bound of JAX's sharded step against
# its single-device step in tests/test_shmap.py, which the port's
# sharded step keeps against its unsharded one)
CONFIGS = {
    "fast": (dict(jacobi_tol=0.0, jacobi_iters=20, outer_corrector_rounds=0,
                  early_exit=False, pallas_fuse_k=10), 5, 1e-6),
    "reference": (dict(jacobi_tol=0.0, jacobi_iters=20, outer_corrector_rounds=2,
                       outer_corrector_tol=0.0, early_exit=True, pallas_fuse_k=10),
                  4, 2e-6),
    "js_adaptive": (dict(semantics="JS", jacobi_tol=0.0, jacobi_iters=20,
                         early_exit=False, extrapolate=True, substeps_init=2,
                         substeps_adaptive=True, substeps_max=4,
                         residual_dt_scaling=True, pallas_fuse_k=10), 4, 5e-5),
    "sor": (dict(solver="SOR", jacobi_tol=0.0, jacobi_iters=20,
                 outer_corrector_rounds=0, early_exit=False, pallas_fuse_k=10), 5, 5e-5),
    "fdm": (dict(solver="FDM", outer_corrector_rounds=0), 4, 0.0),
}


def port_state(jstate):
    return tc.state_from_numpy({f: None if getattr(jstate, f) is None
                                else np.asarray(getattr(jstate, f)) for f in _FIELDS},
                               "cpu")


def run_port_sharded(tscene, state, steps, shards):
    mesh = make_mesh(shards, "cpu")
    got, diags = make_run_shmap(tscene, mesh, steps)(shard_state(state, mesh))
    return gather_state(got, "cpu"), diags


def atol_of(ref, rtol):
    return rtol * max(1.0, float(np.max(np.abs(np.asarray(ref)))))


def assert_states(got, gd, want, wd, field_rtol, scalar_rtol=1e-5):
    for f in FIELDS:
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None, f
            continue
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(w), rtol=0,
                                   atol=atol_of(w, field_rtol), err_msg=f)
    for f in SCALARS:
        assert np.isclose(float(getattr(got, f)), float(getattr(want, f)),
                          rtol=scalar_rtol, atol=1e-8), f
    np.testing.assert_array_equal(np.asarray(gd.substeps), np.asarray(wd.substeps))
    np.testing.assert_allclose(np.asarray(gd.res_p), np.asarray(wd.res_p),
                               rtol=scalar_rtol, atol=1e-8)


@pytest.mark.parametrize("name", ["fast", "reference", "js_adaptive", "sor"])
def test_step_shmap_matches_jax(name):
    opts, steps, _ = CONFIGS[name]
    jscene, tscene = scene(jc, **opts), scene(tc, **opts)
    j0 = jscene.init_state()
    want, wd = jax_run_shmap(jscene, jax_mesh(), steps, interpret=True)(j0)
    got, gd = run_port_sharded(tscene, port_state(j0), steps, 8)
    assert_states(got, gd, want, wd, 1e-6)


def test_step_shmap_fdm_matches_jax_and_the_unsharded_step():
    opts, steps, _ = CONFIGS["fdm"]
    jscene, tscene = scene(jc, **opts), scene(tc, **opts)
    j0 = jscene.init_state()
    want, _ = jax_run_shmap(jscene, jax_mesh(), steps, interpret=True)(j0)
    got, gd = run_port_sharded(tscene, port_state(j0), steps, 8)
    g = tscene.grid
    _assert_golden(got, {"u": want.u, "v": want.v, "p": want.p, "dt": want.dt},
                   g.dx, g.dy, "fdm sharded")
    ref, rd = tc.make_run(tscene, steps)(port_state(j0))
    for f in ("u", "v", "p", "p_prime"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in SCALARS:
        assert float(getattr(got, f)) == float(getattr(ref, f)), f
    assert torch.equal(gd.res_p, rd.res_p)


@pytest.mark.parametrize("name", ["fast", "reference", "js_adaptive", "sor"])
def test_step_shmap_matches_the_unsharded_step(name):
    """4 shards of 32 rows against the port's own make_run."""
    opts, steps, rtol = CONFIGS[name]
    tscene = scene(tc, **opts)
    start = tscene.init_state(device="cpu")
    ref, rd = tc.make_run(tscene, steps)(start)
    got, gd = run_port_sharded(tscene, start, steps, 4)
    assert_states(got, gd, ref, rd, rtol, scalar_rtol=1e-4)


def test_sharded_and_unsharded_diagnostics_have_one_shape():
    opts, _, _ = CONFIGS["fast"]
    tscene = scene(tc, **opts)
    _, gd = run_port_sharded(tscene, tscene.init_state(device="cpu"), 2, 4)
    _, rd = tc.make_run(tscene, 2)(tscene.init_state(device="cpu"))
    for a, b in zip(gd, rd):
        assert a.shape == b.shape and a.dtype == b.dtype


# ---------------------------------------------------------------------------
# k, and what the tier refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters,fuse_k", [(50, 0), (20, 0), (18, 0), (25, 0), (7, 0),
                                          (50, 8)])
def test_resolve_fuse_k_divide_and_sor_k_match_jax(iters, fuse_k):
    def sc(m):
        return m.make_scene(m.Grid(nx=64, ny=64, lx=1.0, ly=1.0), m.SimulationParams(
            pressure_solver=m.PressureSolver.SOR), m.solver_options_for(
                m.Semantics.RUST, jacobi_iters=iters, pallas_fuse_k=fuse_k))
    js, ts = sc(jc), sc(tc)
    assert resolve_fuse_k(ts.opts, divide=iters) == jax_resolve_fuse_k(
        js.opts, js.grid, divide=iters)
    assert resolve_fuse_k(ts.opts) == (fuse_k or 16)
    assert sor_k(ts) == jax_sor_k(js)
    if not fuse_k:
        assert iters % sor_k(ts) == 0


def _raises(tscene, shards, exc, match):
    with pytest.raises(exc, match=match):
        make_run_shmap(tscene, make_mesh(shards, "cpu"), 1)


@pytest.mark.parametrize("solver,item", [("MULTIGRID", "item 12"),
                                         ("MG_PRODUCTION", "item 12")])
def test_multigrid_solvers_raise_naming_their_item(solver, item):
    _raises(scene(tc, solver=solver, outer_corrector_rounds=0), 8, NotImplementedError,
            item)


def test_cavity_raises_naming_its_item():
    """make_scene takes CAVITY (the unsharded step runs it); the sharded
    step refuses it naming item 6b before any launch, as it refuses a
    Scene built around make_scene."""
    cav = tc.make_scene(tc.cavity_grid(64), tc.SimulationParams(
        flow_case=tc.FlowCase.CAVITY))
    _raises(cav, 4, NotImplementedError, "item 6b")
    cav = tc.Scene(grid=tc.cavity_grid(64), params=tc.SimulationParams(
        flow_case=tc.FlowCase.CAVITY), opts=tc.SolverOptions())
    _raises(cav, 4, NotImplementedError, "item 6b")


def test_bad_splits_and_lexicographic_sor_raise_as_jax():
    opts = CONFIGS["fast"][0]
    # 128 rows into 5 shards; into 16 shards of 8 rows, under the 16-row halo
    _raises(scene(tc, **opts), 5, ValueError, "must split into 5 shards")
    _raises(scene(tc, **opts), 16, ValueError, r"16 shards of >= 16 rows")
    _raises(scene(tc, solver="SOR", sor_ordering="lexicographic", **opts), 8, ValueError,
            "lexicographic SOR is sequential")
    _raises(scene(tc, **dict(opts, jacobi_iters=25)), 8, ValueError,
            "multiple of the \\(resolved\\) pallas_fuse_k")
    with pytest.raises(TypeError, match="sharded over"):
        make_run_shmap(scene(tc, **opts), make_mesh(8, "cpu"), 1)(
            scene(tc, **opts).init_state(device="cpu"))


def test_default_mesh_is_the_card():
    """make_mesh defaults to CUDA devices (no card here: only the devices'
    type is checked)."""
    mesh = make_mesh(3)
    assert [d.type for d in mesh.devices] == ["cuda"] * 3
    assert dataclasses.is_dataclass(mesh) and mesh.size == 3
