"""The port's copied config against the JAX package's, and the port's
import-time independence from jax."""
import dataclasses
import enum
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cfd_demo_tpu.core.config as jcfg
import cfd_demo_tpu_torch as ct
import cfd_demo_tpu_torch.core.config as tcfg

torch.set_num_threads(1)

ENUMS = ["VelocityScheme", "PressureSolver", "InletProfile", "Semantics",
         "FlowCase"]
DATACLASSES = ["Cylinder", "Box", "Grid", "SimulationParams", "SolverOptions"]


def _plain(x):
    """Dataclass/enum values as comparable plain data."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [(m.name, m.value) for m in t] == [(m.name, m.value) for m in j]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_and_defaults_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)

    def spec(cls):
        return [(f.name, str(f.type), _plain(f.default), f.default_factory)
                for f in dataclasses.fields(cls)]

    assert spec(t) == spec(j)
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen


@pytest.mark.parametrize("semantics", ["RUST", "JS"])
def test_solver_options_for_matches(semantics):
    j = jcfg.solver_options_for(jcfg.Semantics[semantics], jacobi_iters=7)
    t = tcfg.solver_options_for(tcfg.Semantics[semantics], jacobi_iters=7)
    assert _plain(t) == _plain(j)


@pytest.mark.parametrize("fn,args", [("default_grid", ()),
                                     ("default_js_grid", ()),
                                     ("cavity_grid", (64,))])
def test_grid_factories_match(fn, args):
    j, t = getattr(jcfg, fn)(*args), getattr(tcfg, fn)(*args)
    assert _plain(t) == _plain(j)
    assert (t.dx, t.dy, t.shape_u, t.shape_v) == (j.dx, j.dy, j.shape_u, j.shape_v)


def test_import_pulls_in_no_jax():
    code = ("import sys, cfd_demo_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'cfd_demo_tpu' or m.startswith('cfd_demo_tpu.')]; "
            "assert not bad, bad")
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def test_no_jax_import_in_sources():
    pkg = Path(ct.__file__).resolve().parent
    bad = re.compile(r"^\s*(from|import)\s+(jax|cfd_demo_tpu)(\.|\s|$)", re.M)
    for path in pkg.rglob("*.py"):
        if "_build" not in path.relative_to(pkg).parts:  # the build cache
            assert not bad.search(path.read_text()), path


_G = tcfg.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
               obstacles=(tcfg.Cylinder(1.0, 0.75, 0.3),))
_RUST = tcfg.solver_options_for(tcfg.Semantics.RUST)
_BOX = tcfg.Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                 obstacles=(tcfg.Box(1.0, 0.75, 0.2, 0.2),))
_CAVITY = tcfg.FlowCase.CAVITY
_UNPORTED = [
    # JS semantics, SECOND/QUICK faces, the parabolic inlets and CAVITY flow
    # (with JACOBI, FDM, MULTIGRID and both MG_PRODUCTION schemes) are
    # ported; CAVITY with SOR or differentiable, and a Box, are not.
    (_G, tcfg.SimulationParams(pressure_solver=tcfg.PressureSolver.SOR,
                               flow_case=_CAVITY),
     tcfg.solver_options_for(tcfg.Semantics.JS)),
    (_G, tcfg.SimulationParams(velocity_scheme=tcfg.VelocityScheme.SECOND,
                               pressure_solver=tcfg.PressureSolver.SOR,
                               flow_case=_CAVITY), _RUST),
    (_BOX, tcfg.SimulationParams(velocity_scheme=tcfg.VelocityScheme.QUICK),
     tcfg.solver_options_for(tcfg.Semantics.JS)),
    # SOR and FDM are ported; differentiable SOR is not.
    (_G, tcfg.SimulationParams(pressure_solver=tcfg.PressureSolver.SOR),
     tcfg.solver_options_for(tcfg.Semantics.RUST, differentiable=True,
                             early_exit=False, outer_corrector_rounds=0)),
    # MULTIGRID and both MG_PRODUCTION cycles are ported, under CAVITY too;
    # differentiable is not.
    (_G, tcfg.SimulationParams(pressure_solver=tcfg.PressureSolver.MG_PRODUCTION),
     tcfg.solver_options_for(tcfg.Semantics.RUST, mgp_scheme="legacy",
                             differentiable=True, early_exit=False,
                             outer_corrector_rounds=0)),
    (_G, tcfg.SimulationParams(flow_case=_CAVITY),
     tcfg.solver_options_for(tcfg.Semantics.RUST, differentiable=True,
                             early_exit=False, outer_corrector_rounds=0)),
    (_G, tcfg.SimulationParams(inlet_profile=tcfg.InletProfile.PARABOLIC),
     tcfg.solver_options_for(tcfg.Semantics.RUST, differentiable=True,
                             early_exit=False, outer_corrector_rounds=0)),
    (_BOX, tcfg.SimulationParams(), _RUST),
    (_G, tcfg.SimulationParams(),
     tcfg.solver_options_for(tcfg.Semantics.RUST, differentiable=True,
                             early_exit=False, outer_corrector_rounds=0)),
]


@pytest.mark.parametrize("grid,params,opts", _UNPORTED,
                         ids=["js", "second", "quick", "sor", "mg-production",
                              "cavity", "parabolic", "box", "differentiable"])
def test_outside_the_slice_raises(grid, params, opts):
    item = "item 6b" if params.flow_case == _CAVITY else "ROADMAP.md"
    with pytest.raises(NotImplementedError, match=item):
        ct.make_scene(grid, params, opts)


@pytest.mark.parametrize("solver", ["JACOBI", "FDM", "MULTIGRID"])
def test_cavity_is_in_the_slice(solver):
    """CAVITY flow with the Jacobi, FDM and vertex multigrid solves."""
    ct.make_scene(ct.cavity_grid(32), tcfg.SimulationParams(
        flow_case=_CAVITY, pressure_solver=tcfg.PressureSolver[solver]), _RUST)


@pytest.mark.parametrize("opts", [
    tcfg.solver_options_for(tcfg.Semantics.RUST, mgp_scheme="legacy"),
    tcfg.solver_options_for(tcfg.Semantics.RUST, mgp_scheme="aligned"),
    tcfg.solver_options_for(tcfg.Semantics.RUST, mgp_fixed_cycles=2)],
    ids=["legacy", "aligned", "fixed-cycles"])
def test_cavity_mg_production_builds_and_steps(opts):
    """CAVITY with MG_PRODUCTION: either scheme and fixed cycles build and
    step with the cavity app's constants, the lid moving and p' pinned at
    the gauge cell."""
    opts = dataclasses.replace(opts, ramp_up_steps=1, mgp_coarse_stop=4)
    scene = ct.make_scene(ct.cavity_grid(24), tcfg.SimulationParams(
        dt=0.002, viscosity=1e-2, flow_case=_CAVITY,
        pressure_solver=tcfg.PressureSolver.MG_PRODUCTION), opts)
    state, _ = ct.make_run(scene, 4)(scene.init_state(device="cpu"))
    assert bool(torch.isfinite(state.u).all()) and float(state.u[-1].max()) > 0.5
    assert float(state.p_prime[0, 0]) == 0.0 and float(state.p_prime.abs().max()) > 0


def test_batched_cavity_state_raises():
    """Kernels 12 and 20 are the channel's alone: a batched CAVITY state
    raises naming item 6b on the CPU as on the card, even where another
    option would raise for item 9 first."""
    for opts in (_RUST, tcfg.solver_options_for(tcfg.Semantics.JS)):
        scene = ct.make_scene(ct.cavity_grid(16), tcfg.SimulationParams(
            flow_case=_CAVITY), opts)
        batched = ct.batch_state(scene.init_state(device="cpu"), 2)
        with pytest.raises(NotImplementedError, match="item 6b"):
            ct.make_step(scene)(batched)


def test_float64_and_batched_state_raise():
    scene = ct.make_scene(_G, tcfg.SimulationParams(), _RUST)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        scene.init_state(device="cpu", dtype=torch.float64)
    # A batch steps with the Jacobi solver only (tests/test_torch_ensemble.py).
    scene = ct.make_scene(_G, tcfg.SimulationParams(
        pressure_solver=tcfg.PressureSolver.MG_PRODUCTION), _RUST)
    batched = ct.batch_state(scene.init_state(device="cpu"), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ct.make_step(scene)(batched)

