"""The lid-driven cavity (CAVITY flow) on the port against cfd_demo_tpu on the CPU.

The cavity's pieces each against their JAX counterparts on the same
numpy-seeded inputs: the all-Neumann p' BCs, the cavity branch of
apply_bcs (both lids, both semantics' masks), the all-Neumann FDM
operator; the plain versions of kernels 2, 3 and 4 against the Pallas
kernels in interpret mode with ``cavity``; and the whole step against
the NumPy oracle and the JAX package (the JAX package alone for FDM,
which the oracle does not transcribe) at the golden bound of
tests/test_golden.py, per-field L2 <= 1e-5 with every tolerance at zero.

Tolerances: BCs and masks exactly equal (the same f32 operations);
kernel outputs 1e-6 x max(1, max|ref|) as tests/test_torch_kernels.py
holds the channel forms; the rounds kernel at tests/test_ensemble_pallas.py's
bound (atol 5e-5, rtol 1e-4), its p and p' with the mean difference
removed: the cavity's Jacobi never pins the interior, so p' carries a
near-uniform gauge that two f32 orders resolve differently
(tests/test_golden.py:14-24).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cfd_demo_tpu as jc
from cfd_demo_tpu.core import config as jcfg
from cfd_demo_tpu.core.masks import masks_traced as j_masks
from cfd_demo_tpu.kernels.jacobi_pallas import jacobi_fused_k as j_fused_k
from cfd_demo_tpu.kernels.jacobi_pallas import jacobi_pallas as j_chain
from cfd_demo_tpu.kernels.rounds_pallas import solve_correct_rounds_pallas
from cfd_demo_tpu.kernels.substep_pallas import correct_bc_pallas
from cfd_demo_tpu.ops import bc as jbc
from cfd_demo_tpu.ops import fdm as jfdm
from cfd_demo_tpu.ops.poisson import _apply_pprime_bcs_cavity as j_cavity_bcs
from cfd_demo_tpu.oracle.reference import NumpyModel

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.core import config as tcfg
from cfd_demo_tpu_torch.core.masks import masks_traced as t_masks
from cfd_demo_tpu_torch.kernels import jacobi as tjac
from cfd_demo_tpu_torch.kernels import rounds as trounds
from cfd_demo_tpu_torch.kernels import substep as tsub
from cfd_demo_tpu_torch.ops import bc as tbc
from cfd_demo_tpu_torch.ops import fdm as tfdm
from cfd_demo_tpu_torch.ops import poisson as tpois
from cfd_demo_tpu_torch.solver import piso as tpiso

from conftest import l2

torch.set_num_threads(1)

CPU = torch.device("cpu")
DT, INLET = 0.003, 1.0
CAVITY_J, CAVITY_T = jcfg.FlowCase.CAVITY, tcfg.FlowCase.CAVITY
PROFILES = ["UNIFORM", "PARABOLIC", "PARABOLIC_UPPER"]


def both(name, *args, **kw):
    """The same config object built in both packages."""
    return getattr(jcfg, name)(*args, **kw), getattr(tcfg, name)(*args, **kw)


def cavity_grids(nx=40, ny=24, cylinder=True):
    """A unit-height cavity, with a cylinder for the BC masks."""
    lx, ly = nx / ny, 1.0
    obs = lambda m: ((m.Cylinder(0.4 * lx, 0.5, 0.2),) if cylinder else ())
    return (jcfg.Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=obs(jcfg)),
            tcfg.Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=obs(tcfg)))


def fields(seed, grid, scale=1.0):
    rng = np.random.default_rng(seed)
    ny, nx = grid.ny, grid.nx
    mk = lambda shape: (scale * rng.standard_normal(shape)).astype(np.float32)
    return mk((ny, nx + 1)), mk((ny, nx)), mk((ny, nx)), mk((ny, nx))


def T(a):
    return torch.from_numpy(np.array(a))


def assert_close(ref, got, scale_rtol=1e-6):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=scale_rtol * max(1.0, float(np.max(np.abs(ref)))))


def pp_rhs(seed, shape):
    """A cavity-BC-consistent p' (what the folded kernels require) and a
    random rhs."""
    rng = np.random.default_rng(seed)
    pp = np.asarray(j_cavity_bcs(jnp.asarray(
        (0.1 * rng.standard_normal(shape)).astype(np.float32))))
    return pp, rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) The cavity's ops against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 20), (24, 40), (23, 37), (3, 3)])
def test_pprime_bcs_cavity_match_jax(shape):
    """Rows, then the left column, the right column from column nx-2, the
    gauge cell (0, 0) pinned last: the same bits (corners included)."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(j_cavity_bcs(jnp.asarray(x)))
    got = tpois._apply_pprime_bcs_cavity(T(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 0.0 and got[-1, -1] == x[-2, -2]
    assert tpois.pprime_bc_fn(CAVITY_T) is tpois._apply_pprime_bcs_cavity
    assert tpois.pprime_bc_fn(tcfg.FlowCase.CHANNEL) is tpois._apply_pprime_bcs


@pytest.mark.parametrize("semantics", ["RUST", "JS"])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("lid_as_tensor", [False, True])
def test_apply_bcs_cavity_matches_jax(semantics, profile, lid_as_tensor):
    """The lid (UNIFORM, or either parabolic profile as the centred
    parabola along x), floor, side walls and masks, bit for bit."""
    jg, tg = cavity_grids()
    u, v, _, _ = fields(4, jg)
    jm = j_masks(jg, jcfg.Semantics[semantics], jnp.float32)
    tm = t_masks(tg, tcfg.Semantics[semantics], CPU)
    assert tm[2] is not None and bool(tm[2].any())
    ref = jbc.apply_bcs(jnp.asarray(u), jnp.asarray(v), jg, jcfg.InletProfile[profile],
                        0.7, jm[2], jm[3], CAVITY_J)
    lid = torch.tensor(0.7) if lid_as_tensor else 0.7
    got = tbc.apply_bcs(T(u), T(v), tg, tcfg.InletProfile[profile], lid, tm[2], tm[3],
                        CAVITY_T)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    lid_row = got[0][-1].numpy()
    assert lid_row[0] == 0 and lid_row[-1] == 0 and lid_row.max() > 0.6


@pytest.mark.parametrize("shape,dx,dy,d_mult", [
    ((40, 56), 1 / 56, 1 / 40, 1.0),
    ((38, 22), 0.3, 0.2, 1.0),
    ((23, 37), 0.05, 0.07, 1.5),     # the JAX package takes the DCT bases too
    ((8, 1), 0.32, 0.4, 1.0),        # width-1 axes
    ((1, 8), 0.32, 0.4, 1.0),
])
def test_fdm_all_neumann_matches_jax(shape, dx, dy, d_mult):
    """east_dirichlet=False: the Neumann east DCT basis and the
    pseudo-inverse gauge (JAX ops/fdm.py:153-180). For an rhs with zero
    mean (the compatible part) the result solves A e = r."""
    r = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    r -= r.mean(dtype=np.float64).astype(np.float32)
    want = np.asarray(jfdm.fdm_solve_interior(jnp.asarray(r), dx, dy, False,
                                              d_mult * dx))
    got = tfdm.fdm_solve_interior(T(r), dx, dy, d_mult * dx, east_dirichlet=False).numpy()
    # f64 against f32 products: a few ulps of the solution's scale.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    # the residual of the folded all-Neumann operator, in f64
    e = got.astype(np.float64)
    pad = np.pad(e, 1, mode="edge")
    lap = ((pad[1:-1, 2:] + pad[1:-1, :-2] - 2 * e) / dx ** 2
           + (pad[2:, 1:-1] + pad[:-2, 1:-1] - 2 * e) / dy ** 2)
    assert np.abs(lap - r).max() <= 1e-3 * max(1.0, float(np.abs(r).max()))
    assert abs(float(e.mean())) <= 1e-5 * max(1.0, float(np.abs(e).max()))


def test_fdm_channel_bases_keep_their_cache_entry():
    """The channel call's bases are cached apart from the all-Neumann
    ones (east_dirichlet is part of the key)."""
    r = torch.ones(6, 5)
    tfdm.fdm_solve_interior(r, 0.2, 0.2, 0.2)
    tfdm.fdm_solve_interior(r, 0.2, 0.2, 0.2, east_dirichlet=False)
    ch = tfdm._fdm_bases(6, 5, 0.2, 0.2, 0.2, CPU)
    cav = tfdm._fdm_bases(6, 5, 0.2, 0.2, 0.2, CPU, False)
    assert not torch.equal(ch[1], cav[1])
    assert float(cav[2][0, 0]) == 0.0 and bool((ch[2] > 0).all())


# ---------------------------------------------------------------------------
# (b) Plain versions of kernels 2, 3 and 4 against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [((64, 96), 5), ((40, 96), 3), ((24, 40), 1),
                                     ((24, 41), 2)])
def test_jacobi_fused_k_cavity_matches_pallas(shape, k):
    """Kernel 2's CAVITY form (jacobi_pallas.py:133-134, :185-187) as
    tests/test_jacobi_kernel_interpret.py:49-70 holds it, and the folded
    twin the CUDA kernel is held to bit for bit."""
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    pp, rhs = pp_rhs(3, shape)
    ref, ref_err = j_fused_k(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, 0.75, k,
                             block_rows=8, interpret=True, cavity=True)
    got, err = tjac.jacobi_fused_k(T(pp), T(rhs), dx, dy, 0.75, k, cavity=True)
    assert_close(ref, got)
    assert_close(ref_err, err)
    folded, ferr = tjac.jacobi_fused_k_folded(T(pp), T(rhs), dx, dy, 0.75, k, cavity=True)
    assert_close(ref, folded)
    assert_close(ref_err, ferr)
    assert float(got[0, 0]) == 0.0
    np.testing.assert_array_equal(got[:, -1].numpy(), got[:, -2].numpy())


@pytest.mark.parametrize("tol,iters,k", [(0.0, 10, 4), (2e-2, 40, 4), (0.0, 3, 4)])
def test_jacobi_chain_cavity_matches_pallas(tol, iters, k):
    shape = (40, 56)
    ny, nx = shape
    dx, dy = 1.0 / nx, 1.0 / ny
    pp, rhs = pp_rhs(4, shape)
    ref = j_chain(jnp.asarray(pp), jnp.asarray(rhs), dx, dy, 0.75, tol, iters, k=k,
                  block_rows=8, interpret=True, cavity=True)
    got = tjac.jacobi_chain(T(pp), T(rhs), dx, dy, 0.75, tol, iters, k=k, cavity=True)
    assert_close(ref[0], got[0])
    assert_close(ref[1], got[1])
    assert int(ref[2]) == int(got[2])


@pytest.mark.parametrize("semantics", ["RUST", "JS"])
@pytest.mark.parametrize("profile", PROFILES)
def test_correct_bc_cavity_matches_pallas(semantics, profile):
    """Kernel 3 with CAVITY, as tests/test_substep_pallas.py:64-80 runs
    it, on a cavity with a cylinder (the masks) and both lids."""
    jg, tg = cavity_grids(96, 64)
    u, v, p, pp = fields(1, jg)
    ue, ve, _, _ = fields(2, jg)
    ref = correct_bc_pallas(
        *map(jnp.asarray, (u, v, p, pp, ue, ve)), DT, INLET, jg,
        jcfg.InletProfile[profile], CAVITY_J, jcfg.Semantics[semantics],
        block_rows=16, interpret=True)
    got = tsub.correct_bc(*map(T, (u, v, p, pp, ue, ve)), DT, INLET, tg,
                          tcfg.InletProfile[profile], CAVITY_T, tcfg.Semantics[semantics])
    for r, g in zip(ref, got):
        assert_close(r, g)


def test_correct_bc_on_a_cavity_state_is_the_plain_cavity_branch():
    """On a CAVITY state correct_bc is correct_bc_plain's cavity branch bit
    for bit: the lid's row at the lid's speed, the floor and the side walls
    at rest, and the three maxima over those fields."""
    _, tg = cavity_grids(cylinder=False)
    args = (*map(T, fields(1, tg)), *map(T, fields(2, tg)[:2]), DT, INLET, tg,
            tcfg.InletProfile.UNIFORM, CAVITY_T, tcfg.Semantics.RUST)
    got, ref = tsub.correct_bc(*args), tsub.correct_bc_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    u, v = got[:2]
    assert bool((u[-1, 1:-1] == INLET).all())
    assert not u[0].any() and not u[:, 0].any() and not u[:, -1].any()
    assert not v[0].any() and not v[:, 0].any() and not v[:, -1].any()
    assert torch.equal(got[3], (u - args[4]).abs().max())
    assert torch.equal(got[5], torch.maximum(u.abs().max(), v.abs().max()))


def _rounds_case(seed, nx, profile="UNIFORM", semantics="RUST"):
    """A cavity scene with a cylinder, with seeded predictor outputs and a
    cavity-BC-consistent warm start (tests/test_ensemble_pallas.py:99-146)."""
    jg, tg = cavity_grids(nx, 24)
    params = lambda m: m.SimulationParams(dt=0.002, viscosity=1e-2, flow_case=m.FlowCase.CAVITY,
                                          inlet_profile=m.InletProfile[profile])
    scenes = [m.make_scene(g, params(m), m.solver_options_for(m.Semantics[semantics]))
              for m, g in ((jc, jg), (tc, tg))]
    rng = np.random.default_rng(seed)
    mk = lambda shp, s: (s * rng.standard_normal(shp)).astype(np.float32)
    us, vs = mk((24, nx + 1), 0.1), mk((24, nx), 0.1)
    p = mk((24, nx), 0.05)
    pp0 = (np.zeros((24, nx), np.float32) if semantics == "JS"
           else np.asarray(j_cavity_bcs(jnp.asarray(mk((24, nx), 0.01)))))
    return (*scenes, (us, vs, p, pp0, mk((24, nx), 1.0)))


@pytest.mark.parametrize("nx,profile,semantics", [(40, "UNIFORM", "RUST"),
                                                  (41, "PARABOLIC", "RUST"),
                                                  (42, "UNIFORM", "JS"),
                                                  (43, "PARABOLIC_UPPER", "RUST")])
def test_rounds_cavity_matches_pallas(nx, profile, semantics):
    """Kernel 4's plain version on a cavity scene (every residue of nx mod
    4) against solve_correct_rounds_pallas(interpret=True)."""
    jscene, tscene, arrays = _rounds_case(2, nx, profile, semantics)
    ref = solve_correct_rounds_pallas(*map(jnp.asarray, arrays), 0.002, 1.0, jscene,
                                      interpret=True)
    got = trounds.solve_correct_rounds(*map(T, arrays), 0.002, 1.0, tscene)
    demean = lambda a, b: a - (a - b).mean()
    for name, r, g in zip(("u", "v", "p", "pp"), ref, got):
        r = np.asarray(r)
        g = g.numpy().astype(np.float64)
        if name in ("p", "pp"):
            g = demean(g, r)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=5e-5, err_msg=name)
    rounds, sweeps = got[5].tolist()
    assert rounds + 1 <= sweeps <= (rounds + 1) * tscene.opts.jacobi_iters
    assert float(got[3][0, 0]) == 0.0
    assert float(got[0][-1, 0]) == 0.0 and float(got[0][-1].max()) > 0.5


# ---------------------------------------------------------------------------
# (c) The step against the NumPy oracle and the JAX package
# ---------------------------------------------------------------------------

def _tracers(m, solver="JACOBI", semantics="RUST", scheme="FIRST", **kw):
    """tests/test_cavity_tracers.py:23-38's scene: cavity_grid(20), the
    cavity app's constants, every tolerance at zero."""
    params = m.SimulationParams(dt=0.002, viscosity=1e-2, target_inlet_velocity=1.0,
                                flow_case=m.FlowCase.CAVITY,
                                pressure_solver=m.PressureSolver[solver],
                                velocity_scheme=m.VelocityScheme[scheme])
    opts = m.solver_options_for(m.Semantics[semantics], ramp_up_steps=10, jacobi_tol=0.0,
                                outer_corrector_tol=0.0, jacobi_iters=10,
                                outer_corrector_rounds=3, **kw)
    return m.cavity_grid(20), params, opts


def _parabolic(m, **kw):
    """tests/test_golden.py:192-215's parabolic lid."""
    grid = m.Grid(nx=24, ny=16, lx=1.5, ly=1.0)
    params = m.SimulationParams(dt=0.004, viscosity=1e-3, target_inlet_velocity=1.0,
                                inlet_profile=m.InletProfile.PARABOLIC,
                                flow_case=m.FlowCase.CAVITY)
    opts = m.solver_options_for(m.Semantics.RUST, ramp_up_steps=3, jacobi_tol=0.0,
                                outer_corrector_tol=0.0, jacobi_iters=10,
                                outer_corrector_rounds=4, **kw)
    return grid, params, opts


def _fused(m, **kw):
    """The fast mode's schedule (bench.py:78-86) on a 40x24 cavity with the
    fused route forced: kernels 1, 2 and 3 in their cavity forms."""
    grid = m.Grid(nx=40, ny=24, lx=40 / 24, ly=1.0)
    params = m.SimulationParams(dt=0.002, viscosity=1e-2, flow_case=m.FlowCase.CAVITY,
                                inlet_profile=m.InletProfile.PARABOLIC)
    opts = m.solver_options_for(m.Semantics.RUST, ramp_up_steps=10, jacobi_tol=0.0,
                                jacobi_iters=20, outer_corrector_rounds=0,
                                early_exit=False, substep_impl="pallas",
                                pressure_impl="pallas", **kw)
    return grid, params, opts


# name -> (the configuration's function, keyword arguments, the oracle transcribes it)
STEP_CASES = {
    "tracers": (_tracers, {}, True),
    "parabolic": (_parabolic, {}, True),
    "js": (_tracers, {"semantics": "JS"}, True),
    "second": (_tracers, {"scheme": "SECOND"}, True),
    "quick": (_tracers, {"scheme": "QUICK"}, True),
    "multigrid": (_tracers, {"solver": "MULTIGRID"}, True),
    "fdm": (_tracers, {"solver": "FDM"}, False),
    "jnp": (_tracers, {"pressure_impl": "jnp"}, True),
    "fused": (_fused, {}, True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_cavity_steps_match_oracle_and_jax(case, monkeypatch):
    """Three steps on both packages (and the oracle), per-field L2 <= 1e-5
    (tests/test_golden.py's bound), u, v, p and p'. The fused case goes
    through kernels 1, 2 and 3's cavity wrappers; the Jacobi cases
    through kernel 4's."""
    build, kw, oracle_ok = STEP_CASES[case]
    jg, jp, jo = build(jc, **kw)
    tg, tp, to = build(tc, **kw)
    jscene = jc.make_scene(jg, jp, jo)
    tscene = tc.make_scene(tg, tp, to)
    calls = []
    for name in ("solve_correct_rounds", "jacobi_chain", "correct_bc"):
        real = getattr(tpiso, name)
        monkeypatch.setattr(tpiso, name, lambda *a, _f=real, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    oracle = NumpyModel(jg, jp, jo) if oracle_ok else None
    jstep, tstep = jc.make_step(jscene, donate=False), tc.make_step(tscene)
    js, ts = jscene.init_state(), tscene.init_state(device="cpu")
    for k in range(3):
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        if oracle is not None:
            oracle.update()
        for f in ("u", "v", "p", "p_prime"):
            got = getattr(ts, f).numpy()
            assert l2(got, np.asarray(getattr(js, f))) <= 1e-5, (k, f, "jax")
            if oracle is not None:
                want = getattr(oracle, f)
                want = want[:-1] if f == "v" else want
                assert l2(got, want) <= 1e-5, (k, f, "oracle")
        assert np.isclose(float(ts.dt), float(js.dt), rtol=1e-5, atol=1e-8)
    want = {"fused": {"jacobi_chain", "correct_bc"}, "fdm": set(), "multigrid": set(),
            "jnp": set()}.get(case, {"solve_correct_rounds"})
    assert set(calls) == want
    lid = ts.u[-1].numpy()
    assert lid[0] == 0 and lid[-1] == 0 and lid.max() > 0


def test_cavity_correct_div_route_equals_the_unfused_route():
    """The fused route with outer rounds and rounds_impl="pallas" (each
    round the cavity chain and one correct_div, the cavity BCs after) is
    the unfused route's arithmetic, bit for bit (as
    tests/test_torch_correct_div.py holds the channel's); u and v at the
    golden bound of the JAX package's route (the chain exits k sweeps
    apart from JAX's per-sweep exit, so p differs by more)."""
    def scene(m, impl):
        g, p, o = _fused(m)
        return m.make_scene(g, p, dataclasses.replace(
            o, outer_corrector_rounds=3, jacobi_tol=1e-3, outer_corrector_tol=1e-3,
            early_exit=True, rounds_impl=impl))

    runs = {impl: tc.make_run(scene(tc, impl), 3)(scene(tc, impl).init_state(device="cpu"))
            for impl in ("pallas", "jnp")}
    (sp, dp), (sj, dj) = runs["pallas"], runs["jnp"]
    for f in ("u", "v", "p", "p_prime"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(), getattr(sj, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(dp.res_p.numpy(), dj.res_p.numpy())
    js, _ = jc.make_run(scene(jc, "pallas"), 3, donate=False)(scene(jc, "pallas").init_state())
    for f in ("u", "v"):
        assert l2(getattr(sp, f).numpy(), np.asarray(getattr(js, f))) <= 1e-5, f


# ---------------------------------------------------------------------------
# (d) A JAX cavity state resumed in the port
# ---------------------------------------------------------------------------

def test_cavity_state_resumes_from_jax():
    """state_from_numpy carries a JAX cavity state (the same fields as a
    channel one) into the port; both step on to the same fields."""
    jscene = jc.make_scene(*_parabolic(jc))
    tscene = tc.make_scene(*_parabolic(tc))
    jstep = jc.make_step(jscene, donate=False)
    js = jscene.init_state()
    for _ in range(2):
        js, _ = jstep(js)
    d = {f.name: (None if getattr(js, f.name) is None else np.asarray(getattr(js, f.name)))
         for f in dataclasses.fields(js)}
    ts = tc.state_from_numpy(d, "cpu")
    assert set(tc.state_to_numpy(ts)) == set(d)
    tstep = tc.make_step(tscene)
    for _ in range(2):
        js, _ = jstep(js)
        ts, _ = tstep(ts)
    for f in ("u", "v", "p", "p_prime"):
        assert l2(getattr(ts, f).numpy(), np.asarray(getattr(js, f))) <= 1e-5, f
    assert int(ts.step) == int(js.step) == 4


# ---------------------------------------------------------------------------
# What the slice leaves out
# ---------------------------------------------------------------------------

def test_cavity_routes_outside_the_slice_raise():
    """Batches and the sharded step refuse CAVITY naming item 6b, as do
    the shard kernels."""
    _, tg = cavity_grids(cylinder=False)
    scene = tc.make_scene(tg, tcfg.SimulationParams(flow_case=CAVITY_T))
    batched = tc.batch_state(scene.init_state(device="cpu"), 2)
    with pytest.raises(NotImplementedError, match="item 6b"):
        tc.make_step(scene)(batched)
    from cfd_demo_tpu_torch.shard import make_mesh, make_step_shmap
    with pytest.raises(NotImplementedError, match="item 6b"):
        make_step_shmap(scene, make_mesh(2, "cpu"))


def test_ghia_scene_and_table_are_test_physics():
    """validation.py's Re = 100 scene and Ghia table are
    tests/test_physics.py:121-170's, and its deviation reads the centre
    lines where that test does."""
    import test_physics as tp
    from cfd_demo_tpu_torch import validation as val
    want = jc.make_scene(jc.cavity_grid(64), jc.SimulationParams(
        dt=3e-3, viscosity=0.01, target_inlet_velocity=1.0, flow_case=CAVITY_J),
        jc.solver_options_for(jc.Semantics.RUST, ramp_up_steps=100, jacobi_tol=0.0,
                              jacobi_iters=50, outer_corrector_rounds=0, early_exit=False))
    scene = val.ghia_scene()
    for part in ("grid", "params", "opts"):
        assert repr(getattr(scene, part)) == repr(getattr(want, part)), part
    for name in ("GHIA_RE100_Y", "GHIA_RE100_U", "GHIA_RE100_X", "GHIA_RE100_V"):
        np.testing.assert_array_equal(getattr(val, name), getattr(tp, name))
    # a state holding the table's own profiles on the centre lines
    n = 64
    c = (np.arange(n) + 0.5) / n
    u = np.zeros((n, n + 1), np.float32)
    v = np.zeros((n, n), np.float32)
    u[:, n // 2] = np.interp(c, tp.GHIA_RE100_Y, tp.GHIA_RE100_U)
    v[n // 2, :] = np.interp(c, tp.GHIA_RE100_X, tp.GHIA_RE100_V)
    state = dataclasses.replace(scene.init_state(device="cpu"), u=T(u), v=T(v))
    du, dv = val.ghia_deviation(state)
    assert du < 0.03 and dv < 0.03
    assert val.ghia_deviation(scene.init_state(device="cpu"))[0] > 0.8


def test_app_dt_at_1024_grows_as_jax_does():
    """The cavity app's dt (0.002) at 1024² breaks the explicit scheme's
    stability limit: within 3 steps u exceeds the ramped lid speed (0.03)
    several times over, in the JAX package as in the port, to the golden
    bound."""
    scenes = [m.make_scene(m.cavity_grid(1024), m.SimulationParams(
        dt=0.002, viscosity=1e-2, target_inlet_velocity=1.0, flow_case=m.FlowCase.CAVITY),
        m.solver_options_for(m.Semantics.RUST)) for m in (jc, tc)]
    js, _ = jc.make_run(scenes[0], 3, donate=False)(scenes[0].init_state())
    ts, _ = tc.make_run(scenes[1], 3)(scenes[1].init_state(device="cpu"))
    for f in ("u", "v"):
        want = np.asarray(getattr(js, f))
        scale = max(1.0, float(np.sqrt(np.mean(want.astype(np.float64) ** 2))))
        assert l2(getattr(ts, f).numpy(), want) <= 1e-5 * scale, f
    assert float(ts.u.max()) > 5 * 0.03
